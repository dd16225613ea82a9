"""surreal-depth3's sampling round in dcvgan_torch held against the benchmark's
plain reference (``portbench/reference``: float32 PyTorch, no kernel, no
JAX) on the CPU at a small size: the depth configuration whose colour
generator is the widest published one (cgen ngf 96 over ggen ngf 64), cut
here to ggen ngf 16 and cgen ngf 24. That keeps the 3:2 ratio of the two
widths and gives cgen channel runs of 24, 48 and 96, which are not whole
16- or 64-channel chunks: the partial chunks of the kernels' staging. Two
videos, on the same seeded weights, running statistics and draws.

In bfloat16 the CPU takes the card's path: the gates of the depth inconv
and of both decoders' fused up stages are opened for a CPU tensor, so that
``inconv3x3``, ``fused_norm_act_conv`` and ``fused_norm_act_up_conv`` run
their plain versions where a card runs the kernels."""

import numpy as np
import pytest
import torch

from dcvgan_torch import prng
from dcvgan_torch.cli.serve import quantize
from dcvgan_torch.models import cgen as cgen_mod
from dcvgan_torch.models import ggen as ggen_mod
from dcvgan_torch.ops import fused_block, fused_up, inconv, outconv
from dcvgan_torch.train.step import DCVGAN
from portbench import harness, judge, weights
from portbench.reference import models, steps, streams

SEED = 2**31 + 8765
SMALL = {"ggen.ngf": 16, "cgen.ngf": 24}


def _card_path(monkeypatch, calls):
    """The gates opened for a CPU tensor in eval bfloat16 (the ops run their
    plain versions), each op's calls counted."""
    def eval_bf16(x, train, norm="batch"):
        return not train and norm == "batch" and x.dtype == torch.bfloat16

    def inconv_on(x, train, geometric_info):
        return geometric_info != "segmentation" and eval_bf16(x, train)

    def counted(name, op):
        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return op(*a, **k)

        return call

    monkeypatch.setattr(cgen_mod, "inconv_fused", inconv_on)
    monkeypatch.setattr(cgen_mod, "decodes_fused", eval_bf16)
    monkeypatch.setattr(ggen_mod, "decodes_fused", eval_bf16)
    monkeypatch.setattr(cgen_mod, "inconv3x3", counted("inconv3x3", inconv.inconv3x3))
    monkeypatch.setattr(cgen_mod, "fused_norm_act_conv", counted("fused_norm_act_conv", fused_block.fused_norm_act_conv))
    monkeypatch.setattr(cgen_mod, "fused_norm_act_up_conv", counted("cgen_up", fused_up.fused_norm_act_up_conv))
    monkeypatch.setattr(ggen_mod, "fused_norm_act_up_conv", counted("ggen_up", fused_up.fused_norm_act_up_conv))


def _round(precision, monkeypatch, calls):
    cfg = harness.load_config(harness.ROOT / "configs" / "surreal-depth3.yml", SEED,
                              dict(SMALL, **{"trainer.precision": precision}))
    assert (cfg.geometric_info.name, cfg.geometric_info.channel) == ("depth", 1)
    assert (cfg.ggen.ngf, cfg.cgen.ngf) == (16, 24)
    w = weights.draw(cfg, SEED, "cpu")
    running = steps.calibrate(cfg, w, SEED, "cpu", batchsize=8)
    gan = DCVGAN(cfg, device="cpu")
    state = gan.init_state(0)
    for m in ("ggen", "cgen"):
        weights.load_into(getattr(state, m), w[m], m)
        weights.load_running(getattr(state, m), running[m])
    served = state.generators()
    _card_path(monkeypatch, calls)
    _, xc = gan.sample_videos(served, prng.for_step(prng.base_key(SEED, "cpu"), 3), 2)

    def reference(arith="f32"):
        gen = streams.fold_in(streams.base_key(SEED, "cpu"), 3)
        return steps.sample_round(cfg, w, running, gen, 2, models.Arith(arith)).numpy()

    return quantize(xc).numpy(), reference


def test_float32_round_is_the_reference(monkeypatch):
    """float32 keeps the modules but for the down path (the fused op's
    tf32x3 route on a card, its plain version here): the same ops in another
    order. The bytes agree but for a level's edge (one level at most), and
    the largest per-video mean gap stays under 0.01 levels."""
    calls = {}
    got, reference = _round("float32", monkeypatch, calls)
    want = reference()
    assert calls == {"fused_norm_act_conv": 5}
    assert judge.video_gap(got, want) < 0.01
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert want.std() > 10  # the calibrated statistics spread the output over the range


def test_bfloat16_round_on_the_fused_path_is_as_near_as_bfloat16_allows(monkeypatch):
    """bfloat16 on the card's path: one inconv, five fused down sites, ggen's
    four and cgen's six fused up sites a round. Its gap to the float32
    reference is rounding, of the size the reference itself shows computed
    in bfloat16 (measured at this size: seed 2**31 + 8765, the port 0.426
    levels, the bf16 reference 0.295, the fp8 control 4.09; seeds 11 and
    12345, 0.439 / 0.317 / 4.52 and 0.549 / 0.377 / 5.46). The port rounds
    to bfloat16 at more points than the reference (each BatchNorm output,
    each activation), so it reads 1.39-1.46 times the bf16 reference. Held:
    the port within 1.5 times the bf16 reference's gap + 0.1 level, and
    under half the fp8 control's gap."""
    calls = {}
    got, reference = _round("bfloat16", monkeypatch, calls)
    assert calls == {"inconv3x3": 1, "fused_norm_act_conv": 5, "ggen_up": 4, "cgen_up": 6}
    want = reference()
    gap, bf16_gap = judge.video_gap(got, want), judge.video_gap(reference("bf16"), want)
    fp8_gap = judge.video_gap(reference("fp8"), want)
    assert 0 < gap <= 1.5 * bf16_gap + 0.1, (gap, bf16_gap)
    assert gap < 0.5 * fp8_gap, (gap, fp8_gap)


@pytest.mark.parametrize("op", ["fused_norm_act_conv", "fused_norm_act_up_conv"])
def test_the_planners_take_channel_runs_that_are_not_whole_chunks(op):
    """At cgen ngf 24 the sites' channel runs (24, 48, 96) are not whole 16-
    or 64-channel chunks. The CPU runs each op's plain version; on a card
    the same round takes the kernels, so each site must have a plan there."""
    cgen = cgen_mod.ColorVideoGenerator(ngf=24)
    if op == "fused_norm_act_conv":
        for i in range(1, len(cgen.down_blocks)):
            conv, h = cgen.down_blocks[i].main[0], 64 >> i
            assert fused_block.plan(32, h, h, conv.in_channels, conv.out_channels, torch.bfloat16) is not None
    else:
        for i in range(1, len(cgen.up_blocks)):
            c1, conv, h = cgen.up_blocks[i - 1].main[0].out_channels, cgen.up_blocks[i].main[0], 1 << i
            assert fused_up.plan(32, h, h, c1, conv.in_channels - c1, conv.out_channels).units > 0
        c1 = cgen.up_blocks[-1].main[0].out_channels
        assert outconv.plan(32, 64, 64, c1, cgen.outconv.main[0].in_channels - c1, 3).grid > 0
