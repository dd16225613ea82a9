"""surreal-segm's sampling round in dcvgan_torch held against the benchmark's
plain reference (``portbench/reference``: float32 PyTorch, no kernel, no
JAX) on the CPU at a small size: 25 segmentation classes, ggen and cgen at
ngf 16 (ggen's channels 128 -> 64 -> 32 -> 16 -> 25, the published 768 ->
... -> 25 over six), two videos, on the same seeded weights, running
statistics and draws."""

import numpy as np
import pytest
import torch

from dcvgan_torch import prng
from dcvgan_torch.cli.serve import quantize
from dcvgan_torch.models import cgen as cgen_mod
from dcvgan_torch.ops import onehot_conv
from dcvgan_torch.train.step import DCVGAN
from portbench import harness, judge, weights
from portbench.reference import models, steps, streams

SEED = 2**31 + 4321
SMALL = {"ggen.ngf": 16, "cgen.ngf": 16}


def _round(precision, monkeypatch, op_calls):
    cfg = harness.load_config(harness.ROOT / "configs" / "surreal-segm.yml", SEED,
                              dict(SMALL, **{"trainer.precision": precision}))
    assert cfg.geometric_info.name == "segmentation" and cfg.geometric_info.channel == 25
    w = weights.draw(cfg, SEED, "cpu")
    running = steps.calibrate(cfg, w, SEED, "cpu", batchsize=8)
    gan = DCVGAN(cfg, device="cpu")
    state = gan.init_state(0)
    for m in ("ggen", "cgen"):
        weights.load_into(getattr(state, m), w[m], m)
        weights.load_running(getattr(state, m), running[m])
    served = state.generators()

    def counted(p, wt, slope=0.01):
        op_calls.append(tuple(p.shape))
        return onehot_conv.onehot_conv3x3(p, wt, slope)

    # the CPU taken as CUDA for the colour generator's one-hot input (the
    # op runs its plain version), so the round takes the path a card takes
    monkeypatch.setattr(cgen_mod, "onehot_fused", lambda x, train: x.dtype == torch.bfloat16 and not train)
    monkeypatch.setattr(cgen_mod, "onehot_conv3x3", counted)
    _, xc = gan.sample_videos(served, prng.for_step(prng.base_key(SEED, "cpu"), 2), 2)

    def reference(arith="f32"):
        gen = streams.fold_in(streams.base_key(SEED, "cpu"), 2)
        return steps.sample_round(cfg, w, running, gen, 2, models.Arith(arith)).numpy()

    return quantize(xc).numpy(), reference


def test_float32_round_is_the_reference(monkeypatch):
    """float32: the same ops in another order; the bytes agree but for a
    level's edge (one level), so the largest per-video mean gap stays under
    0.01 levels."""
    calls = []
    got, reference = _round("float32", monkeypatch, calls)
    want = reference()
    assert calls == []  # float32 keeps the modules
    assert judge.video_gap(got, want) < 0.01
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert want.std() > 10  # the calibrated statistics spread the output over the range


def test_bfloat16_round_on_the_op_is_as_near_as_bfloat16_allows(monkeypatch):
    """bfloat16 with the one-hot input on the op. ggen's softmax is rounded
    to bf16 (8 significant bits), so classes within ~0.4% of the maximum
    tie and the first wins where the float32 reference takes the larger;
    each such pixel takes another class and cgen colours its neighbourhood
    otherwise. So the gap to the float32 reference is that of the reference
    itself computed in bfloat16 (measured at ngf 16, 4 videos, 3 seeds: the
    port 4.45-4.56 levels, the bf16 reference 4.41-4.55, the fp8 control
    12.7-13.7). Held: the port within 10% + 0.1 level of the bf16
    reference's gap, and the fp8 control more than twice the port's."""
    calls = []
    got, reference = _round("bfloat16", monkeypatch, calls)
    assert calls == [(32, 25, 64, 64)]  # one launch a round: 2 videos x 16 frames
    want = reference()
    gap, bf16_gap = judge.video_gap(got, want), judge.video_gap(reference("bf16"), want)
    fp8_gap = judge.video_gap(reference("fp8"), want)
    assert 0 < gap <= 1.1 * bf16_gap + 0.1, (gap, bf16_gap)
    assert fp8_gap > 2 * gap, (gap, fp8_gap)
