"""The benchmark's plain reference held against dcvgan_torch at ngf 8 on
the CPU, in float32: the same weights and draws give the same sampling
rounds and the same train steps."""

import numpy as np
import pytest
import torch

from portbench import harness, judge, weights
from portbench.reference import models, steps, streams
from portbench.tests.conftest import TINY

SEED = 2**31 + 12345


def _cfg(path="mug-depth.yml", **extra):
    return harness.load_config(harness.ROOT / "configs" / path, SEED, dict(TINY, **extra))


@pytest.fixture(scope="module")
def program():
    from dcvgan_torch import prng
    from dcvgan_torch.train.step import DCVGAN

    return DCVGAN, prng


@pytest.mark.parametrize("config,extra", [
    ("mug-depth.yml", {}),
    ("isogd-flow.yml", {}),
    ("mug-depth.yml", {"idis.use_noise": True, "vdis.use_noise": True, "loss": "hinge-loss"})])
def test_train_step_matches_the_program(program, config, extra):
    DCVGAN, prng = program
    cfg = _cfg(config, **extra)
    gan = DCVGAN(cfg, device="cpu")
    state = gan.init_state(0)
    w = weights.draw(cfg, SEED, "cpu")
    for m in models.MODELS:
        weights.load_into(getattr(state, m), w[m], m)
    rng = np.random.default_rng(0)
    gi = cfg.geometric_info
    batches = [{"color": torch.from_numpy(rng.uniform(-1, 1, (4, 16, 64, 64, 3)).astype(np.float32)),
                gi.name: torch.from_numpy(rng.uniform(-1, 1, (4, 16, 64, 64, gi.channel)).astype(np.float32))}
               for _ in range(2)]
    losses = []
    for s, b in enumerate(batches):
        state, met = gan.train_step(state, b, prng.base_key(SEED, "cpu"))
        losses.append({k: float(v) for k, v in met.items()})
        if s == 0:
            grads1 = {m: {k: (state.opt[m].state[p]["exp_avg"] / (1 - getattr(cfg, m).optimizer.b1)).clone()
                          for k, p in getattr(state, m).named_parameters()} for m in models.MODELS}
    params = {m: {k: p.detach().clone() for k, p in getattr(state, m).named_parameters()}
              for m in models.MODELS}
    ref = steps.train_steps(cfg, w, batches, SEED, "cpu")
    for got, want in zip(losses, ref["losses"]):
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6)
    gaps = judge.train_gaps(losses, grads1, params, ref, w)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-3 and gaps["grad_gap.critics"] < 1e-4


def test_sampling_round_matches_the_program(program):
    """Eval mode: ggen, then cgen on the fused path's plain version, both
    quantised; the program's bytes equal the reference's but for rounding
    at a level's edge."""
    DCVGAN, prng = program
    from dcvgan_torch.cli.serve import quantize

    cfg = _cfg()
    w = weights.draw(cfg, SEED, "cpu")
    running = steps.calibrate(cfg, w, SEED, "cpu", batchsize=8)
    gan = DCVGAN(cfg, device="cpu")
    state = gan.init_state(0)
    for m in ("ggen", "cgen"):
        weights.load_into(getattr(state, m), w[m], m)
        weights.load_running(getattr(state, m), running[m])
    served = state.generators()
    key = prng.for_step(prng.base_key(SEED, "cpu"), 3)
    _, xc = gan.sample_videos(served, key, 6)
    got = quantize(xc).numpy()
    want = steps.sample_round(cfg, w, running, streams.fold_in(streams.base_key(SEED, "cpu"), 3), 6).numpy()
    assert judge.video_gap(got, want) < 0.01
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert want.std() > 10  # the calibrated statistics spread the output over the range


def test_batches_are_the_loaders(tmp_path):
    from dcvgan_torch.cli.train import build_dataset
    from dcvgan_torch.data.loader import VideoLoader
    from portbench import data

    cfg = _cfg(**{"dataset.processed_root": str(tmp_path)})
    tree = data.tree(tmp_path, 12, 64)
    ds = build_dataset(cfg)
    with VideoLoader(ds, batchsize=4, n_workers=2, seed=cfg.seed) as loader:
        for b, got in enumerate(loader.epoch_iterator(epoch=0)):
            want = steps.read_batch(tree["path"], cfg, cfg.seed, 0, b, "cpu")
            for k in ("color", "depth"):
                assert torch.equal(torch.from_numpy(got[k]).float() / 127.5 - 1, want[k])


def test_streams_are_the_programs(program):
    _, prng = program
    for seed in (0, 5, 2**31 + 7, 2**40 + 3):
        a, b = prng.base_key(seed, "cpu"), streams.base_key(seed, "cpu")
        assert a.initial_seed() == b.initial_seed()
        for name in streams.NAMED_TAGS:
            assert prng.named(a, name).initial_seed() == streams.named(b, name).initial_seed()
        assert prng.for_step(a, 9).initial_seed() == streams.fold_in(b, 9).initial_seed()


def test_tree_is_the_synthetic_generator(tmp_path):
    """The frozen copy writes what the port's synthetic preprocessor writes."""
    from dcvgan_torch.data.preprocess.synthetic import preprocess_synthetic_dataset
    from portbench import data

    ours = data.tree(tmp_path / "a", 5, 64)
    preprocess_synthetic_dataset(None, tmp_path / "b", "train", 16, 64, 1, n_videos=5)
    a, b = tmp_path / "a" / data.NAME / "train", tmp_path / "b"
    assert (a / "list.txt").read_text() == (b / "list.txt").read_text()
    for f in sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file()):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    assert ours["bytes"] > 0
