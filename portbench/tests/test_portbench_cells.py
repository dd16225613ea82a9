"""Whole runs of each traffic kind on the CPU at a tiny size (the look for a
card skipped), sound and with the timed path broken underneath: ``correct``
holds for the sound program and comes out false for each fault the cell can
have.

The ``train`` kind has no cell in BENCHMARK.json yet (PERF.md, Open
questions): its run here uses a cell and limits of the test's own, float32
at ngf 8, to hold the harness's mechanics."""

import functools
import time

import numpy as np
import pytest
import torch

from portbench import harness

TRAIN = "mug-depth.train-test"
SAMPLE = "mug-depth.sample-b256"
HTTP = "mug-depth.http-cli"
SMALL = {TRAIN: {"n_clips": 12, "warm_steps": 4},
         SAMPLE: {"batchsize": 4, "rounds": 2, "sampled_chunks": [2, 4]},
         HTTP: {"batchsize": 8, "rounds": 1, "n_mix": [1, 2, 4], "warm_s": 1.0}}
# float32 at ngf 8 on the CPU: the step-1 critic gradients agree to ~1e-4 and
# the change over three steps to ~0.1 (Adam's first steps move near-zero
# gradient elements by whole learning rates)
TRAIN_WORKLOAD = {"traffic": "train", "why": "the harness's train mechanics at ngf 8",
                  "params": {"n_clips": 12, "warm_steps": 4, "trace_warm_steps": 1,
                             "trace_steps": 2,
                             "limits": {"grad_gap.critics": 0.01, "change_gap": 0.3}}}


def _bench_with_train():
    bench = harness.load_bench()
    bench["workloads"].append({"name": TRAIN, "config": "mug-depth", "traffic": "train-test",
                               "chips": 1, "why": TRAIN_WORKLOAD["why"]})
    bench["end_to_end"].append({"name": "train_videos_per_s", "unit": "videos/s",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": [TRAIN]})
    return bench


def _run(cell, tiny, seed=2**31 + 99, seconds=2.0):
    if cell == TRAIN:
        return harness.run(cell, seed, seconds, False, time.time(), device="cpu", overrides=tiny,
                           bench=_bench_with_train(), workload=TRAIN_WORKLOAD)
    return harness.run(cell, seed, seconds, False, time.time(), device="cpu", overrides=tiny,
                       params=SMALL[cell])


def _unchanged(step):
    """A train step that returns its state unchanged (its losses as computed)."""

    @functools.wraps(step)
    def broken(self, state, batch, key, draws=None):
        saved = {m: {k: p.detach().clone() for k, p in getattr(state, m).named_parameters()}
                 for m in ("ggen", "cgen", "idis", "vdis", "gdis")}
        state, metrics = step(self, state, batch, key, draws)
        with torch.no_grad():
            for m, ps in saved.items():
                for k, p in getattr(state, m).named_parameters():
                    p.copy_(ps[k])
        return state, metrics

    return broken


def _half_batch(step):
    """A train step on the first half of its batch, the means over it."""

    @functools.wraps(step)
    def broken(self, state, batch, key, draws=None):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return step(self, state, half, key, draws)

    return broken


def _altered_video(quantize):
    """The quantised videos with one video's levels moved where produced."""

    @functools.wraps(quantize)
    def broken(x):
        q = quantize(x)
        if q.shape[-1] == 3:
            q[0] = q[0] + 64
        return q

    return broken


def _half_round(sample_videos):
    """A sampling round that draws half its videos and repeats them."""

    @functools.wraps(sample_videos)
    def broken(self, state, gen, batchsize, latents=None):
        xg, xc = sample_videos(self, state, gen, batchsize - batchsize // 2, latents)
        return (torch.cat([xg, xg])[:batchsize], torch.cat([xc, xc])[:batchsize])

    return broken


@pytest.mark.parametrize("cell", [TRAIN, SAMPLE, HTTP])
def test_sound_run_is_correct(cell, tiny):
    r = _run(cell, tiny)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    bench = _bench_with_train() if cell == TRAIN else harness.load_bench()
    e2e = {m["name"] for m in harness.metrics_for(bench, cell, "end_to_end")}
    assert set(r["metrics"]) == e2e and all(v["value"] > 0 for k, v in r["metrics"].items()
                                            if k != "peak_mem_gb")
    assert list(r)[-2:] == ["checks", "counters"] or list(r)[-1] == "checks"


@pytest.mark.parametrize("cell,target,fault", [
    (TRAIN, "dcvgan_torch.train.step.DCVGAN.train_step", _unchanged),
    (TRAIN, "dcvgan_torch.train.step.DCVGAN.train_step", _half_batch),
    (SAMPLE, "dcvgan_torch.cli.serve.quantize", _altered_video),
    (SAMPLE, "dcvgan_torch.train.step.DCVGAN.sample_videos", _half_round),
    (HTTP, "dcvgan_torch.cli.serve.quantize", _altered_video),
    (HTTP, "dcvgan_torch.train.step.DCVGAN.sample_videos", _half_round),
], ids=lambda v: getattr(v, "__name__", None) or str(v).split(".")[-1])
def test_broken_path_is_not_correct(cell, target, fault, tiny, monkeypatch):
    import importlib

    mod_name, attr = target.rsplit(".", 1)
    try:
        owner = importlib.import_module(mod_name)
    except ModuleNotFoundError:
        mod_name, cls = mod_name.rsplit(".", 1)
        owner = getattr(importlib.import_module(mod_name), cls)
    monkeypatch.setattr(owner, attr, fault(getattr(owner, attr)))
    r = _run(cell, tiny)
    assert not r["correct"], r["checks"]


def test_digest_sees_one_frame():
    from portbench.traffic import closed_http

    a = np.zeros((64, 64, 3), np.uint8)
    b = a.copy()
    b[2, 5, 1] = 1
    assert closed_http._digest(a) != closed_http._digest(b)
    assert closed_http._digest(a) == closed_http._digest(a.copy())
