"""Traffic ``train``: the program's ``Trainer.train()`` on the benchmark's
dataset tree, for the window.

Set-up writes the tree once per checkout, builds the dataset through the
program's ``build_dataset`` (decoded cache, uint8 ingest), decodes every
clip into the cache, builds the ``Trainer`` and hands it the benchmark's
weights. One ``train()`` call then runs the whole run: its first steps are
the warm-up; steps 1-3 feed the output check (the losses each step returned,
the gradients Adam took at step 1, read from its first moments, and the
parameters after step 3); the window starts after ``warm_steps`` steps and
ends at the first step boundary past ``--seconds``, in a device
synchronise. The harness wraps from outside: the epoch iterator (the wait
for each batch, the window's bounds), ``DCVGAN.train_step`` (host time a
call, the losses of steps 1-3) and ``DCVGAN.ingest`` (a profiler range).

Parameters: ``n_clips``, ``warm_steps``, ``trace_warm_steps``,
``trace_steps``; limits: ``loss_gap``, ``grad_gap``, ``change_gap``.
"""

from __future__ import annotations

import functools
import shutil
import statistics
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from portbench import data, judge, weights, yardstick
from portbench.harness import Outcome, Readings
from portbench.reference import models, steps

CHECKED_STEPS = 3


def _slices(times, t0, t1, width):
    """Steps started in each ``width``-second slice of ``[t0, t1)``."""
    n = max(1, int((t1 - t0) // width))
    counts = [0] * n
    for t in times:
        if t0 <= t < t0 + n * width:
            counts[int((t - t0) // width)] += 1
    return counts


class StopWindow(Exception):
    """Raised from the epoch iterator when the window has closed."""


def _sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def measure(ctx) -> Outcome:
    from dcvgan_torch.cli.train import build_dataset
    from dcvgan_torch.train.trainer import Trainer

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    phases = {"imported": time.time() - ctx.t_process}
    tree = data.tree(Path(cfg.dataset.processed_root), p["n_clips"], cfg.image_size)
    shutil.rmtree(Path(cfg.log_dir), ignore_errors=True)
    dataset = build_dataset(cfg)
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda i: dataset.sample(i, rng), range(len(dataset))))
    decode_s = time.perf_counter() - t0

    phases["decoded"] = time.time() - ctx.t_process
    trainer = Trainer(cfg, dataset, evaluator=None, device=dev)
    phases["trainer_built"] = time.time() - ctx.t_process
    w = weights.draw(cfg, ctx.seed, dev)
    for m in models.MODELS:
        weights.load_into(getattr(trainer.state, m), w[m], m)

    gan, loader = trainer.gan, trainer.loader
    st = {"n": 0, "phase": "warm", "span": None, "losses": [], "host": [], "wait": [], "h2d": [], "at": [],
          "bound_s": 0.0, "t_window": None, "t_rest": None, "t_end": None}
    snap = {}

    step_fn = gan.train_step

    @functools.wraps(step_fn)
    def train_step(*args, **kwargs):
        t = time.perf_counter()
        state, metrics = step_fn(*args, **kwargs)
        st["host"].append((st["phase"], time.perf_counter() - t))
        st["at"].append(t)
        if len(st["losses"]) < CHECKED_STEPS:
            st["losses"].append(metrics)
        return state, metrics

    ingest_fn = gan.ingest

    @functools.wraps(ingest_fn)
    def ingest(batch):
        if st["phase"] != "traced":
            return ingest_fn(batch)
        with torch.profiler.record_function("portbench.ingest"):
            out = ingest_fn(batch)
        st["bound_s"] += yardstick.ingest_bound(
            [v for v in batch.values() if isinstance(v, torch.Tensor)], gan.dtype)
        return out

    to_device = trainer.to_device

    @functools.wraps(to_device)
    def timed_to_device(batch):
        t = time.perf_counter()
        out = to_device(batch)
        st["h2d"].append((st["phase"], time.perf_counter() - t))
        return out

    gan.train_step, gan.ingest, trainer.to_device = train_step, ingest, timed_to_device
    epochs = loader.epoch_iterator

    def boundary() -> None:
        """Steps 1..n are enqueued; the next batch is asked for."""
        n, now = st["n"], time.perf_counter
        if n == 1:
            _sync(dev)
            phases["first_step"] = time.time() - ctx.t_process
            snap["grads1"] = {m: {k: (trainer.state.opt[m].state[q]["exp_avg"]
                                      / (1 - getattr(cfg, m).optimizer.b1)).cpu()
                                  for k, q in getattr(trainer.state, m).named_parameters()}
                              for m in models.MODELS}
        if n == CHECKED_STEPS:
            _sync(dev)
            snap["params"] = {m: {k: q.detach().to("cpu", copy=True) for k, q in getattr(trainer.state, m).named_parameters()}
                              for m in models.MODELS}
        if n == p["warm_steps"]:
            _sync(dev)
            st["t_window"], st["wall_window"] = now(), time.time()
            if ctx.trace:
                from portbench.trace import Span

                st["span"] = Span()
                st["span"].open()
                st["phase"], st["span_at"] = "trace_warm", n
            else:
                st["phase"], st["t_rest"], st["rest_at"] = "rest", st["t_window"], n
        elif st["phase"] == "trace_warm" and n == st["span_at"] + p["trace_warm_steps"]:
            st["span"].measure()
            st["phase"], st["span_at"] = "traced", n
        elif st["phase"] == "traced" and n == st["span_at"] + p["trace_steps"]:
            st["span"].close()
            st["traced_steps"] = n - st["span_at"]
            st["phase"], st["t_rest"], st["rest_at"] = "rest", now(), n
        # a traced run's untraced part lasts --seconds of its own
        if st["phase"] == "rest" and now() - st["t_rest"] >= ctx.seconds:
            _sync(dev)
            st["t_end"] = now()
            raise StopWindow

    def epoch_iterator(*args, **kwargs):
        it = epochs(*args, **kwargs)
        while True:
            boundary()
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            st["wait"].append((st["phase"], time.perf_counter() - t))
            st["n"] += 1
            yield batch

    loader.epoch_iterator = epoch_iterator
    phases["train_called"] = time.time() - ctx.t_process
    try:
        trainer.train()
    except StopWindow:
        pass
    else:
        raise RuntimeError("train() ended before the window closed: raise n_epochs")

    b = cfg.batchsize
    window_steps = st["n"] - p["warm_steps"]
    rest_steps = st["n"] - st["rest_at"]
    rest_s = st["t_end"] - st["t_rest"]
    readings = Readings(
        spans={"loader_wait": [s for ph, s in st["wait"] if ph == "rest"],
               "step_host": [s for ph, s in st["host"] if ph == "rest"],
               "to_device": [s for ph, s in st["h2d"] if ph == "rest"]},
        counters={"rest_steps": rest_steps, "rest_s": rest_s,
                  "flops_per_step": yardstick.train_step_flops(cfg, b),
                  "traced_steps": st.get("traced_steps", 0), "ingest_bound_s": st["bound_s"],
                  "tree_write_s": tree["seconds"], "tree_bytes": tree["bytes"],
                  "decode_s": decode_s, "setup_phases_s": phases,
                  "steps_per_5s": _slices(st["at"], st["t_rest"], st["t_end"], 5.0),
                  "to_device_ms": 1e3 * statistics.mean([s for ph, s in st["h2d"] if ph == "rest"] or [0])},
        trace=st["span"].summarize() if st["span"] else None)
    prog_losses = [{k: float(v) for k, v in m.items()} for m in st["losses"]]
    holder = {"trainer": trainer, "dataset": dataset}

    def release():
        holder.clear()

    def check():
        batches = [steps.read_batch(Path(tree["path"]), cfg, ctx.seed, 0, i, dev)
                   for i in range(CHECKED_STEPS)]
        ref = steps.train_steps(cfg, w, batches, ctx.seed, dev)
        numbers = judge.train_gaps(prog_losses, snap["grads1"], snap["params"], ref, w)
        readings.counters["numbers"] = numbers
        readings.counters["detail"] = judge.train_gap_detail(
            prog_losses, snap["grads1"], snap["params"], ref, w)
        return judge.compared(numbers, p["limits"])

    return Outcome(end_to_end={"train_videos_per_s": b * window_steps / (st["t_end"] - st["t_window"])},
                   t_window=st["wall_window"],
                   attempted=window_steps, failed=0, readings=readings, check=check, release=release)
