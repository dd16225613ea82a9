"""Traffic ``sample``: bulk sampling through the program's ``cli.serve``
``serve()`` chunk loop, for the window.

Set-up draws the benchmark's weights, gives the generators running
BatchNorm statistics computed by the reference (``steps.calibrate``: what
training would leave), makes the program's serving copy
(``GANState.generators()``: parameters cast once to bfloat16) and calls
``serve()`` with a sink of the harness's: every chunk's uint8 colour videos
come to host memory through ``InFlight``'s pinned copy, and the sink keeps
the chunks the check samples. ``serve()``'s own warm-up chunk is set-up;
the window opens at its first chunk and closes at the first delivery past
``--seconds``. The harness wraps from outside ``serve``'s ``make_chunk_fn``
(host time to enqueue a chunk) and the name ``fused_norm_act_conv`` that
``models/cgen.py`` calls (a profiler range and the call's bound).

Parameters: ``batchsize``, ``rounds`` (per chunk), ``queue_depth``,
``sampled_chunks``, ``trace_warm_chunks``, ``trace_chunks``; limit:
``video_gap``.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from portbench import judge, weights, yardstick
from portbench.harness import Outcome, Readings
from portbench.reference import models, steps, streams


class StopWindow(Exception):
    """Raised from the sink when the window has closed."""


def _sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


class KeepSink:
    """``serve()``'s sink: counts each delivered chunk, keeps those
    ``keep(idx)`` asks for, and closes the window."""

    kind = "keep"
    wants_color = True
    with_geo = False

    def __init__(self, on_chunk):
        self.on_chunk = on_chunk

    def write(self, idx, xg, xc) -> int:
        self.on_chunk(idx, xc)
        return xc.nbytes

    def close(self) -> None:
        pass


def measure(ctx) -> Outcome:
    import dcvgan_torch.cli.serve as serve_mod
    import dcvgan_torch.models.cgen as cgen_mod
    from dcvgan_torch.train.step import DCVGAN

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    b, rounds = p["batchsize"], p["rounds"]
    w = weights.draw(cfg, ctx.seed, dev)
    running = steps.calibrate(cfg, w, ctx.seed, dev)
    gan = DCVGAN(cfg, device=dev)
    state = gan.init_state(ctx.seed)
    for m in ("ggen", "cgen"):
        weights.load_into(getattr(state, m), w[m], m)
        weights.load_running(getattr(state, m), running[m])
    served = state.generators()
    del state

    pick = np.random.default_rng(ctx.seed)
    sampled = {0} | set(int(i) for i in pick.integers(1, p["sampled_chunks"][1],
                                                      p["sampled_chunks"][0]))
    check_round = {k: int(pick.integers(0, rounds)) for k in sorted(sampled)}
    st = {"calls": 0, "phase": "setup", "host": [], "bound_s": 0.0, "kept": {}, "last": None,
          "delivered": 0}

    make_chunk_fn = serve_mod.make_chunk_fn

    def timed_make_chunk_fn(*args, **kwargs):
        inner = make_chunk_fn(*args, **kwargs)

        @functools.wraps(inner)
        def chunk_fn(*a, **k):
            if st["calls"] == 1:  # the first chunk after serve()'s warm-up
                _sync(dev)
                st["t_window"], st["wall_window"] = time.perf_counter(), time.time()
                if ctx.trace:
                    from portbench.trace import Span

                    st["span"] = Span()
                    st["span"].open()
                    st["phase"] = "trace_warm"
                else:
                    st["phase"], st["t_rest"], st["rest_at"] = "rest", st["t_window"], 0
            st["calls"] += 1
            t = time.perf_counter()
            out = inner(*a, **k)
            st["host"].append((st["phase"], time.perf_counter() - t))
            return out

        return chunk_fn

    fused = cgen_mod.fused_norm_act_conv

    @functools.wraps(fused)
    def ranged_fused(x, scale, shift, w_, slope=0.2, xn_out=None):
        if st["phase"] != "traced":
            return fused(x, scale, shift, w_, slope, xn_out=xn_out)
        with torch.profiler.record_function("portbench.fused_block"):
            out = fused(x, scale, shift, w_, slope, xn_out=xn_out)
        n, c, h, _ = x.shape
        st["bound_s"] += yardstick.fused_site_bound(n, h, c, w_.shape[0], x.dtype,
                                                    xn_out is not None)[0]
        return out

    def on_chunk(idx, xc):
        now = time.perf_counter()
        st["delivered"] += 1
        if idx in sampled:
            st["kept"][idx] = xc[check_round[idx]].copy()
        st["last"] = (idx, xc)
        if st["phase"] == "trace_warm" and idx == p["trace_warm_chunks"] - 1:
            st["span"].measure()
            st["phase"], st["span_at"] = "traced", idx
        elif st["phase"] == "traced" and idx == st["span_at"] + p["trace_chunks"]:
            st["span"].close()
            st["traced_chunks"] = idx - st["span_at"]
            st["phase"], st["t_rest"], st["rest_at"] = "rest", time.perf_counter(), idx + 1
        # a traced run's untraced part lasts --seconds of its own
        if st["phase"] == "rest" and now - st["t_rest"] >= ctx.seconds:
            st["t_end"], st["end_at"] = now, idx + 1
            raise StopWindow

    serve_mod.make_chunk_fn, cgen_mod.fused_norm_act_conv = timed_make_chunk_fn, ranged_fused
    try:
        serve_mod.serve(gan, served, b, rounds, 10 ** 9, KeepSink(on_chunk), seed=ctx.seed,
                        queue_depth=p["queue_depth"])
    except StopWindow:
        pass
    finally:
        serve_mod.make_chunk_fn, cgen_mod.fused_norm_act_conv = make_chunk_fn, fused
    _sync(dev)

    per_chunk = b * rounds
    last_idx, last = st["last"]
    st["kept"].setdefault(last_idx, last[check_round.setdefault(last_idx, rounds - 1)])
    kept = {k: v for k, v in st["kept"].items() if k < st["end_at"]}
    readings = Readings(
        spans={"dispatch": [s for ph, s in st["host"] if ph == "rest"]},
        counters={"rest_videos": (st["end_at"] - st["rest_at"]) * per_chunk,
                  "rest_s": st["t_end"] - st["t_rest"],
                  "flops_per_video": yardstick.sample_flops(cfg, b) / b,
                  "traced_chunks": st.get("traced_chunks", 0), "fused_bound_s": st["bound_s"]},
        trace=st["span"].summarize() if st.get("span") else None)
    holder = {"gan": gan, "served": served}

    def release():
        holder.clear()

    def check():
        key = streams.base_key(ctx.seed, dev)
        gaps = []
        for k, got in sorted(kept.items()):
            gen = streams.fold_in(streams.fold_in(key, k), check_round[k])
            want = steps.sample_round(cfg, w, running, gen, b).cpu().numpy()
            gaps.append(judge.video_gap(got, want))
        return [("video_gap", max(gaps), p["limits"]["video_gap"])]

    return Outcome(end_to_end={"sample_videos_per_s": st["end_at"] * per_chunk / (st["t_end"] - st["t_window"])},
                   t_window=st["wall_window"], attempted=st["end_at"], failed=0,
                   readings=readings, check=check, release=release)
