#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches its own:

1. environment: torch, CUDA, nvcc and the card (name and power limit);
   TF32 is switched off for cuDNN and matmul, so f32 comparisons are f32;
2. build every kernel under ``dcvgan_torch/csrc`` with nvcc;
3. hold each kernel (``fused_norm_act_conv``, ``dequantize_videos``)
   against its plain PyTorch version on the card at the main paths' shapes
   and at edge shapes, and time kernel, plain version, one library call
   where there is one, and the bound; the bf16 ``fused_norm_act_conv`` is
   timed on its TMA route and on the mma.sync kernel of the other route in
   turns, the f32 one on its tf32x3 route (the TMA kernel on
   error-compensated TF32) and on the FMA kernel of the other f32 route in
   turns, beside the bound of three TF32 products on the tensor cores and
   the FFMA floor, each route asserted at the flagship sites and at edge
   shapes (slope 0.2 and 0.01 with shift + 1), a train step's two
   ``dequant`` batches in one launch and launched per tensor in turns;
4. the serving path: ``dcvgan_torch.cli.serve``'s ``serve()`` and
   ``GenerationServer.generate`` at the flagship width
   (``configs/mug-depth.yml``: depth, ngf 64, bf16, batch 256, seeded weights),
   with every launch counter set to 0 just before and read just after;
5. a profile of one sampling round: device time by kernel kind and the
   device's idle share; then the f32 serving path: ``serve()`` at the same
   widths with ``trainer.precision: float32`` (batch 256), the fused f32
   colour generator held to its plain forward at the f32 tolerance, and
   every ``fused_norm_act_conv`` launch counted by route from 0 (5 a cgen
   forward, all tf32x3), with its videos/s;
6. the training path: ``dcvgan_torch.cli.train``'s ``build_dataset`` and
   ``Trainer.train()`` at the same width (batch 20, bf16 compute over f32
   parameters) on the self-generating ``synthetic`` dataset, uint8 batches
   dequantised on the card (colour and depth in one launch a step), 42
   steps, again with the counters set to 0 just before and read just after
   (``fused_norm_act_conv`` held against its plain version first at the
   frame count of ``log_samples``' round, as before each later path at its
   own); then a seeded replay of 3 steps, a uint8 against float batch, a
   checkpoint round trip, a profile of one step, and one epoch with
   ``trainer.profile: true`` whose trace must name ``dequant_kernel``;
7. the lever path: the four repo configs that set a train-step lever
   (``demo-synthetic-{fastpath,quirks,sharedfakes}.yml`` and
   ``headtohead-tpu-seed0-10k-stable-gn.yml``, ``trainer.norm: group``) as
   they stand, each through ``Trainer.train()`` for 12 steps on the
   synthetic dataset, counters from 0 just before and read just after:
   ``dequantize_video`` once a step, ``fused_norm_act_conv`` only in
   ``log_samples`` (5 per cgen forward under BatchNorm, none under
   GroupNorm); finite losses, first critic losses near 2 ln 2, a
   checkpoint round trip, the quirks run's Adam counts; torch's Adam
   keeps ``.grad`` over two steps; the GroupNorm run served through
   ``load_run`` + ``GenerationServer`` (seeded bytes replay, no fused
   launch); ``remat`` on against off (f32, ngf 32) and a
   ``critic_stat_reuse`` bf16 step against the same step on the CPU; then
   the flagship's train it/s and peak memory under six lever settings, each
   in turns with levers off, and remat's peak memory;
8. the raw-dataset path: SURREAL- and IsoGD-style raw trees built from a
   seed at the raw frame size (64 and 104 videos of 20 frames at 320x240),
   ``python -m dcvgan_torch.cli.preprocess`` of each in its own process (the
   written trees checked), the host library (``dcvgan_torch.native``) held
   bit for bit against its numpy forms and timed against them in turns,
   then ``configs/surreal-segm.yml`` (batch 60) and ``configs/isogd-flow.yml``
   (batch 100) at their full widths through ``build_dataset`` +
   ``Trainer.train()`` on the written trees, 8 and 6 steps, counters from 0
   just before and read just after: ``dequantize_video`` once a step,
   ``fused_norm_act_conv`` 5 per cgen forward of ``log_samples`` and never
   in a step; both kernels held at these runs' shapes first;
9. the evaluation path: ``Trainer.evaluate`` on the trained state with
   ``configs/mug-depth.yml``'s evaluation block (IS and FID of 200 samples,
   the v2 extractor npz, the synthetic dataset as the real side), the
   device-resident and host paths held to the same scores;
10. the inference path: ``cli.infer`` on the training run (40 videos, mp4s
   read back), then ``cli.evaluate`` of the colour directory;
11. the HTTP path: ``cli.serve``'s ``GenerationServer`` on the training run
   behind ``serve_http`` in this process: seeded bytes over two chunks and a
   geo npz equal to ``generate``, a 400, a 413 and a 429, ``/stats`` equal to
   what was sent; the latency, delivered videos/s, delivered share, idle
   share of a profiled round and resident memory of 4 clients x 16 unseeded
   n=16 requests at two server shapes (64 x 1 round and 256 x 4 rounds a
   chunk); then ``cli.serve <run> -1 --sink mp4 --with-geo`` (128 + 128
   mp4s read back); counters set to 0 just before and read just after;
12. the data-parallel path (``parallel/``), each run a ``torchrun`` of this
    script's ``--child`` mode, which calls ``cli.train.main`` on every rank
    and prints a ``CHILD {...}`` line of its counters and numbers: (a) world
    1 over NCCL, the flagship for 12 steps with cuDNN held to deterministic
    algorithms, its first 3 steps' losses equal bit for bit to the
    single-process trainer's of the same seed, a rank-0 checkpoint that
    restores equal; (b) two gloo ranks sharing ``cuda:0`` (global batch 20,
    10 rows a rank): f32 with TF32 off for 3 steps against one rank at
    batch 20 with the same global-batch BatchNorm arithmetic, cuDNN
    deterministic on both (losses, the first step's gradients and the
    updates within the stated tolerances; a per-rank-BatchNorm rank is the
    control), per-replica statistics for 6 steps (both ranks' states hash equal), the
    bf16 flagship's it/s over 18 steps (not a scaling number: two processes
    share one card); (c) the f32 run's evaluation over both ranks (25 videos
    a rank a round) against one rank's scores within 1e-4 rel + 1e-5; (d)
    two serving replicas on ``cuda:0`` against one replica, bytes within
    the stated bound. One ``dequantize_video`` launch a step on every rank;
    ``fused_norm_act_conv`` only in rank 0's ``log_samples``, the
    evaluation's rounds and the replicas (5 per cgen forward); both kernels
    held at this path's shapes first (10 rows a rank; 400 and 2,048 frames);
13. the time-sharded path (``parallel/temporal.py``, ``mesh.time > 1``),
    ``torchrun`` of the same ``--child`` mode with every rank on ``cuda:0``
    over gloo: (a) ``mesh: {data: 1, time: 2}`` on 2 ranks, f32 with TF32
    off, deterministic cuDNN, global batch 20, 3 steps, against phase 12's
    one rank with the same global-batch BatchNorm arithmetic and unsharded
    critics at phase 12's limits; (b) the bf16 flagship at ``mesh: {data:
    2, time: 2}`` on 4 ranks for 18 steps: finite losses, first critic
    losses near 2 ln 2, states equal, a checkpoint that restores, the it/s
    (not a scaling number: four processes share one card) and peak memory
    by rank; in both, one ``dequantize_video`` launch a step on every rank,
    ``fused_norm_act_conv`` only in rank 0's ``log_samples``, and the halo
    exchanges counted against the number the critics imply (52 a step);
    (c) ``time 8`` of 16 frames raises the halo error before any step; both
    kernels held at this path's shapes first (20 and 10 rows a data row,
    400 frames);
14. the head-to-head path (``dcvgan_torch.tools.headtohead``, the
    repository's quality protocol, ``HEADTOHEAD.md``): both kernels held at
    this path's shapes first (batch 8; ngf 32's cgen sites at 512 and 400
    frames); the tool's scorer over the JAX package's committed sample sets
    (``results/headtohead/tpurun_samples{,_seed3}``) against a regenerated
    real set, each FID and IS within 1% of the JAX scorer's record
    (``tpu_scores{,_seed3}.json``); then ``headtohead.main`` on
    ``configs/headtohead-tpu.yml`` as it stands (1,600 bf16 steps at batch
    8, ngf 32, an evaluation of 128 videos every 200 steps, 8 snapshots of
    128 mp4 files, IS, FID and PRD), counters from 0 just before and read
    just after: ``dequantize_video`` once a step, ``fused_norm_act_conv`` 5
    per sampling round and none inside a step; finite losses, first critic
    losses within 0.2 of 2 ln 2, finite scores, PRD in [0, 1] and the best
    FID of the 8 points at most 1,000; train it/s, each stage's seconds and
    peak memory;
15. a ``{"kernels": [...]}`` line, the card's line, and last
    ``{"ok": true, "device": {...}}``.

Every phase prints its numbers as it goes. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import http.client
import importlib.metadata
import importlib.util
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12  # TF32 on the tensor cores: the tf32x3 route's three products
PEAK_BYTES_PER_S = 3.35e12

N_FRAMES = 4096  # batch 256 x 16 frames: the flagship serve call
FLAGSHIP = "mug-depth"  # configs/mug-depth.yml: ngf 64, 64 px
# out: |kernel - plain| <= atol + rtol * |plain|. bf16: both sum the same
# exact bf16 products in f32, in another order, so the outputs may round to
# neighbouring bf16 values (one ulp <= 2^-7 relative). f32: summation order
# over K = 16*C <= 4096 terms. xn_out: the same f32 arithmetic and rounding,
# so exact.
OUT_TOL = {torch.bfloat16: (1e-4, 2.0**-7), torch.float32: (1e-4, 1e-4)}
# whole colour generator, fused path against a layer-by-layer plain forward
# in bf16 on redrawn O(1) weights: BatchNorm + LeakyReLU round once (fused,
# f32 prologue) or twice (plain), a few bf16 ulps carried through the U-Net
# to outputs in [-1, 1]. The same comparison on the CPU (plain kernel
# version) gives max 1.7e-2 and mean 9e-4; held at max 4e-2, mean 4e-3.
CGEN_TOL, CGEN_MEAN_TOL = 4e-2, 4e-3


def sh(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def card_line() -> str:
    return sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])


def cuda_ms(fn, runs: int = 5, window_ms: float = 20.0) -> float:
    """Median over ``runs`` of the mean device time of back-to-back calls,
    as many as fill about ``window_ms`` (inputs stay warm in L2 where they fit)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(1, min(1000, int(window_ms / max(start.elapsed_time(end), 1e-3))))
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def site_bound(n: int, h: int, c: int, cout: int, dtype: torch.dtype, xn: bool, tf32x3: bool = False):
    """(bound_ms, bound_by, flops, bytes) of one call: each input read once,
    each output written once; operations over the taps that touch the image
    (padding taps multiply zeros), at the card's peak for the dtype: bf16
    on the tensor cores, f32 on the CUDA cores (FFMA), or with ``tf32x3``
    the f32 route's three TF32 products for each f32 one on the tensor
    cores."""
    es = torch.finfo(dtype).bits // 8
    oh = h // 2
    taps = (4 * oh - 2) ** 2  # non-padding taps summed over the output pixels
    flops = 2 * n * cout * c * taps
    nbytes = (n * h * h * c * (2 if xn else 1) + 16 * c * cout + n * oh * oh * cout) * es + 8 * c
    t_ops = (3 * flops / PEAK_TF32 if tf32x3 else flops / PEAK_FLOPS[dtype]) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


# (label, N, H, W, C, Cout, route): shapes at the TMA route's edges, and one
# it cannot take; the route each must take
EDGE_CASES = [
    ("partial last tile, odd tile count", 3, 16, 16, 128, 256, "tma"),
    ("down5's 2x2 input, 3 tiles", 300, 2, 2, 256, 256, "tma"),
    ("OW < 8, W != H", 5, 4, 12, 64, 64, "tma"),
    ("C = 8, one zero-filled half chunk", 7, 6, 6, 8, 16, "tma"),
    ("OH*OW = 15, tiles across images", 40, 6, 10, 64, 64, "tma"),
    ("C = 12: the mma.sync route", 3, 8, 8, 12, 8, "mma_sync"),
]
# the same for f32: the TMA kernel's tf32x3 route (32 channels a stage) and
# the FMA kernel of the shapes it cannot take
F32_EDGE_CASES = [
    ("partial last tile, odd tile count", 3, 16, 16, 128, 256, "tf32x3"),
    ("down5's 2x2 input, 3 tiles", 300, 2, 2, 256, 256, "tf32x3"),
    ("OW < 8, W != H", 5, 4, 12, 64, 64, "tf32x3"),
    ("C = 8 (debug-mock-depth's ngf), a quarter chunk", 7, 6, 6, 8, 16, "tf32x3"),
    ("OH*OW = 15, tiles across images", 40, 6, 10, 64, 64, "tf32x3"),
    ("Cout = 8: the FMA route", 3, 8, 8, 12, 8, "f32"),
]
EDGE_CASES_BY_DTYPE = {torch.bfloat16: EDGE_CASES, torch.float32: F32_EDGE_CASES}


def kernel_inputs(n, h, c, cout, dtype, seed, shift_offset=0.0, w=None):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    cl = torch.channels_last
    x = torch.randn(n, c, h, w or h, generator=g, device="cuda").to(dtype).contiguous(memory_format=cl)
    w = (torch.randn(cout, c, 4, 4, generator=g, device="cuda") / (16 * c) ** 0.5)
    w = w.to(dtype).contiguous(memory_format=cl)
    scale = torch.rand(c, generator=g, device="cuda") + 0.5
    shift = torch.randn(c, generator=g, device="cuda") * 0.2 + shift_offset
    return x, scale, shift, w


def check_kernel(fused, plain, n, h, c, cout, dtype, xn, slope=0.2, shift_offset=0.0, width=None):
    """Kernel against plain version on the same inputs; returns max |diff|."""
    x, scale, shift, w = kernel_inputs(n, h, c, cout, dtype, seed=h * 7 + c, shift_offset=shift_offset,
                                       w=width)
    xn_k = torch.empty_like(x) if xn else None
    xn_p = torch.empty_like(x) if xn else None
    got = fused(x, scale, shift, w, slope, xn_out=xn_k)
    want = plain(x, scale, shift, w, slope, xn_out=xn_p)
    torch.cuda.synchronize()
    if got.shape != want.shape or not got.is_contiguous(memory_format=torch.channels_last):
        raise AssertionError(f"kernel output has shape {tuple(got.shape)} / layout off")
    atol, rtol = OUT_TOL[dtype]
    d = (got.float() - want.float()).abs()
    bad = d > atol + rtol * want.float().abs()
    if bad.any():
        raise AssertionError(
            f"fused_norm_act_conv {dtype} h={h} c={c}: {int(bad.sum())} outputs off, "
            f"max |diff| {d.max().item():.3e}"
        )
    err = d.max().item()
    if xn:
        dxn = (xn_k.float() - xn_p.float()).abs().max().item()
        if dxn != 0:
            raise AssertionError(f"xn_out differs from the plain activation by {dxn:.3e}")
    return err


def cgen_sites(cfg) -> list:
    """The fused kernel's sites in one eval-mode cgen forward of ``cfg``:
    (name, H = W of x, C, Cout) of down1..down5, from its ngf and image size
    (at ngf 64, 64 px: 32 px 64 -> 128, 16 px 128 -> 256, then 256 -> 256)."""
    from dcvgan_torch.models.cgen import ColorVideoGenerator

    widths = [cfg.cgen.ngf * m for m in ColorVideoGenerator._down_mults(cfg.image_size)]
    return [(f"down{i}", cfg.image_size >> i, widths[i - 1], widths[i]) for i in range(1, len(widths))]


def flagship_sites() -> list:
    from dcvgan_torch.config import load_config

    return cgen_sites(load_config(ROOT / "configs" / f"{FLAGSHIP}.yml"))


def check_sites(n: int, path: str, sites: list) -> float:
    """The kernel against its plain version at ``sites`` (the widths of the
    path's cgen, :func:`cgen_sites`) and ``n`` frames, the frame count one
    sampling round of ``path`` gives it (its route, tile table and
    persistent schedule depend on C, Cout and ``n``), in bf16 and f32, with
    and without ``xn_out``; returns the largest max |diff|. Called outside
    the paths' counted runs."""
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv, reference_norm_act_conv

    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, h, c, cout in sites:
            for xn in (True, False):
                e = check_kernel(fused_norm_act_conv, reference_norm_act_conv, n, h, c, cout, dtype, xn)
                errs.append(e)
                print(f"check {path} N={n} {name} C={c} Cout={cout} {str(dtype)[6:]} xn_out={xn}: "
                      f"max|diff| {e:.3e} "
                      f"(tol {OUT_TOL[dtype][0]:g} + {OUT_TOL[dtype][1]:g}*|plain|)", flush=True)
    torch.cuda.empty_cache()
    return max(errs)


def phase_kernels() -> dict:
    import torch.nn.functional as F

    from dcvgan_torch.ops.fused_block import (
        Plan, fused_norm_act_conv, launch, plan_for, reference_norm_act_conv)

    sites_64 = flagship_sites()
    errs = [check_sites(N_FRAMES, "serve", sites_64)]
    for dtype in (torch.bfloat16, torch.float32):
        # LeakyReLU slope 0.01 with a shift large enough that the activation
        # branches differently and padding != leaky_relu(shift) would show
        e = check_kernel(fused_norm_act_conv, reference_norm_act_conv, N_FRAMES, 16, 128, 256,
                         dtype, True, slope=0.01, shift_offset=1.0)
        errs.append(e)
        print(f"check slope 0.01 shift+1 {str(dtype)[6:]}: max|diff| {e:.3e}", flush=True)
    for dtype, cases in EDGE_CASES_BY_DTYPE.items():
        for label, n, h, w, c, cout, want_route in cases:
            x, _, _, wt = kernel_inputs(n, h, c, cout, dtype, seed=0, w=w)
            route = plan_for(x, wt, torch.empty(n, cout, h // 2, w // 2, dtype=x.dtype, device="cuda",
                                                memory_format=torch.channels_last)).route
            if route != want_route:
                raise AssertionError(f"edge case {label!r} takes the {route} route, not {want_route}")
            for slope, shift_offset in ((0.2, 0.5), (0.01, 1.0)):
                e = check_kernel(fused_norm_act_conv, reference_norm_act_conv, n, h, c, cout, dtype,
                                 True, slope=slope, shift_offset=shift_offset, width=w)
                errs.append(e)
                print(f"check edge {str(dtype)[6:]} {label} (N={n} {h}x{w} C={c} Cout={cout}, route "
                      f"{route}, slope {slope}): max|diff| {e:.3e}", flush=True)

    sites = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, h, c, cout in sites_64:
            x, scale, shift, w = kernel_inputs(N_FRAMES, h, c, cout, dtype, seed=1)
            xn = torch.empty_like(x)
            reference_norm_act_conv(x, scale, shift, w, 0.2, xn_out=xn)  # for the library call
            bound, bound_by, flops, nbytes = site_bound(N_FRAMES, h, c, cout, dtype, True)
            row = {"site": name, "dtype": str(dtype)[6:], "x": [N_FRAMES, h, h, c], "cout": cout}
            if dtype == torch.bfloat16:
                # the TMA route against the mma.sync kernel, in turns: old, new, new, old
                out = torch.empty(N_FRAMES, cout, h // 2, h // 2, dtype=dtype, device="cuda",
                                  memory_format=torch.channels_last)
                plan = plan_for(x, w, out, xn)
                if plan.route != "tma":
                    raise AssertionError(f"{name} does not take the TMA route: {plan}")
                old, new = Plan("mma_sync"), plan
                turns = [cuda_ms(lambda p=p: launch(p, x, scale, shift, w, out, 0.2, xn))
                         for p in (old, new, new, old)]
                row.update(kernel_ms=(turns[1] + turns[2]) / 2, old_ms=(turns[0] + turns[3]) / 2,
                           turns_ms=turns, plan={k: v for k, v in vars(plan).items() if k != "route"})
            else:
                # the tf32x3 route against the FMA kernel, in turns: old, new, new, old
                out = torch.empty(N_FRAMES, cout, h // 2, h // 2, dtype=dtype, device="cuda",
                                  memory_format=torch.channels_last)
                plan = plan_for(x, w, out, xn)
                if plan.route != "tf32x3":
                    raise AssertionError(f"{name} does not take the tf32x3 route in f32: {plan}")
                old, new = Plan("f32"), plan
                turns = [cuda_ms(lambda p=p: launch(p, x, scale, shift, w, out, 0.2, xn))
                         for p in (old, new, new, old)]
                row.update(kernel_ms=(turns[1] + turns[2]) / 2, old_ms=(turns[0] + turns[3]) / 2,
                           turns_ms=turns, plan={k: v for k, v in vars(plan).items() if k != "route"})
                # the FMA kernel's floor (the CUDA cores' FFMA peak) beside the route's own
                row["ffma_bound_ms"] = bound
                bound, bound_by, _, _ = site_bound(N_FRAMES, h, c, cout, dtype, True, tf32x3=True)
            row.update(
                plain_ms=cuda_ms(lambda: reference_norm_act_conv(x, scale, shift, w, 0.2, xn_out=xn)),
                library_ms=cuda_ms(lambda: F.conv2d(xn, w, stride=2, padding=1)),
                bound_ms=bound, bound_by=bound_by, gflop=flops / 1e9, gbytes=nbytes / 1e9,
            )
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
            row["kernel_over_library"] = row["kernel_ms"] / row["library_ms"]
            sites.append(row)
            print("time " + json.dumps(row), flush=True)
            del x, xn
    torch.cuda.empty_cache()
    main_path = [r for r in sites if r["dtype"] == "bfloat16"]
    f32_path = [r for r in sites if r["dtype"] == "float32"]
    by_kind = {"bytes": 0.0, "operations": 0.0}
    for r in main_path:
        by_kind[r["bound_by"]] += r["bound_ms"]
    f32_by_kind = {"bytes": 0.0, "operations": 0.0}
    for r in f32_path:
        f32_by_kind[r["bound_by"]] += r["bound_ms"]
    entry = {
        "name": "fused_norm_act_conv",
        "route": "cuda",
        "source": "dcvgan_torch/csrc/fused_block.cu",
        "replaces": "dcvgan_tpu/ops/fused_block.py:51",
        "launches": None,
        "max_abs_err": max(errs),
        # one colour-generator forward's five bf16 launches at the flagship
        "ms": sum(r["kernel_ms"] for r in main_path),
        "plain_ms": sum(r["plain_ms"] for r in main_path),
        "bound_ms": sum(r["bound_ms"] for r in main_path),
        "bound_by": max(by_kind, key=by_kind.get),
        "library_ms": sum(r["library_ms"] for r in main_path),
        # the mma.sync kernel (the route of shapes TMA cannot take) at the same sites
        "old_ms": sum(r["old_ms"] for r in main_path),
        # the f32 forward's five launches (trainer.precision: float32) on the
        # tf32x3 route, the FMA kernel of the shapes it cannot take, the plain
        # version and cuDNN's f32 conv with TF32 off at the same sites; the
        # bound at the tensor cores' TF32 rate for three products, and at the
        # CUDA cores' FFMA rate for one
        "f32_ms": sum(r["kernel_ms"] for r in f32_path),
        "f32_old_ms": sum(r["old_ms"] for r in f32_path),
        "f32_plain_ms": sum(r["plain_ms"] for r in f32_path),
        "f32_library_ms": sum(r["library_ms"] for r in f32_path),
        "f32_bound_ms": sum(r["bound_ms"] for r in f32_path),
        "f32_bound_by": max(f32_by_kind, key=f32_by_kind.get),
        "f32_ffma_bound_ms": sum(r["ffma_bound_ms"] for r in f32_path),
    }
    print(f"fused_norm_act_conv bf16, five sites: TMA route {entry['ms']:.4f} ms, mma.sync kernel "
          f"{entry['old_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms, cuDNN {entry['library_ms']:.4f} ms",
          flush=True)
    print(f"fused_norm_act_conv f32, five sites: tf32x3 route {entry['f32_ms']:.4f} ms, FMA kernel "
          f"{entry['f32_old_ms']:.4f} ms, plain {entry['f32_plain_ms']:.4f} ms, cuDNN f32 (TF32 off) "
          f"{entry['f32_library_ms']:.4f} ms, bound {entry['f32_bound_ms']:.4f} ms (three TF32 products), "
          f"FFMA bound {entry['f32_ffma_bound_ms']:.4f} ms", flush=True)
    return entry


def redrawn(module, seed: int):
    """A copy of ``module`` with weights and BatchNorm statistics drawn at a
    scale that keeps activations O(1) (the reference init shrinks them layer
    by layer, which would make a comparison of outputs say little)."""
    m = copy.deepcopy(module)
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, t in list(m.named_parameters()) + list(m.named_buffers()):
            if not t.is_floating_point():
                continue
            r = torch.empty(t.shape, device="cuda")
            if t.dim() == 4:  # conv / conv-transpose weight
                r.normal_(0.0, t[0].numel() ** -0.5, generator=g)
            elif name.endswith("running_var"):
                r.uniform_(0.5, 2.0, generator=g)
            elif name.endswith("running_mean"):
                r.normal_(0.0, 0.5, generator=g)
            elif name.endswith("weight"):
                r.uniform_(0.5, 1.5, generator=g)
            else:
                r.normal_(0.0, 0.1, generator=g)
            t.copy_(r)
    return m


def plain_cgen(cgen, x, z):
    """The colour generator layer by layer, as the reference torch module
    runs it: no fused op."""
    with torch.inference_mode():
        hs = [cgen.inconv.main(x)]
        for blk in cgen.down_blocks:
            hs.append(blk.main(hs[-1]))
        n = len(cgen.down_blocks)
        h = torch.cat([hs[-1], z.to(x.dtype).reshape(z.shape[0], -1, 1, 1)], 1)
        for i, blk in enumerate(cgen.up_blocks):
            if i > 0:
                h = torch.cat([h, hs[n - i]], 1)
            h = blk.main(h)
        return cgen.outconv.main(torch.cat([h, hs[0]], 1))


def phase_slice(card: str) -> int:
    from dcvgan_torch import prng
    from dcvgan_torch.cli.serve import GenerationServer, Sink, serve
    from dcvgan_torch.config import load_config
    from dcvgan_torch.ops.dequant import dequantize_video
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv
    from dcvgan_torch.train.state import GeneratorState
    from dcvgan_torch.train.step import DCVGAN

    cfg = load_config(ROOT / "configs" / "mug-depth.yml")
    gan = DCVGAN(cfg)
    if gan.dtype != torch.bfloat16 or cfg.cgen.ngf != 64:
        raise AssertionError("configs/mug-depth.yml is no longer the bf16, ngf 64 flagship")
    # seeded weights at a scale that keeps activations O(1), so that outputs,
    # checksums and replays vary with the seed
    # the serving copy of a fresh state: parameters cast to bf16 once
    init = gan.init_state(cfg.seed).generators()
    if next(init.cgen.parameters()).dtype != torch.bfloat16:
        raise AssertionError("the serving copy does not hold bf16 parameters")
    state = GeneratorState(ggen=redrawn(init.ggen, seed=1), cgen=redrawn(init.cgen, seed=2))

    # the fused colour generator against its plain layer-by-layer forward on
    # geometry-like inputs in [-1, 1]
    cgen = state.cgen
    g = torch.Generator(device="cuda").manual_seed(4)
    frames = torch.rand(32, 64, 64, 1, generator=g, device="cuda").mul(2).sub(1)
    frames = frames.to(gan.dtype).permute(0, 3, 1, 2)
    z = torch.randn(32, cfg.cgen.dim_z_color, generator=g, device="cuda")
    with torch.inference_mode():
        got = cgen(frames, z)
    want = plain_cgen(cgen, frames, z)
    if not (got.float().abs().max().item() > 0.1 and torch.isfinite(got.float()).all()):
        raise AssertionError("the redrawn colour generator's outputs are degenerate")
    diff = (got.float() - want.float()).abs()
    cgen_err, cgen_mean = diff.max().item(), diff.mean().item()
    print(f"cgen fused vs plain (bf16, 32 frames, redrawn weights): max|diff| {cgen_err:.3e} "
          f"(tol {CGEN_TOL}), mean {cgen_mean:.3e} (tol {CGEN_MEAN_TOL})", flush=True)
    if not (cgen_err <= CGEN_TOL and cgen_mean <= CGEN_MEAN_TOL):
        raise AssertionError("the fused colour generator disagrees with its plain forward")

    batch, iters, chunks = 256, 4, 8
    torch.cuda.reset_peak_memory_stats()
    fused_norm_act_conv.launches = 0
    dequantize_video.launches = 0
    # -- main path: counts from 0 ------------------------------------------
    t0 = time.perf_counter()
    xg, xc = gan.sample_videos(state, prng.base_key(11, "cuda"), batch)
    stats = serve(gan, state, batch, iters, chunks, Sink("null", None, "depth", False), seed=0)
    server = GenerationServer(gan, state, batchsize=batch, iters_per_chunk=1, geo_name="depth")
    geo_a, col_a = server.generate(2 * batch, seed=7, with_geo=True)
    geo_b, col_b = server.generate(2 * batch, seed=7, with_geo=True)
    _, col_c = server.generate(2 * batch, seed=8)
    server.close()
    torch.cuda.synchronize()
    launches = fused_norm_act_conv.launches
    # -- end of main path ----------------------------------------------------
    slice_s = time.perf_counter() - t0
    # cgen forwards: 1 sample, serve warm-up + chunks, server warm-up + 3 requests of 2
    forwards = 1 + iters * (chunks + 1) + 1 + 3 * 2
    print(f"fused_norm_act_conv launches {launches} for {forwards} cgen forwards", flush=True)
    if launches != 5 * forwards:
        raise AssertionError(f"expected {5 * forwards} launches, counted {launches}")
    if dequantize_video.launches != 0:
        raise AssertionError("the serving path launched dequantize_video")
    for name, v in (("geometry", xg), ("colour", xc)):
        vf = v.float()
        if not torch.isfinite(vf).all() or vf.abs().max().item() > 1.0:
            raise AssertionError(f"{name} videos are not finite values in [-1, 1]")
    if xg.shape != (batch, 16, 64, 64, 1) or xc.shape != (batch, 16, 64, 64, 3):
        raise AssertionError(f"unexpected video shapes {tuple(xg.shape)} {tuple(xc.shape)}")
    if col_a.shape != (2 * batch, 16, 64, 64, 3) or geo_a.shape != (2 * batch, 16, 64, 64, 1):
        raise AssertionError("GenerationServer returned the wrong shapes")
    if not (np_equal(col_a, col_b) and np_equal(geo_a, geo_b)):
        raise AssertionError("an explicit seed did not replay the same bytes")
    if np_equal(col_a, col_c) or len(np.unique(col_a[:4])) < 64:
        raise AssertionError("the served bytes do not depend on the seed, or are near constant")
    print(f"main path: {slice_s:.2f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    print(f"serve: {stats['value']} videos/s at batch {batch} on {card} "
          f"(checksum {stats['checksum']})", flush=True)
    print("serve " + json.dumps(stats), flush=True)
    phase_profile(gan, state, batch)
    return launches


F32_SERVE_BATCH, F32_SERVE_ITERS, F32_SERVE_CHUNKS = 256, 2, 4


def phase_serve_f32(card: str) -> dict:
    """The f32 serving path: ``serve()`` at the flagship's widths with
    ``trainer.precision: float32`` (batch 256, seeded weights), every cgen
    forward's five ``fused_norm_act_conv`` launches on the tf32x3 route,
    counted by route from 0 just before and read just after; the fused
    colour generator held to its plain f32 forward first."""
    from dcvgan_torch.cli.serve import Sink, serve
    from dcvgan_torch.config import load_config
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv
    from dcvgan_torch.train.state import GeneratorState
    from dcvgan_torch.train.step import DCVGAN

    cfg = load_config(ROOT / "configs" / f"{FLAGSHIP}.yml")
    cfg.trainer.precision = "float32"
    gan = DCVGAN(cfg)
    if gan.dtype != torch.float32 or cfg.cgen.ngf != 64:
        raise AssertionError("the f32 serving run is not f32 at ngf 64")
    init = gan.init_state(cfg.seed).generators()
    state = GeneratorState(ggen=redrawn(init.ggen, seed=1), cgen=redrawn(init.cgen, seed=2))

    g = torch.Generator(device="cuda").manual_seed(4)
    frames = torch.rand(32, 64, 64, 1, generator=g, device="cuda").mul(2).sub(1).permute(0, 3, 1, 2)
    z = torch.randn(32, cfg.cgen.dim_z_color, generator=g, device="cuda")
    with torch.inference_mode():
        got = state.cgen(frames, z)
    want = plain_cgen(state.cgen, frames, z)
    atol, rtol = OUT_TOL[torch.float32]
    diff = (got - want).abs()
    worst = (diff / (atol + rtol * want.abs())).max().item()
    print(f"cgen fused vs plain (f32, TF32 off, 32 frames, redrawn weights): max|diff| "
          f"{diff.max().item():.3e}, mean {diff.mean().item():.3e}, worst |diff| / (tol {atol:g} + "
          f"{rtol:g}*|plain|) {worst:.3f}", flush=True)
    if not (worst <= 1.0 and got.abs().max().item() > 0.1 and torch.isfinite(got).all()):
        raise AssertionError("the fused f32 colour generator disagrees with its plain forward")

    batch, iters, chunks = F32_SERVE_BATCH, F32_SERVE_ITERS, F32_SERVE_CHUNKS
    fused_norm_act_conv.launches = 0
    fused_norm_act_conv.routes.clear()
    # -- main path: counts from 0 ------------------------------------------
    stats = serve(gan, state, batch, iters, chunks, Sink("null", None, "depth", False), seed=0)
    torch.cuda.synchronize()
    launches, routes = fused_norm_act_conv.launches, dict(fused_norm_act_conv.routes)
    # -- end of main path ----------------------------------------------------
    forwards = iters * (chunks + 1)  # warm-up + chunks
    print(f"f32 serve: fused_norm_act_conv launches {launches} for {forwards} cgen forwards, by route "
          f"{json.dumps(routes)}", flush=True)
    if launches != 5 * forwards or routes != {"tf32x3": launches}:
        raise AssertionError(f"expected {5 * forwards} launches, all on the tf32x3 route")
    print(f"f32 serve: {stats['value']} videos/s at batch {batch} on {card} (a first measurement, "
          f"not a limit; checksum {stats['checksum']})", flush=True)
    print("f32 serve " + json.dumps(stats), flush=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "routes": routes, "videos_per_s": stats["value"], "cgen_err": worst}


# kernel-name fragments -> category, for the profile of one sampling round
KERNEL_KINDS = [
    ("fused_norm_act_conv", ("fused_tma_kernel", "fused_bf16_kernel", "fused_f32_kernel")),
    ("dequantize_video", ("dequant_kernel",)),
    ("adam (foreach)", ("multi_tensor", "foreach", "Foreach")),
    ("conv / conv-transpose (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad", "fprop")),
    ("matmul (GRU)", ("gemm", "gemv")),
    ("batch norm", ("batch_norm", "bn_fw", "batchnorm")),
    ("group norm", ("GroupNorm", "group_norm", "RowwiseMoments", "ComputeFusedParams",
                    "Compute1dBackward", "ComputeInternalGradients", "ComputeBackwardFusedParams",
                    "GammaBeta")),
    ("concat / copy", ("cat", "copy", "Copy")),
]


def phase_profile(gan, state, batch: int) -> None:
    """Device time by kernel kind over one sampling round + quantize at
    ``batch``, and the device's idle share of the round's wall time."""
    from dcvgan_torch import prng
    from dcvgan_torch.cli.serve import quantize
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv

    def round_():
        xg, xc = gan.sample_videos(state, prng.base_key(5, "cuda"), batch)
        return quantize(xg), quantize(xc)

    profile_once(round_, "profile", {"batch": batch}, {"fused_norm_act_conv": fused_norm_act_conv})


def traced(body, counted: dict):
    """Run ``body`` twice under ``torch.profiler``: a warm-up pass, traced
    and discarded, then the measured pass. The profiler loses kernels
    launched just after its trace or its measured window starts, so the
    measured window opens with a marker kernel (a short spin, left out of
    every sum), a synchronise and a pause. Returns (profiler, wall ms of the
    measured pass, each counted wrapper's launches in it)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        body()
        torch.cuda.synchronize()
        prof.step()
        torch.cuda._sleep(1000)  # the marker: spin_kernel
        torch.cuda.synchronize()
        time.sleep(0.005)
        before = {k: fn.launches for k, fn in counted.items()}
        t0 = time.perf_counter()
        body()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launched = {k: fn.launches - before[k] for k, fn in counted.items()}
        prof.step()
    return prof, wall_ms, launched


def device_kernels(prof) -> list:
    """The profile's kernels. A user annotation (torch's own around an
    optimizer's step) carries the time of the kernels under it and would
    count them twice; the marker is left out."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not e.is_user_annotation and not e.key.startswith("Optimizer.")
            and "spin_kernel" not in e.key]


def profile_once(round_, label: str, report: dict, counted: dict) -> dict:
    """Profile one ``round_`` (see :func:`traced`); print ``label`` and a
    JSON report of device time by kernel kind, and return it (empty when
    the profiler recorded no device time). ``counted`` maps kinds to
    wrappers with a ``launches`` count: the profile must show each wrapper's
    launches in the measured pass, no fewer and no more."""
    prof, wall_ms, launched = traced(round_, counted)
    kernels = device_kernels(prof)
    kinds = {name: 0.0 for name, _ in KERNEL_KINDS}
    kinds["elementwise and other"] = 0.0
    calls = dict.fromkeys(kinds, 0)
    for e in kernels:
        kind = next((name for name, frags in KERNEL_KINDS if any(f in e.key for f in frags)),
                    "elementwise and other")
        kinds[kind] += e.self_device_time_total / 1e3
        calls[kind] += e.count
    lost = {k: n - calls[k] for k, n in launched.items() if calls[k] != n}
    if kernels and lost:
        raise AssertionError(f"{label}: the profile's launches disagree with the wrappers' counts "
                             f"(counted minus shown: {lost})")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    # each kernel counts once, under the innermost op that launched it
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.key.startswith("aten::") and e.self_device_time_total > 0]
    top_ops = sorted(ops, key=lambda e: -e.self_device_time_total)[:12]
    prof_report = {
        **report,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
        "by_kind_ms": kinds,
        "by_kind_launches": calls,
        "top_kernels": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3, "calls": e.count}
                        for e in top],
        "top_ops": [{"op": e.key, "shapes": str(e.input_shapes)[:120],
                     "ms": e.self_device_time_total / 1e3, "calls": e.count} for e in top_ops],
    }
    if not busy_ms:
        print(f"{label}: the profiler recorded no device time (not measured)", flush=True)
        return {}
    print(f"{label} " + json.dumps(prof_report), flush=True)
    return prof_report


# the two uint8 batches of one train step at the flagship: (B, T, H, W, C)
DEQUANT_SHAPES = [("colour", (20, 16, 64, 64, 3)), ("depth", (20, 16, 64, 64, 1))]
PEAK_F32_OPS = 67e12


def dequant_bound_ms(dtype: torch.dtype = torch.bfloat16) -> float:
    """One train step's two batches: each input read once, each output written once."""
    es = torch.finfo(dtype).bits // 8
    n = sum(math.prod(shape) for _, shape in DEQUANT_SHAPES)
    return max(n * (1 + es) / PEAK_BYTES_PER_S, 2 * n / PEAK_F32_OPS) * 1e3


DEQUANT_BOUND_MS = dequant_bound_ms()


def profiled_device_us(fn, counted: dict, reps: int = 50):
    """(device us per call, launches per call) of ``counted``'s one kernel
    kind (``{kind: wrapper}``, the kind a name fragment) over ``reps``
    back-to-back calls of ``fn`` (see :func:`traced`); fails when the
    profile shows another number of launches than the wrapper counted."""
    (kind, _), = counted.items()

    def body():
        for _ in range(reps):
            fn()

    prof, _, launched = traced(body, counted)
    found = [e for e in device_kernels(prof) if kind in e.key]
    shown = sum(e.count for e in found)
    if shown != launched[kind]:
        raise AssertionError(f"{kind}: the profile shows {shown} of {launched[kind]} launches")
    return sum(e.self_device_time_total for e in found) / reps, shown / reps


def host_us(fn, reps: int = 500) -> float:
    """Host microseconds per call of ``fn`` when calls are enqueued back to
    back (the wrapper's cost; the device keeps up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def phase_dequant() -> dict:
    """``dequantize_videos`` against its plain version per tensor, bit for
    bit, and its times: a train step's two batches in one launch against the
    same kernel launched once per tensor, in turns. No single PyTorch call
    computes the function, so there is no library time."""
    from dcvgan_torch.ops.dequant import dequantize_video, dequantize_videos, reference_dequantize

    g = torch.Generator(device="cuda").manual_seed(3)

    def draw(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=g)

    step = [draw(shape) for _, shape in DEQUANT_SHAPES]
    all256 = torch.arange(256, dtype=torch.uint8, device="cuda")
    # segment lists: the step's pair, views that start off alignment (read
    # with scalar loads) beside aligned tensors, empty segments, all 256 values
    cases = [
        ("colour + depth", step),
        ("one tensor", [step[0]]),
        ("0 elements", [draw((0,))]),
        ("1 element", [draw((1,))]),
        ("odd count, 0 elements, odd count", [draw((3, 1001)), draw((0,)), draw((17, 3))]),
        ("all 256 values, views at +1 and +8, depth", [all256, draw((4099,))[1:], draw((5000,))[8:], step[1]]),
        ("view at +3, 0 elements, 7 elements", [draw((64,))[3:], draw((0,)), draw((7,))]),
    ]
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, xs in cases:
            before = dequantize_video.launches
            got = dequantize_videos(xs, dtype)
            torch.cuda.synchronize()
            if dequantize_video.launches - before != (1 if any(x.numel() for x in xs) else 0):
                raise AssertionError(f"dequantize_videos {name}: not one launch")
            for x, y in zip(xs, got):
                want = reference_dequantize(x, dtype)
                if y.shape != x.shape or y.dtype != dtype or not torch.equal(y, want):
                    raise AssertionError(f"dequantize_videos {str(dtype)[6:]} {name}: differs from the plain "
                                         f"version at shape {tuple(x.shape)}")
                if x.numel():
                    worst = max(worst, (y.float() - want.float()).abs().max().item())
        lo, hi = dequantize_video(torch.tensor([0, 255], dtype=torch.uint8, device="cuda"), dtype).tolist()
        if (lo, hi) != (-1.0, 1.0):
            raise AssertionError(f"0 and 255 map to {lo}, {hi}")
        # for the record: dividing by a Python scalar, torch multiplies by the reciprocal
        scalar_form = (all256.to(torch.float32) / 127.5 - 1.0).to(dtype)
        off = int((scalar_form != reference_dequantize(all256, dtype)).sum())
        print(f"check dequant {str(dtype)[6:]}: {len(cases)} segment lists equal the plain version per "
              f"tensor bit for bit, one launch each (`x / 127.5` with a Python scalar differs from the "
              f"division at {off} of 256 bytes)", flush=True)
    for bad in ([torch.zeros(4, device="cuda")], [step[1], torch.zeros(4, device="cuda")]):
        try:
            dequantize_videos(bad, torch.bfloat16)
        except TypeError:
            pass
        else:
            raise AssertionError("dequantize_videos accepted a float input")

    # a step's two bf16 batches: one launch (the train step's form) against
    # the same kernel launched once per tensor, in turns: one, two, two, one
    forms = {"one launch": lambda: dequantize_videos(step, torch.bfloat16),
             "per tensor": lambda: [dequantize_video(x, torch.bfloat16) for x in step]}
    turns = []
    for form in ("one launch", "per tensor", "per tensor", "one launch"):
        us, launches = profiled_device_us(forms[form], {"dequant_kernel": dequantize_video})
        turns.append({"form": form, "device_us": us, "launches": launches,
                      "host_us": host_us(forms[form])})
        if launches != (1 if form == "one launch" else 2):
            raise AssertionError(f"dequant {form}: the profile shows {launches} launches a step")
    one = [t for t in turns if t["form"] == "one launch"]
    two = [t for t in turns if t["form"] == "per tensor"]
    row = {
        "x": [list(shape) for _, shape in DEQUANT_SHAPES], "dtype": "bfloat16", "turns": turns,
        "device_us": statistics.mean(t["device_us"] for t in one),
        "per_tensor_device_us": statistics.mean(t["device_us"] for t in two),
        "host_us": statistics.mean(t["host_us"] for t in one),
        "per_tensor_host_us": statistics.mean(t["host_us"] for t in two),
        "plain_ms": cuda_ms(lambda: [reference_dequantize(x, torch.bfloat16) for x in step]),
        "bound_ms": DEQUANT_BOUND_MS,
    }
    row["bound_share"] = row["bound_ms"] * 1e3 / row["device_us"]
    print("time dequant " + json.dumps(row), flush=True)
    print(f"dequant, a step's two bf16 batches: {row['device_us']:.3f} us of device time in one launch "
          f"against {row['per_tensor_device_us']:.3f} us launched per tensor (in turns, inputs warm in L2); "
          f"bound {DEQUANT_BOUND_MS * 1e3:.3f} us; wrapper host cost {row['host_us']:.2f} us a step "
          f"against {row['per_tensor_host_us']:.2f} us", flush=True)
    return {
        "name": "dequantize_video",
        "route": "cuda",
        "source": "dcvgan_torch/csrc/dequant.cu",
        "replaces": "dcvgan_tpu/ops/dequant.py:25",
        "launches": None,
        "max_abs_err": worst,
        # one train step's bf16 batches (colour + depth) in one launch, at the
        # flagship; "ms" becomes the train step's profiled device time
        "ms": row["device_us"] / 1e3,
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "isolated_ms": row["device_us"] / 1e3,
        "per_tensor_ms": row["per_tensor_device_us"] / 1e3,
        "wrapper_ms": row["host_us"] / 1e3,
        "per_tensor_wrapper_ms": row["per_tensor_host_us"] / 1e3,
    }


def check_dequant_batch(batch: dict, path: str) -> float:
    """``dequantize_videos`` of one loader batch of ``path`` (its colour and
    depth videos in one launch, as its train step makes it) against the plain
    version per tensor, bit for bit, in bf16 and f32; returns the largest
    |diff|. Called outside the path's counted run."""
    from dcvgan_torch.ops.dequant import dequantize_videos, reference_dequantize

    xs = list(batch.values())
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for x, y in zip(xs, dequantize_videos(xs, dtype)):
            want = reference_dequantize(x, dtype)
            if y.shape != x.shape or y.dtype != dtype or not torch.equal(y, want):
                raise AssertionError(f"dequantize_videos {path} {str(dtype)[6:]}: differs from the plain "
                                     f"version at shape {tuple(x.shape)}")
            worst = max(worst, (y.float() - want.float()).abs().max().item())
    print(f"check dequant {path}: {[tuple(x.shape) for x in xs]} uint8 in one launch equal the plain "
          "version per tensor bit for bit, bf16 and f32", flush=True)
    return worst


TRAIN_EPOCHS, LOG_EVERY = 14, 6  # 3 batches of 20 per epoch of 64 videos: 42 steps


def train_config(root: Path):
    """``configs/mug-depth.yml`` on the synthetic dataset, writing under ``root``."""
    from dcvgan_torch.config import load_config

    cfg = load_config(ROOT / "configs" / "mug-depth.yml")
    cfg.dataset.name, cfg.dataset.cache_decoded = "synthetic", True
    cfg.dataset.path = str(root / "raw")
    cfg.dataset.processed_root = str(root / "processed")
    cfg.evaluation.metrics = []
    cfg.log_dir, cfg.tensorboard_dir = str(root / "result"), str(root / "result" / "runs")
    cfg.n_epochs, cfg.log_interval = TRAIN_EPOCHS, LOG_EVERY
    cfg.snapshot_interval = cfg.log_samples_interval = cfg.evaluation_interval = 10**9
    if (cfg.batchsize, cfg.trainer.precision, cfg.idis.ndf, cfg.gdis.ndf) != (20, "bfloat16", 64, 32):
        raise AssertionError("configs/mug-depth.yml is no longer the batch 20, bf16 flagship")
    return cfg


def recorder(run_dir: Path):
    """A ``Logger`` that keeps every value the trainer logs (``.seen``),
    beside logging it."""
    from dcvgan_torch.logging.logger import Logger

    class Recorder(Logger):
        def __init__(self, *args):
            super().__init__(*args)
            self.seen = {}

        def update(self, name, value):
            self.seen.setdefault(name, []).append(value)
            super().update(name, value)

    return Recorder(run_dir, None)


def check_restore(trainer, state, cfg) -> int:
    """The run's last checkpoint restores every state tensor equal (model
    state dicts and Adam's state); returns how many."""
    from dcvgan_torch.train.step import DCVGAN

    restored = trainer.ckpt.restore(DCVGAN(cfg).init_state(cfg.seed + 1))
    if restored.step != state.step:
        raise AssertionError("the checkpoint restored another step")
    n_equal = 0
    for name in state.models:
        a, b = state.models[name].state_dict(), restored.models[name].state_dict()
        oa, ob = state.opt[name].state_dict()["state"], restored.opt[name].state_dict()["state"]
        pairs = [(a[k], b[k]) for k in a] + [
            (oa[i][k], ob[i][k]) for i in oa for k in ("step", "exp_avg", "exp_avg_sq")]
        for x, y in pairs:
            if not torch.equal(x.cpu(), y.cpu()):
                raise AssertionError(f"{name}: a restored tensor differs")
            n_equal += 1
    print(f"checkpoint {trainer.ckpt.latest_step()} of {cfg.experiment_name}: {n_equal} tensors "
          "restore equal", flush=True)
    return n_equal


def phase_train(card: str):
    from dcvgan_torch import prng
    from dcvgan_torch.cli.train import build_dataset
    from dcvgan_torch.data.loader import VideoLoader
    from dcvgan_torch.ops.dequant import dequantize_video, reference_dequantize
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv
    from dcvgan_torch.train.step import DCVGAN
    from dcvgan_torch.train.trainer import LOSS_NAMES, Trainer

    tmp = tempfile.TemporaryDirectory(prefix="dcvgan_smoke_")
    root = Path(tmp.name)
    cfg = train_config(root)
    t0 = time.perf_counter()
    dataset = build_dataset(cfg)
    print(f"synthetic dataset: {len(dataset)} videos written and listed in "
          f"{time.perf_counter() - t0:.1f} s (cv2 JPEG frames)", flush=True)
    run_dir = Path(cfg.log_dir) / cfg.experiment_name
    logger = recorder(run_dir)
    # the fused kernel at the frame count of log_samples' one sampling round
    fused_err = check_sites(Trainer.NUM_LOG * cfg.video_length, "train log_samples", cgen_sites(cfg))

    torch.cuda.reset_peak_memory_stats()
    fused_norm_act_conv.launches = 0
    dequantize_video.launches = 0
    # -- main path: counts from 0 ------------------------------------------
    t0 = time.perf_counter()
    trainer = Trainer(cfg, dataset, logger=logger)
    state = trainer.train()
    torch.cuda.synchronize()
    launches, fused = dequantize_video.launches, fused_norm_act_conv.launches
    # -- end of main path ----------------------------------------------------
    train_s = time.perf_counter() - t0
    steps = TRAIN_EPOCHS * (len(dataset) // cfg.batchsize)
    print(f"train: {state.step} steps in {train_s:.1f} s; dequantize_video launches {launches}, "
          f"fused_norm_act_conv launches {fused}", flush=True)
    if state.step != steps or launches != steps:  # one launch a step for colour + depth
        raise AssertionError(f"expected {steps} steps and {steps} dequant launches")
    if fused != 5 * 2:  # log_samples at step 0 and at the end, one cgen forward each
        raise AssertionError(f"expected 10 fused launches from log_samples, counted {fused}")
    if next(state.cgen.parameters()).dtype != torch.float32:
        raise AssertionError("training parameters are not float32")
    losses = {k: logger.seen[k] for k in LOSS_NAMES}
    for k, v in losses.items():
        if len(v) != steps or not all(math.isfinite(x) for x in v):
            raise AssertionError(f"{k}: {len(v)} values, not all finite")
    first = {k: v[0] for k, v in losses.items()}
    print("first step " + json.dumps(first) + " last step "
          + json.dumps({k: v[-1] for k, v in losses.items()}), flush=True)
    for k in ("loss_idis", "loss_vdis", "loss_gdis"):
        if abs(first[k] - 2 * math.log(2)) > 0.2:
            raise AssertionError(f"first-step {k} {first[k]} is not within 0.2 of 2 ln 2")
    windows = logger.seen["iters_per_sec"]
    steady = windows[2:]  # the first windows hold cuDNN's algorithm search
    print(f"train it/s at batch {cfg.batchsize}: median {statistics.median(steady):.3f} over "
          f"{len(steady)} windows of {LOG_EVERY} steps (all windows: "
          f"{[round(w, 2) for w in windows]}) on {card}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    check_restore(trainer, state, cfg)

    # seeded replay, and a uint8 batch against the same batch as floats
    with VideoLoader(dataset, cfg.batchsize, n_workers=2, seed=1) as loader:
        batches = list(loader.epoch_iterator(0))
    gan = DCVGAN(cfg)

    def run(transform):
        st = gan.init_state(cfg.seed)
        out = []
        for batch in batches:
            st, m = gan.train_step(st, transform(trainer.to_device(batch)), prng.base_key(3, "cuda"))
            out.append(torch.stack([m[k] for k in LOSS_NAMES]))
        return torch.stack(out).cpu()

    a, b = run(lambda x: x), run(lambda x: x)
    as_float = run(lambda x: {k: reference_dequantize(v, gan.dtype) for k, v in x.items()})
    if a.shape != (3, 4):
        raise AssertionError("the replay did not run 3 steps")
    # the first step's critic losses come from forward passes over equal
    # state: equal bits. Everything after a backward pass may differ: cuDNN's
    # weight-gradient kernels sum with atomics, Adam's first steps move every
    # weight by +-lr whatever the gradient's size, so a few flipped signs show
    # in the later losses. Held within 1e-2 + 2% of the loss.
    replay = (a - b).abs()
    print(f"seeded replay of 3 steps: first-step critic losses differ by "
          f"{replay[0, 1:].max().item():.3e}; max |loss diff| after backward passes "
          f"{replay.max().item():.3e} (losses up to {a.abs().max().item():.2f}; cuDNN's backward "
          "kernels sum with atomics)", flush=True)
    u8 = (a - as_float).abs()
    print(f"uint8 batch against the same batch as floats: first-step critic losses differ by "
          f"{u8[0, 1:].max().item():.3e}, max over 3 steps {u8.max().item():.3e}", flush=True)
    bound = 1e-2 + 2e-2 * a.abs()
    if replay[0, 1:].max().item() != 0 or u8[0, 1:].max().item() != 0:
        raise AssertionError("equal state and equal draws gave different critic losses")
    if (replay > bound).any() or (u8 > bound).any():
        raise AssertionError("the replay or the uint8 ingest disagrees beyond 1e-2 + 2%")

    st = gan.init_state(cfg.seed)
    dev_batch = trainer.to_device(batches[0])
    kinds = profile_once(lambda: gan.train_step(st, dev_batch, prng.base_key(3, "cuda")),
                         "train profile", {"batch": cfg.batchsize},
                         {"dequantize_video": dequantize_video, "fused_norm_act_conv": fused_norm_act_conv})
    profiled_train(cfg, dataset)
    out = {"launches": launches, "device_ms": None, "trainer": trainer, "dataset": dataset,
           "logger": logger, "tmp": tmp, "fused_err": fused_err}
    if not kinds:
        return out  # not measured
    dq_ms = kinds["by_kind_ms"]["dequantize_video"]
    dq_calls = kinds["by_kind_launches"]["dequantize_video"]
    if dq_calls != 1:
        raise AssertionError(f"the step's profile shows {dq_calls} dequantize_video launches, not 1")
    print(f"dequant in the train-step profile: {dq_ms * 1e3:.2f} us of device time for the step's "
          f"one launch (colour + depth), against a bound of {DEQUANT_BOUND_MS * 1e3:.2f} us (bytes from "
          "device memory; the inputs may sit in L2)", flush=True)
    out["device_ms"] = dq_ms
    return out


def profiled_train(cfg, dataset) -> None:
    """``trainer.profile`` on the card: one epoch (3 steps) of the train
    phase's config with the key on writes a Chrome trace under
    ``<run_dir>/profile`` whose device kernels name ``dequant_kernel``."""
    from dcvgan_torch.train.trainer import Trainer

    pcfg = copy.deepcopy(cfg)
    pcfg.experiment_name += "-profiled"
    pcfg.n_epochs, pcfg.trainer.profile = 1, True
    trainer = Trainer(pcfg, dataset, logger=recorder(Path(pcfg.log_dir) / pcfg.experiment_name))
    state = trainer.train()
    traces = sorted((trainer.run_dir / "profile").glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"trainer.profile wrote {len(traces)} traces, not 1")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    dequant = [e for e in kernels if "dequant_kernel" in e.get("name", "")]
    print(f"trainer.profile: {traces[0].name} ({traces[0].stat().st_size / 1e6:.1f} MB) over {state.step} "
          f"steps: {len(kernels)} device kernel events, {len(dequant)} of dequant_kernel "
          f"(dequantize_video)", flush=True)
    if not dequant:
        raise AssertionError("the trainer's trace names no dequant_kernel launch")


# ------------------------------------------------------------------ levers
# the four repo configs that set a train-step lever, as they stand (their own
# widths, batch and precision), each trained for 12 steps on 48 synthetic
# videos: 4 epochs at batch 16, 2 at batch 8
LEVER_CONFIGS = ("demo-synthetic-fastpath", "demo-synthetic-quirks",
                 "demo-synthetic-sharedfakes", "headtohead-tpu-seed0-10k-stable-gn")
LEVER_STEPS, LEVER_VIDEOS = 12, 48
# remat on against off, f32 at ngf 32, one step from one state and the same
# draws, with cuDNN held to its deterministic algorithms while they run (its
# default weight-gradient kernels sum with atomics, and Adam's first step
# turns a gradient of rounding noise into +-lr, which the G phase would then
# meet in the critics). Held on the generators' gradients, which a dropout
# mask redrawn in the recompute would change: relative L2 per model within
# REMAT_GRAD_L2 (the backward may add the gradients that meet at one tensor
# in another order); losses and running statistics within their atols.
# The same step with the G phase's masks drawn anew must move those
# gradients by more than REMAT_CONTROL_L2, or the check could not fail.
# Measured on an H100 80GB HBM3 at 700 W: losses, statistics and gradients
# equal bit for bit, plain and trio (so are two runs without remat); other
# masks move the gradients by 0.088-0.43.
REMAT_LOSS_ATOL, REMAT_STATS_ATOL, REMAT_GRAD_L2, REMAT_CONTROL_L2 = 1e-5, 1e-6, 1e-4, 1e-2
# the critic_stat_reuse step on the card against the same step on the CPU
# (plain versions), from one state and the same draws. bf16: every conv
# rounds to bf16 in another order; the losses are softplus means of O(1)
# logits (the CPU suite holds bf16 losses at 1e-2 against JAX); held at
# 2e-2 (measured 8.8e-4). The generators' bf16 gradients sum that rounding
# over ~30 layers backward from a reference init and are printed, not held
# (0.10 and 0.18 in relative L2). f32 (TF32 off): the same step differs by
# summation order only; the generators' gradients, which pass backward
# through the critics' eval-mode BatchNorms, measured 4.3e-4 to 1.7e-3 in
# relative L2 over two runs, held at 5e-3 (a wrong backward through an
# eval-mode BatchNorm is off by tens of percent); the losses at 1e-4
# (measured 2.4e-7). All measured on an H100 80GB HBM3 at 700 W.
REUSE_BF16_LOSS_ATOL, REUSE_F32_LOSS_ATOL, REUSE_F32_GRAD_L2 = 2e-2, 1e-4, 5e-3
# one eval-mode BatchNorm3d, bf16 activations and f32 parameters, forward
# and backward on the card against the CPU: the output and the input's
# gradient are f32 values rounded once to bf16 (one ulp, 2^-7 of the
# value); the parameters' gradients are f32 sums over 14,336 products a
# channel in another order
BN_BF16_RTOL, BN_PARAM_GRAD_RTOL = 2.0**-7, 1e-4
# the flagship lever settings timed in turns against levers off
LEVER_SETTINGS = {
    "trio": {"shared_fakes": True, "critic_joint_batch": True, "critic_stat_reuse": True},
    "shared_fakes": {"shared_fakes": True},
    "critic_joint_batch": {"critic_joint_batch": True},
    "critic_stat_reuse": {"critic_stat_reuse": True},
    "ggen_double_step": {"ggen_double_step": True},
    "norm_group": {"norm": "group"},
}
LEVER_TIMED_STEPS = 42


def lever_config(name: str, root: Path):
    """``configs/<name>.yml`` on the synthetic dataset under ``root``, 12
    steps, no evaluation, no interval saves or sample rounds."""
    from dcvgan_torch.config import load_config

    cfg = load_config(ROOT / "configs" / f"{name}.yml")
    cfg.dataset.name, cfg.dataset.cache_decoded = "synthetic", True
    cfg.dataset.path = str(root / "raw")
    cfg.dataset.processed_root = str(root / "processed")
    cfg.dataset.number_limit = LEVER_VIDEOS
    cfg.evaluation.metrics = []
    cfg.log_dir, cfg.tensorboard_dir = str(root / "levers"), str(root / "levers" / "runs")
    cfg.n_epochs = LEVER_STEPS // (LEVER_VIDEOS // cfg.batchsize)
    cfg.log_interval = 6
    cfg.snapshot_interval = cfg.log_samples_interval = cfg.evaluation_interval = 10**9
    return cfg


def counting_trainer():
    """A ``Trainer`` that counts its ``log_samples`` rounds and the fused
    launches made inside them."""
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv
    from dcvgan_torch.train.trainer import Trainer

    class CountingTrainer(Trainer):
        sample_rounds = sample_launches = 0

        def log_samples(self, iteration):
            before = fused_norm_act_conv.launches
            super().log_samples(iteration)
            self.sample_rounds += 1
            self.sample_launches += fused_norm_act_conv.launches - before

    return CountingTrainer


def train_lever_config(name: str, root: Path) -> dict:
    """``Trainer.train()`` of one lever config, counters from 0 just before
    and read just after: ``dequantize_video`` once a step, and
    ``fused_norm_act_conv`` only inside ``log_samples`` (5 per cgen forward
    under BatchNorm, none under GroupNorm), never in a train step."""
    from dcvgan_torch.cli.train import build_dataset
    from dcvgan_torch.ops.dequant import dequantize_video
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv
    from dcvgan_torch.train.trainer import LOSS_NAMES, Trainer

    CountingTrainer = counting_trainer()
    cfg = lever_config(name, root)
    dataset = build_dataset(cfg)
    logger = recorder(Path(cfg.log_dir) / cfg.experiment_name)
    # both kernels at the shapes this path gives them: dequant at the
    # config's batch, the fused kernel at its cgen widths and the frame
    # count of log_samples' one sampling round (BatchNorm only)
    dequant_err = check_dequant_batch(device_batches(dataset, cfg.batchsize, 1)[0], f"lever {name}")
    fused_err = 0.0
    if cfg.trainer.norm == "batch":
        fused_err = check_sites(Trainer.NUM_LOG * cfg.video_length, f"lever {name} log_samples",
                                cgen_sites(cfg))
    fused_norm_act_conv.launches = 0
    dequantize_video.launches = 0
    # -- main path: counts from 0 ------------------------------------------
    t0 = time.perf_counter()
    trainer = CountingTrainer(cfg, dataset, logger=logger)
    state = trainer.train()
    torch.cuda.synchronize()
    dq, fused = dequantize_video.launches, fused_norm_act_conv.launches
    # -- end of main path ----------------------------------------------------
    train_s = time.perf_counter() - t0
    per_forward = 0 if cfg.trainer.norm == "group" else 5
    print(f"lever {name} (norm {cfg.trainer.norm}, batch {cfg.batchsize}, {cfg.trainer.precision}): "
          f"{state.step} steps in {train_s:.1f} s; dequantize_video launches {dq}; "
          f"fused_norm_act_conv launches {fused} ({trainer.sample_launches} in "
          f"{trainer.sample_rounds} log_samples rounds)", flush=True)
    if state.step != LEVER_STEPS or dq != LEVER_STEPS:
        raise AssertionError(f"{name}: expected {LEVER_STEPS} steps and dequant launches")
    if fused != trainer.sample_launches:
        raise AssertionError(f"{name}: a train step launched fused_norm_act_conv")
    if trainer.sample_launches != per_forward * trainer.sample_rounds or not trainer.sample_rounds:
        raise AssertionError(f"{name}: expected {per_forward} fused launches per sample round")
    losses = {k: logger.seen[k] for k in LOSS_NAMES}
    for k, v in losses.items():
        if len(v) != LEVER_STEPS or not all(math.isfinite(x) for x in v):
            raise AssertionError(f"{name} {k}: {len(v)} values, not all finite")
    first = {k: v[0] for k, v in losses.items()}
    print(f"lever {name}: first step " + json.dumps(first) + " last step "
          + json.dumps({k: v[-1] for k, v in losses.items()}), flush=True)
    for k in ("loss_idis", "loss_vdis", "loss_gdis"):
        if abs(first[k] - 2 * math.log(2)) > 0.2:
            raise AssertionError(f"{name}: first-step {k} {first[k]} is not within 0.2 of 2 ln 2")
    check_restore(trainer, state, cfg)
    trainer.loader.close()
    return {"cfg": cfg, "trainer": trainer, "state": state, "dequant": dq, "fused": fused,
            "dequant_err": dequant_err, "fused_err": fused_err}


def serve_group_norm_run(run: dict) -> None:
    """``load_run`` + ``GenerationServer.generate`` of the GroupNorm run: a
    seeded request twice gives equal bytes, and cgen's unfoldable down path
    makes no fused launch (counters from 0 just before, read just after)."""
    from dcvgan_torch.cli.infer import load_run
    from dcvgan_torch.cli.serve import GenerationServer
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv

    cfg, gan, trained = load_run(run["trainer"].run_dir, -1)
    if cfg.trainer.norm != "group" or trained.ema is None:
        raise AssertionError("the GroupNorm run did not load with its norm and EMA")
    state = trained.generators().with_ema_params()
    fused_norm_act_conv.launches = 0
    # -- main path: counts from 0 ------------------------------------------
    server = GenerationServer(gan, state, batchsize=64, iters_per_chunk=1, geo_name="depth")
    _, a = server.generate(128, seed=7)
    _, b = server.generate(128, seed=7)
    _, c = server.generate(128, seed=8)
    server.close()
    torch.cuda.synchronize()
    launches = fused_norm_act_conv.launches
    # -- end of main path ----------------------------------------------------
    print(f"served the GroupNorm run: {a.shape} uint8 twice with seed 7, equal bytes "
          f"{np_equal(a, b)}; fused_norm_act_conv launches {launches}", flush=True)
    if a.shape != (128, 16, 64, 64, 3) or not np_equal(a, b) or np_equal(a, c):
        raise AssertionError("the GroupNorm run's seeded bytes do not replay, or ignore the seed")
    if launches != 0:
        raise AssertionError(f"a GroupNorm cgen launched fused_norm_act_conv {launches} times")


def device_batches(dataset, batchsize: int, n: int, seed: int = 1) -> list:
    """The first ``n`` loader batches of epoch 0, uint8, on the card."""
    from dcvgan_torch.data.loader import VideoLoader

    with VideoLoader(dataset, batchsize, n_workers=2, seed=seed) as loader:
        batches = list(loader.epoch_iterator(0))[:n]
    return [{k: torch.from_numpy(np.asarray(v)).cuda() for k, v in b.items()} for b in batches]


def step_state(gan, batches, key: int, steps: int = 1):
    """A fresh state from the config's seed after ``steps`` steps of
    ``batches`` under ``key``; the last step's metrics."""
    from dcvgan_torch import prng

    state = gan.init_state(gan.config.seed)
    for i in range(steps):
        state, m = gan.train_step(state, batches[i % len(batches)],
                                  prng.base_key(key, gan.device))
    return state, m


def generator_grads(state) -> dict:
    """The generators' gradients as they stand after a step, flat f32."""
    return {name: torch.cat([p.grad.float().flatten() for p in getattr(state, name).parameters()])
            for name in ("ggen", "cgen")}


def rel_l2(a: dict, b: dict) -> dict:
    return {k: ((a[k] - b[k]).norm() / b[k].norm()).item() for k in b}


def remat_equivalence(root: Path) -> dict:
    """``remat`` on against off, f32 (TF32 off) at ngf 32, one step from one
    state and the same draws, under the plain step and under the fast-path
    trio: losses, running statistics and the generators' gradients within
    the stated tolerances, and a control step with other G-phase dropout
    masks outside them."""
    from dcvgan_torch import prng
    from dcvgan_torch.cli.train import build_dataset
    from dcvgan_torch.train.step import DCVGAN, StepDraws

    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for label, fast in (("plain", False), ("trio", True)):
        cfg = lever_config("demo-synthetic-fastpath", root)
        cfg.trainer.precision = "float32"
        cfg.trainer.shared_fakes = cfg.trainer.critic_joint_batch = fast
        cfg.trainer.critic_stat_reuse = fast
        batch = device_batches(build_dataset(cfg), cfg.batchsize, 1)[0]
        g = torch.Generator().manual_seed(4)
        cpu, n_frames = torch.device("cpu"), cfg.batchsize * cfg.video_length
        probe = DCVGAN(cfg, "cpu")
        cgen = probe.init_state(cfg.seed).cgen
        draws = StepDraws(
            t_rand=5,
            d_latents=probe.sample_latents(g, cfg.batchsize),
            g_latents=probe.sample_latents(g, cfg.batchsize),
            d_dropout=cgen.dropout_masks(n_frames, g, cpu),
            g_dropout=cgen.dropout_masks(n_frames, g, cpu),
        )
        other = dataclasses.replace(draws, g_dropout=cgen.dropout_masks(n_frames, g, cpu))
        runs = {}
        for run, remat, run_draws in (("off", False, draws), ("on", True, draws),
                                      ("off again", False, draws), ("other masks", True, other)):
            cfg.trainer.remat = remat
            gan = DCVGAN(cfg)
            torch.cuda.reset_peak_memory_stats()
            state, m = gan.train_step(gan.init_state(cfg.seed), batch, prng.base_key(5, gan.device),
                                      run_draws)
            runs[run] = (state, m, generator_grads(state), torch.cuda.max_memory_allocated() / 1e9)
        (a, ma, ga, peak_a), (b, mb, gb, peak_b) = runs["off"], runs["on"]
        loss = max(abs(ma[k].item() - mb[k].item()) for k in ma)
        stats = max((x.float() - y.float()).abs().max().item()
                    for name in a.models
                    for x, y in zip(a.models[name].buffers(), b.models[name].buffers())
                    if x.is_floating_point())
        grad = rel_l2(gb, ga)
        floor = rel_l2(runs["off again"][2], ga)
        control = rel_l2(runs["other masks"][2], ga)
        print(f"remat on vs off ({label}, f32, ngf {cfg.ggen.ngf}, batch {cfg.batchsize}, one step, "
              f"deterministic cuDNN): max |loss diff| {loss:.3e} (tol {REMAT_LOSS_ATOL:g}), running "
              f"statistics {stats:.3e} (tol {REMAT_STATS_ATOL:g}), generator gradients' relative L2 "
              f"{json.dumps(grad)} (tol {REMAT_GRAD_L2:g}); remat off twice {json.dumps(floor)}; "
              f"other G-phase masks {json.dumps(control)} (must exceed {REMAT_CONTROL_L2:g}); peak "
              f"device memory {peak_a:.3f} GB off, {peak_b:.3f} GB on", flush=True)
        if loss > REMAT_LOSS_ATOL or stats > REMAT_STATS_ATOL or max(grad.values()) > REMAT_GRAD_L2:
            raise AssertionError(f"remat on and off disagree ({label})")
        if min(control.values()) <= REMAT_CONTROL_L2:
            raise AssertionError(f"other dropout masks left the generator gradients in tolerance ({label})")
        out[label] = {"loss": loss, "stats": stats, "grad_rel_l2": grad, "floor_rel_l2": floor,
                      "control_rel_l2": control}
    torch.backends.cudnn.deterministic = deterministic
    return out


def stat_reuse_step(root: Path, precision: str) -> dict:
    """One ``critic_stat_reuse`` step on the card and on the CPU (plain
    versions) from one state and the same draws, in ``precision``: the
    generator phase's backward runs through the critics' eval-mode
    BatchNorm3d. ngf 32, batch 4 (the CPU's time), critic noise off so that
    every draw is an explicit input. Returns the losses' largest difference
    and the generators' gradients' relative L2 distance."""
    from dcvgan_torch import prng
    from dcvgan_torch.cli.train import build_dataset
    from dcvgan_torch.data.loader import VideoLoader
    from dcvgan_torch.train.step import DCVGAN, StepDraws

    cfg = lever_config("demo-synthetic-fastpath", root)
    cfg.batchsize = 4
    cfg.trainer.precision = precision
    cfg.trainer.shared_fakes = cfg.trainer.critic_joint_batch = False
    for name in ("idis", "vdis", "gdis"):
        getattr(cfg, name).use_noise = False
    with VideoLoader(build_dataset(cfg), cfg.batchsize, n_workers=2, seed=1) as loader:
        batch = next(loader.epoch_iterator(0))
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    gans = {device: DCVGAN(cfg, device) for device in ("cuda", "cpu")}
    states = {device: gan.init_state(cfg.seed) for device, gan in gans.items()}
    g = torch.Generator().manual_seed(6)
    n_frames = cfg.batchsize * cfg.video_length
    cpu = torch.device("cpu")
    draws = StepDraws(
        t_rand=5,
        d_latents=gans["cpu"].sample_latents(g, cfg.batchsize),
        g_latents=gans["cpu"].sample_latents(g, cfg.batchsize),
        d_dropout=states["cpu"].cgen.dropout_masks(n_frames, g, cpu),
        g_dropout=states["cpu"].cgen.dropout_masks(n_frames, g, cpu),
    )
    results = {}
    for device, gan in gans.items():
        state = states[device]
        on_device = {k: v.to(gan.device) for k, v in batch.items()}
        state, m = gan.train_step(state, on_device, prng.base_key(5, gan.device), draws)
        grads = {name: torch.cat([p.grad.float().flatten().cpu()
                                  for p in getattr(state, name).parameters()])
                 for name in ("ggen", "cgen")}
        results[device] = ({k: v.item() for k, v in m.items()}, grads)
    (mc, gc), (mh, gh) = results["cuda"], results["cpu"]
    loss = max(abs(mc[k] - mh[k]) for k in mc)
    rel = {name: ((gc[name] - gh[name]).norm() / gh[name].norm()).item() for name in gc}
    print(f"critic_stat_reuse {precision} step, card against CPU (ngf {cfg.ggen.ngf}, batch "
          f"{cfg.batchsize}): losses card {json.dumps(mc)} CPU {json.dumps(mh)}; max |diff| "
          f"{loss:.3e}; generator gradients' relative L2 "
          f"{json.dumps({k: round(v, 6) for k, v in rel.items()})}", flush=True)
    if not all(math.isfinite(v) for v in mc.values()):
        raise AssertionError(f"the critic_stat_reuse {precision} step's losses are not finite")
    return {"loss": loss, "grad_rel_l2": rel}


def eval_batch_norm_backward() -> dict:
    """One eval-mode ``BatchNorm3d`` (bf16 activations, f32 parameters and
    running statistics, channels-last) forward and backward on the card
    against the CPU, on the same values."""
    from dcvgan_torch.models.layers import batch_norm3d

    g = torch.Generator().manual_seed(8)
    bn = batch_norm3d(64)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(0.0, 0.1, generator=g)
        bn.running_mean.normal_(0.0, 0.5, generator=g)
        bn.running_var.uniform_(0.5, 2.0, generator=g)
    x = torch.randn(8, 64, 7, 16, 16, generator=g).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last_3d)
    dy = torch.randn(x.shape, generator=g).to(torch.bfloat16)
    out = {}
    for device in ("cuda", "cpu"):
        layer = copy.deepcopy(bn).to(device)
        xd = x.to(device, copy=True).requires_grad_()
        y = layer(xd, False, False)
        y.backward(dy.to(device).contiguous(memory_format=torch.channels_last_3d))
        out[device] = [t.detach().float().cpu() for t in (y, xd.grad, layer.weight.grad, layer.bias.grad)]
    errs = {}
    for name, a, b, rtol in zip(("y", "dx", "dweight", "dbias"), out["cuda"], out["cpu"],
                                (BN_BF16_RTOL, BN_BF16_RTOL, BN_PARAM_GRAD_RTOL, BN_PARAM_GRAD_RTOL)):
        d = (a - b).abs()
        scale = b.abs() if name in ("y", "dx") else b.abs().max()
        # the largest difference as a share of its tolerance (<= 1 passes)
        errs[name] = (d / (rtol * scale + 1e-6)).max().item()
        if errs[name] > 1:
            raise AssertionError(f"eval-mode BatchNorm3d {name}: card and CPU differ by {d.max().item():.3e}")
    print("eval-mode BatchNorm3d, bf16 activations, f32 parameters, card against CPU: largest "
          f"difference as a share of its tolerance {json.dumps({k: round(v, 4) for k, v in errs.items()})}"
          f" (tol {BN_BF16_RTOL:g} relative + 1e-6 for y and dx, {BN_PARAM_GRAD_RTOL:g} of the largest "
          "for the parameters' gradients)", flush=True)
    return errs


def stat_reuse_against_cpu(root: Path) -> dict:
    """``critic_stat_reuse`` on the card against the CPU: the layer, then a
    whole step in f32 (gradients held) and in bf16 (losses held)."""
    layer = eval_batch_norm_backward()
    f32 = stat_reuse_step(root, "float32")
    bf16 = stat_reuse_step(root, "bfloat16")
    if f32["loss"] > REUSE_F32_LOSS_ATOL or max(f32["grad_rel_l2"].values()) > REUSE_F32_GRAD_L2:
        raise AssertionError("the f32 critic_stat_reuse step on the card disagrees with the CPU's")
    if bf16["loss"] > REUSE_BF16_LOSS_ATOL:
        raise AssertionError("the bf16 critic_stat_reuse step's losses disagree with the CPU's")
    print(f"critic_stat_reuse held: f32 losses within {REUSE_F32_LOSS_ATOL:g} and gradients within "
          f"{REUSE_F32_GRAD_L2:g} relative L2; bf16 losses within {REUSE_BF16_LOSS_ATOL:g}", flush=True)
    return {"layer": layer, "f32": f32, "bf16": bf16}


def adam_keeps_the_gradient() -> None:
    """``ggen_double_step`` steps ggen's Adam twice on one gradient: torch's
    foreach Adam (the card's default) must add the weight decay to a copy."""
    from dcvgan_torch.config import OptimizerConfig
    from dcvgan_torch.train.step import make_optimizer

    g = torch.Generator(device="cuda").manual_seed(2)
    params = [torch.nn.Parameter(torch.randn(64, 32, 4, 4, device="cuda", generator=g))
              for _ in range(3)]
    opt = make_optimizer(OptimizerConfig(decay=0.5), params)
    grads = [torch.randn(p.shape, device="cuda", generator=g) for p in params]
    for p, gr in zip(params, grads):
        p.grad = gr.clone()
    for _ in range(2):
        opt.step()
    if not all(torch.equal(p.grad, gr) for p, gr in zip(params, grads)):
        raise AssertionError("torch's Adam changed .grad in place: a second step sees another gradient")
    print("Adam (foreach, weight decay 0.5) left .grad as it was over two steps", flush=True)


def time_lever_settings(run: dict, card: str) -> dict:
    """The flagship (``configs/mug-depth.yml``: batch 20, ngf 64, bf16) with
    each lever setting against levers off, in turns (off, on, on, off): train
    it/s over 42 steps after 2 untimed ones, and peak device memory; then
    remat's peak memory against none, and a profile of one step under the
    trio and under GroupNorm. Numbers only: no limit."""
    from dcvgan_torch import prng
    from dcvgan_torch.ops.dequant import dequantize_video
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv
    from dcvgan_torch.train.step import DCVGAN

    base = train_config(Path(run["tmp"].name))
    batches = device_batches(run["dataset"], base.batchsize, 3)

    def one(levers: dict) -> tuple:
        cfg = train_config(Path(run["tmp"].name))
        for k, v in levers.items():
            setattr(cfg.trainer, k, v)
        gan = DCVGAN(cfg)
        torch.cuda.reset_peak_memory_stats()
        state, _ = step_state(gan, batches, key=9, steps=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(LEVER_TIMED_STEPS):
            state, m = gan.train_step(state, batches[i % len(batches)], prng.base_key(9, "cuda"))
        torch.cuda.synchronize()
        its = LEVER_TIMED_STEPS / (time.perf_counter() - t0)
        if not all(math.isfinite(v.item()) for v in m.values()):
            raise AssertionError(f"levers {levers}: non-finite losses")
        del state
        return its, torch.cuda.max_memory_allocated() / 1e9

    report = {}
    for label, levers in LEVER_SETTINGS.items():
        turns = [one({} if i in (0, 3) else levers) for i in range(4)]
        report[label] = {"off_its": [turns[0][0], turns[3][0]], "on_its": [turns[1][0], turns[2][0]],
                         "off_peak_gb": turns[0][1], "on_peak_gb": turns[1][1]}
        print(f"levers {label} at batch {base.batchsize} on {card}: train it/s off "
              f"{turns[0][0]:.3f}, on {turns[1][0]:.3f}, on {turns[2][0]:.3f}, off {turns[3][0]:.3f}; "
              f"peak device memory off {turns[0][1]:.3f} GB, on {turns[1][1]:.3f} GB", flush=True)
    remat = {r: one({"remat": r})[1] for r in (False, True)}
    report["remat_peak_gb"] = remat
    print(f"remat at batch {base.batchsize}: peak device memory {remat[False]:.3f} GB without, "
          f"{remat[True]:.3f} GB with", flush=True)
    print("levers " + json.dumps(report), flush=True)
    # where a step's time goes under the trio and under GroupNorm
    for label in ("trio", "norm_group"):
        cfg = train_config(Path(run["tmp"].name))
        for k, v in LEVER_SETTINGS[label].items():
            setattr(cfg.trainer, k, v)
        gan = DCVGAN(cfg)
        state, _ = step_state(gan, batches, key=9, steps=1)
        profile_once(lambda: gan.train_step(state, batches[0], prng.base_key(9, "cuda")),
                     f"train profile {label}", {"batch": cfg.batchsize},
                     {"dequantize_video": dequantize_video, "fused_norm_act_conv": fused_norm_act_conv})
    return report


def phase_levers(run: dict, card: str) -> dict:
    """The train step's opt-in levers and ``trainer.norm: group``: the four
    repo configs that set them trained as they stand, the GroupNorm run
    served, remat and critic_stat_reuse held to their equivalents, and the
    flagship's numbers under each setting."""
    root = Path(run["tmp"].name)
    runs = {name: train_lever_config(name, root) for name in LEVER_CONFIGS}
    quirks = runs["demo-synthetic-quirks"]["state"]
    counts = {name: {float(s["step"]) for s in quirks.opt[name].state.values()} for name in quirks.models}
    print(f"quirks run's Adam counts after {LEVER_STEPS} steps: "
          + json.dumps({k: sorted(v) for k, v in counts.items()}), flush=True)
    if counts["ggen"] != {2.0 * LEVER_STEPS} or counts["cgen"] != {float(LEVER_STEPS)} \
            or counts["idis"] != {LEVER_STEPS / 2}:
        raise AssertionError("the quirks run did not step ggen twice a step and the critics every second")
    adam_keeps_the_gradient()
    serve_group_norm_run(runs["headtohead-tpu-seed0-10k-stable-gn"])
    remat = remat_equivalence(root)
    reuse = stat_reuse_against_cpu(root)
    numbers = time_lever_settings(run, card)
    torch.cuda.empty_cache()
    return {"dequant_launches": sum(r["dequant"] for r in runs.values()),
            "fused_launches": sum(r["fused"] for r in runs.values()),
            "dequant_err": max(r["dequant_err"] for r in runs.values()),
            "fused_err": max(r["fused_err"] for r in runs.values()),
            "remat": remat, "reuse": reuse, "numbers": numbers}


# ---------------------------------------------------------------- datasets
# the dataset phase's raw trees, at SURREAL's and IsoGD's raw frame size
# (320 x 240), 20 frames a video: enough videos for one batch of
# configs/surreal-segm.yml (60) and configs/isogd-flow.yml (100)
RAW_T, RAW_H, RAW_W = 20, 240, 320
RAW_VIDEOS = {"surreal": 64, "isogd": 104}
# each config as it stands, trained one batch an epoch for this many steps
DATASET_STEPS = {"surreal-segm": 8, "isogd-flow": 6}
# the config fields each run must keep, and the first critic losses they
# start from: 2 ln 2 for the adversarial loss, 2 for the hinge loss (logits
# near 0 at initialisation), each held within 0.2
DATASET_CONFIGS = {
    "surreal-segm": {"dataset": "surreal", "batchsize": 60, "loss": "adversarial-loss",
                     "num_gen_update": 2, "widths": (96, 64, 64, 48, 32), "first_d": 2 * math.log(2)},
    "isogd-flow": {"dataset": "isogd", "batchsize": 100, "loss": "hinge-loss",
                   "num_gen_update": 1, "widths": (64, 64, 64, 64, 32), "first_d": 2.0},
}


def sliding_frames(rng: np.random.Generator, t: int) -> np.ndarray:
    """(t, RAW_H, RAW_W, 3) uint8: a random pattern of 16-pixel blocks that
    slides 2 pixels a frame, so that optical flow finds motion."""
    blocks = rng.integers(0, 256, (RAW_H // 16, RAW_W // 16, 3), np.uint8)
    frame = np.repeat(np.repeat(blocks, 16, 0), 16, 1)
    return np.stack([np.roll(frame, 2 * i, axis=1) for i in range(t)])


def write_surreal_raw(root: Path, n: int) -> None:
    """A SURREAL-style raw tree under ``root``, as the JAX package's
    preprocessing tests build it: per video an mp4, ``_depth.mat`` (float32,
    the 1e10 background on ~70% of pixels), ``_segm.mat`` (uint8 labels
    0-24) and ``_info.mat`` (24 joints in the middle of the frame)."""
    import scipy.io
    from dcvgan_torch.io.video import write_video

    def one(v: int) -> None:
        rng = np.random.default_rng((7, v))
        seq = root / "train" / "run0" / f"{v:03d}_01"
        seq.mkdir(parents=True, exist_ok=True)
        stem = f"{v:03d}_01_c0001"
        write_video(sliding_frames(rng, RAW_T), seq / f"{stem}.mp4")
        shape = (RAW_T, RAW_H, RAW_W)
        depth = np.where(rng.random(shape) < 0.3, rng.uniform(2, 5, shape), 1e10).astype(np.float32)
        scipy.io.savemat(seq / f"{stem}_depth.mat", {f"depth_{i + 1}": d for i, d in enumerate(depth)})
        segm = rng.integers(0, 25, shape, np.uint8)
        scipy.io.savemat(seq / f"{stem}_segm.mat", {f"segm_{i + 1}": s for i, s in enumerate(segm)})
        joints = np.stack([rng.uniform(RAW_W * 0.4, RAW_W * 0.6, (24, RAW_T)),
                           rng.uniform(RAW_H * 0.3, RAW_H * 0.7, (24, RAW_T))])
        scipy.io.savemat(seq / f"{stem}_info.mat", {"joints2D": joints})

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(one, range(n)))


def write_isogd_raw(root: Path, n: int) -> None:
    """An IsoGD-style raw tree under ``root``: colour and depth mp4s per
    video and ``train_list.txt`` of (colour, depth, label) rows."""
    from dcvgan_torch.io.video import write_video

    def one(v: int) -> str:
        rng = np.random.default_rng((11, v))
        color, depth = f"train/{v:03d}/M_{v:05d}.mp4", f"train/{v:03d}/K_{v:05d}.mp4"
        (root / "train" / f"{v:03d}").mkdir(parents=True, exist_ok=True)
        write_video(sliding_frames(rng, RAW_T), root / color)
        write_video(sliding_frames(rng, RAW_T), root / depth)
        return f"{color} {depth} {v % 249 + 1}"

    with ThreadPoolExecutor(max_workers=8) as pool:
        rows = list(pool.map(one, range(n)))
    (root / "train_list.txt").write_text("\n".join(rows) + "\n")


def preprocess_cli(dataset: str, raw: Path, out: Path) -> float:
    """``python -m dcvgan_torch.cli.preprocess <dataset> raw out --img-size
    64`` in its own process, then its tree checked: one ``list.txt`` line a
    raw video, each video's frames and arrays at 64 x 64, and every preview
    mp4 decodes. Returns the preprocessing seconds."""
    from dcvgan_torch.io.video import read_video

    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "dcvgan_torch.cli.preprocess", dataset, str(raw), str(out),
         "--img-size", "64"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if done.returncode != 0:
        raise AssertionError(f"cli.preprocess {dataset} exited {done.returncode}:\n{done.stderr[-4000:]}")
    lines = (out / "list.txt").read_text().splitlines()
    n = RAW_VIDEOS[dataset]
    if len(lines) != n or any(not line.endswith(f" {RAW_T}") for line in lines):
        raise AssertionError(f"{dataset}: list.txt has {len(lines)} lines for {n} raw videos")
    arrays = {"surreal": {"depth.npy": (RAW_T, 64, 64), "segm.npy": (RAW_T, 64, 64)},
              "isogd": {"optical-flow.npy": (RAW_T - 1, 64, 64, 2)}}[dataset]
    frame_dirs = {"surreal": ("color",), "isogd": ("color", "depth")}[dataset]
    previews = {"surreal": ("color", "depth", "segm"), "isogd": ("color", "depth", "optical-flow")}[dataset]
    for line in lines:
        name = line.split()[0]
        for sub in frame_dirs:
            if len(list((out / name / sub).glob("*.jpg"))) != RAW_T:
                raise AssertionError(f"{dataset} {name}: not {RAW_T} {sub} frames")
        for f, shape in arrays.items():
            a = np.load(out / name / f)
            if a.shape != shape:
                raise AssertionError(f"{dataset} {name}/{f}: shape {a.shape}, not {shape}")
        for sub in previews:
            v = read_video(out / sub / f"{name}.mp4")
            if v.shape[1:] != (64, 64, 3) or len(v) < RAW_T - 1:
                raise AssertionError(f"{dataset} preview {sub}/{name}.mp4 decodes as {v.shape}")
    print(f"cli.preprocess {dataset}: {n} raw videos ({RAW_T} frames of {RAW_W}x{RAW_H}) in "
          f"{seconds:.2f} s = {n / seconds:.2f} videos/s with {os.cpu_count()} CPUs; {len(lines)} listed, "
          f"frames, arrays and {len(previews) * n} previews checked", flush=True)
    return seconds


def check_native(card: str) -> dict:
    """The host library bit for bit against the numpy forms at the shapes the
    run gives it (``one_hot`` of log_samples' real segmentation batch, with
    labels >= 25 mixed in; ``scale_f32`` of a flow sample; ``normalize_u8``
    of a colour sample), then each timed against its numpy form in turns
    (numpy, native, native, numpy; median of 20 calls each)."""
    from dcvgan_torch import native
    from dcvgan_torch.data import host_ops
    from dcvgan_torch.train.trainer import Trainer

    if not native.available():
        raise AssertionError("the host library did not build")
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 25, (Trainer.NUM_LOG * 16, 64, 64), np.uint8)
    flat = labels.reshape(-1)  # a view
    flat[::7] = rng.integers(25, 256, flat[::7].size, dtype=np.uint8)  # all-zero rows
    flow = (rng.normal(size=(16, 64, 64, 2)) * 5).astype(np.float32)
    frames = rng.integers(0, 256, (16, 64, 64, 3), np.uint8)
    cases = {
        "one_hot": (lambda: native.one_hot(labels, 25), lambda: host_ops.one_hot(labels, 25), labels.shape),
        "scale_f32": (lambda: native.scale_f32(flow, 1 / 64), lambda: host_ops.scale_f32(flow, 1 / 64),
                      flow.shape),
        "normalize_u8": (lambda: native.normalize_u8(frames, 127.5, -1.0),
                         lambda: host_ops.normalize_u8(frames, 127.5, -1.0), frames.shape),
    }

    def median_ms(fn, reps: int = 20) -> float:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    out = {}
    for name, (fast, plain, shape) in cases.items():
        a, b = fast(), plain()
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            raise AssertionError(f"native {name} differs from its numpy form at {shape}")
        turns = [median_ms(f) for f in (plain, fast, fast, plain)]
        out[name] = {"shape": list(shape), "numpy_ms": [turns[0], turns[3]], "native_ms": [turns[1], turns[2]]}
    print("native " + json.dumps({"threads": native.DEFAULT_THREADS, "cpus": os.cpu_count(), **out})
          + f" (bit for bit equal to the numpy forms; host CPU of the card's machine, {card})", flush=True)
    return out


def dataset_config(name: str, root: Path, processed: Path):
    """``configs/<name>.yml`` as it stands, pointed at the trees under
    ``root``: these fields change, nothing else (PERF.md lists them)."""
    from dcvgan_torch.config import load_config

    cfg = load_config(ROOT / "configs" / f"{name}.yml")
    want = DATASET_CONFIGS[name]
    widths = (cfg.ggen.ngf, cfg.cgen.ngf, cfg.idis.ndf, cfg.vdis.ndf, cfg.gdis.ndf)
    if (cfg.dataset.name, cfg.batchsize, cfg.loss, cfg.num_gen_update, widths, cfg.trainer.precision) \
            != (want["dataset"], want["batchsize"], want["loss"], want["num_gen_update"], want["widths"],
                "bfloat16"):
        raise AssertionError(f"configs/{name}.yml is no longer the config this phase was written for")
    steps = DATASET_STEPS[name]
    cfg.dataset.path = str(root / "raw" / want["dataset"])
    cfg.dataset.processed_root = str(processed)
    cfg.log_dir, cfg.tensorboard_dir = str(root / "result"), str(root / "result" / "runs")
    cfg.n_epochs = steps  # one batch an epoch
    # one sample round and one checkpoint inside the run, beside the
    # trainer's own at step 0 and at the end
    cfg.log_samples_interval = cfg.snapshot_interval = steps // 2 + 1
    # the losses reach the logger at each window's end: a loss fetch (one
    # host sync) every 2 steps, where the config's 160 would fetch none
    cfg.log_interval = 2
    cfg.evaluation.metrics = []
    return cfg


class CallCounter:
    """Counts the calls of ``module``'s functions ``names`` while active
    (thread-safe: the loader's workers call them)."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.counts = {n: 0 for n in names}
        self._lock = threading.Lock()

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.saved.items():
            def counted(*args, _fn=fn, _n=n, **kwargs):
                with self._lock:
                    self.counts[_n] += 1
                return _fn(*args, **kwargs)
            setattr(self.module, n, counted)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def train_dataset_config(name: str, root: Path, processed: Path, card: str) -> dict:
    """``build_dataset`` + ``Trainer.train()`` of one dataset config on the
    tree ``cli.preprocess`` wrote, counters from 0 just before and read just
    after: ``dequantize_video`` once a step (the colour batch; segmentation
    is one-hot on the card, flow arrives as float16), ``fused_norm_act_conv``
    5 per cgen forward, all inside ``log_samples``; the host library's
    calls counted too. Both kernels are held at this run's shapes first."""
    from dcvgan_torch import native
    from dcvgan_torch.cli.train import build_dataset
    from dcvgan_torch.ops.dequant import dequantize_video
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv
    from dcvgan_torch.train.trainer import LOSS_NAMES, Trainer

    cfg = dataset_config(name, root, processed)
    steps = DATASET_STEPS[name]
    dataset = build_dataset(cfg)
    if len(dataset) != RAW_VIDEOS[DATASET_CONFIGS[name]["dataset"]]:
        raise AssertionError(f"{name}: the dataset lists {len(dataset)} videos")
    logger = recorder(Path(cfg.log_dir) / cfg.experiment_name)
    batch = device_batches(dataset, cfg.batchsize, 1)[0]
    dequant_err = check_dequant_batch({"color": batch["color"]}, f"{name} batch {cfg.batchsize}")
    fused_err = check_sites(Trainer.NUM_LOG * cfg.video_length, f"{name} log_samples", cgen_sites(cfg))
    del batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    CountingTrainer = counting_trainer()
    with CallCounter(native, ("normalize_u8", "one_hot", "scale_f32")) as calls:
        fused_norm_act_conv.launches = 0
        dequantize_video.launches = 0
        # -- main path: counts from 0 --------------------------------------
        t0 = time.perf_counter()
        trainer = CountingTrainer(cfg, dataset, logger=logger)
        state = trainer.train()
        torch.cuda.synchronize()
        dq, fused = dequantize_video.launches, fused_norm_act_conv.launches
        # -- end of main path ------------------------------------------------
    train_s = time.perf_counter() - t0
    print(f"{name} ({cfg.geometric_info.name}, batch {cfg.batchsize}, {cfg.loss}, num_gen_update "
          f"{cfg.num_gen_update}): {state.step} steps in {train_s:.1f} s; dequantize_video launches "
          f"{dq}; fused_norm_act_conv launches {fused} ({trainer.sample_launches} in "
          f"{trainer.sample_rounds} log_samples rounds); host library calls {json.dumps(calls.counts)}",
          flush=True)
    if state.step != steps or dq != steps:
        raise AssertionError(f"{name}: expected {steps} steps and {steps} dequant launches")
    if fused != trainer.sample_launches:
        raise AssertionError(f"{name}: a train step launched fused_norm_act_conv")
    if trainer.sample_rounds != 3 or trainer.sample_launches != 5 * trainer.sample_rounds:
        raise AssertionError(f"{name}: expected 3 sample rounds of 5 fused launches")
    geo = cfg.geometric_info.name
    if geo == "optical-flow" and calls.counts["scale_f32"] < steps * cfg.batchsize:
        raise AssertionError(f"{name}: the flow of {steps * cfg.batchsize} samples did not pass scale_f32")
    if geo == "segmentation" and calls.counts["one_hot"] != trainer.sample_rounds:
        raise AssertionError(f"{name}: log_samples did not one-hot its real batch natively")
    losses = {k: logger.seen[k] for k in LOSS_NAMES}
    for k, v in losses.items():
        if len(v) != steps or not all(math.isfinite(x) for x in v):
            raise AssertionError(f"{name} {k}: {len(v)} values, not all finite")
    first = {k: v[0] for k, v in losses.items()}
    print(f"{name}: first step " + json.dumps(first) + " last step "
          + json.dumps({k: v[-1] for k, v in losses.items()}), flush=True)
    for k in ("loss_idis", "loss_vdis", "loss_gdis"):
        if abs(first[k] - DATASET_CONFIGS[name]["first_d"]) > 0.2:
            raise AssertionError(f"{name}: first-step {k} {first[k]} is not within 0.2 of "
                                 f"{DATASET_CONFIGS[name]['first_d']:.4f}")
    windows = logger.seen["iters_per_sec"]
    print(f"{name} train it/s at batch {cfg.batchsize}, one batch an epoch (loader and step in series, "
          f"a loss fetch every 2 steps): windows of 2 steps {[round(w, 3) for w in windows]}, median "
          f"after the first {statistics.median(windows[1:]):.3f} on {card}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    check_restore(trainer, state, cfg)
    trainer.loader.close()
    split = loader_and_step_ms(trainer, dataset, cfg)
    loader = split["loader_batches_ms"]
    print(f"{name} at batch {cfg.batchsize}: the loader alone median {split['loader_ms']:.1f} ms a batch "
          f"over {len(loader)} batches ({min(loader):.1f}-{max(loader):.1f}; {cfg.dataset.n_workers} "
          f"workers, host clock), the step alone {split['step_ms']:.1f} ms on one resident batch "
          f"(synchronised), against {1e3 / statistics.median(windows[1:]):.1f} ms a step in the run's "
          f"windows; with prefetch over many batches an epoch a step would take the larger of the two: "
          f"at most {1e3 / max(split['loader_ms'], split['step_ms']):.3f} it/s, on {card}", flush=True)
    return {"dequant": dq, "fused": fused, "dequant_err": dequant_err, "fused_err": fused_err,
            "it_s": windows, "native_calls": calls.counts, **split}


def loader_and_step_ms(trainer, dataset, cfg, epochs: int = 12, steps: int = 4) -> dict:
    """Where a step's time goes: the config's loader alone, each of
    ``epochs`` epochs of one batch timed on its own (the loader decodes one
    batch at a time, its samples over the workers, so a batch's time is its
    rate), and the train step alone on one resident batch (``steps`` steps
    after one, ending in a synchronise), in ms a batch."""
    from dcvgan_torch.data.loader import VideoLoader

    loader_batches_ms = []
    with VideoLoader(dataset, cfg.batchsize, n_workers=cfg.dataset.n_workers, seed=5) as loader:
        for epoch in range(epochs):
            t0 = time.perf_counter()
            for host_batch in loader.epoch_iterator(epoch):
                loader_batches_ms.append((time.perf_counter() - t0) * 1e3)
    loader_ms = statistics.median(loader_batches_ms)
    batch, state = trainer.to_device(host_batch), trainer.state
    state, _ = trainer.gan.train_step(state, batch, trainer.base_key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = trainer.gan.train_step(state, batch, trainer.base_key)
    torch.cuda.synchronize()
    return {"loader_ms": loader_ms, "loader_batches_ms": loader_batches_ms,
            "step_ms": (time.perf_counter() - t0) * 1e3 / steps}


def phase_datasets(card: str) -> dict:
    """The raw-dataset path: SURREAL- and IsoGD-style raw trees at the raw
    frame size, ``cli.preprocess`` of each in its own process, the host
    library held bit for bit, then ``configs/surreal-segm.yml`` and
    ``configs/isogd-flow.yml`` trained at their full widths on the trees
    written. Its temporary directory is its own and goes at its end."""
    with tempfile.TemporaryDirectory(prefix="dcvgan_smoke_datasets_") as tmp:
        root = Path(tmp)
        processed = root / "processed"
        t0 = time.perf_counter()
        write_surreal_raw(root / "raw" / "surreal", RAW_VIDEOS["surreal"])
        write_isogd_raw(root / "raw" / "isogd", RAW_VIDEOS["isogd"])
        raw_mb = sum(p.stat().st_size for p in (root / "raw").rglob("*") if p.is_file()) / 1e6
        print(f"raw trees: {RAW_VIDEOS['surreal']} SURREAL and {RAW_VIDEOS['isogd']} IsoGD videos, "
              f"{raw_mb:.0f} MB, written in {time.perf_counter() - t0:.1f} s", flush=True)
        seconds = {d: preprocess_cli(d, root / "raw" / d, processed / d / "train") for d in RAW_VIDEOS}
        native_times = check_native(card)
        runs = {name: train_dataset_config(name, root, processed, card) for name in DATASET_STEPS}
    torch.cuda.empty_cache()
    return {"runs": runs, "preprocess_s": seconds, "native": native_times}


EVAL_WEIGHTS = "assets/extractor-synthetic-v2.npz"
# device-resident against host scoring: the same quantisation and the same
# extractor batches, so the same scores up to the order of float sums;
# held as tests/test_evaluator.py holds the JAX package's two paths
EVAL_RTOL, EVAL_ATOL = 1e-4, 1e-5


def phase_eval(run: dict) -> dict:
    """``Trainer.evaluate`` on the trained mug-depth state with
    ``configs/mug-depth.yml``'s own evaluation block (IS and FID of 200
    samples in rounds of 50) and the v2 extractor, the synthetic dataset as
    the real side; counters set to 0 just before and read just after, the
    fused kernel held against its plain version at a round's frame count
    (50 videos x 16) before. Then
    the device-resident sample-and-embed alone (videos embedded a second)
    and the host path, which must score the same."""
    from dcvgan_torch import prng
    from dcvgan_torch.cli.train import build_evaluator
    from dcvgan_torch.config import load_config
    from dcvgan_torch.ops.dequant import dequantize_video
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv

    trainer, logger = run["trainer"], run["logger"]
    cfg = trainer.config
    cfg.evaluation = load_config(ROOT / "configs" / "mug-depth.yml").evaluation
    cfg.evaluation.extractor_weights = EVAL_WEIGHTS
    ev = cfg.evaluation
    if (ev.batchsize, ev.num_samples, ev.metrics) != (50, 200, ["is", "fid"]):
        raise AssertionError("configs/mug-depth.yml no longer evaluates IS and FID of 200 samples in 50s")
    evaluator = trainer.evaluator = build_evaluator(cfg, run["dataset"])
    print(f"eval extractor: {evaluator.extractor.fingerprint} ({EVAL_WEIGHTS}; float32 convolutions "
          "with TF32 off)", flush=True)
    rounds = -(-ev.num_samples // ev.batchsize)
    fused_err = check_sites(ev.batchsize * cfg.video_length, "eval", cgen_sites(cfg))

    torch.cuda.reset_peak_memory_stats()
    fused_norm_act_conv.launches = 0
    dequantize_video.launches = 0
    # -- main path: counts from 0 ------------------------------------------
    t0 = time.perf_counter()
    trainer.evaluate(trainer.state.step)
    torch.cuda.synchronize()
    launches = fused_norm_act_conv.launches
    # -- end of main path ----------------------------------------------------
    eval_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != 5 * rounds:
        raise AssertionError(f"expected {5 * rounds} fused launches for {rounds} sampling rounds, "
                             f"counted {launches}")
    if dequantize_video.launches != 0:
        raise AssertionError("the eval path launched dequantize_video")
    scores = {m: logger.seen[m][-1] for m in ev.metrics}
    if not all(math.isfinite(v) for v in scores.values()):
        raise AssertionError(f"scores are not finite: {scores}")

    key = prng.named(prng.for_step(trainer.base_key, trainer.state.step), "eval")
    state = trainer.eval_state
    t0 = time.perf_counter()
    feats, probs = evaluator.sample_and_embed(trainer.gan, state, key)
    embed_s = time.perf_counter() - t0
    if feats.shape[0] != ev.num_samples or not (np.isfinite(feats).all() and np.isfinite(probs).all()):
        raise AssertionError("sample_and_embed gave the wrong count or non-finite values")
    t0 = time.perf_counter()
    host = evaluator.evaluate(trainer.gan, state, key, device_resident=False)
    host_s = time.perf_counter() - t0
    for m, v in scores.items():
        if not math.isclose(v, host[m], rel_tol=EVAL_RTOL, abs_tol=EVAL_ATOL):
            raise AssertionError(f"{m}: device-resident {v} against host {host[m]}")
    record = {
        "scores": scores, "host_scores": host, "samples": ev.num_samples, "batch": ev.batchsize,
        "real_clips": len(evaluator._real_features()), "fused_launches": launches,
        "evaluate_s": eval_s, "sample_and_embed_s": embed_s,
        "videos_embedded_per_s": ev.num_samples / embed_s, "host_path_s": host_s,
        "peak_gb": peak_gb, "fingerprint": evaluator.extractor.fingerprint, "fused_err": fused_err,
    }
    print("eval " + json.dumps(record), flush=True)
    print(f"eval: Trainer.evaluate {eval_s:.3f} s (with the real side); device-resident sample and embed "
          f"of {ev.num_samples} videos {embed_s:.3f} s = {record['videos_embedded_per_s']:.1f} videos/s; "
          f"host path {host_s:.3f} s; peak device memory {peak_gb:.2f} GB", flush=True)
    return record


def phase_infer(run: dict, fingerprint: str) -> dict:
    """``cli.infer`` on the train phase's run directory (40 videos in
    rounds of 20; the fused kernel held against its plain version at a
    round's 320 frames first), every mp4 read back, then ``cli.evaluate`` of
    the colour directory."""
    from dcvgan_torch.cli import evaluate as cli_evaluate
    from dcvgan_torch.cli import infer as cli_infer
    from dcvgan_torch.io.video import read_video
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv

    run_dir = run["trainer"].run_dir
    save = Path(run["tmp"].name) / "generated"
    n, b = 40, 20
    fused_err = check_sites(b * run["trainer"].config.video_length, "infer",
                            cgen_sites(run["trainer"].config))
    fused_norm_act_conv.launches = 0
    # -- main path: counts from 0 ------------------------------------------
    t0 = time.perf_counter()
    cli_infer.main([str(run_dir), "-1", str(save), "-n", str(n), "-b", str(b)])
    torch.cuda.synchronize()
    launches = fused_norm_act_conv.launches
    # -- end of main path ----------------------------------------------------
    infer_s = time.perf_counter() - t0
    if launches != 5 * (n // b):
        raise AssertionError(f"expected {5 * (n // b)} fused launches, counted {launches}")
    for sub in ("color", "depth"):
        files = sorted((save / sub).glob("*.mp4"))
        if [p.name for p in files] != [f"{i:06d}.mp4" for i in range(n)]:
            raise AssertionError(f"cli.infer wrote {len(files)} files under {sub}/, not {n}")
        for p in files:
            v = read_video(p)
            if v.shape != (16, 64, 64, 3) or v.dtype != np.uint8:
                raise AssertionError(f"{sub}/{p.name} reads back as {v.shape} {v.dtype}")
    t0 = time.perf_counter()
    scores = cli_evaluate.main([str(save / "color"), "--metrics", "is", "--batchsize", str(b),
                                "--weights", str(ROOT / EVAL_WEIGHTS)])
    evaluate_s = time.perf_counter() - t0
    if scores["extractor"] != fingerprint or not math.isfinite(scores["is"]):
        raise AssertionError(f"cli.evaluate printed {scores}")
    record = {"videos": n, "batch": b, "infer_s": infer_s, "fused_launches": launches,
              "evaluate_dir_s": evaluate_s, "scores": scores, "fused_err": fused_err}
    print("infer " + json.dumps(record), flush=True)
    return record


# the two server shapes the HTTP mix runs at: GenerationServer's defaults
# (64 videos a chunk) and the CLI's (256 x 4 rounds)
HTTP_SHAPES = [(64, 1), (256, 4)]
# the mix: 4 client threads, each sending 16 unseeded n=16 colour requests
# one after another (closed loop), 64 requests and 1,024 videos in all
MIX_CLIENTS, MIX_REQUESTS, MIX_N = 4, 16, 16
SEEDED_N = 1100  # a seeded request over two chunks of 256 x 4


def http_request(port: int, path: str, body: bytes | None = None):
    """(status, headers, body) of one request to the in-process server:
    POST when ``body`` is given, else GET."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("GET" if body is None else "POST", path, body=body)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def expect_status(port: int, path: str, want: int, body: bytes | None = None):
    status, headers, data = http_request(port, path, body)
    if status != want:
        raise AssertionError(f"{path}: HTTP {status}, not {want} ({data[:200]!r})")
    return headers, data


def npy_bytes(array: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, array)
    return buf.getvalue()


def rss_mb() -> float:
    """This process's resident set, MB."""
    with open("/proc/self/status") as f:
        kb = next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))
    return kb / 1024


def unseeded_clients(port: int, clients: int, requests: int, video_shape: tuple) -> dict:
    """``clients`` threads, each sending ``requests`` unseeded n=MIX_N colour
    requests one after another; a 429 is retried after 1 ms (and counted);
    any other answer than 200 with the exact npy header and length fails.
    Returns the latencies (send to last byte, s), the wall time and the
    retries."""
    hdr = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        hdr, {"descr": "|u1", "fortran_order": False, "shape": (MIX_N,) + video_shape})
    header = hdr.getvalue()
    length = len(header) + MIX_N * math.prod(video_shape)
    lat, retries, failures = [], [0], []
    lock = threading.Lock()

    def client():
        try:
            for _ in range(requests):
                t0 = time.perf_counter()
                while True:
                    status, _, data = http_request(port, f"/generate?n={MIX_N}")
                    if status != 429:
                        break
                    with lock:
                        retries[0] += 1
                    time.sleep(0.001)
                dt = time.perf_counter() - t0
                if status != 200 or len(data) != length or data[:len(header)] != header:
                    raise AssertionError(f"HTTP {status}, {len(data)} bytes ({length} expected)")
                with lock:
                    lat.append(dt)
        except Exception as e:  # reported below, which fails the run
            failures.append(e)

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if failures or any(t.is_alive() for t in threads) or len(lat) != clients * requests:
        raise AssertionError(f"HTTP clients failed: {failures[:3]}")
    return {"latencies": lat, "wall_s": wall, "retries": retries[0]}


def http_behaviour(server, port: int) -> dict:
    """What the front end must do, at the CLI's server shape (256 x 4):
    seeded bytes across two chunks equal ``generate`` in this process, by
    GET and by POST; a geo npz equals ``generate(with_geo=True)``; one 400,
    one 413 and one 429. Returns the requests sent and the chunks they
    dispatched."""
    per_chunk = server.batchsize * server.iters
    n = SEEDED_N
    if not per_chunk < n <= 2 * per_chunk:
        raise AssertionError(f"n={n} does not span two chunks of {per_chunk}")
    health = json.loads(expect_status(port, "/healthz", 200)[1])
    if health["device"] != torch.cuda.get_device_name(0) or health["batchsize"] != server.batchsize:
        raise AssertionError(f"/healthz says {health}")
    headers, got = expect_status(port, f"/generate?n={n}&seed=11", 200)
    _, posted = expect_status(port, "/generate", 200, json.dumps({"n": n, "seed": 11}).encode())
    _, color = server.generate(n, 11)
    want = npy_bytes(color)
    if got != want or posted != want or int(headers["Content-Length"]) != len(want):
        raise AssertionError("seeded HTTP bytes differ from GenerationServer.generate")
    if headers["X-Video-Shape"] != "x".join(map(str, color.shape)):
        raise AssertionError(f"X-Video-Shape {headers['X-Video-Shape']}")
    headers, npz = expect_status(port, "/generate?n=8&seed=5&geo=1", 200)
    geo, color = server.generate(8, 5, with_geo=True)
    arrays = np.load(io.BytesIO(npz))
    if not (np_equal(arrays["color"], color) and np_equal(arrays["geo"], geo)):
        raise AssertionError("the geo npz differs from generate(with_geo=True)")
    if headers["Content-Type"] != "application/x-npz" or geo.shape != (8,) + server.video_shape[:-1] + (1,):
        raise AssertionError(f"geo response {headers['Content-Type']} {geo.shape}")
    expect_status(port, "/generate?n=0", 400)  # the one deliberate error
    limit = server.max_request_videos
    err = json.loads(expect_status(port, f"/generate?n={limit + 1}", 413)[1])
    if err["max_request_videos"] != limit:
        raise AssertionError(f"413 body {err}")
    taken = 0
    while server.admit():
        taken += 1
    try:
        headers, _ = expect_status(port, "/generate?n=1", 429)
    finally:
        for _ in range(taken):
            server.release()
    if taken != 4 or headers.get("Retry-After") != "1":
        raise AssertionError(f"{taken} admission slots, Retry-After {headers.get('Retry-After')}")
    print(f"http behaviour: seeded n={n} over two chunks equals generate by GET and POST "
          f"({len(want)} bytes), geo n=8 npz equals generate, 400 / 413 / 429 seen", flush=True)
    # 2 GET/POST + generate of n, 1 geo GET + generate; 2 chunks each for n
    return {"requests": 5, "videos": 3 * n + 2 * 8, "errors": 1, "rejected": 2, "chunks": 3 * 2 + 2}


def http_shape(gan, state, batch: int, iters: int, card: str, behaviour: bool) -> dict:
    """One server shape: ``serve_http`` in-process on a daemon thread, the
    behaviour checks where asked, the timed mix, then one profiled round
    of the mix's load (4 concurrent n=16 requests). Returns the record and
    the cgen forwards of every chunk the server dispatched."""
    from dcvgan_torch.cli.serve import GenerationServer, serve_http
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv

    torch.cuda.reset_peak_memory_stats()
    server = GenerationServer(gan, state, batchsize=batch, iters_per_chunk=iters, geo_name="depth",
                              max_concurrent=4, batch_window_ms=5.0)
    httpd = serve_http(server, 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        sent = http_behaviour(server, port) if behaviour else {
            "requests": 0, "videos": 0, "errors": 0, "rejected": 0, "chunks": 0}
        before = dict(server.counters)
        rss_before = rss_mb()
        mix = unseeded_clients(port, MIX_CLIENTS, MIX_REQUESTS, server.video_shape)
        rss_after = rss_mb()
        chunks = server.counters["batched_chunks"] - before["batched_chunks"]
        capacity = batch * iters
        lat = np.array(mix["latencies"]) * 1e3
        record = {
            "batch": batch, "iters_per_chunk": iters, "window_ms": 5.0, "max_concurrent": 4,
            "clients": MIX_CLIENTS, "requests": len(lat), "n": MIX_N,
            "p50_ms": float(np.percentile(lat, 50)), "p90_ms": float(np.percentile(lat, 90)),
            "p99_ms": float(np.percentile(lat, 99)), "max_ms": float(lat.max()),
            "mix_s": mix["wall_s"], "videos_per_s": MIX_CLIENTS * MIX_REQUESTS * MIX_N / mix["wall_s"],
            "batched_chunks": chunks,
            "delivered_share": MIX_CLIENTS * MIX_REQUESTS * MIX_N / (chunks * capacity),
            "retried_429": mix["retries"], "rss_mb_before": rss_before, "rss_mb_after": rss_after,
            "latencies_ms": lat.tolist(),  # in the order the requests ended
        }
        retried = [mix["retries"]]

        def one_round():  # the mix's load for one round: each client's one request
            retried.append(unseeded_clients(port, MIX_CLIENTS, 1, server.video_shape)["retries"])

        prof = profile_once(one_round, f"http profile {batch}x{iters}", {"batch": batch, "iters": iters},
                            {"fused_norm_act_conv": fused_norm_act_conv})
        record["profiled_round_idle_share"] = prof.get("device_idle_share")
        record["profiled_round_wall_ms"] = prof.get("wall_ms")
        record["rss_mb_after_profile"] = rss_mb()
        record["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
        stats = json.loads(expect_status(port, "/stats", 200)[1])
        mixed = MIX_CLIENTS * MIX_REQUESTS + 2 * MIX_CLIENTS  # the mix and the two traced rounds
        want = {
            "requests": sent["requests"] + mixed, "batched_requests": mixed,
            "videos_served": sent["videos"] + mixed * MIX_N, "errors": sent["errors"],
            "rejected": sent["rejected"] + sum(retried),
        }
        if {k: stats[k] for k in want} != want:
            raise AssertionError(f"/stats says {stats}, the phase sent {want}")
        record["stats"] = {k: stats[k] for k in server.counters}
        dispatched = 1 + sent["chunks"] + stats["batched_chunks"]  # 1: the warm-up at construction
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        server.close()
    print(f"http {batch}x{iters} " + json.dumps(record), flush=True)
    print(f"http {batch}x{iters}: {len(lat)} requests of n={MIX_N} from {MIX_CLIENTS} clients, latency "
          f"p50 {record['p50_ms']:.2f} p90 {record['p90_ms']:.2f} p99 {record['p99_ms']:.2f} "
          f"max {record['max_ms']:.2f} ms; {record['videos_per_s']:.1f} videos/s delivered; {chunks} "
          f"chunks, delivered share {record['delivered_share']:.4f}; idle share of a profiled round "
          f"{record['profiled_round_idle_share']}; RSS {rss_before:.0f} -> {rss_after:.0f} MB; "
          f"on {card}", flush=True)
    return {"record": record, "forwards": dispatched * iters}


def phase_http(run: dict, card: str) -> dict:
    """The HTTP front end of ``cli.serve`` on the train phase's run
    directory (loaded through ``load_run``, EMA where there is one): the
    behaviour checks and the mix at both server shapes, then ``cli.serve``'s
    run-directory form into the mp4 sink (2 chunks of 64 with geometry, 128
    + 128 files read back). The fused kernel is held against its plain
    version at the 64 x 1 server's 1,024 frames first; counters set to 0
    just before and read just after: 5 launches per cgen forward."""
    from dcvgan_torch.cli import serve as cli_serve
    from dcvgan_torch.cli.infer import load_run
    from dcvgan_torch.io.video import read_video
    from dcvgan_torch.ops.dequant import dequantize_video
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv

    run_dir = run["trainer"].run_dir
    cfg, gan, trained = load_run(run_dir, -1)
    state = trained.generators().with_ema_params()
    out = Path(run["tmp"].name) / "served"
    fused_err = check_sites(HTTP_SHAPES[0][0] * cfg.video_length, "http", cgen_sites(cfg))
    fused_norm_act_conv.launches = 0
    dequantize_video.launches = 0
    # -- main path: counts from 0 ------------------------------------------
    t0 = time.perf_counter()
    shapes = [http_shape(gan, state, b, it, card, behaviour=(b, it) == HTTP_SHAPES[-1])
              for b, it in HTTP_SHAPES]
    stats = cli_serve.main([str(run_dir), "-1", "--sink", "mp4", "--out", str(out), "-b", "64",
                            "--iters-per-chunk", "1", "--chunks", "2", "--with-geo"])
    torch.cuda.synchronize()
    launches = fused_norm_act_conv.launches
    # -- end of main path ----------------------------------------------------
    http_s = time.perf_counter() - t0
    forwards = sum(s["forwards"] for s in shapes) + 1 + 2  # cli.serve: warm-up + 2 chunks of 1 round
    print(f"http phase: {http_s:.1f} s; fused_norm_act_conv launches {launches} for {forwards} cgen "
          "forwards", flush=True)
    if launches != 5 * forwards:
        raise AssertionError(f"expected {5 * forwards} fused launches, counted {launches}")
    if dequantize_video.launches != 0:
        raise AssertionError("the HTTP path launched dequantize_video")
    for sub in ("color", "depth"):
        files = sorted((out / sub).glob("*.mp4"))
        if [p.name for p in files] != [f"{i:06d}.mp4" for i in range(128)]:
            raise AssertionError(f"cli.serve wrote {len(files)} mp4 files under {sub}/, not 128")
        for p in files:
            v = read_video(p)
            if v.shape != (16, 64, 64, 3) or v.dtype != np.uint8:
                raise AssertionError(f"{sub}/{p.name} reads back as {v.shape} {v.dtype}")
    print(f"cli.serve <run> -1 --sink mp4: 128 + 128 files read back as (16, 64, 64, 3) uint8 "
          f"({stats['total_s_incl_writes']} s with writes)", flush=True)
    return {"fused_launches": launches, "fused_err": fused_err, "http_s": http_s,
            "shapes": [s["record"] for s in shapes]}


# ----------------------------------------------------------- data parallel
# (a) world 1 over NCCL through torchrun: the flagship for 12 steps (4
# epochs of 3 batches), cuDNN held to deterministic algorithms, its first 3
# steps' losses against the single-process trainer of the same seed, bit
# for bit. (b) two gloo ranks sharing cuda:0: global batch 20 (10 rows a
# rank) in f32 with TF32 off for 3 steps against one rank at batch 20 with
# the same global-batch BatchNorm arithmetic, per-replica statistics for 6
# steps (both ranks' states hash equal), and the bf16 flagship's it/s over
# 18 steps. (c) the f32 run's evaluation over both ranks against one rank's.
# (d) two serving replicas on cuda:0.
DP_NCCL_EPOCHS, DP_REPLAY_STEPS = 4, 3
DP_TIMED_EPOCHS = 6
# (b) two ranks against one rank that runs the same global-batch BatchNorm
# arithmetic (s1, s2 sums through all_reduce_sum, DCVGAN.global_batch
# forced, as tests/torch_dist_util.py does on the CPU), both with cuDNN held
# to deterministic algorithms; a one-rank run with per-rank BatchNorm
# (native_batch_norm) is printed beside them as a control. Only rounding
# differs (the sums' order over two ranks of 10 rows against one of 20;
# cuDNN's kernels at batch 10 and 20), but Adam's first step moves a
# parameter by about lr whatever its gradient's size, so a gradient of
# rounding noise steps either way, and the generators' gradients are taken
# after the critics' first update. Held: the first step's losses within
# JAX's cross-topology tolerance, 5e-4 relative (tests/test_multihost.py:253),
# later steps' within 1e-2; by model, the first step's gradients (what each
# optimizer receives after the all-reduce) and the updates of the 3 steps
# (parameters less their init) by relative L2. These limits were set from
# the readings of two measurement runs on an NVIDIA H100 80GB HBM3 at
# 700.00 W, equal to the last digit (two ranks against one: losses 9.6e-7
# at the first step, 1.6e-3 at the third; gradients 1.3e-6 to 1.1e-4 for
# the critics, 2.3e-3 and 2.9e-3 for the generators; updates 0.015-0.033 and
# 0.118-0.128), 2-10 times above them and below what a backward without the
# all-reduce gives at ngf 8 on the CPU (gradients 0.24-0.50, updates
# 0.49-0.81; tests/test_torch_data_parallel_lesion.py).
DP_LOSS_RTOL, DP_LATER_LOSS_RTOL = 5e-4, 1e-2
DP_GRAD_L2 = {"critics": 1e-3, "generators": 2e-2}
DP_UPDATE_L2 = {"critics": 0.1, "generators": 0.3}
# two serving replicas on one card against one replica: each samples its
# half of the round at half the batch, where cuDNN may pick other
# algorithms, so a bf16 output may round to a neighbouring value and a byte
# move by a quantisation level (stated before the first run on the card)
DP_SERVE_MAX_LEVELS, DP_SERVE_MAX_SHARE = 2, 1e-2


def dp_config(run: dict, root: Path, name: str, epochs: int, precision: str = "bfloat16",
              sync: bool = True, evaluation: bool = False, mesh: dict | None = None) -> tuple:
    """The train phase's config (mug-depth on its synthetic tree) as run
    ``name`` under ``root``, with ``mesh``'s axes: ``(config, path of its
    YAML)``."""
    from dcvgan_torch.config import load_config, save_config

    base = run["trainer"].config
    cfg = train_config(root)
    cfg.dataset.path, cfg.dataset.processed_root = base.dataset.path, base.dataset.processed_root
    cfg.experiment_name, cfg.n_epochs, cfg.log_interval = name, epochs, 1 if epochs < DP_TIMED_EPOCHS else LOG_EVERY
    cfg.log_dir, cfg.tensorboard_dir = str(root / name / "result"), str(root / name / "runs")
    cfg.trainer.precision, cfg.trainer.sync_batchnorm = precision, sync
    for axis, size in (mesh or {}).items():
        setattr(cfg.mesh, axis, size)
    if evaluation:
        cfg.evaluation = load_config(ROOT / "configs" / "mug-depth.yml").evaluation
        cfg.evaluation.extractor_weights = EVAL_WEIGHTS
    path = root / f"{name}.yml"
    path.parent.mkdir(parents=True, exist_ok=True)
    save_config(cfg, path)
    return cfg, path


def state_sha256(state) -> str:
    """One hash of every model's parameters and statistics and the EMA."""
    import hashlib

    h = hashlib.sha256()
    for name, module in state.models.items():
        for k, v in module.state_dict().items():
            h.update(f"{name}.{k}".encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    for name, avg in (state.ema or {}).items():
        for k in sorted(avg):
            h.update(avg[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def child(spec_path: str) -> int:
    """A rank that ``torchrun`` started: each run of the spec through
    ``cli.train.main`` (which joins the group), the train step's losses and
    the logger's values recorded, counters from 0 just before each run and
    read just after; prints one ``CHILD {...}`` line a run. A run's
    ``global_batch_norm`` forces the global-batch arithmetic in a world of
    one rank; its ``grads`` names a file where rank 0 saves the first step's
    reduced gradients and the parameters after it, flat f32 by model."""
    import torch.distributed as dist

    from dcvgan_torch import prng
    from dcvgan_torch.cli import train as cli_train
    from dcvgan_torch.logging.logger import Logger
    from dcvgan_torch.ops.dequant import dequantize_video
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv
    from dcvgan_torch.parallel import temporal
    from dcvgan_torch.train.step import DCVGAN
    from dcvgan_torch.train.trainer import LOSS_NAMES

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(os.environ["RANK"])
    losses, seen, grads, step1 = [], {}, {}, {}
    train_step, update, average = DCVGAN.train_step, Logger.update, DCVGAN._average
    global_batch = DCVGAN.global_batch
    exchange, halos = temporal._exchange, [0]

    def counting(*args, **kwargs):
        # one time-sharded halo exchange, forward or backward
        halos[0] += 1
        return exchange(*args, **kwargs)

    temporal._exchange = counting

    def recording(self, *args, **kwargs):
        state, m = train_step(self, *args, **kwargs)
        losses.append(torch.stack([m[k] for k in LOSS_NAMES]))
        if not step1:
            with torch.no_grad():
                step1.update({name: torch.cat([p.float().flatten() for p in module.parameters()]).cpu()
                              for name, module in state.models.items()})
        return state, m

    def averaging(self, tensors, state, names):
        average(self, tensors, state, names)
        if names[0] in grads:
            return
        i = 0  # tensors: the models' gradients in order, then the losses
        for name in names:
            n = len(list(getattr(state, name).parameters()))
            grads[name] = torch.cat([t.float().flatten() for t in tensors[i: i + n]]).cpu()
            i += n

    def keep(self, name, value):
        seen.setdefault(name, []).append(value)
        update(self, name, value)

    DCVGAN.train_step, Logger.update, DCVGAN._average = recording, keep, averaging
    for spec in json.loads(Path(spec_path).read_text()):
        torch.backends.cudnn.deterministic = spec.get("deterministic", False)
        if spec.get("global_batch_norm"):
            DCVGAN.global_batch = property(lambda self: True)
        losses.clear()
        seen.clear()
        grads.clear()
        step1.clear()
        torch.cuda.reset_peak_memory_stats()
        fused_norm_act_conv.launches = 0
        dequantize_video.launches = 0
        halos[0] = 0
        # -- main path: counts from 0 --------------------------------------
        t0 = time.perf_counter()
        trainer = cli_train.main(spec["argv"])
        torch.cuda.synchronize()
        fused, dequant = fused_norm_act_conv.launches, dequantize_video.launches
        # -- end of main path ------------------------------------------------
        lay = trainer.layout
        rec = {"run": spec["name"], "rank": rank, "world": lay.world,
               "layout": [lay.dcn, lay.data, lay.time, lay.row, lay.time_index],
               "device": str(trainer.device), "steps": trainer.state.step, "train_s": time.perf_counter() - t0,
               "dequant_launches": dequant, "fused_launches": fused, "halo_exchanges": halos[0],
               "losses": torch.stack(losses).cpu().tolist(), "iters_per_sec": seen.get("iters_per_sec", []),
               "state_sha256": state_sha256(trainer.state),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if rank == 0:
            rec["restored_equal"] = check_restore(trainer, trainer.state, trainer.config)
            if spec.get("grads"):
                torch.save({"grads": grads, "step1": step1}, spec["grads"])
        if spec.get("evaluate"):
            fused_norm_act_conv.launches = 0
            key = prng.named(prng.for_step(trainer.base_key, trainer.state.step), "eval")
            # -- main path: counts from 0 ----------------------------------
            rec["scores"] = trainer.evaluator.evaluate(trainer.gan, trainer.eval_state, key)
            torch.cuda.synchronize()
            rec["eval_fused_launches"] = fused_norm_act_conv.launches
            # -- end of main path --------------------------------------------
        torch.backends.cudnn.deterministic = False
        DCVGAN.global_batch = global_batch
        print("CHILD " + json.dumps(rec), flush=True)
    dist.destroy_process_group()
    return 0


def torchrun(nproc: int, specs: list, root: Path, label: str, timeout: float = 600.0) -> dict:
    """``torchrun --standalone --nproc_per_node nproc chip_smoke.py --child``
    of ``specs``; returns ``{run name: [record of rank 0, rank 1, ...]}``. The
    whole process group is killed if it outlives ``timeout``."""
    import signal

    spec = root / f"{label}.json"
    spec.write_text(json.dumps(specs))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), str(ROOT / "chip_smoke.py"), "--child", str(spec)]
    print("launch: torchrun " + " ".join(cmd[3:]), flush=True)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=ROOT, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    log = root / f"{label}.log"
    log.write_text(out)
    if proc.returncode != 0:
        print(out[-8000:], flush=True)
        raise AssertionError(f"torchrun {label} exited {proc.returncode}")
    records: dict = {}
    for line in out.splitlines():
        if line.startswith("CHILD "):
            rec = json.loads(line[len("CHILD "):])
            records.setdefault(rec["run"], [None] * nproc)[rec["rank"]] = rec
    for s in specs:
        if s["name"] not in records or None in records[s["name"]]:
            raise AssertionError(f"torchrun {label}: run {s['name']} printed no record on some rank")
    return records


def check_dp_run(recs: list, cfg, path: str) -> None:
    """Each rank ran the config's steps, finite losses, first critic losses
    near 2 ln 2, one dequant launch a step on every rank, fused launches
    only in log_samples on rank 0 (step 0 and the end) and, where the config
    evaluates, in the step-0 evaluation's rounds on every rank, every rank's
    state equal, rank 0's checkpoint restores equal tensors."""
    rounds = 0
    if cfg.evaluation.metrics:
        rounds = -(-cfg.evaluation.num_samples // cfg.evaluation.batchsize)
    steps = cfg.n_epochs * (64 // cfg.batchsize)
    for r in recs:
        if r["steps"] != steps or r["dequant_launches"] != steps or len(r["losses"]) != steps:
            raise AssertionError(f"{path} rank {r['rank']}: {r['steps']} steps, {r['dequant_launches']} "
                                 f"dequant launches, {len(r['losses'])} losses; expected {steps}")
        if not all(math.isfinite(x) for row in r["losses"] for x in row):
            raise AssertionError(f"{path} rank {r['rank']}: a loss is not finite")
        first = r["losses"][0][1:]  # loss_gen first, then the critics
        if any(abs(x - 2 * math.log(2)) > 0.2 for x in first):
            raise AssertionError(f"{path}: first critic losses {first} not within 0.2 of 2 ln 2")
        want = 5 * rounds + (5 * 2 if r["rank"] == 0 else 0)
        if r["fused_launches"] != want:
            raise AssertionError(f"{path} rank {r['rank']}: {r['fused_launches']} fused launches, "
                                 f"expected {want}")
    if len({r["state_sha256"] for r in recs}) != 1:
        raise AssertionError(f"{path}: the ranks' states differ")
    if recs[0].get("restored_equal", 0) <= 0:
        raise AssertionError(f"{path}: rank 0's checkpoint did not restore")
    print(f"{path}: {len(recs)} rank(s) x {steps} steps, dequant launches "
          f"{[r['dequant_launches'] for r in recs]}, fused launches {[r['fused_launches'] for r in recs]}, "
          f"states equal (sha256 {recs[0]['state_sha256'][:16]}), first step "
          f"{dict(zip(('loss_gen', 'loss_idis', 'loss_vdis', 'loss_gdis'), recs[0]['losses'][0]))}",
          flush=True)


def one_process_run(cfg, steps: int) -> tuple:
    """The flagship's single-process trainer on ``cfg`` in this process:
    ``(losses a step, trainer)``."""
    from dcvgan_torch.cli.train import build_dataset
    from dcvgan_torch.train.trainer import LOSS_NAMES, Trainer

    run_dir = Path(cfg.log_dir) / cfg.experiment_name
    logger = recorder(run_dir)
    trainer = Trainer(cfg, build_dataset(cfg), logger=logger)
    trainer.train()
    torch.cuda.synchronize()
    losses = [[logger.seen[k][i] for k in LOSS_NAMES] for i in range(steps)]
    return losses, trainer


def initial_params(cfg) -> dict:
    """Every model's initial parameters for ``cfg``'s seed, flat f32 on the
    host, by model."""
    from dcvgan_torch.train.step import DCVGAN

    init = DCVGAN(cfg).init_state(cfg.seed)
    with torch.no_grad():
        return {m: torch.cat([p.flatten() for p in init.models[m].parameters()]).cpu() for m in init.models}


def saved_run(rec: dict, name: str, root: Path, cfg, p0: dict) -> dict:
    """A child run's losses, the first step's reduced gradients and update
    (saved by rank 0), its final state from its checkpoint, and the
    parameters' moves from ``p0``."""
    from dcvgan_torch.train.checkpoint import CheckpointManager
    from dcvgan_torch.train.step import DCVGAN

    saved = torch.load(root / f"{name}.pt")
    state = CheckpointManager(root / name / "result" / name / "models").restore(
        DCVGAN(cfg).init_state(cfg.seed + 1))
    with torch.no_grad():
        moved = {m: torch.cat([p.flatten() for p in state.models[m].parameters()]).cpu() - p0[m]
                 for m in p0}
    return {"losses": rec["losses"], "grads": saved["grads"], "state": state, "moved": moved,
            "first": {m: saved["step1"][m] - p0[m] for m in p0}}


def compare_runs(x: dict, y: dict) -> dict:
    """Two ``saved_run``s: the losses' relative differences by step, and by
    model the relative L2 distances of the first step's gradients and
    update and of all the steps' updates."""
    return {"loss_rel_by_step": [max(abs(u - v) / abs(v) for u, v in zip(ra, rb))
                                 for ra, rb in zip(x["losses"], y["losses"])],
            "first_step_grads_rel_l2": rel_l2(x["grads"], y["grads"]),
            "first_step_updates_rel_l2": rel_l2(x["first"], y["first"]),
            "updates_rel_l2": rel_l2(x["moved"], y["moved"])}


def within_dp_limits(held: dict) -> bool:
    """A ``compare_runs`` within the DP_* limits."""
    roles = {m: "critics" if m in ("idis", "vdis", "gdis") else "generators"
             for m in held["updates_rel_l2"]}
    return (held["loss_rel_by_step"][0] <= DP_LOSS_RTOL
            and max(held["loss_rel_by_step"]) <= DP_LATER_LOSS_RTOL
            and all(v <= DP_GRAD_L2[roles[m]] for m, v in held["first_step_grads_rel_l2"].items())
            and all(v <= DP_UPDATE_L2[roles[m]] for m, v in held["updates_rel_l2"].items()))


def rounded(d: dict) -> str:
    return json.dumps({k: ([float(f"{x:.3e}") for x in v] if isinstance(v, list)
                           else {m: float(f"{x:.3e}") for m, x in v.items()}) for k, v in d.items()})


def phase_data_parallel(run: dict, card: str) -> dict:
    """The data-parallel path (module docstring, phase 12)."""
    from dcvgan_torch import prng
    from dcvgan_torch.cli.infer import load_run
    from dcvgan_torch.cli.serve import GenerationServer
    from dcvgan_torch.cli.train import build_evaluator
    from dcvgan_torch.data.loader import VideoLoader
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv
    from dcvgan_torch.train.step import DCVGAN

    root = Path(run["tmp"].name) / "dp"
    base = run["trainer"].config
    # both kernels at this path's shapes first: a rank's batch of 10 rows,
    # log_samples' and a rank's evaluation round (25 videos, 400 frames),
    # a serving replica's half of 256 (2,048 frames)
    with VideoLoader(run["dataset"], base.batchsize, n_workers=2, seed=1, process_index=1,
                     process_count=2, shard_divisor=2) as loader:
        rank_batch = {k: torch.from_numpy(v).cuda() for k, v in loader.fetch_batch(0).items()}
    if rank_batch["color"].shape[0] != base.batchsize // 2:
        raise AssertionError("the loader's rank slice is not half the global batch")
    dequant_err = check_dequant_batch(rank_batch, "data-parallel rank batch")
    fused_err = max(check_sites(25 * base.video_length, "data-parallel log_samples / eval rank round",
                                cgen_sites(base)),
                    check_sites(128 * base.video_length, "serving replica", cgen_sites(base)))

    # (a) world 1 over NCCL, then the single-process trainer; in the same
    # launch, (b)'s references: one rank with the global-batch arithmetic,
    # and one with per-rank BatchNorm (native_batch_norm) as a control
    cfg_a, path_a = dp_config(run, root, "dp-nccl", DP_NCCL_EPOCHS)
    cfg_r, path_r = dp_config(run, root, "dp-sync-f32-one", 1, precision="float32")
    cfg_c, path_c = dp_config(run, root, "dp-native-f32-one", 1, precision="float32")
    nccl = ["--dist-backend", "nccl"]
    recs_a = torchrun(1, [
        {"name": "nccl", "deterministic": True, "argv": ["--config", str(path_a)] + nccl},
        {"name": "ref", "deterministic": True, "global_batch_norm": True, "grads": str(root / "dp-sync-f32-one.pt"),
         "argv": ["--config", str(path_r)] + nccl},
        {"name": "control", "deterministic": True, "grads": str(root / "dp-native-f32-one.pt"),
         "argv": ["--config", str(path_c)] + nccl},
    ], root, "nccl")
    check_dp_run(recs_a["nccl"], cfg_a, "torchrun world 1 nccl")
    check_dp_run(recs_a["ref"], cfg_r, "torchrun world 1 nccl, f32, global-batch BatchNorm arithmetic")
    check_dp_run(recs_a["control"], cfg_c, "torchrun world 1 nccl, f32, per-rank BatchNorm")
    cfg_1, _ = dp_config(run, root, "dp-single", 1)
    torch.backends.cudnn.deterministic = True
    single, _ = one_process_run(cfg_1, DP_REPLAY_STEPS)
    torch.backends.cudnn.deterministic = False
    replay = recs_a["nccl"][0]["losses"][:DP_REPLAY_STEPS]
    print(f"torchrun world 1 against the single-process trainer, first {DP_REPLAY_STEPS} steps, "
          f"deterministic cuDNN: equal bits {replay == single}; max |diff| "
          f"{max(abs(a - b) for ra, rb in zip(replay, single) for a, b in zip(ra, rb)):.3e}", flush=True)
    if replay != single:
        raise AssertionError("torchrun world 1 and the single-process trainer differ")

    # (b) + (c): two gloo ranks sharing cuda:0
    cfg_s, path_s = dp_config(run, root, "dp-sync-f32", 1, precision="float32", evaluation=True)
    cfg_p, path_p = dp_config(run, root, "dp-replica", 2, sync=False)
    cfg_t, path_t = dp_config(run, root, "dp-timed", DP_TIMED_EPOCHS)
    gloo = ["--dist-backend", "gloo", "--device", "cuda:0"]
    recs = torchrun(2, [
        {"name": "sync", "deterministic": True, "grads": str(root / "dp-sync-f32.pt"),
         "argv": ["--config", str(path_s)] + gloo, "evaluate": True},
        {"name": "replica", "argv": ["--config", str(path_p)] + gloo},
        {"name": "timed", "argv": ["--config", str(path_t)] + gloo},
    ], root, "gloo")
    check_dp_run(recs["sync"], cfg_s, "2 gloo ranks on cuda:0, f32 global batch")
    check_dp_run(recs["replica"], cfg_p, "2 gloo ranks on cuda:0, per-replica statistics")
    check_dp_run(recs["timed"], cfg_t, "2 gloo ranks on cuda:0, bf16 flagship")
    if [r["world"] for r in recs["sync"]] != [2, 2] or {r["device"] for r in recs["sync"]} != {"cuda:0"}:
        raise AssertionError("the gloo ranks are not 2 on cuda:0")

    p0 = initial_params(cfg_s)
    seen = {key: saved_run(rec, name, root, cfg_s, p0) for key, (rec, name) in {
        "two": (recs["sync"][0], "dp-sync-f32"), "ref": (recs_a["ref"][0], "dp-sync-f32-one"),
        "control": (recs_a["control"][0], "dp-native-f32-one")}.items()}
    held = compare_runs(seen["two"], seen["ref"])
    print(f"2 gloo ranks against one rank with the same global-batch BatchNorm arithmetic, f32 at global "
          f"batch 20, {len(seen['two']['losses'])} steps, deterministic cuDNN on both: {rounded(held)} "
          f"(held at: losses {DP_LOSS_RTOL:g} relative at the first step, {DP_LATER_LOSS_RTOL:g} later; "
          f"relative L2 by model: the first step's gradients {json.dumps(DP_GRAD_L2)}, the updates of "
          f"all steps {json.dumps(DP_UPDATE_L2)})", flush=True)
    print(f"control, one rank with per-rank BatchNorm (native_batch_norm) against the same one rank: "
          f"{rounded(compare_runs(seen['control'], seen['ref']))}; 2 gloo ranks against it: "
          f"{rounded(compare_runs(seen['two'], seen['control']))}", flush=True)
    if not within_dp_limits(held):
        raise AssertionError("2 gloo ranks and one rank disagree beyond the stated tolerance")
    loss_rel = max(held["loss_rel_by_step"])
    two_state = seen["two"]["state"]

    # (c) the f32 run's evaluation over the ranks against one rank's
    evaluator = build_evaluator(cfg_s, run["dataset"])
    key = prng.named(prng.for_step(prng.base_key(cfg_s.seed, "cuda"), two_state.step), "eval")
    eval_state = two_state.with_ema_params() if cfg_s.trainer.ema_eval else two_state
    want = evaluator.evaluate(DCVGAN(cfg_s), eval_state, key)
    rounds = -(-cfg_s.evaluation.num_samples // cfg_s.evaluation.batchsize)
    for r in recs["sync"]:
        got = r["scores"]
        if r["eval_fused_launches"] != 5 * rounds:
            raise AssertionError(f"rank {r['rank']}: {r['eval_fused_launches']} fused launches in "
                                 f"{rounds} evaluation rounds, expected {5 * rounds}")
        for m, v in want.items():
            if not math.isclose(got[m], v, rel_tol=EVAL_RTOL, abs_tol=EVAL_ATOL):
                raise AssertionError(f"{m} over 2 ranks {got[m]} against one rank {v}")
    print(f"evaluation over 2 gloo ranks ({cfg_s.evaluation.batchsize // 2} videos a rank a round): "
          f"{json.dumps(recs['sync'][0]['scores'])} against one rank {json.dumps(want)}; fused launches "
          f"{[r['eval_fused_launches'] for r in recs['sync']]}", flush=True)

    windows = recs["timed"][0]["iters_per_sec"]
    it_s = statistics.median(windows[1:])
    print(f"bf16 flagship, 2 gloo ranks sharing one card, global batch 20: {it_s:.3f} it/s (median of "
          f"{len(windows) - 1} windows of {LOG_EVERY} steps after the first; all {[round(w, 3) for w in windows]}) "
          f"on {card}; not a scaling number: two processes share one card; peak "
          f"{[round(r['peak_gb'], 2) for r in recs['timed']]} GB", flush=True)

    # (d) two serving replicas on cuda:0 against one
    _, gan, trained = load_run(run["trainer"].run_dir, -1)
    state = trained.generators().with_ema_params()
    one_server = GenerationServer(gan, state, batchsize=256, iters_per_chunk=1)
    two_server = GenerationServer(gan, state, batchsize=256, iters_per_chunk=1, mesh=["cuda:0", "cuda:0"])
    want_geo, want_color = one_server.generate(512, seed=3, with_geo=True)
    fused_norm_act_conv.launches = 0
    # -- main path: counts from 0 --------------------------------------------
    got_geo, got_color = two_server.generate(512, seed=3, with_geo=True)
    torch.cuda.synchronize()
    serve_fused = fused_norm_act_conv.launches
    # -- end of main path ------------------------------------------------------
    one_server.close()
    two_server.close()
    diffs = {}
    for label, got, want_ in (("color", got_color, want_color), ("geo", got_geo, want_geo)):
        d = np.abs(got.astype(np.int16) - want_.astype(np.int16))
        diffs[label] = {"max": int(d.max()), "share": float((d > 0).mean())}
    print(f"2 serving replicas on cuda:0 against one, 512 videos at B=256 (128 a replica): bytes "
          f"{json.dumps(diffs)}; fused launches {serve_fused} (5 per cgen forward, 2 rounds x 2 replicas)",
          flush=True)
    if serve_fused != 5 * 2 * 2:
        raise AssertionError(f"expected 20 fused launches from the replicas, counted {serve_fused}")
    if any(v["max"] > DP_SERVE_MAX_LEVELS or v["share"] > DP_SERVE_MAX_SHARE for v in diffs.values()):
        raise AssertionError("the replicas' bytes differ from one replica's beyond the stated bound")

    return {
        "fused_err": fused_err, "dequant_err": dequant_err,
        "fused_launches": {"nccl": recs_a["nccl"][0]["fused_launches"],
                           **{k: [r["fused_launches"] for r in v] for k, v in recs.items()},
                           "eval": [r["eval_fused_launches"] for r in recs["sync"]], "serve": serve_fused},
        "dequant_launches": {"nccl": recs_a["nccl"][0]["dequant_launches"],
                             **{k: [r["dequant_launches"] for r in v] for k, v in recs.items()}},
        "it_s": it_s, "loss_rel": loss_rel, "serve_bytes": diffs,
        # phase 13 holds its time-sharded run to the same one-rank reference
        "ref": seen["ref"], "p0": p0, "ref_config": cfg_s,
    }



# ------------------------------------------------------------- time sharded
# (a) mesh {data: 1, time: 2} on two gloo ranks sharing cuda:0: f32 with
# TF32 off, deterministic cuDNN, global batch 20, 3 steps, held to phase
# 12's one rank with the same global-batch BatchNorm arithmetic (its
# unsharded critics) at phase 12's DP_* limits. (b) the bf16 flagship at
# mesh {data: 2, time: 2} on four gloo ranks sharing cuda:0, 18 steps.
# (c) time 8 of 16 frames raises before any step.
TIME_TIMED_EPOCHS = 6
# halo exchanges a train step makes under the flagship's settings (no
# critic lever): each forward of the video critic runs 5 halo-extended
# time-valid convs, the gradient critic 4 and its 1-frame temporal
# difference, so 10 a forward of the pair. A halo's backward exchanges
# again where its input carries a gradient: in the D phase (real and fake
# videos without one) the convs after the first layer, 3 of the video
# critic's and 3 of the gradient critic's; in the G phase every one of the
# 10 (the fakes carry the generators' gradient).
HALOS_PER_STEP = 2 * (10 + 6) + (10 + 10)


def phase_time(run: dict, card: str, dp: dict) -> dict:
    """The time-sharded path (module docstring, phase 13)."""
    from dcvgan_torch import prng
    from dcvgan_torch.data.loader import VideoLoader
    from dcvgan_torch.parallel import create_layout
    from dcvgan_torch.train.step import DCVGAN

    root = Path(run["tmp"].name) / "time"
    base = run["trainer"].config
    # both kernels at this path's shapes first: a data row's batch at data 1
    # (20 rows) and data 2 (10 rows), and log_samples' round (25 videos)
    dequant_err = 0.0
    for ways in (1, 2):
        with VideoLoader(run["dataset"], base.batchsize, n_workers=2, seed=1, process_index=ways - 1,
                         process_count=ways, shard_divisor=ways) as loader:
            batch = {k: torch.from_numpy(v).cuda() for k, v in loader.fetch_batch(0).items()}
        dequant_err = max(dequant_err, check_dequant_batch(batch, f"time-sharded data row of {ways} rows"))
    fused_err = check_sites(25 * base.video_length, "time-sharded log_samples round", cgen_sites(base))

    cfg_a, path_a = dp_config(run, root, "time-f32", 1, precision="float32", mesh={"data": 1, "time": 2})
    cfg_b, path_b = dp_config(run, root, "time-flagship", TIME_TIMED_EPOCHS, mesh={"data": 2, "time": 2})
    gloo = ["--dist-backend", "gloo", "--device", "cuda:0"]
    recs_a = torchrun(2, [{"name": "time", "deterministic": True, "grads": str(root / "time-f32.pt"),
                           "argv": ["--config", str(path_a)] + gloo}], root, "time-a")["time"]
    recs_b = torchrun(4, [{"name": "flagship", "argv": ["--config", str(path_b)] + gloo}],
                      root, "time-b")["flagship"]
    for recs, cfg, label in ((recs_a, cfg_a, "2 gloo ranks on cuda:0, data 1 x time 2, f32"),
                             (recs_b, cfg_b, "4 gloo ranks on cuda:0, data 2 x time 2, bf16 flagship")):
        check_dp_run(recs, cfg, label)
        want = [[1, cfg.mesh.data, cfg.mesh.time, r // cfg.mesh.time, r % cfg.mesh.time]
                for r in range(len(recs))]
        if [r["layout"] for r in recs] != want or {r["device"] for r in recs} != {"cuda:0"}:
            raise AssertionError(f"{label}: layouts {[r['layout'] for r in recs]} on "
                                 f"{sorted({r['device'] for r in recs})}, expected {want} on cuda:0")
        halos = [r["halo_exchanges"] for r in recs]
        print(f"{label}: halo exchanges {halos} in {recs[0]['steps']} steps, "
              f"{HALOS_PER_STEP} a step a rank expected", flush=True)
        if halos != [HALOS_PER_STEP * r["steps"] for r in recs]:
            raise AssertionError(f"{label}: {halos} halo exchanges, expected {HALOS_PER_STEP} a step")

    # (a) against phase 12's one unsharded rank
    mine = saved_run(recs_a[0], "time-f32", root, dp["ref_config"], dp["p0"])
    held = compare_runs(mine, dp["ref"])
    print(f"2 time ranks (data 1 x time 2) against one rank with the same global-batch BatchNorm "
          f"arithmetic and unsharded critics, f32 at global batch 20, {len(mine['losses'])} steps, "
          f"deterministic cuDNN on both: {rounded(held)} (held at phase 12's limits)", flush=True)
    if not within_dp_limits(held):
        raise AssertionError("2 time ranks and one rank disagree beyond the stated tolerance")

    # (b) the flagship's rate and memory
    windows = recs_b[0]["iters_per_sec"]
    it_s = statistics.median(windows[1:])
    print(f"bf16 flagship, data 2 x time 2 on 4 gloo ranks, global batch 20: {it_s:.3f} it/s (median of "
          f"{len(windows) - 1} windows of {LOG_EVERY} steps after the first; all {[round(w, 3) for w in windows]}) "
          f"on {card}; not a scaling number: four processes share one card; peak memory by rank "
          f"{[round(r['peak_gb'], 2) for r in recs_b]} GB", flush=True)

    # (c) time 8 of 16 frames: the halo error before any step
    cfg_c, _ = dp_config(run, root, "time-8", 1, mesh={"data": 1, "time": 8})
    gan = DCVGAN(cfg_c, layout=create_layout(cfg_c, world=8, rank=0))
    state = gan.init_state(cfg_c.seed)
    before = {k: v.clone() for k, v in state.vdis.state_dict().items()}
    try:
        gan.train_step(state, batch, prng.base_key(cfg_c.seed, "cuda"))
    except ValueError as e:
        if "halo" not in str(e):
            raise
        print(f"mesh time 8 of {cfg_c.video_length} frames: {e}", flush=True)
    else:
        raise AssertionError("mesh time 8 of 16 frames trained a step")
    if state.step != 0 or any(not torch.equal(v, before[k]) for k, v in state.vdis.state_dict().items()):
        raise AssertionError("mesh time 8 changed the state before raising")

    return {
        "fused_err": fused_err, "dequant_err": dequant_err, "it_s": it_s,
        "loss_rel": max(held["loss_rel_by_step"]),
        "fused_launches": {"f32": [r["fused_launches"] for r in recs_a],
                           "flagship": [r["fused_launches"] for r in recs_b]},
        "dequant_launches": {"f32": [r["dequant_launches"] for r in recs_a],
                             "flagship": [r["dequant_launches"] for r in recs_b]},
    }


# ------------------------------------------------------------ head to head
# the JAX package's head-to-head run (configs/headtohead-tpu.yml) through
# the port's tool, dcvgan_torch.tools.headtohead, with the repository's
# protocol (HEADTOHEAD.md): 128 mp4 files a snapshot, the committed
# extractor, the real mp4 set of the synthetic tree
H2H_CONFIG = "headtohead-tpu"
H2H_METRICS = ["is", "fid", "prd"]
# the committed sample sets of the JAX package's runs and the scores its
# scorer recorded for them (tools/score_iters.py); the JAX scorer on the
# CPU reproduces both files to their 4 decimals from a regenerated real set
H2H_RECORDS = [("tpurun_samples", "tpu_scores.json"), ("tpurun_samples_seed3", "tpu_scores_seed3.json")]
H2H_RTOL = 1e-2
# every recorded run's best FID over its 8 points is 311.7-813.4
# (HEADTOHEAD.md), every untrained reading above 1,000 (1,387.9 at iteration
# 0, 1,079-1,767 at 200): a best above this is a training fault
H2H_BEST_FID = 1000.0


@contextlib.contextmanager
def counting_rounds():
    """Counts, while inside, the eval-mode sampling rounds
    (``DCVGAN.sample_videos``: one cgen forward each) and the fused launches
    made inside train steps; the class is restored after."""
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv
    from dcvgan_torch.train.step import DCVGAN

    seen = {"rounds": 0, "in_steps": 0}
    sample, step = DCVGAN.sample_videos, DCVGAN.train_step

    def counted_sample(self, *args, **kwargs):
        seen["rounds"] += 1
        return sample(self, *args, **kwargs)

    def counted_step(self, *args, **kwargs):
        before = fused_norm_act_conv.launches
        out = step(self, *args, **kwargs)
        seen["in_steps"] += fused_norm_act_conv.launches - before
        return out

    DCVGAN.sample_videos, DCVGAN.train_step = counted_sample, counted_step
    try:
        yield seen
    finally:
        DCVGAN.sample_videos, DCVGAN.train_step = sample, step


def quiet(fn, *args, **kwargs):
    """``fn``'s result, its standard output printed with a prefix (the
    tool prints a JSON object a row)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    for line in buf.getvalue().splitlines():
        print(f"headtohead tool: {line}", flush=True)
    return out


def phase_headtohead(card: str) -> dict:
    """The head-to-head path (module docstring, phase 14)."""
    from dcvgan_torch.cli.train import build_dataset
    from dcvgan_torch.config import load_config
    from dcvgan_torch.ops.dequant import dequantize_video
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv
    from dcvgan_torch.tools import headtohead
    from dcvgan_torch.train.trainer import Trainer

    path = ROOT / "configs" / f"{H2H_CONFIG}.yml"
    cfg = load_config(path)
    if (cfg.batchsize, cfg.cgen.ngf, cfg.trainer.precision, cfg.snapshot_interval) != (8, 32, "bfloat16", 200):
        raise AssertionError(f"configs/{H2H_CONFIG}.yml is no longer batch 8, ngf 32, bf16, a snapshot "
                             "every 200 steps")
    tmp = tempfile.TemporaryDirectory(prefix="dcvgan_h2h_")
    root = Path(tmp.name)

    # 1. both kernels at this path's shapes: dequant at batch 8, the fused
    # kernel at ngf 32's cgen sites and the frame counts of a sampling and
    # evaluation round (32 videos) and of log_samples' round (25)
    cfg.dataset.processed_root = str(root / "processed")
    dataset = build_dataset(cfg)
    dequant_err = check_dequant_batch(device_batches(dataset, cfg.batchsize, 1)[0], "headtohead batch 8")
    fused_err = max(check_sites(32 * cfg.video_length, "headtohead sampling round", cgen_sites(cfg)),
                    check_sites(Trainer.NUM_LOG * cfg.video_length, "headtohead log_samples",
                                cgen_sites(cfg)))

    # 2. the port's scorer against the JAX scorer's record
    real = headtohead.real_set(root / "processed" / cfg.dataset.name / "train")
    fingerprint = headtohead.get_extractor().fingerprint
    worst = 0.0
    for samples, record in H2H_RECORDS:
        want = {r["iteration"]: r for r in json.loads((ROOT / "results" / "headtohead" / record).read_text())}
        rows = quiet(headtohead.score_trajectory, ROOT / "results" / "headtohead" / samples, real, H2H_METRICS)
        for row in rows:
            rel = {k: abs(row[k] - want[row["iteration"]][k]) / abs(want[row["iteration"]][k])
                   for k in ("is", "fid")}
            worst = max(worst, *rel.values())
            print(f"headtohead scorer {samples} iteration {row['iteration']}: {json.dumps(row)} against the "
                  f"record's is {want[row['iteration']]['is']} fid {want[row['iteration']]['fid']} "
                  f"(relative {rel['is']:.2e}, {rel['fid']:.2e}; extractor {fingerprint})", flush=True)
            if max(rel.values()) > H2H_RTOL:
                raise AssertionError(f"{samples} iteration {row['iteration']}: the port's scorer is "
                                     f"{max(rel.values()):.2e} from the JAX record, beyond {H2H_RTOL:g}")

    # 3. the run: train, sample every snapshot, score the trajectory
    fused_norm_act_conv.launches = 0
    dequantize_video.launches = 0
    # -- main path: counts from 0 ------------------------------------------
    with counting_rounds() as rounds:
        summary = quiet(headtohead.main, ["--config", str(path), "--out", str(root / "run"),
                                          "--metrics", *H2H_METRICS])
    torch.cuda.synchronize()
    dq, fused = dequantize_video.launches, fused_norm_act_conv.launches
    # -- end of main path ----------------------------------------------------
    steps, rows = summary["steps"], summary["rows"]
    snapshots = steps // cfg.snapshot_interval
    # log_samples at step 0 and at the end; an evaluation at step 0 and every
    # evaluation_interval; each snapshot sampled; rounds of 32 videos
    want_rounds = 2 + (1 + steps // cfg.evaluation_interval + snapshots) * math.ceil(128 / 32)
    print(f"headtohead run: {steps} steps; dequantize_video launches {dq}; fused_norm_act_conv "
          f"launches {fused} in {rounds['rounds']} sampling rounds ({want_rounds} expected), "
          f"{rounds['in_steps']} inside train steps", flush=True)
    if steps != cfg.n_epochs * (len(dataset) // cfg.batchsize) or dq != steps:
        raise AssertionError(f"{steps} steps and {dq} dequant launches: expected one a step of "
                             f"{cfg.n_epochs} epochs of {len(dataset) // cfg.batchsize} batches")
    if rounds["rounds"] != want_rounds or fused != 5 * want_rounds or rounds["in_steps"]:
        raise AssertionError("expected 5 fused launches per cgen forward and none inside a step")
    if not summary["losses_finite"]:
        raise AssertionError("a training loss is not finite")
    for k in ("loss_idis", "loss_vdis", "loss_gdis"):
        if abs(summary["first_losses"][k] - 2 * math.log(2)) > 0.2:
            raise AssertionError(f"first-step {k} {summary['first_losses'][k]} is not within 0.2 of 2 ln 2")
    if [r["iteration"] for r in rows] != [cfg.snapshot_interval * (i + 1) for i in range(snapshots)]:
        raise AssertionError(f"scored iterations {[r['iteration'] for r in rows]}")
    for r in rows:
        print(f"headtohead trajectory {json.dumps(r)} on {card}", flush=True)
        if not all(math.isfinite(r[k]) for k in r) or not (0 <= r["prd"] <= 1 and 0 <= r["prd_f1_8"] <= 1):
            raise AssertionError(f"iteration {r['iteration']}: scores {r} not finite or prd outside [0, 1]")
    best = min(rows, key=lambda r: r["fid"])
    sec = summary["seconds"]
    print(f"headtohead: best FID {best['fid']} at iteration {best['iteration']}, endpoint FID {rows[-1]['fid']} "
          f"(limit {H2H_BEST_FID:g}); train {summary['train_it_per_s']:.3f} it/s at batch {cfg.batchsize} "
          f"(median of the log windows after the first); wall s train {sec['train']:.1f} sample "
          f"{sec['sample']:.1f} score {sec['score']:.1f}; peak device memory {summary['peak_memory_gb']:.2f} "
          f"GB; first losses {json.dumps(summary['first_losses'])} last {json.dumps(summary['last_losses'])}; "
          f"in-training eval {json.dumps(summary['in_training_eval'])}; on {card}", flush=True)
    if best["fid"] > H2H_BEST_FID:
        raise AssertionError(f"best FID {best['fid']} above {H2H_BEST_FID:g}: a training-dynamics fault")
    tmp.cleanup()
    return {"dequant_err": dequant_err, "fused_err": fused_err, "dequant_launches": dq,
            "fused_launches": fused, "scorer_rel": worst}


def np_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--child"]:
        return child(sys.argv[2])
    from dcvgan_torch.ops import build

    card = card_line()
    try:
        triton_version = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton_version = "not installed"
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"cudnn {torch.backends.cudnn.version()} triton {triton_version}")
    print(sh([build.nvcc_path(), "--version"]).splitlines()[-1])
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("cv2", "yaml", "scipy", "tensorboardX", "joblib", "face_recognition")}
    print("optional packages: " + ", ".join(f"{m} {'found' if ok else 'absent'}" for m, ok in found.items()))
    print(f"card: {card}; torch sees {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN and matmul: f32 comparisons run in full f32", flush=True)

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s ({json.dumps({k: round(v, 1) for k, v in built.items()})})",
          flush=True)

    entry = phase_kernels()
    dequant_entry = phase_dequant()
    entry["launches"] = phase_slice(card)
    f32_serve = phase_serve_f32(card)
    # the f32 serving run's launches, counted from 0, all on the tf32x3 route
    entry["f32_serve_launches"] = f32_serve["launches"]
    entry["f32_serve_videos_per_s"] = f32_serve["videos_per_s"]
    run = phase_train(card)
    levers = phase_levers(run, card)
    dequant_entry["launches"] = run["launches"]
    # each kernel's launches on the lever paths, counted from 0 per config
    dequant_entry["lever_launches"] = levers["dequant_launches"]
    entry["lever_launches"] = levers["fused_launches"]
    datasets = phase_datasets(card)
    # each kernel's launches on the two dataset runs, each counted from 0
    for entry_, kernel in ((entry, "fused"), (dequant_entry, "dequant")):
        entry_["surreal_launches"] = datasets["runs"]["surreal-segm"][kernel]
        entry_["isogd_launches"] = datasets["runs"]["isogd-flow"][kernel]
    dequant_entry["max_abs_err"] = max(dequant_entry["max_abs_err"], levers["dequant_err"],
                                       *(r["dequant_err"] for r in datasets["runs"].values()))
    if run["device_ms"] is not None:
        # the kernel's time on the main path: the step's one launch in the
        # train-step profile (else the isolated time of phase 3 stays)
        dequant_entry["ms"] = run["device_ms"]
    evaluation = phase_eval(run)
    inference = phase_infer(run, evaluation["fingerprint"])
    served = phase_http(run, card)
    parallel = phase_data_parallel(run, card)
    timed = phase_time(run, card, parallel)
    run["tmp"].cleanup()
    h2h = phase_headtohead(card)
    # the fused kernel's launches on the later paths, each counted from 0
    entry["eval_launches"] = evaluation["fused_launches"]
    entry["infer_launches"] = inference["fused_launches"]
    entry["http_launches"] = served["fused_launches"]
    # each kernel's launches on the data-parallel paths, per run and rank
    entry["data_parallel_launches"] = parallel["fused_launches"]
    dequant_entry["data_parallel_launches"] = parallel["dequant_launches"]
    # and on the time-sharded paths
    entry["time_sharded_launches"] = timed["fused_launches"]
    dequant_entry["time_sharded_launches"] = timed["dequant_launches"]
    # and on the head-to-head path
    entry["headtohead_launches"] = h2h["fused_launches"]
    dequant_entry["headtohead_launches"] = h2h["dequant_launches"]
    dequant_entry["max_abs_err"] = max(dequant_entry["max_abs_err"], parallel["dequant_err"],
                                       timed["dequant_err"], h2h["dequant_err"])
    # and its comparisons at each path's frame count
    entry["max_abs_err"] = max(entry["max_abs_err"], run["fused_err"], levers["fused_err"],
                               *(r["fused_err"] for r in datasets["runs"].values()),
                               evaluation["fused_err"], inference["fused_err"], served["fused_err"],
                               parallel["fused_err"], timed["fused_err"], h2h["fused_err"])

    print(json.dumps({"kernels": [entry, dequant_entry]}))
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
