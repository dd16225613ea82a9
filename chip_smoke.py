#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches its own:

1. environment: torch, CUDA, nvcc and the card (name and power limit);
   TF32 is switched off for cuDNN and matmul, so f32 comparisons are f32;
2. build every kernel under ``dcvgan_torch/csrc`` with nvcc;
3. hold each kernel (``fused_norm_act_conv``, ``dequantize_video``) against
   its plain PyTorch version on the card at the main paths' shapes and at
   edge shapes, and time kernel, plain version, one library call where there
   is one, and the bound; the bf16 ``fused_norm_act_conv`` is timed on its
   TMA route and on the mma.sync kernel of the other route in turns;
4. the serving path: ``dcvgan_torch.cli.serve``'s ``serve()`` and
   ``GenerationServer.generate`` at the flagship width
   (``configs/mug-depth.yml``: depth, ngf 64, bf16, batch 256, seeded weights),
   with every launch counter set to 0 just before and read just after;
5. a profile of one sampling round: device time by kernel kind and the
   device's idle share;
6. the training path: ``dcvgan_torch.cli.train``'s ``build_dataset`` and
   ``Trainer.train()`` at the same width (batch 20, bf16 compute over f32
   parameters) on the self-generating ``synthetic`` dataset, uint8 batches
   dequantised on the card, 42 steps, again with the counters set to 0 just
   before and read just after; then a seeded replay of 3 steps, a uint8
   against float batch, a checkpoint round trip, and a profile of one step;
7. a ``{"kernels": [...]}`` line, the card's line, and last
   ``{"ok": true, "device": {...}}``.

Every phase prints its numbers as it goes. Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.metadata
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

N_FRAMES = 4096  # batch 256 x 16 frames: the flagship serve call
# cgen down1..down5 at 64 px, ngf 64: (name, H = W of x, C, Cout)
SITES = [
    ("down1", 32, 64, 128),
    ("down2", 16, 128, 256),
    ("down3", 8, 256, 256),
    ("down4", 4, 256, 256),
    ("down5", 2, 256, 256),
]
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


def site_bound(n: int, h: int, c: int, cout: int, dtype: torch.dtype, xn: bool):
    """(bound_ms, bound_by, flops, bytes) of one call: each input read once,
    each output written once; operations over the taps that touch the image
    (padding taps multiply zeros), at the card's peak for the dtype."""
    es = torch.finfo(dtype).bits // 8
    oh = h // 2
    taps = (4 * oh - 2) ** 2  # non-padding taps summed over the output pixels
    flops = 2 * n * cout * c * taps
    nbytes = (n * h * h * c * (2 if xn else 1) + 16 * c * cout + n * oh * oh * cout) * es + 8 * c
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
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


def phase_kernels() -> dict:
    import torch.nn.functional as F

    from dcvgan_torch.ops.fused_block import (
        Plan, fused_norm_act_conv, launch, plan_for, reference_norm_act_conv)

    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, h, c, cout in SITES:
            for xn in (True, False):
                e = check_kernel(fused_norm_act_conv, reference_norm_act_conv, N_FRAMES, h, c, cout, dtype, xn)
                errs.append(e)
                print(f"check {name} {str(dtype)[6:]} xn_out={xn}: max|diff| {e:.3e} "
                      f"(tol {OUT_TOL[dtype][0]:g} + {OUT_TOL[dtype][1]:g}*|plain|)", flush=True)
        # LeakyReLU slope 0.01 with a shift large enough that the activation
        # branches differently and padding != leaky_relu(shift) would show
        e = check_kernel(fused_norm_act_conv, reference_norm_act_conv, N_FRAMES, 16, 128, 256,
                         dtype, True, slope=0.01, shift_offset=1.0)
        errs.append(e)
        print(f"check slope 0.01 shift+1 {str(dtype)[6:]}: max|diff| {e:.3e}", flush=True)
    for label, n, h, w, c, cout, want_route in EDGE_CASES:
        x, _, _, wt = kernel_inputs(n, h, c, cout, torch.bfloat16, seed=0, w=w)
        route = plan_for(x, wt, torch.empty(n, cout, h // 2, w // 2, dtype=x.dtype, device="cuda",
                                            memory_format=torch.channels_last)).route
        if route != want_route:
            raise AssertionError(f"edge case {label!r} takes the {route} route, not {want_route}")
        e = check_kernel(fused_norm_act_conv, reference_norm_act_conv, n, h, c, cout, torch.bfloat16,
                         True, shift_offset=0.5, width=w)
        errs.append(e)
        print(f"check edge bf16 {label} (N={n} {h}x{w} C={c} Cout={cout}, route {route}): "
              f"max|diff| {e:.3e}", flush=True)

    sites = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, h, c, cout in SITES:
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
                row["kernel_ms"] = cuda_ms(lambda: fused_norm_act_conv(x, scale, shift, w, 0.2, xn_out=xn))
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
    by_kind = {"bytes": 0.0, "operations": 0.0}
    for r in main_path:
        by_kind[r["bound_by"]] += r["bound_ms"]
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
    }
    print(f"fused_norm_act_conv bf16, five sites: TMA route {entry['ms']:.4f} ms, mma.sync kernel "
          f"{entry['old_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms, cuDNN {entry['library_ms']:.4f} ms",
          flush=True)
    return entry


def redrawn(module, seed: int):
    """A copy of ``module`` with weights and BatchNorm statistics drawn at a
    scale that keeps activations O(1) (the reference init shrinks them layer
    by layer, which would make a comparison of outputs say little)."""
    import copy

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
    stats = serve(gan, state, batch, iters, chunks, Sink("null", None), seed=0)
    server = GenerationServer(gan, state, batchsize=batch, iters_per_chunk=1, geo_name="depth")
    geo_a, col_a = server.generate(2 * batch, seed=7, with_geo=True)
    geo_b, col_b = server.generate(2 * batch, seed=7, with_geo=True)
    _, col_c = server.generate(2 * batch, seed=8)
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


# kernel-name fragments -> category, for the profile of one sampling round
KERNEL_KINDS = [
    ("fused_norm_act_conv", ("fused_tma_kernel", "fused_bf16_kernel", "fused_f32_kernel")),
    ("dequantize_video", ("dequant_kernel",)),
    ("adam (foreach)", ("multi_tensor", "foreach", "Foreach")),
    ("conv / conv-transpose (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad", "fprop")),
    ("matmul (GRU)", ("gemm", "gemv")),
    ("batch norm", ("batch_norm", "bn_fw", "batchnorm")),
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


def profile_once(round_, label: str, report: dict, counted: dict) -> dict:
    """Run ``round_`` twice under ``torch.profiler``: a warm-up step, traced
    and discarded (the profiler loses kernels launched just after its trace
    starts), then the measured step. Print ``label`` and a JSON report of
    device time by kernel kind; return the device ms and launches of each
    kernel kind. ``counted`` maps kinds to wrappers with a ``launches``
    count: the profile must show each wrapper's launches in the measured
    step, no fewer and no more."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        round_()
        torch.cuda.synchronize()
        prof.step()
        before = {k: fn.launches for k, fn in counted.items()}
        t0 = time.perf_counter()
        round_()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launched = {k: fn.launches - before[k] for k, fn in counted.items()}
        prof.step()
    # kernels only: a user annotation (torch's own around an optimizer's step)
    # carries the time of the kernels under it and would count them twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not e.is_user_annotation and not e.key.startswith("Optimizer.")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kinds = {name: 0.0 for name, _ in KERNEL_KINDS}
    kinds["elementwise and other"] = 0.0
    calls = dict.fromkeys(kinds, 0)
    for e in kernels:
        kind = next((name for name, frags in KERNEL_KINDS if any(f in e.key for f in frags)),
                    "elementwise and other")
        kinds[kind] += e.self_device_time_total / 1e3
        calls[kind] += e.count
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
    for kind, n in launched.items():
        if calls[kind] != n:
            raise AssertionError(f"{label}: the profile shows {calls[kind]} {kind} launches, "
                                 f"the wrapper counted {n}")
    return {k: (kinds[k], calls[k]) for k in kinds}


# the two uint8 batches of one train step at the flagship: (B, T, H, W, C)
DEQUANT_SHAPES = [("colour", (20, 16, 64, 64, 3)), ("depth", (20, 16, 64, 64, 1))]
PEAK_F32_OPS = 67e12


def dequant_bound_ms(dtype: torch.dtype = torch.bfloat16) -> float:
    """One train step's two launches: each input read once, each output written once."""
    es = torch.finfo(dtype).bits // 8
    n = sum(math.prod(shape) for _, shape in DEQUANT_SHAPES)
    return max(n * (1 + es) / PEAK_BYTES_PER_S, 2 * n / PEAK_F32_OPS) * 1e3


DEQUANT_BOUND_MS = dequant_bound_ms()


def phase_dequant() -> dict:
    """``dequantize_video`` against its plain version, bit for bit, and its
    times. No single PyTorch call computes the function, so there is no
    library time."""
    from dcvgan_torch.ops.dequant import dequantize_video, reference_dequantize

    g = torch.Generator(device="cuda").manual_seed(3)

    def draw(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=g)

    cases = [(name, draw(shape)) for name, shape in DEQUANT_SHAPES]
    cases += [
        ("0 elements", draw((0,))), ("1 element", draw((1,))), ("odd count", draw((3, 1001))),
        ("all 256 values", torch.arange(256, dtype=torch.uint8, device="cuda")),
        # views that start off 16-byte alignment: read with scalar loads
        ("view at +1", draw((4099,))[1:]), ("view at +8", draw((5000,))[8:]),
    ]
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, x in cases:
            got, want = dequantize_video(x, dtype), reference_dequantize(x, dtype)
            if got.shape != x.shape or got.dtype != dtype:
                raise AssertionError(f"dequantize_video {name}: shape or dtype off")
            if not torch.equal(got, want):
                d = (got.float() - want.float()).abs().max().item()
                raise AssertionError(f"dequantize_video {str(dtype)[6:]} {name}: differs, max {d:.3e}")
            if x.numel():
                worst = max(worst, (got.float() - want.float()).abs().max().item())
        lo, hi = dequantize_video(torch.tensor([0, 255], dtype=torch.uint8, device="cuda"), dtype).tolist()
        if (lo, hi) != (-1.0, 1.0):
            raise AssertionError(f"0 and 255 map to {lo}, {hi}")
        # for the record: dividing by a Python scalar, torch multiplies by the reciprocal
        allv = torch.arange(256, dtype=torch.uint8, device="cuda")
        scalar_form = (allv.to(torch.float32) / 127.5 - 1.0).to(dtype)
        off = int((scalar_form != reference_dequantize(allv, dtype)).sum())
        print(f"check dequant {str(dtype)[6:]}: {len(cases)} cases equal the plain version bit for bit "
              f"(`x / 127.5` with a Python scalar differs from the division at {off} of 256 bytes)",
              flush=True)
    try:
        dequantize_video(torch.zeros(4, device="cuda"), torch.bfloat16)
    except TypeError:
        pass
    else:
        raise AssertionError("dequantize_video accepted a float input")

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.finfo(dtype).bits // 8
        for name, shape in DEQUANT_SHAPES:
            x = draw(shape)
            n = x.numel()
            t_bytes = n * (1 + es) / PEAK_BYTES_PER_S * 1e3  # read once, written once
            t_ops = 2 * n / PEAK_F32_OPS * 1e3  # one division and one subtraction each
            row = {
                "site": name, "dtype": str(dtype)[6:], "x": list(shape),
                "kernel_ms": cuda_ms(lambda: dequantize_video(x, dtype)),
                "plain_ms": cuda_ms(lambda: reference_dequantize(x, dtype)),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            rows.append(row)
            print("time dequant " + json.dumps(row), flush=True)
    main_path = [r for r in rows if r["dtype"] == "bfloat16"]
    return {
        "name": "dequantize_video",
        "route": "cuda",
        "source": "dcvgan_torch/csrc/dequant.cu",
        "replaces": "dcvgan_tpu/ops/dequant.py:25",
        "launches": None,
        "max_abs_err": worst,
        # one train step's two bf16 launches (colour + depth) at the flagship
        "ms": sum(r["kernel_ms"] for r in main_path),
        "plain_ms": sum(r["plain_ms"] for r in main_path),
        "bound_ms": sum(r["bound_ms"] for r in main_path),
        "bound_by": "bytes",
        "library_ms": None,
    }


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


def phase_train(card: str):
    from dcvgan_torch import prng
    from dcvgan_torch.cli.train import build_dataset
    from dcvgan_torch.data.loader import VideoLoader
    from dcvgan_torch.logging.logger import Logger
    from dcvgan_torch.ops.dequant import dequantize_video, reference_dequantize
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv
    from dcvgan_torch.train.step import DCVGAN
    from dcvgan_torch.train.trainer import LOSS_NAMES, Trainer

    class Recorder(Logger):
        """Keeps every value the trainer logs, beside logging it."""

        def __init__(self, *args):
            super().__init__(*args)
            self.seen = {}

        def update(self, name, value):
            self.seen.setdefault(name, []).append(value)
            super().update(name, value)

    tmp = tempfile.TemporaryDirectory(prefix="dcvgan_smoke_")
    root = Path(tmp.name)
    cfg = train_config(root)
    t0 = time.perf_counter()
    dataset = build_dataset(cfg)
    print(f"synthetic dataset: {len(dataset)} videos written and listed in "
          f"{time.perf_counter() - t0:.1f} s (cv2 JPEG frames)", flush=True)
    run_dir = Path(cfg.log_dir) / cfg.experiment_name
    logger = Recorder(run_dir, None)

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
    if state.step != steps or launches != 2 * steps:
        raise AssertionError(f"expected {steps} steps and {2 * steps} dequant launches")
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

    # a checkpoint was written and restores to equal tensors
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
    print(f"checkpoint {trainer.ckpt.latest_step()}: {n_equal} tensors restore equal", flush=True)

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
    tmp.cleanup()
    if not kinds:
        return launches, None  # not measured
    dq_ms, dq_calls = kinds["dequantize_video"]
    if dq_calls != 2:
        raise AssertionError(f"the step's profile shows {dq_calls} dequantize_video launches, not 2")
    print(f"dequant in the train-step profile: {dq_ms * 1e3:.2f} us of device time for the step's "
          f"{dq_calls} launches, against a bound of {DEQUANT_BOUND_MS * 1e3:.2f} us for the two (bytes "
          "from device memory; the inputs may sit in L2)", flush=True)
    return launches, dq_ms


def np_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
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
             for m in ("cv2", "yaml", "tensorboardX", "joblib")}
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
    dequant_entry["launches"], device_ms = phase_train(card)
    # the kernel's own time: device time in the step's profile; back-to-back
    # CUDA-event timing of the wrapper measures its host cost
    dequant_entry["wrapper_ms"] = dequant_entry["ms"]
    dequant_entry["ms"] = device_ms

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
