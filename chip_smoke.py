#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches its own:

1. environment: torch, CUDA, nvcc and the card (name and power limit);
   TF32 is switched off for cuDNN and matmul, so f32 comparisons are f32;
2. build every kernel under ``dcvgan_torch/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time kernel, plain version, one library call and
   the bound;
4. the main path: ``dcvgan_torch.cli.serve``'s ``serve()`` and
   ``GenerationServer.generate`` at the flagship width
   (``configs/mug-depth.yml``: depth, ngf 64, bf16, batch 256, seeded weights),
   with every launch counter set to 0 just before and read just after;
5. a profile of one sampling round: device time by kernel kind and the
   device's idle share;
6. a ``{"kernels": [...]}`` line, the card's line, and last
   ``{"ok": true, "device": {...}}``.

Every phase prints its numbers as it goes. Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.metadata
import json
import statistics
import subprocess
import sys
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


def kernel_inputs(n, h, c, cout, dtype, seed, shift_offset=0.0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    cl = torch.channels_last
    x = torch.randn(n, c, h, h, generator=g, device="cuda").to(dtype).contiguous(memory_format=cl)
    w = (torch.randn(cout, c, 4, 4, generator=g, device="cuda") / (16 * c) ** 0.5)
    w = w.to(dtype).contiguous(memory_format=cl)
    scale = torch.rand(c, generator=g, device="cuda") + 0.5
    shift = torch.randn(c, generator=g, device="cuda") * 0.2 + shift_offset
    return x, scale, shift, w


def check_kernel(fused, plain, n, h, c, cout, dtype, xn, slope=0.2, shift_offset=0.0):
    """Kernel against plain version on the same inputs; returns max |diff|."""
    x, scale, shift, w = kernel_inputs(n, h, c, cout, dtype, seed=h * 7 + c, shift_offset=shift_offset)
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

    from dcvgan_torch.ops.fused_block import fused_norm_act_conv, reference_norm_act_conv

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

    sites = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, h, c, cout in SITES:
            x, scale, shift, w = kernel_inputs(N_FRAMES, h, c, cout, dtype, seed=1)
            xn = torch.empty_like(x)
            reference_norm_act_conv(x, scale, shift, w, 0.2, xn_out=xn)  # for the library call
            bound, bound_by, flops, nbytes = site_bound(N_FRAMES, h, c, cout, dtype, True)
            row = {
                "site": name, "dtype": str(dtype)[6:], "x": [N_FRAMES, h, h, c], "cout": cout,
                "kernel_ms": cuda_ms(lambda: fused_norm_act_conv(x, scale, shift, w, 0.2, xn_out=xn)),
                "plain_ms": cuda_ms(lambda: reference_norm_act_conv(x, scale, shift, w, 0.2, xn_out=xn)),
                "library_ms": cuda_ms(lambda: F.conv2d(xn, w, stride=2, padding=1)),
                "bound_ms": bound, "bound_by": bound_by, "gflop": flops / 1e9, "gbytes": nbytes / 1e9,
            }
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
            sites.append(row)
            print("time " + json.dumps(row), flush=True)
            del x, xn
    torch.cuda.empty_cache()
    main_path = [r for r in sites if r["dtype"] == "bfloat16"]
    by_kind = {"bytes": 0.0, "operations": 0.0}
    for r in main_path:
        by_kind[r["bound_by"]] += r["bound_ms"]
    return {
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
    }


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
    from dcvgan_torch.ops.fused_block import fused_norm_act_conv
    from dcvgan_torch.train.state import GeneratorState
    from dcvgan_torch.train.step import DCVGAN

    cfg = load_config(ROOT / "configs" / "mug-depth.yml")
    gan = DCVGAN(cfg)
    if gan.dtype != torch.bfloat16 or cfg.cgen.ngf != 64:
        raise AssertionError("configs/mug-depth.yml is no longer the bf16, ngf 64 flagship")
    # seeded weights at a scale that keeps activations O(1), so that outputs,
    # checksums and replays vary with the seed
    init = gan.init_state(cfg.seed)
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
    ("fused_norm_act_conv", ("fused_bf16_kernel", "fused_f32_kernel")),
    ("conv / conv-transpose (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad", "fprop")),
    ("matmul (GRU)", ("gemm", "gemv")),
    ("batch norm", ("batch_norm", "bn_fw", "batchnorm")),
    ("concat / copy", ("cat", "copy", "Copy")),
]


def phase_profile(gan, state, batch: int) -> None:
    """Device time by kernel kind over one sampling round + quantize at
    ``batch``, and the device's idle share of the round's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from dcvgan_torch import prng
    from dcvgan_torch.cli.serve import quantize

    def round_():
        xg, xc = gan.sample_videos(state, prng.base_key(5, "cuda"), batch)
        return quantize(xg), quantize(xc)

    round_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        t0 = time.perf_counter()
        round_()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kinds = {name: 0.0 for name, _ in KERNEL_KINDS}
    kinds["elementwise and other"] = 0.0
    for e in kernels:
        kind = next((name for name, frags in KERNEL_KINDS if any(f in e.key for f in frags)),
                    "elementwise and other")
        kinds[kind] += e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    # each kernel counts once, under the innermost op that launched it
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.key.startswith("aten::") and e.self_device_time_total > 0]
    top_ops = sorted(ops, key=lambda e: -e.self_device_time_total)[:12]
    prof_report = {
        "batch": batch,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
        "by_kind_ms": kinds,
        "top_kernels": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3, "calls": e.count}
                        for e in top],
        "top_ops": [{"op": e.key, "shapes": str(e.input_shapes)[:120],
                     "ms": e.self_device_time_total / 1e3, "calls": e.count} for e in top_ops],
    }
    if not busy_ms:
        print("profile: the profiler recorded no device time (not measured)", flush=True)
        return
    print("profile " + json.dumps(prof_report), flush=True)


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
    print(f"card: {card}; torch sees {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN and matmul: f32 comparisons run in full f32", flush=True)

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s ({json.dumps({k: round(v, 1) for k, v in built.items()})})",
          flush=True)

    entry = phase_kernels()
    entry["launches"] = phase_slice(card)

    print(json.dumps({"kernels": [entry]}))
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
