"""Where the fused_block kernel's time goes: a lesion study on the card.

    python3 -m dcvgan_torch.tools.fused_block_lesions [--dtype float32]

Builds ``csrc/fused_block.cu`` as it is and copies with a part of the TMA
kernel removed (the transform warps' prologue, which also writes
``xn_out``; only the ``xn_out`` stores; the wgmmas; the prologue and the
wgmmas, which leaves the loads, the barriers and the stores; in f32 also
the two correction products of the tf32x3 route, which leaves one TF32
product), then times each at the five flagship sites of the colour
generator's down path (N = 4096 frames, with ``xn_out``, bf16 by default)
with CUDA events. The lesioned builds compute wrong values; only their
times mean anything. f32 also builds ``one_sum``, the route with all three
products in one accumulator (a variant that computes the right values, less
accurately), and reports each exact build's worst error at each site as a
share of the f32 tolerance, 1e-4 + 1e-4·|plain| against the plain version
with cuDNN's TF32 off. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from dcvgan_torch.ops import build
from dcvgan_torch.ops import fused_block as fb

SITES = [("down1", 32, 64, 128), ("down2", 16, 128, 256), ("down3", 8, 256, 256),
         ("down4", 4, 256, 256), ("down5", 2, 256, 256)]
N_FRAMES = 4096
_PROLOGUE = ("          if (ch < p.c) {  // channels past C stay 0",
             "          if (false) {  // channels past C stay 0")
_MMA = ("for (int kk = 0; kk < 4; ++kk) wgmma_rs<BN>(acc, af[B][kk], desc + 2 * kk, 1);",
        "for (int kk = 0; kk < 4; ++kk) acc[kk] += __uint_as_float(af[B][kk][0] ^ af[B][kk][3]);")
_XN_OUT = ("              if (write_xn) {\n                const int own_lo",
           "              if (false) {\n                const int own_lo")
_CORRECTIONS = ("""            wgmma_tf32<BN>(part, al[B][kk], desc + 2 * kk, 1);
            wgmma_tf32<BN>(part, af[B][kk], desc + desc_part + 2 * kk, 1);
""", "")
_ONE_SUM = ("""            wgmma_tf32<BN>(part, al[B][kk], desc + 2 * kk, 1);
            wgmma_tf32<BN>(part, af[B][kk], desc + desc_part + 2 * kk, 1);""",
            """            wgmma_tf32<BN>(acc, al[B][kk], desc + 2 * kk, 1);
            wgmma_tf32<BN>(acc, af[B][kk], desc + desc_part + 2 * kk, 1);""")
_TF32_MMA = ("""            wgmma_tf32<BN>(part, al[B][kk], desc + 2 * kk, 1);
            wgmma_tf32<BN>(part, af[B][kk], desc + desc_part + 2 * kk, 1);
            wgmma_tf32<BN>(acc, af[B][kk], desc + 2 * kk, 1);""",
             "            acc[kk] += __uint_as_float(af[B][kk][0] ^ al[B][kk][3]);")
LESIONS = {
    torch.bfloat16: {
        "full": (),
        "no_prologue": (_PROLOGUE,),
        "no_xn_out": (_XN_OUT,),
        "no_wgmma": (_MMA,),
        "loads_only": (_PROLOGUE, _MMA),
    },
    torch.float32: {
        "full": (),
        "one_sum": (_ONE_SUM,),
        "no_prologue": (_PROLOGUE,),
        "no_xn_out": (_XN_OUT,),
        "one_product": (_CORRECTIONS,),
        "no_wgmma": (_TF32_MMA,),
        "loads_only": (_PROLOGUE, _TF32_MMA),
    },
}
# the builds that compute the function, whose errors mean something
EXACT = {torch.bfloat16: (), torch.float32: ("full", "one_sum")}


def _compile(src: str, out: Path):
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    # the copy lives elsewhere: its #include "hopper.cuh" needs csrc/ on the path
    done = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o", str(out),
                           str(cu)], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on {cu.name}:\n{done.stdout}{done.stderr}")
    return fb.bind(ctypes.CDLL(str(out)))


def _time_ms(fn, runs: int = 5, reps: int = 20) -> float:
    fn()
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


def main(dtype: torch.dtype = torch.bfloat16) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False  # the plain version in full f32
    source = (build.CSRC_DIR / "fused_block.cu").read_text()
    g = torch.Generator(device="cuda").manual_seed(0)
    cl = torch.channels_last
    inputs = {}
    for name, h, c, cout in SITES:
        x = torch.randn(N_FRAMES, c, h, h, generator=g, device="cuda").to(dtype)
        w = torch.randn(cout, c, 4, 4, generator=g, device="cuda").to(dtype) / (16 * c) ** 0.5
        inputs[name] = (
            x.contiguous(memory_format=cl), w.contiguous(memory_format=cl),
            torch.rand(c, device="cuda") + 0.5, torch.randn(c, device="cuda") * 0.2,
            torch.empty(N_FRAMES, cout, h // 2, h // 2, dtype=dtype, device="cuda",
                        memory_format=cl),
            torch.empty(N_FRAMES, c, h, h, dtype=dtype, device="cuda", memory_format=cl),
        )
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    result = {"card": card, "dtype": str(dtype)[6:], "n_frames": N_FRAMES, "ms": {}, "worst_over_tol": {}}

    def worst(label: str, name: str) -> None:
        """The last launch's output against the plain version, for the exact builds."""
        if label not in EXACT[dtype]:
            return
        x, w, scale, shift, out, _ = inputs[name]
        want = fb.reference_norm_act_conv(x, scale, shift, w, 0.2)
        share = ((out - want).abs() / (1e-4 + 1e-4 * want.abs())).max().item()
        result["worst_over_tol"].setdefault(label, {})[name] = share
    with tempfile.TemporaryDirectory() as tmp:
        sources = {}
        for lesion, edits in LESIONS[dtype].items():
            src = source
            for old, new in edits:
                if old not in src:
                    raise RuntimeError(f"lesion {lesion!r}: the kernel source no longer has {old!r}")
                src = src.replace(old, new)
            sources[lesion] = src
        with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each, all at once
            builds = dict(zip(sources, pool.map(
                lambda kv: _compile(kv[1], Path(tmp) / f"lib{kv[0]}.so"), sources.items())))
        for lesion, kernel in builds.items():
            row = {}
            for name, h, c, cout in SITES:
                x, w, scale, shift, out, xn = inputs[name]
                p = fb.plan(N_FRAMES, h, h, c, cout, dtype)
                row[name] = _time_ms(
                    lambda: fb.launch(p, x, scale, shift, w, out, 0.2, xn, kernel=kernel))
                worst(lesion, name)
            result["ms"][lesion] = row
    for row in result["ms"].values():
        row["sum"] = sum(row[name] for name, *_ in SITES)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    main(getattr(torch, parser.parse_args().dtype))
