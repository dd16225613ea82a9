"""Where the bf16 fused_block kernel's time goes: a lesion study on the card.

    python3 -m dcvgan_torch.tools.fused_block_lesions

Builds ``csrc/fused_block.cu`` as it is and four copies with a part of the
TMA kernel removed (the transform warps' prologue, which also writes
``xn_out``; only the ``xn_out`` stores; the wgmmas; the prologue and the
wgmmas, which leaves the loads, the barriers and the stores), then times each
at the five flagship sites of the colour generator's down path (bf16,
N = 4096 frames, with ``xn_out``) with CUDA events, and the mma.sync kernel
of the other route at the same sites. The lesioned builds compute wrong
values; only their times mean anything. Prints one JSON line.
"""

from __future__ import annotations

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
LESIONS = {
    "full": (),
    "no_prologue": (_PROLOGUE,),
    "no_xn_out": (_XN_OUT,),
    "no_wgmma": (_MMA,),
    "loads_only": (_PROLOGUE, _MMA),
}


def _compile(src: str, out: Path):
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    done = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out), str(cu)],
                          capture_output=True, text=True)
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


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    source = (build.CSRC_DIR / "fused_block.cu").read_text()
    g = torch.Generator(device="cuda").manual_seed(0)
    cl = torch.channels_last
    inputs = {}
    for name, h, c, cout in SITES:
        x = torch.randn(N_FRAMES, c, h, h, generator=g, device="cuda").bfloat16()
        w = torch.randn(cout, c, 4, 4, generator=g, device="cuda").bfloat16() / (16 * c) ** 0.5
        inputs[name] = (
            x.contiguous(memory_format=cl), w.contiguous(memory_format=cl),
            torch.rand(c, device="cuda") + 0.5, torch.randn(c, device="cuda") * 0.2,
            torch.empty(N_FRAMES, cout, h // 2, h // 2, dtype=torch.bfloat16, device="cuda",
                        memory_format=cl),
            torch.empty(N_FRAMES, c, h, h, dtype=torch.bfloat16, device="cuda", memory_format=cl),
        )
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    result = {"card": card, "n_frames": N_FRAMES, "ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        sources = {}
        for lesion, edits in LESIONS.items():
            src = source
            for old, new in edits:
                if old not in src:
                    raise RuntimeError(f"lesion {lesion!r}: the kernel source no longer has {old!r}")
                src = src.replace(old, new)
            sources[lesion] = src
        with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each, all at once
            builds = dict(zip(sources, pool.map(
                lambda kv: _compile(kv[1], Path(tmp) / f"lib{kv[0]}.so"), sources.items())))
        for lesion, kernels in builds.items():
            row = {}
            for name, h, c, cout in SITES:
                x, w, scale, shift, out, xn = inputs[name]
                p = fb.plan(N_FRAMES, h, h, c, cout, torch.bfloat16)
                row[name] = _time_ms(
                    lambda: fb.launch(p, x, scale, shift, w, out, 0.2, xn, kernels=kernels))
            result["ms"][lesion] = row
        row = {}
        for name, h, c, cout in SITES:
            x, w, scale, shift, out, xn = inputs[name]
            row[name] = _time_ms(lambda: fb.launch(fb.Plan("mma_sync"), x, scale, shift, w, out, 0.2, xn))
        result["ms"]["mma_sync_route"] = row
    for row in result["ms"].values():
        row["sum"] = sum(row[name] for name, *_ in SITES)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
