"""Where the bf16 fused_block kernel's time goes: a lesion study on the card.

    python3 -m dcvgan_torch.tools.fused_block_lesions

Builds ``csrc/fused_block.cu`` as it is and three copies with a part removed
(the prologue, which also writes ``xn_out``; the MMAs; both), then times each
at the five flagship sites of the colour generator's down path (bf16,
N = 4096 frames, with ``xn_out``) with CUDA events. The lesioned builds
compute wrong values; only their times mean anything. Prints one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from dcvgan_torch.ops import build

SITES = [("down1", 32, 64, 128), ("down2", 16, 128, 256), ("down3", 8, 256, 256),
         ("down4", 4, 256, 256), ("down5", 2, 256, 256)]
N_FRAMES = 4096
_PROLOGUE = ("  transform_region(0);\n", "      transform_region(s + 1);\n")
_MMA = ("mma_bf16(acc[mi][ni], af[mi], bfrag[ni]);",
        "acc[mi][ni][0] += __uint_as_float(af[mi][0] ^ bfrag[ni][1]);")
LESIONS = {
    "full": (),
    "no_prologue": ((_PROLOGUE[0], ""), (_PROLOGUE[1], "")),
    "no_mma": (_MMA,),
    "loads_only": ((_PROLOGUE[0], ""), (_PROLOGUE[1], ""), _MMA),
}


def _compile(src: str, out: Path) -> ctypes.CDLL:
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out), str(cu)], check=True)
    fn = ctypes.CDLL(str(out)).dcvgan_fused_norm_act_conv
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    inputs = {}
    for name, h, c, cout in SITES:
        cl = torch.channels_last
        x = torch.randn(N_FRAMES, c, h, h, generator=g, device="cuda").bfloat16()
        w = torch.randn(cout, c, 4, 4, generator=g, device="cuda").bfloat16() / (16 * c) ** 0.5
        inputs[name] = (
            x.contiguous(memory_format=cl), w.contiguous(memory_format=cl),
            torch.rand(c, device="cuda") + 0.5, torch.randn(c, device="cuda") * 0.2,
            torch.empty(N_FRAMES, cout, h // 2, h // 2, dtype=torch.bfloat16, device="cuda",
                        memory_format=cl),
            torch.empty(N_FRAMES, c, h, h, dtype=torch.bfloat16, device="cuda", memory_format=cl),
        )
    result = {"card": torch.cuda.get_device_name(0), "ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for lesion, edits in LESIONS.items():
            src = source
            for old, new in edits:
                if old not in src:
                    raise RuntimeError(f"lesion {lesion!r}: the kernel source no longer has {old!r}")
                src = src.replace(old, new)
            fn = _compile(src, Path(tmp) / f"lib{lesion}.so")
            row = {}
            for name, h, c, cout in SITES:
                x, w, scale, shift, out, xn = inputs[name]

                def launch():
                    err = fn(1, x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w.data_ptr(),
                             out.data_ptr(), xn.data_ptr(), N_FRAMES, h, h, c, cout, 0.2,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: {err}")

                row[name] = _time_ms(launch)
            result["ms"][lesion] = row
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
