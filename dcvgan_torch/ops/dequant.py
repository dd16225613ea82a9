"""uint8 -> [-1, 1] dequantisation on the device.

Counterpart of ``dcvgan_tpu/ops/dequant.py``. The loader ships raw uint8
batches (a quarter of the float32 bytes over PCIe) and the train step turns
them into the compute dtype on the card:

    out = float32(x) / 127.5 - 1.0, cast to ``dtype``

with IEEE division (not a multiply by a reciprocal), so that the result
equals the JAX function's bit for bit for all 256 byte values in float32 and
bfloat16. The shape is kept.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/dequant.cu`` (replacing the Pallas ``_dequant_kernel``) and counts the
launch in ``dequantize_video.launches``; on a CPU tensor it runs
:func:`reference_dequantize`, the plain version. There is no fallback from
the one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dcvgan_torch.ops import build

_DIVISOR = 127.5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reference_dequantize(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain version: ``(x.to(float32) / 127.5 - 1.0).to(dtype)``.

    The divisor is a 0-dim tensor on ``x``'s device, not a Python scalar:
    with a scalar divisor torch's CUDA kernel multiplies by the reciprocal,
    which rounds some of the 256 values differently from a division.
    """
    divisor = torch.tensor(_DIVISOR, dtype=torch.float32, device=x.device)
    return (torch.div(x.to(torch.float32), divisor) - 1.0).to(dtype)


@functools.cache
def _kernel():
    fn = build.library("dequant").dcvgan_dequant
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def dequantize_video(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 tensor of any shape -> ``x / 127.5 - 1`` in ``dtype`` (float32
    or bfloat16), same shape, on ``x``'s device.

    ``x`` must be contiguous; a view that starts off 16-byte alignment is
    read with scalar loads, never copied. Launches on the current stream and
    does not synchronise.
    """
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {x.dtype}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    if x.device.type == "cpu":
        return reference_dequantize(x, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("dequantize_video needs a contiguous tensor")
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(_DTYPE_CODES[dtype], x.data_ptr(), out.data_ptr(), x.numel(), stream)
    if err != 0:
        raise RuntimeError(f"dequantize_video kernel launch failed: CUDA error {err}")
    dequantize_video.launches += 1
    return out


dequantize_video.launches = 0
