"""uint8 -> [-1, 1] dequantisation on the device.

Counterpart of ``dcvgan_tpu/ops/dequant.py``. The loader ships raw uint8
batches (a quarter of the float32 bytes over PCIe) and the train step turns
them into the compute dtype on the card:

    out = float32(x) / 127.5 - 1.0, cast to ``dtype``

with IEEE division (not a multiply by a reciprocal), so that the result
equals the JAX function's bit for bit for all 256 byte values in float32 and
bfloat16. The shape is kept.

:func:`dequantize_videos` takes up to four tensors and, on CUDA, dequantises
all of them in ONE launch of the hand-written kernel in ``csrc/dequant.cu``
(replacing the Pallas ``_dequant_kernel``): a train step's colour and depth
batches cost one launch. :func:`dequantize_video` is its one-tensor form.
``dequantize_video.launches`` counts kernel launches, not tensors. On CPU
tensors both run :func:`reference_dequantize`, the plain version. There is
no fallback from the one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from dcvgan_torch.ops import build

_DIVISOR = 127.5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SEGMENTS = 4  # tensors per launch (csrc/dequant.cu: kMaxSegments)


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
    fn = build.library("dequant").dcvgan_dequant_segments
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _raw_stream(device_index: int) -> int:
    """The current CUDA stream of a device as an integer handle, without
    building a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _launch(xs: Sequence[torch.Tensor], outs: Sequence[torch.Tensor], dtype: torch.dtype) -> None:
    """One kernel launch over the segments ``(x, out)``, on ``xs[0]``'s
    device and its current stream; counted in ``dequantize_video.launches``."""
    args: List[int] = []
    for x, out in zip(xs, outs):
        args += (x.data_ptr(), out.data_ptr(), x.numel())
    device = xs[0].device.index
    err = _kernel()(
        _DTYPE_CODES[dtype], len(xs), (ctypes.c_longlong * len(args))(*args), device,
        _raw_stream(device),
    )
    if err != 0:
        raise RuntimeError(f"dequantize_video kernel launch failed: CUDA error {err}")
    dequantize_video.launches += 1


def dequantize_videos(
    xs: Sequence[torch.Tensor], dtype: torch.dtype = torch.bfloat16
) -> List[torch.Tensor]:
    """uint8 tensors of any shapes -> ``x / 127.5 - 1`` in ``dtype``
    (float32 or bfloat16), each its own shape, in one kernel launch.

    ``xs`` holds 1 to 4 tensors on one device, each contiguous; a view that
    starts off alignment is read with scalar loads, never copied.
    Launches on the current stream and does not synchronise; launches
    nothing when every tensor is empty.
    """
    xs = list(xs)
    if not 1 <= len(xs) <= MAX_SEGMENTS:
        raise ValueError(f"dequantize_videos takes 1 to {MAX_SEGMENTS} tensors, got {len(xs)}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    device = xs[0].device
    for x in xs:
        if x.dtype != torch.uint8:
            raise TypeError(f"expected uint8, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"tensors on {device} and {x.device}: one device per call")
    if device.type == "cpu":
        return [reference_dequantize(x, dtype) for x in xs]
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("dequantize_video needs contiguous tensors")
    outs = [torch.empty_like(x, dtype=dtype) for x in xs]  # contiguous, as x is
    if any(x.numel() for x in xs):
        _launch(xs, outs, dtype)
    return outs


def dequantize_video(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One tensor through :func:`dequantize_videos`: same shape, ``dtype``,
    on ``x``'s device."""
    return dequantize_videos([x], dtype)[0]


dequantize_video.launches = 0
