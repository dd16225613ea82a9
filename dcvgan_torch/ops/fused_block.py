"""Conv 4x4 stride 2 with a fused BatchNorm-affine + LeakyReLU prologue.

Counterpart of ``dcvgan_tpu/ops/fused_block.py``. It computes

    out = conv2d(k=4, s=2, p=1)(leaky_relu(x * scale + shift, negative_slope))

with ``scale``/``shift`` a BatchNorm folded per channel in f32, no bias, f32
accumulation and the output in ``x.dtype``; the activation is rounded to
``x.dtype`` before the product. Zero padding applies to the activation, so a
padded tap contributes 0. With ``xn_out`` the activation is also written out,
once per input pixel: the colour generator's down path keeps it as the U-Net
skip (``models/cgen.py``).

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/fused_block.cu`` (replacing the Pallas ``_fused_kernel``) and counts
the launch in ``fused_norm_act_conv.launches``; on a CPU tensor it runs
:func:`reference_norm_act_conv`, the plain version. There is no fallback
from the one to the other.

Layouts are torch's: ``x`` is (N, C, H, W) and the weight (Cout, C, 4, 4),
both in ``torch.channels_last`` memory format, so the kernel reads NHWC with
contiguous channels and the weight as a Cout x (4*4*C) matrix.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from dcvgan_torch.ops import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CL = torch.channels_last


def _check(
    x: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    w: torch.Tensor,
    xn_out: Optional[torch.Tensor],
) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got shape {tuple(x.shape)}")
    n, c, h, wd = x.shape
    if h % 2 or wd % 2:
        raise ValueError(f"H/W must be even, got {(h, wd)}")
    if w.dtype != x.dtype:
        raise TypeError(f"w must have x's dtype {x.dtype}, got {w.dtype}")
    if w.dim() != 4 or tuple(w.shape[1:]) != (c, 4, 4):
        raise ValueError(f"w must be (Cout, {c}, 4, 4), got {tuple(w.shape)}")
    for name, v in (("scale", scale), ("shift", shift)):
        if v.dtype != torch.float32 or tuple(v.shape) != (c,):
            raise ValueError(f"{name} must be float32 of shape ({c},)")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous(memory_format=_CL):
        raise ValueError("x must be contiguous in torch.channels_last format")
    if not w.is_contiguous(memory_format=_CL):
        raise ValueError("w must be contiguous in torch.channels_last format")
    tensors = [scale, shift, w]
    if xn_out is not None:
        if xn_out.dtype != x.dtype or xn_out.shape != x.shape:
            raise ValueError("xn_out must match x's shape and dtype")
        if not xn_out.is_contiguous(memory_format=_CL):
            raise ValueError("xn_out must be contiguous in torch.channels_last format")
        tensors.append(xn_out)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got {t.device}")
    if max(x.numel(), w.numel()) >= 2**31:
        raise ValueError("tensors with 2**31 or more elements are not supported")


def reference_norm_act_conv(
    x: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    w: torch.Tensor,
    negative_slope: float = 0.2,
    xn_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version: materialise the activation, then an f32 conv."""
    xn = x.float() * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
    xn = torch.where(xn >= 0, xn, xn * negative_slope).to(x.dtype)
    if xn_out is not None:
        xn_out.copy_(xn)
    out = F.conv2d(xn.float(), w.float(), stride=2, padding=1)
    return out.to(x.dtype).contiguous(memory_format=_CL)


@functools.cache
def _kernel():
    fn = build.library("fused_block").dcvgan_fused_norm_act_conv
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def fused_norm_act_conv(
    x: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    w: torch.Tensor,
    negative_slope: float = 0.2,
    xn_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``conv4x4s2p1(leaky_relu(x * scale + shift))``; see the module docstring.

    x: (N, C, H, W) channels-last, float32 or bfloat16, H and W even;
    scale, shift: (C,) float32; w: (Cout, C, 4, 4) channels-last in x's
    dtype; xn_out: optional (N, C, H, W) channels-last in x's dtype that
    receives the activation. Returns (N, Cout, H/2, W/2) channels-last.
    Launches on the current stream and does not synchronise.
    """
    _check(x, scale, shift, w, xn_out)
    if x.device.type == "cpu":
        return reference_norm_act_conv(x, scale, shift, w, negative_slope, xn_out)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, c, h, wd = x.shape
    cout = w.shape[0]
    out = torch.empty(
        (n, cout, h // 2, wd // 2), dtype=x.dtype, device=x.device, memory_format=_CL
    )
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(
            _DTYPE_CODES[x.dtype],
            x.data_ptr(),
            scale.data_ptr(),
            shift.data_ptr(),
            w.data_ptr(),
            out.data_ptr(),
            xn_out.data_ptr() if xn_out is not None else None,
            n, h, wd, c, cout,
            float(negative_slope),
            stream,
        )
    if err == -1:
        raise ValueError(
            f"fused_norm_act_conv: the input rows a bf16 tile reads (width {wd}) "
            "do not fit in shared memory"
        )
    if err != 0:
        raise RuntimeError(f"fused_norm_act_conv kernel launch failed: CUDA error {err}")
    fused_norm_act_conv.launches += 1
    return out


fused_norm_act_conv.launches = 0
