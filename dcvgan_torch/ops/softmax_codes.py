"""The geometry generator's segmentation head and its serving codes, in one op.

It computes, from the head conv's raw scores ``raw`` (N, C, H, W),

    probs = softmax(raw, dim=1)
    codes = quantize(probs)         # uint8, the serving quantisation
    total = codes.sum(dtype=int64)

and returns them as :class:`SoftmaxCodes`, probabilities and codes
channels-last like ``raw``.

It replaces no Pallas kernel: the JAX package leaves the softmax and the
quantisation to XLA. It was added because on the H100 the PyTorch chain
took some 40 ms a serving chunk of surreal-segm (4 rounds of 4,096 frames
of 64 x 64 x 25): the softmax makes the channels-last scores contiguous in
NCHW first, ``decode`` returns a permuted view of its output, and
``quantize`` (four elementwise ops with a float round trip) and the
checksum run strided over that view. The op needs 5 bytes an element (each
score read once, each probability and code written once), 0.63 ms a round
at 3.35 TB/s. ``GeometricVideoGenerator`` (``models/ggen.py``) takes it for
its softmax head wherever the decoder runs fused (eval, bfloat16, CUDA,
BatchNorm): one launch a sampling round, and ``cli.serve``'s chunk takes the
codes and their sum from it instead of quantising the geometry video.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/softmax_codes.cu`` (built on the first call, not before) and counts it
in ``softmax_codes.launches``; a shape, type or layout the kernel cannot
take raises. On a CPU tensor it runs :func:`reference_softmax_codes`, the
plain version: the module chain. There is no fallback from the one to the
other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from dcvgan_torch.ops import build

_CL = torch.channels_last

TILE = 256  # the CUDA source's kThreads: pixels a tile, one a thread
SMEM_LIMIT = 232_448  # dynamic shared memory one block may opt into on Hopper


class SoftmaxCodes(NamedTuple):
    probs: torch.Tensor  # (N, C, H, W) channels-last, raw's dtype: softmax over C
    codes: torch.Tensor  # (N, C, H, W) channels-last uint8: quantize(probs)
    total: torch.Tensor  # int64 scalar: the sum of the codes


def quantize(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 as the JAX server computes it: clip, +1, *127.5 in
    ``x.dtype`` (bf16 arithmetic rounds in bf16), then a truncating cast."""
    return ((x.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)


def smem_bytes(c: int) -> int:
    """The kernel's dynamic shared memory for ``c`` classes: two tiles of
    scores. Raises ``ValueError`` where they do not fit in one block's."""
    smem = 2 * TILE * c * 2
    if smem > SMEM_LIMIT:
        raise ValueError(f"two tiles of {TILE} pixels of {c} classes need {smem} bytes of shared memory, "
                         f"over {SMEM_LIMIT}")
    return smem


def _check(raw: torch.Tensor) -> None:
    if raw.dim() != 4:
        raise ValueError(f"raw must be (N, C, H, W), got shape {tuple(raw.shape)}")
    if raw.numel() == 0:
        raise ValueError(f"empty shape {tuple(raw.shape)}")
    if not raw.is_floating_point():
        raise TypeError(f"raw must be floating point, got {raw.dtype}")
    if not raw.is_contiguous(memory_format=_CL):
        raise ValueError("raw must be contiguous in torch.channels_last format")
    if raw.device.type == "cuda":
        if raw.dtype != torch.bfloat16:
            raise TypeError(f"the kernel takes bfloat16, got {raw.dtype}")
        if raw.data_ptr() % 16:
            raise ValueError("the kernel takes raw at a 16-byte aligned address")
        if raw.numel() >= 2**31:
            raise ValueError("tensors with 2**31 or more elements are not supported")


def reference_softmax_codes(raw: torch.Tensor) -> SoftmaxCodes:
    """The plain version, the module chain: ``torch.softmax`` over C in
    raw's dtype, :func:`quantize` of it, the int64 sum."""
    probs = torch.softmax(raw, 1).contiguous(memory_format=_CL)
    codes = quantize(probs).contiguous(memory_format=_CL)
    return SoftmaxCodes(probs, codes, codes.sum(dtype=torch.int64))


@functools.cache
def _kernel():
    fn = build.library("softmax_codes").dcvgan_softmax_codes
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def softmax_codes(raw: torch.Tensor) -> SoftmaxCodes:
    """``softmax(raw, 1)``, its :func:`quantize` codes and their int64 sum;
    see the module docstring.

    raw: (N, C, H, W) channels-last, bfloat16 at a 16-byte aligned address
    on CUDA. Launches on the current stream and does not synchronise.
    """
    _check(raw)
    if raw.device.type == "cpu":
        return reference_softmax_codes(raw)
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    n, c, h, w = raw.shape
    smem = smem_bytes(c)
    probs = torch.empty_like(raw, memory_format=_CL)
    codes = torch.empty(raw.shape, dtype=torch.uint8, device=raw.device, memory_format=_CL)
    total = torch.zeros((), dtype=torch.int64, device=raw.device)
    fn = _kernel()
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        err = fn(raw.data_ptr(), probs.data_ptr(), codes.data_ptr(), total.data_ptr(), n * h * w, c, smem, stream)
    if err != 0:
        raise RuntimeError(f"softmax_codes kernel launch failed: CUDA error {err}")
    softmax_codes.launches += 1
    return SoftmaxCodes(probs, codes, total)


softmax_codes.launches = 0
