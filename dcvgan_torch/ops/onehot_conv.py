"""The colour generator's input conv on a segmentation input, in one launch.

It computes

    out = leaky_relu(conv2d(2 * one_hot(argmax_c p) - 1, w, padding=1), slope)

with ``p`` (N, C, H, W) class scores (ggen's softmax) and ``w`` (Cout, C, 3,
3), channels-last in and out; ties take the first class, as
``torch.argmax`` does.

It replaces no Pallas kernel: the JAX package leaves the argmax, the one-hot
and the conv to XLA. It was added because on the H100 the unfused chain
(argmax, an int64 one-hot, its cast and affine, cuDNN's conv on C = 25
channels, a separate LeakyReLU) moves some 19 GB a sampling round of 4,096
frames, against the 2.99 GB the op needs (each score read once, each output
written once). The conv of a +-1 one-hot is a gather: with ``T[t][c] = 2 *
w[:, c, t] - sum_c' w[:, c', t]``, a pixel's conv is the sum of ``T[t][c(q +
t)]`` over the taps ``t`` whose input pixel ``q + t`` lies in the image.
``ColorVideoGenerator`` (``models/cgen.py``) takes the op for a segmentation
input in eval mode in bfloat16 on CUDA (``models.layers.onehot_fused``): one
launch a sampling round.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/onehot_conv.cu`` (built on the first call, not before) and counts it
in ``onehot_conv3x3.launches``; a shape the kernel cannot take raises. On a
CPU tensor it runs :func:`reference_onehot_conv3x3`, the plain version: the
unfused chain. There is no fallback from the one to the other. The f32 table
``T`` (9 x C x Cout) is built once per weight version and kept on the weight
tensor (:func:`gather_table`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from dcvgan_torch.ops import build

_CL = torch.channels_last

GROUPS = 4  # the CUDA source's kGroups: groups of 256 threads a CTA, each with its own tile
TILE_PIXELS = 512  # a tile is this many pixels of whole image rows, at least one row
SMEM_LIMIT = 232_448  # dynamic shared memory one block may opt into on Hopper


@dataclasses.dataclass(frozen=True)
class Plan:
    rows: int  # image rows a tile: the CTAs' groups walk the N x ceil(H / rows) tiles
    vec: bool  # scores staged in 16-byte pieces (p aligned, W * C a multiple of 8)
    smem: int  # dynamic shared memory bytes: the table, and each group's staged scores and labels


def _smem_bytes(w: int, c: int, cout: int, rows: int, groups: int = GROUPS) -> int:
    """The CUDA source's layout: the f32 table, then for each group the
    staged scores of ``rows`` + 2 image rows and the int16 labels with
    halo, each rounded up to 16 bytes."""
    return 9 * c * cout * 4 + groups * (-(-(rows + 2) * w * c * 2 // 16) * 16 + -(-(rows + 2) * (w + 2) * 2 // 16) * 16)


@functools.lru_cache(maxsize=64)
def plan(n: int, h: int, w: int, c: int, cout: int, aligned: bool = True) -> Plan:
    """The schedule of one call from its shape; raises ``ValueError`` for a
    shape the kernel cannot take: Cout not a multiple of 8, more classes than
    an int16 label holds, or a table and each group's one image row that do
    not fit in shared memory."""
    if n * h * w == 0 or c < 1:
        raise ValueError(f"empty shape {(n, c, h, w)}")
    if cout < 8 or cout % 8:
        raise ValueError(f"Cout must be a multiple of 8, got {cout}")
    if c > 32767:
        raise ValueError(f"at most 32767 classes, got {c}")
    rows = max(1, min(h, TILE_PIXELS // w))
    while rows > 1 and _smem_bytes(w, c, cout, rows) > SMEM_LIMIT:
        rows //= 2
    smem = _smem_bytes(w, c, cout, rows)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the table of {c} classes x {cout} channels and {GROUPS} groups' image rows of width {w} need "
                         f"{smem} bytes of shared memory, over {SMEM_LIMIT}")
    return Plan(rows, aligned and (w * c) % 8 == 0, smem)


def _check(p: torch.Tensor, w: torch.Tensor) -> None:
    if p.dim() != 4:
        raise ValueError(f"p must be (N, C, H, W), got shape {tuple(p.shape)}")
    c = p.shape[1]
    if w.dim() != 4 or w.shape[1] != c or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"w must be (Cout, {c}, 3, 3), got {tuple(w.shape)}")
    if w.dtype != p.dtype:
        raise TypeError(f"w must have p's dtype {p.dtype}, got {w.dtype}")
    if w.device != p.device:
        raise ValueError(f"w must be on {p.device}, got {w.device}")
    if not p.is_contiguous(memory_format=_CL):
        raise ValueError("p must be contiguous in torch.channels_last format")
    if p.device.type == "cuda" and p.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16, got {p.dtype}")


def reference_onehot_conv3x3(p: torch.Tensor, w: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """The plain version, the unfused chain: argmax, a +-1 one-hot in p's
    dtype, the conv (padding 1) and LeakyReLU."""
    x = F.one_hot(p.argmax(1), p.shape[1]).to(p.dtype) * 2.0 - 1.0
    out = F.leaky_relu(F.conv2d(x.permute(0, 3, 1, 2), w, padding=1), slope)
    return out.contiguous(memory_format=_CL)


def table(w: torch.Tensor) -> torch.Tensor:
    """``T`` (9, C, Cout) float32: ``T[kh * 3 + kw, c] = 2 * w[:, c, kh, kw]
    - sum_c' w[:, c', kh, kw]``."""
    wf = w.detach().float()
    t = 2.0 * wf - wf.sum(1, keepdim=True)
    return t.permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0]).contiguous()


def gather_table(w: torch.Tensor) -> torch.Tensor:
    """:func:`table`, kept on ``w`` while its storage and version stay the
    same (a serving copy builds it once); an inference tensor, which has no
    version counter, is built at every call."""
    if w.is_inference():
        return table(w)
    key = (w.data_ptr(), w._version)
    kept = getattr(w, "_onehot_table", None)
    if kept is None or kept[0] != key:
        kept = (key, table(w))
        w._onehot_table = kept
    return kept[1]


@functools.cache
def _kernel():
    fn = build.library("onehot_conv").dcvgan_onehot_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def onehot_conv3x3(p: torch.Tensor, w: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """``leaky_relu(conv2d(2 * one_hot(argmax_c p) - 1, w, padding=1),
    slope)``; see the module docstring.

    p: (N, C, H, W) channels-last, bfloat16 on CUDA; w: (Cout, C, 3, 3) in
    p's dtype, Cout a multiple of 8 on CUDA. Returns (N, Cout, H, W)
    channels-last in p's dtype. Launches on the current stream and does not
    synchronise.
    """
    _check(p, w)
    if p.device.type == "cpu":
        return reference_onehot_conv3x3(p, w, slope)
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    n, c, h, wd = p.shape
    cout = w.shape[0]
    out = torch.empty((n, cout, h, wd), dtype=p.dtype, device=p.device, memory_format=_CL)
    if max(p.numel(), out.numel()) >= 2**31:
        raise ValueError("tensors with 2**31 or more elements are not supported")
    t = gather_table(w)
    pl = plan(n, h, wd, c, cout, p.data_ptr() % 16 == 0)
    fn = _kernel()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), t.data_ptr(), out.data_ptr(), n, h, wd, c, cout, pl.rows, int(pl.vec), pl.smem,
                 float(slope), stream)
    if err != 0:
        raise RuntimeError(f"onehot_conv3x3 kernel launch failed: CUDA error {err}")
    onehot_conv3x3.launches += 1
    return out


onehot_conv3x3.launches = 0
