"""The colour generator's outconv: ``fused_norm_act_up_conv``'s k3 s1 p1 route.

It computes

    out = conv_transpose2d(cat([relu(x * scale + shift), skip], 1), w, stride=1, padding=1)

to a few output channels (cgen's 3 colours; at most :data:`MAX_COUT`) as one
GEMM to tap partials and a 3 x 3 stencil sum, in the hand-written kernel of
``csrc/outconv.cu``:

    T[q, t, c] = sum_k A[q, k] * W27[k, t * Cout + c]     (f32; A: pixel q's K channels)
    out[p, c]  = sum_t T[p + offset(t), t, c]              (t = 0..8 in order, f32, one bf16 rounding)

so each input pixel is gathered once for all nine taps and every output
channel. The source's notes say what bounds it and why. It replaces no
Pallas kernel: the JAX package leaves this conv to XLA.

``ops/fused_up.py``'s :func:`~dcvgan_torch.ops.fused_up.fused_norm_act_up_conv`
takes this route for a k3 s1 p1 weight on CUDA, checks the tensors, packs
the weight once per weight version (:func:`pack_weight`), plans the
schedule (:func:`plan`) and counts the launch under its route ``k3s1``; the
plain version (``reference_norm_act_up_conv``) runs on the CPU. There is no
fallback from the one to the other: a shape the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from dcvgan_torch.ops import build

CHUNK = 64  # channels a staged chunk: 128 bytes of bf16, TMA's widest swizzle
TILE_W = 64  # input columns a row's GEMM takes: one m64 tile
STRIP = TILE_W - 2  # output columns a strip of a row wider than the tile
SLOT_COLS = TILE_W + 2  # a partial row's columns: the tile's and one zero column a side
MAX_COUT = 8  # 9 * Cout tap columns: at most 72, one wgmma of at most 96 columns
MAX_W = 256
SMEM_LIMIT = 232_448  # dynamic shared memory one block may opt into on Hopper
H100_SMS = 132
MIN_STAGES, MAX_STAGES = 2, 8  # the ring of row stages
SLOTS, MIN_SLOTS = 6, 4  # the ring of partial rows: three for an output row, the rest for overlap


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs: the kernel's schedule."""

    bn: int  # W27's padded columns: 9 * Cout rounded up to 16, 32, 64 or 96
    stages: int  # row stages: one image row's chunks (x's, then the skip's) each
    slots: int  # partial rows in shared memory
    strips: int  # column strips a row: 1 up to W = 64, else ceil(W / 62)
    rows: int  # the walk's rows: N x strips x H
    grid: int  # CTAs, one per SM at most: CTA b runs rows cta_rows(rows, grid)[b]
    smem: int  # dynamic shared memory bytes (the CUDA layout's, checked there)


def tap_columns(cout: int) -> int:
    """W27's columns, ``9 * cout``, padded to a wgmma width (16, 32, 64, 96)."""
    n = 9 * cout
    return next(b for b in (16, 32, 64, 96) if n <= b)


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(w: int, c1: int, c2: int, bn: int, stages: int, slots: int) -> int:
    """The CUDA source's ``layout(...).total``: the row stages, W27, the
    partial rows, scale and shift, the mbarriers and 1024 bytes of slack."""
    chunks1, chunks = -(-c1 // CHUNK), -(-c1 // CHUNK) + -(-c2 // CHUNK)
    stage = chunks * _up(min(w, TILE_W) * 128, 1024)
    return (1024 + stages * stage + chunks * bn * 128 + slots * SLOT_COLS * (bn + 8) * 4 + 8 * CHUNK * chunks1
            + 16 * (stages + slots))


@functools.lru_cache(maxsize=64)
def plan(n: int, h: int, w: int, c1: int, c2: int, cout: int, aligned: bool = True, sms: int = H100_SMS) -> Plan:
    """The schedule of one call from its shape; raises ``ValueError`` for a
    shape the kernel cannot take: channel counts not a multiple of 8, Cout
    over :data:`MAX_COUT`, W over :data:`MAX_W` (TMA's box), pointers not
    16-byte aligned, or a row stage too wide for shared memory.

    The grid is one CTA per SM (``sms``), each walking an equal share of the
    rows; as many row stages as fit beside :data:`SLOTS` partial rows, up to
    :data:`MAX_STAGES` (8 at 64 + 64 channels, 4 at 96 + 96)."""
    if not aligned:
        raise ValueError("the outconv takes 16-byte aligned tensors only")
    if c1 <= 0 or c1 % 8 or c2 < 0 or c2 % 8:
        raise ValueError(f"channel counts must be multiples of 8, got x {c1} and skip {c2}")
    if n * h * w == 0 or cout < 1:
        raise ValueError(f"empty shape {(n, h, w, cout)}")
    if cout > MAX_COUT:
        raise ValueError(f"the k3 s1 route takes at most {MAX_COUT} output channels (9 * Cout tap columns), "
                         f"got {cout}")
    if w > MAX_W:
        raise ValueError(f"W {w} is over the TMA box limit of {MAX_W}")
    bn = tap_columns(cout)
    stage = smem_bytes(w, c1, c2, bn, 1, 0) - smem_bytes(w, c1, c2, bn, 0, 0)
    for slots in (SLOTS, MIN_SLOTS):
        stages = min(MAX_STAGES, (SMEM_LIMIT - smem_bytes(w, c1, c2, bn, 0, slots)) // stage)
        if stages >= MIN_STAGES:
            break
    else:
        raise ValueError(f"{MIN_STAGES} row stages of {c1} + {c2} channels at W {w} and {MIN_SLOTS} partial rows "
                         f"do not fit in shared memory")
    strips = 1 if w <= TILE_W else -(-w // STRIP)
    rows = n * strips * h
    return Plan(bn, stages, slots, strips, rows, min(rows, sms), smem_bytes(w, c1, c2, bn, stages, slots))


def cta_rows(rows: int, h: int, grid: int) -> List[Tuple[int, int, int, int]]:
    """Each CTA's walk, as the kernel computes it: ``(g0, g1, lo, hi)``, the
    output rows ``[g0, g1)`` it writes (of the walk's rows, frame by frame
    and strip by strip, ``h`` rows each) and the rows ``[lo, hi]`` whose
    partials it computes, one more a side where its range starts or ends
    inside a frame."""
    walks = []
    for b in range(grid):
        g0, g1 = b * rows // grid, (b + 1) * rows // grid
        lo = g0 - 1 if g0 % h else g0
        hi = g1 if (g1 - 1) % h != h - 1 else g1 - 1
        walks.append((g0, g1, lo, hi))
    return walks


def pack_weight(w: torch.Tensor, c1: int) -> torch.Tensor:
    """The kernel's W27, ``(chunks, BN, 64)``: chunk ``cc``, column ``t *
    Cout + c``, channel ``j`` holds ``w[k, c, 2 - t // 3, 2 - t % 3]`` for
    the input channel ``k`` at packed position ``64 cc + j`` (x's ``c1``
    channels from 0, the skip's from ``64 * ceil(c1 / 64)``; zeros between,
    past the runs and past ``9 * Cout``). ``w``: a (C1 + C2, Cout, 3, 3)
    ConvTranspose2d weight; tap ``t`` reads input pixel ``p + (t // 3 - 1,
    t % 3 - 1)``, so it takes the flipped kernel."""
    cin, cout = w.shape[:2]
    chunks1, chunks2 = -(-c1 // CHUNK), -(-(cin - c1) // CHUNK)
    bn = tap_columns(cout)
    taps = w.flip(2, 3).reshape(cin, cout, 9).permute(0, 2, 1).reshape(cin, 9 * cout)  # (K, t * Cout + c)
    g = w.new_zeros(((chunks1 + chunks2) * CHUNK, bn))
    off = chunks1 * CHUNK
    g[:c1, : 9 * cout] = taps[:c1]
    g[off : off + cin - c1, : 9 * cout] = taps[c1:]
    return g.reshape(chunks1 + chunks2, CHUNK, bn).transpose(1, 2).contiguous()


@functools.cache
def _kernel():
    fn = build.library("outconv").dcvgan_outconv
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_ERRORS = {
    -2: "the plan's shared memory is not the CUDA source's layout",
    -3: "libcuda has no cuTensorMapEncodeTiled",
    -4: "a TMA tensor map was refused",
}


def plan_for(x: torch.Tensor, w27: torch.Tensor, out: torch.Tensor, skip: Optional[torch.Tensor]) -> Plan:
    """:func:`plan` for these CUDA tensors (their shapes, alignment and card)."""
    n, c1, h, wd = x.shape
    ptrs = [x, w27, out] + ([skip] if skip is not None else [])
    aligned = all(t.data_ptr() % 16 == 0 for t in ptrs)
    c2 = 0 if skip is None else skip.shape[1]
    return plan(n, h, wd, c1, c2, out.shape[1], aligned, _sms(x.device.index or 0))


def launch(p: Plan, x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, w27: torch.Tensor,
           out: torch.Tensor, skip: Optional[torch.Tensor] = None) -> None:
    """Launch the kernel on the current stream; raises if the launch fails.
    ``w27`` is :func:`pack_weight`'s matrix, ``out`` (N, Cout, H, W)
    channels-last."""
    n, c1, h, wd = x.shape
    c2 = 0 if skip is None else skip.shape[1]
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), skip.data_ptr() if skip is not None else None, scale.data_ptr(), shift.data_ptr(),
                 w27.data_ptr(), out.data_ptr(), n, h, wd, c1, c2, out.shape[1], p.stages, p.slots, p.grid, p.smem,
                 stream)
    if err in _ERRORS:
        raise ValueError(f"outconv (width {wd}): {_ERRORS[err]}")
    if err != 0:
        raise RuntimeError(f"outconv kernel launch failed: CUDA error {err}")
