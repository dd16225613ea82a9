"""Conv 4x4 stride 2 with a fused BatchNorm-affine + LeakyReLU prologue.

Counterpart of ``dcvgan_tpu/ops/fused_block.py``. It computes

    out = conv2d(k=4, s=2, p=1)(leaky_relu(x * scale + shift, negative_slope))

with ``scale``/``shift`` a BatchNorm folded per channel in f32, no bias, f32
accumulation and the output in ``x.dtype``; the activation is rounded to
``x.dtype`` before the product. Zero padding applies to the activation, so a
padded tap contributes 0. With ``xn_out`` the activation is also written out,
once per input pixel: the colour generator's down path keeps it as the U-Net
skip (``models/cgen.py``).

On a CUDA tensor the wrapper launches the hand-written TMA + wgmma kernel
in ``csrc/fused_block.cu`` (replacing the Pallas ``_fused_kernel``) and
counts the launch in ``fused_norm_act_conv.launches`` (and by route in
``fused_norm_act_conv.routes``: ``tma`` for bf16, ``tf32x3`` for f32); on a
CPU tensor it runs :func:`reference_norm_act_conv`, the plain version.

The kernel's schedule is planned here, by shape, before the launch
(:func:`plan`): the tile size, the ring depths, the grid, the shared memory
and the table of tiles the kernel walks (:func:`tile_table`: each tile's
pixels, channels, staged rows and live taps), which the wrapper copies to
the card once per shape. The CUDA source checks the shared memory against
its own layout and the staged rows against its own count of the rows a tile
reads. A shape the kernel cannot take (C not a multiple of 8 in bf16 or 4 in
f32, Cout not of 16, a pointer not 16-byte aligned, W > 256, a tile's rows
or layout beyond a TMA box or shared memory) has no plan, and on CUDA it
raises ``ValueError``, as ``ops/fused_up.py`` does: there is no fallback
from the kernel to the plain version. No configuration's colour generator
reaches such a shape.

``tf32x3`` is the TMA kernel on f32 with error-compensated TF32 products:
each operand is split into two TF32 parts (v = hi + lo) and three
tensor-core products (lo*hi + hi*lo + hi*hi) accumulate in f32, which holds
the output within the f32 tolerance of a full-f32 convolution. The wrapper
allocates the scratch that receives the weight's two parts; the library
fills it before the kernel runs.

Layouts are torch's: ``x`` is (N, C, H, W) and the weight (Cout, C, 4, 4),
both in ``torch.channels_last`` memory format, so the kernel reads NHWC with
contiguous channels and the weight as a Cout x (4*4*C) matrix.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from dcvgan_torch.ops import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CL = torch.channels_last


# ---------------------------------------------------------------- the plan --

TILE_M = 128  # output pixels per TMA tile: two consumer warpgroups of 64 rows
SMEM_LIMIT = 232_448  # dynamic shared memory one block may opt into on Hopper
# a staged pixel's or weight row's channels a pipeline stage (64 bf16, 32
# f32): TMA's widest swizzle
ROW_BYTES = 128
# weight parts per stage: f32 stages the high and the low TF32 part
WEIGHT_PARTS = {torch.bfloat16: 1, torch.float32: 2}
# the kernel's route, by dtype
TMA_ROUTE = {torch.bfloat16: "tma", torch.float32: "tf32x3"}
# channels a multiple of this: 16-byte rows for TMA
CHANNEL_MULTIPLE = {torch.bfloat16: 8, torch.float32: 4}
# output channels per tile at most: f32 keeps two accumulators and a tap's
# split A fragments in the consumers' registers (csrc/fused_block.cu: kMaxBN)
MAX_BN = {torch.bfloat16: 192, torch.float32: 64}
# the tile widths the kernel is built for, widest first: a plan takes the
# widest that divides Cout. bf16 goes to 192 for a Cout that 192 divides
# (cgen ngf 96's 192 and 384: each M tile's A is then gathered and
# transformed once or twice, not three times; PERF.md: at N = 4096 down1
# 3.42 -> 1.75 ms, 64 -> 192 wide; 384 -> 384 at 8 px 0.75 -> 0.58, 128 ->
# 192); ngf 64's 128 and 256 keep 128
TILE_WIDTHS = (192, 128, 96, 64, 32, 16)
REGION_STAGES = 2
MAX_W_STAGES = 8
MIN_W_STAGES = 2
H100_SMS = 132
# the columns of a tile-table row, as the kernel reads them
TILE_COLUMNS = ("m0", "m1", "n0", "p_lo", "live")


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel runs one call: its ``route`` and its schedule."""

    route: str  # "tma" (bf16) or "tf32x3" (f32)
    bn: int  # output channels per tile (one of TILE_WIDTHS that divides Cout, at most MAX_BN)
    w_stages: int  # weight ring depth: one tap x ROW_BYTES of channels x bn rows x parts each
    region_rows: int  # flattened input rows staged per tile and chunk
    grid: int  # CTAs, persistent: CTA b runs units b, b + grid, ...
    smem: int  # dynamic shared memory bytes (the CUDA layout's, checked there)
    m_tiles: int
    units: int  # m_tiles x (Cout / bn): the rows of :func:`tile_table`


@functools.lru_cache(maxsize=64)
def _m_tiles(n: int, h: int, w: int) -> torch.Tensor:
    """One row per TILE_M-pixel M tile: m0, m1, the first and last flattened
    input row (n * H + ih) its output pixels read, and its live taps (bit
    ``4 * kh + kw`` set when tap (kh, kw) reads the image for some pixel of
    the tile; the others multiply only padding, 0 after the prologue).

    The tiles' shapes repeat every ``period`` tiles (a whole number of
    images), so the live taps are found over one period and the last tile."""
    oh, ow = h // 2, w // 2
    m = n * oh * ow
    mt = -(-m // TILE_M)
    m0 = torch.arange(mt, dtype=torch.int64) * TILE_M
    m1 = torch.clamp(m0 + TILE_M, max=m)
    q0, q1 = m0 // ow, (m1 - 1) // ow  # flattened output rows
    lo = q0 // oh * h + torch.clamp(2 * (q0 % oh) - 1, min=0)
    hi = q1 // oh * h + torch.clamp(2 * (q1 % oh) + 2, max=h - 1)

    def live(first: int, count: int) -> torch.Tensor:
        """Live taps of tiles first .. first + count - 1."""
        px = first * TILE_M + torch.arange(count * TILE_M)
        r = px % (oh * ow)
        ph, pw = r // ow, r % ow
        rows = 6 | (ph >= 1).long() | ((2 * ph + 2 < h).long() << 3)
        cols = 6 | (pw >= 1).long() | ((2 * pw + 2 < w).long() << 3)
        mask = sum(((rows >> k) & 1) * (cols << (4 * k)) for k in range(4))
        mask = torch.where(px < m, mask, 0).reshape(count, TILE_M)
        return sum(((mask >> b) & 1).amax(1) << b for b in range(16))

    period = oh * ow // math.gcd(TILE_M, oh * ow)
    taps = live(0, min(mt, period)).repeat(-(-mt // period))[:mt]
    if mt > period:
        taps[-1] = live(mt - 1, 1)[0]
    return torch.stack([m0, m1, lo, hi, taps], 1)


@functools.lru_cache(maxsize=64)
def tile_table(n: int, h: int, w: int, bn: int, cout: int) -> torch.Tensor:
    """The units of a TMA launch, the kernel's whole walk: one int32 row per
    unit (``TILE_COLUMNS``: output pixels [m0, m1), output channels
    [n0, n0 + bn), the first staged input row, the live taps), unit
    ``u`` = M tile ``u // (cout // bn)`` at Cout tile ``u % (cout // bn)``."""
    t = _m_tiles(n, h, w)
    n_tiles_n = cout // bn
    t = t.repeat_interleave(n_tiles_n, 0)
    n0 = torch.arange(n_tiles_n, dtype=torch.int64).repeat(len(t) // n_tiles_n) * bn
    return torch.stack([t[:, 0], t[:, 1], n0, t[:, 2], t[:, 4]], 1).to(torch.int32).contiguous()


def _smem_bytes(w: int, bn: int, w_stages: int, rows: int, parts: int = 1) -> int:
    """The CUDA source's ``tma::layout(...).total``."""

    def up(v: int, m: int) -> int:
        return -(-v // m) * m

    region = up(rows * w * ROW_BYTES, 1024)
    wstage = parts * up(bn * ROW_BYTES, 1024)
    return 1024 + REGION_STAGES * region + w_stages * wstage + 128 + 8 * (
        3 * REGION_STAGES + 2 * w_stages
    )


@functools.lru_cache(maxsize=256)
def plan(
    n: int, h: int, w: int, c: int, cout: int, dtype: torch.dtype,
    aligned: bool = True, sms: int = H100_SMS,
) -> Optional[Plan]:
    """The kernel's schedule for one call, from its shape alone, or None
    where the kernel cannot take the shape.

    The kernel takes C a multiple of 8 (bf16) or 4 (f32), Cout a multiple of
    16, W <= 256 and the rows of a tile <= 256 (TMA box limits), and a layout
    that fits in shared memory: route ``tma`` for bf16, ``tf32x3`` for f32.

    ``aligned``: every pointer is 16-byte aligned. ``sms``: the card's
    streaming multiprocessors.
    """
    m = n * (h // 2) * (w // 2)
    if not (aligned and c % CHANNEL_MULTIPLE[dtype] == 0 and cout % 16 == 0 and w <= 256 and m > 0):
        return None
    t = _m_tiles(n, h, w)
    rows = int((t[:, 3] - t[:, 2]).max()) + 1
    if rows > 256:
        return None
    m_tiles = len(t)
    widths = [b for b in TILE_WIDTHS if cout % b == 0 and b <= MAX_BN[dtype]]
    # a small site takes narrower tiles until the grid covers at least half the card
    i = 0
    while m_tiles * (cout // widths[i]) < sms // 2 and i + 1 < len(widths):
        i += 1
    bn = widths[i]
    parts = WEIGHT_PARTS[dtype]
    fixed = _smem_bytes(w, bn, 0, rows, parts)
    stages = min(MAX_W_STAGES, (SMEM_LIMIT - fixed) // (_smem_bytes(w, bn, 1, rows, parts) - fixed))
    if stages < MIN_W_STAGES:
        return None
    units = m_tiles * (cout // bn)
    return Plan(
        TMA_ROUTE[dtype], bn=bn, w_stages=stages, region_rows=rows, grid=min(units, sms),
        smem=_smem_bytes(w, bn, stages, rows, parts), m_tiles=m_tiles, units=units,
    )


@functools.lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def bind(lib: ctypes.CDLL):
    """The C entry of a ``fused_block`` library."""
    entry = lib.dcvgan_fused_norm_act_conv_tma
    entry.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float] + [
        ctypes.c_int
    ] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    entry.restype = ctypes.c_int
    return entry


@functools.cache
def _kernel():
    return bind(build.library("fused_block"))


@functools.lru_cache(maxsize=64)
def _tiles_on(device: torch.device, n: int, h: int, w: int, bn: int, cout: int) -> torch.Tensor:
    return tile_table(n, h, w, bn, cout).to(device)


_ERRORS = {
    -2: "the plan's shared memory is not the CUDA source's layout",
    -5: "the plan stages fewer input rows than a tile reads",
    -3: "libcuda has no cuTensorMapEncodeTiled",
    -4: "a TMA tensor map was refused",
}


def plan_for(
    x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, xn_out: Optional[torch.Tensor] = None
) -> Optional[Plan]:
    """:func:`plan` for these CUDA tensors (their shapes, alignment and card)."""
    n, c, h, wd = x.shape
    ptrs = [x, w, out] + ([xn_out] if xn_out is not None else [])
    aligned = all(t.data_ptr() % 16 == 0 for t in ptrs)
    return plan(n, h, wd, c, w.shape[0], x.dtype, aligned, _sms(x.device.index or 0))


def launch(
    p: Plan,
    x: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    w: torch.Tensor,
    out: torch.Tensor,
    negative_slope: float = 0.2,
    xn_out: Optional[torch.Tensor] = None,
    kernel=None,
) -> None:
    """Launch the kernel on plan ``p`` on the current stream; raises if the
    launch fails. ``out`` is (N, Cout, H/2, W/2) channels-last. ``kernel``:
    the :func:`bind` of another build of the source (the lesion tool's); by
    default the package's own."""
    n, c, h, wd = x.shape
    cout = w.shape[0]
    xn_ptr = xn_out.data_ptr() if xn_out is not None else None
    tiles = _tiles_on(x.device, n, h, wd, p.bn, cout)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        # tf32x3: the weight's high and low TF32 parts, written by the library
        split = torch.empty(2 * w.numel(), dtype=torch.float32, device=x.device) if (
            p.route == "tf32x3") else None
        err = (kernel or _kernel())(
            _DTYPE_CODES[x.dtype], x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w.data_ptr(),
            split.data_ptr() if split is not None else None, out.data_ptr(),
            xn_ptr, n, h, wd, c, cout, float(negative_slope),
            p.bn, p.w_stages, p.region_rows, tiles.data_ptr(), p.units, p.grid, p.smem, stream,
        )
    if err in _ERRORS:
        raise ValueError(f"fused_norm_act_conv ({p.route}, width {wd}): {_ERRORS[err]}")
    if err != 0:
        raise RuntimeError(f"fused_norm_act_conv {p.route} kernel launch failed: CUDA error {err}")


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
    Launches on the current stream and does not synchronise. Runs the plain
    version on a CPU tensor; on CUDA raises ``ValueError`` where :func:`plan`
    has no plan.
    """
    _check(x, scale, shift, w, xn_out)
    if x.device.type == "cpu":
        return reference_norm_act_conv(x, scale, shift, w, negative_slope, xn_out)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, c, h, wd = x.shape
    out = torch.empty(
        (n, w.shape[0], h // 2, wd // 2), dtype=x.dtype, device=x.device, memory_format=_CL
    )
    p = plan_for(x, w, out, xn_out)
    if p is None:
        raise ValueError(
            f"fused_norm_act_conv has no plan for x {tuple(x.shape)} {x.dtype}, Cout {w.shape[0]}: "
            f"the kernel takes C a multiple of {CHANNEL_MULTIPLE[x.dtype]}, Cout of 16, a non-empty "
            f"output, 16-byte aligned tensors, W <= 256 and a layout that fits in shared memory"
        )
    launch(p, x, scale, shift, w, out, negative_slope, xn_out)
    fused_norm_act_conv.launches += 1
    fused_norm_act_conv.routes[p.route] += 1
    return out


fused_norm_act_conv.launches = 0
fused_norm_act_conv.routes = collections.Counter()
