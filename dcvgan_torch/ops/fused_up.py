"""One decoder stage: BatchNorm-affine + ReLU, the U-Net skip and a transposed conv.

It computes

    out = conv_transpose2d(cat([relu(x * scale + shift), skip], 1), w, stride, padding)

with ``scale``/``shift`` the previous stage's eval-mode BatchNorm folded per
channel in f32 (``models.layers.fold_batch_norm``), the activation rounded
to bf16 before the product, ``skip`` (optional) read as it is, zero padding
on the activation, f32 accumulation and the raw conv result in bf16,
channels-last. Two geometries, two algorithms: k4 s2 p1 (the decoders' up
stages) and k3 s1 p1 to at most 8 channels (the colour generator's outconv).

It replaces no Pallas kernel: the JAX package leaves these convs and the
BatchNorm, ReLU and concatenation around them to XLA. It was added because
under cuDNN they were four passes over each activation and most of a
sampling round's device time on the H100; the generators' eval-mode bf16
decode (``models/ggen.py``, ``models/cgen.py``) runs each stage as one
launch of this op.

On a CUDA tensor the wrapper launches a hand-written kernel by geometry and
counts the launch in ``fused_norm_act_up_conv.launches`` (and by geometry in
``fused_norm_act_up_conv.routes``: ``k4s2``, ``k3s1``): ``k4s2`` the implicit
GEMM of ``csrc/fused_up.cu``, ``k3s1`` the tap-partials GEMM and stencil of
``csrc/outconv.cu`` (``ops/outconv.py``); a shape a kernel cannot take
raises. On a CPU tensor it runs :func:`reference_norm_act_up_conv`, the plain
version. There is no fallback from the one to the other.

The k4s2 schedule is planned here, by shape (:func:`plan`): a unit's input
positions (128 or 256), output phases (one or all four) and output
channels, whether its weights stay resident in shared memory or stream, the
ring depths, the grid and the shared memory, and the table of units the
kernel walks (:func:`tile_table`), copied to the card once per shape. The
weight ``(C_x + C_skip, Cout, k, k)`` is repacked for the tensor cores
(:func:`gemm_weight`) once per weight version.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from dcvgan_torch.ops import build, outconv

_CL = torch.channels_last

TILE_M = 128  # input positions per tile and m-block: two consumer warpgroups of 64 rows
CHUNK = 64  # channels a pipeline stage: 128 bytes of bf16, TMA's widest swizzle
ROW_BYTES = 128
SMEM_LIMIT = 232_448  # dynamic shared memory one block may opt into on Hopper
MIN_REGION_STAGES, MAX_REGION_STAGES = 2, 6
MIN_W_STAGES, MAX_W_STAGES = 2, 12  # the streamed weight ring
# shared memory a unit's weights (its phases' taps x chunks at its Cout tile)
# may take to stay resident for a CTA's whole walk
RESIDENT_BYTES = 160 * 1024
H100_SMS = 132
# the one tile width that is no power of two: a Cout that 96 divides and 128
# does not (ggen's 192 and 96 at ngf 96) fills its tiles, where 128-channel
# tiles would leave a quarter of every product empty
WIDE_ODD = 96
# (kernel, stride, padding) -> route
GEOMETRIES = {(4, 2, 1): "k4s2", (3, 1, 1): "k3s1"}
PHASES = 4  # output phases of a k4s2 output: its parities (py, px)
# the columns of a tile-table row, as the kernel reads them
TILE_COLUMNS = ("m0", "m1", "n0", "p_lo", "phase")


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one k4s2 call runs: the kernel's schedule."""

    phases: int  # output phases a unit computes: 1, or 4 (resident weights)
    mblocks: int  # m-blocks of 64 rows a consumer warpgroup takes: a unit is TILE_M * mblocks positions
    bn: int  # output channels per tile: 16, 32, 64, 128, or WIDE_ODD
    region_stages: int  # staged regions: one CHUNK of channels of a tile's rows each
    w_stages: int  # weight stages: one tap x CHUNK channels x bn rows each
    resident: bool  # each CTA loads its units' weights once (w_stages = chunks x a unit's taps)
    region_rows: int  # flattened input rows staged per tile and chunk
    grid: int  # CTAs, persistent: CTA b runs units b, b + grid, ...
    smem: int  # dynamic shared memory bytes (the CUDA layout's, checked there)
    m_tiles: int
    units: int  # m_tiles x phase groups x ceil(Cout / bn): the rows of tile_table


@functools.lru_cache(maxsize=64)
def _m_tiles(n: int, h: int, w: int, tile_m: int = TILE_M) -> torch.Tensor:
    """One int64 row per ``tile_m``-position M tile: m0, m1, and the first
    and last flattened input row (n * H + a) its positions read (one row
    above and below, within the image)."""
    m = n * h * w
    m0 = torch.arange(-(-m // tile_m), dtype=torch.int64) * tile_m
    m1 = torch.clamp(m0 + tile_m, max=m)
    q0, q1 = m0 // w, (m1 - 1) // w
    lo = q0 // h * h + torch.clamp(q0 % h - 1, min=0)
    hi = q1 // h * h + torch.clamp(q1 % h + 1, max=h - 1)
    return torch.stack([m0, m1, lo, hi], 1)


@functools.lru_cache(maxsize=64)
def tile_table(n: int, h: int, w: int, bn: int, cout: int, groups: int, tile_m: int = TILE_M) -> torch.Tensor:
    """The units of a launch, the kernel's whole walk: one int32 row per unit
    (``TILE_COLUMNS``: input positions [m0, m1), output channels [n0, n0 +
    bn), the first staged input row, the phase group: the output phase of a
    one-phase unit, else 0). ``groups``: 4 for one-phase units, 1 for
    four-phase ones. Unit ``u`` is M tile ``u // (groups * nt)``, group
    ``u // nt % groups``, Cout tile ``u % nt`` with ``nt = ceil(cout / bn)``: a tile's
    units are neighbours, so the CTAs that run them at once read its rows
    from L2."""
    t = _m_tiles(n, h, w, tile_m)
    nt = -(-cout // bn)
    per = groups * nt
    rows = t.repeat_interleave(per, 0)
    phase = torch.arange(groups, dtype=torch.int64).repeat_interleave(nt).repeat(len(t))
    n0 = torch.arange(nt, dtype=torch.int64).repeat(len(t) * groups) * bn
    return torch.stack([rows[:, 0], rows[:, 1], n0, rows[:, 2], phase], 1).to(torch.int32).contiguous()


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _smem_bytes(w: int, bn: int, region_stages: int, w_stages: int, rows: int) -> int:
    """The CUDA source's ``layout(...).total``."""
    return (1024 + region_stages * _up(rows * w * ROW_BYTES, 1024) + w_stages * _up(bn * ROW_BYTES, 1024) + 128
            + 8 * (3 * region_stages + 2 * w_stages))


def _schedule(n, h, w, c1, c2, cout, unit_phases, mblocks, bn, may_stream, sms) -> Optional[Plan]:
    """The plan of one unit shape (phases, m-blocks, at most ``bn`` output
    channels a tile), its weights resident where they fit, else streamed
    where ``may_stream``; else None."""
    t = _m_tiles(n, h, w, TILE_M * mblocks)
    rows = int((t[:, 3] - t[:, 2]).max()) + 1
    if rows > 256:
        raise ValueError(f"a tile reads {rows} input rows, over the TMA box limit of 256")
    m_tiles, chunks = len(t), -(-c1 // CHUNK) + -(-c2 // CHUNK)
    groups = PHASES // unit_phases
    # a small site splits Cout until the grid covers at least half the card
    while m_tiles * groups * -(-cout // bn) < sms // 2 and bn >= 32:
        bn = 32 if bn == WIDE_ODD else bn // 2
    group = groups * -(-cout // bn)  # units of one M tile
    units = m_tiles * group
    region, stage = _up(rows * w * ROW_BYTES, 1024), _up(bn * ROW_BYTES, 1024)
    fixed = _smem_bytes(w, bn, 0, 0, rows)
    per_region, per_stage = region + 24, stage + 16  # with the stage's barriers
    # resident weights: a unit's chunks x (phase, tap) stages, when they fit
    # beside two regions and the grid can keep every CTA on one phase group
    # and Cout tile
    resident_stages = chunks * 4 * unit_phases
    if (resident_stages * stage <= RESIDENT_BYTES and units >= group and sms >= group
            and fixed + resident_stages * per_stage + MIN_REGION_STAGES * per_region <= SMEM_LIMIT):
        w_stages, grid = resident_stages, min(units, sms) // group * group
        region_stages = min(MAX_REGION_STAGES, (SMEM_LIMIT - fixed - w_stages * per_stage) // per_region)
        resident = True
    elif not may_stream:
        return None
    else:
        region_stages, resident, grid = MIN_REGION_STAGES, False, min(units, sms)
        w_stages = min(MAX_W_STAGES, (SMEM_LIMIT - fixed - region_stages * per_region) // per_stage)
        if w_stages < MIN_W_STAGES:
            raise ValueError(f"the staged rows of W {w} leave no room for the weight ring")
    return Plan(unit_phases, mblocks, bn, region_stages, w_stages, resident, rows, grid,
                _smem_bytes(w, bn, region_stages, w_stages, rows), m_tiles, units)


@functools.lru_cache(maxsize=256)
def plan(
    n: int, h: int, w: int, c1: int, c2: int, cout: int, aligned: bool = True, sms: int = H100_SMS,
) -> Plan:
    """The schedule of one k4s2 call, from its shape alone; raises ``ValueError``
    for a shape the kernel cannot take: channel counts not a multiple of 8,
    W or the rows a tile reads over 256 (TMA box limits), pointers not
    16-byte aligned (``aligned``), or rings that do not fit in shared
    memory. ``sms``: the card's streaming multiprocessors.

    The unit's shape is the first of these whose weights stay resident
    (else the last, streamed), as measured at the flagship sites on the
    H100 (PERF.md): all four phases at up to 32 channels (one staged
    region and 9 A gathers for 16 products); two m-blocks of 64 rows a
    warpgroup where one tile of up to 64 channels covers Cout (half the
    weight bytes and staged halo rows a position); one m-block at up to
    128 channels, or at 96 where 96 divides Cout and 128 does not (ngf 96's
    192 and 96: 1.84 -> 1.68 and 2.15 -> 1.50 ms at N = 4096, PERF.md).

    Before them, a unit that takes a skip at a Cout that 96 divides
    (the colour generator's up1-5 at cgen ngf 96) is two m-blocks of 96
    channels, resident or streamed: half the weight bytes a position of
    one m-block's, and the kernel runs only the k steps that hold channels
    of runs that end inside a 64-channel chunk (ngf 96's 96 and 192). At N
    = 4096, up1-5 0.32 / 1.31 / 3.18 / 3.36 / 8.73 -> 0.32 / 1.29 / 2.53 /
    2.96 / 6.96 ms (PERF.md); the geometry generator's stages, which take
    no skip, keep their plans."""
    if not aligned:
        raise ValueError("fused_norm_act_up_conv takes 16-byte aligned tensors only")
    if c1 <= 0 or c1 % 8 or c2 < 0 or c2 % 8:
        raise ValueError(f"channel counts must be multiples of 8, got x {c1} and skip {c2}")
    if n * h * w == 0 or cout < 1:
        raise ValueError(f"empty shape {(n, h, w, cout)}")
    if w > 256:
        raise ValueError(f"W {w} is over the TMA box limit of 256")
    widest = 16
    while widest < min(cout, 128):
        widest *= 2
    if cout % 128 and cout % WIDE_ODD == 0:  # Cout 96, 192, 288, ...: whole 96-channel tiles
        widest = WIDE_ODD
    # (phases, m-blocks, channels a tile at most, whether its weights may
    # stream): the last always may
    shapes = [(1, 1, widest, True)]
    if widest <= 64:
        shapes.insert(0, (1, 2, widest, False))
    shapes.insert(0, (4, 1, min(widest, 32), False))
    if c2 > 0 and cout % WIDE_ODD == 0:
        shapes.insert(0, (1, 2, WIDE_ODD, True))
    for unit_phases, mblocks, bn, may_stream in shapes:
        p = _schedule(n, h, w, c1, c2, cout, unit_phases, mblocks, bn, may_stream, sms)
        if p is not None:
            return p
    raise AssertionError("the last unit shape streams its weights: it always has a plan")


@functools.lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _route(w: torch.Tensor, stride: int, padding: int) -> str:
    geometry = (w.shape[2], stride, padding)
    if w.shape[2] != w.shape[3] or geometry not in GEOMETRIES:
        raise ValueError(
            f"takes k4 s2 p1 or k3 s1 p1, got kernel {tuple(w.shape[2:])}, stride {stride}, padding {padding}"
        )
    return GEOMETRIES[geometry]


def _check(x, scale, shift, w, skip, stride, padding) -> str:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got shape {tuple(x.shape)}")
    n, c1, h, wd = x.shape
    c2 = 0 if skip is None else skip.shape[1]
    if skip is not None:
        if skip.dim() != 4 or (skip.shape[0], skip.shape[2], skip.shape[3]) != (n, h, wd):
            raise ValueError(f"skip must be (N, C, H, W) with x's N, H, W, got {tuple(skip.shape)}")
        if skip.dtype != x.dtype:
            raise TypeError(f"skip must have x's dtype {x.dtype}, got {skip.dtype}")
    if w.dim() != 4 or w.shape[0] != c1 + c2:
        raise ValueError(f"w must be ({c1 + c2}, Cout, k, k), got {tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"w must have x's dtype {x.dtype}, got {w.dtype}")
    route = _route(w, stride, padding)
    for name, v in (("scale", scale), ("shift", shift)):
        if v.dtype != torch.float32 or tuple(v.shape) != (c1,) or not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 of shape ({c1},)")
    for name, t in (("x", x), ("skip", skip)):
        if t is not None and not t.is_contiguous(memory_format=_CL):
            raise ValueError(f"{name} must be contiguous in torch.channels_last format")
    for t in (scale, shift, w, skip):
        if t is not None and t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got {t.device}")
    if x.device.type == "cuda" and x.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16, got {x.dtype}")
    out_numel = n * w.shape[1] * (h * wd if route == "k3s1" else 4 * h * wd)
    if max(x.numel(), c2 * n * h * wd, w.numel(), out_numel) >= 2**31:
        raise ValueError("tensors with 2**31 or more elements are not supported")
    return route


def reference_norm_act_up_conv(
    x: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    w: torch.Tensor,
    skip: Optional[torch.Tensor] = None,
    stride: int = 2,
    padding: int = 1,
) -> torch.Tensor:
    """The plain version: materialise the activation and the concatenation,
    then an f32 transposed conv."""
    xn = torch.relu(x.float() * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)).to(x.dtype)
    if skip is not None:
        xn = torch.cat([xn, skip], 1)
    out = F.conv_transpose2d(xn.float(), w.float(), stride=stride, padding=padding)
    return out.to(x.dtype).contiguous(memory_format=_CL)


def pack_weight(w: torch.Tensor, c1: int) -> torch.Tensor:
    """The kernel's B matrix: ``(Cout, k*k, K)`` row-major, ``K`` the input
    channels with x's first ``c1`` at [0, c1) and the skip's at
    [CHUNK * ceil(c1 / CHUNK), ...), zeros between; tap ``kh * k + kw``."""
    cin, cout, kh, kw = w.shape
    off = CHUNK * -(-c1 // CHUNK)
    k = off + CHUNK * -(-(cin - c1) // CHUNK)
    rows = w.permute(1, 2, 3, 0).reshape(cout, kh * kw, cin)
    g = w.new_zeros((cout, kh * kw, k))
    g[:, :, :c1] = rows[:, :, :c1]
    g[:, :, off : off + cin - c1] = rows[:, :, c1:]
    return g


def gemm_weight(w: torch.Tensor, c1: int, pack=pack_weight) -> torch.Tensor:
    """``pack(w, c1)`` (:func:`pack_weight`, or the k3s1 route's
    ``outconv.pack_weight``), kept on ``w`` while its storage and version
    stay the same (a serving copy packs once); an inference tensor, which
    has no version counter, is packed at every call."""
    if w.is_inference():
        return pack(w, c1)
    key = (w.data_ptr(), w._version, c1, pack)
    kept = getattr(w, "_fused_up_gemm", None)
    if kept is None or kept[0] != key:
        kept = (key, pack(w.detach(), c1))
        w._fused_up_gemm = kept
    return kept[1]


@functools.cache
def _kernel():
    fn = build.library("fused_up").dcvgan_fused_up_conv
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=64)
def _tiles_on(device: torch.device, n: int, h: int, w: int, bn: int, cout: int, groups: int,
              tile_m: int) -> torch.Tensor:
    return tile_table(n, h, w, bn, cout, groups, tile_m).to(device)


_ERRORS = {
    -2: "the plan's shared memory is not the CUDA source's layout",
    -3: "libcuda has no cuTensorMapEncodeTiled",
    -4: "a TMA tensor map was refused",
    -5: "the plan stages fewer input rows than a tile reads",
}


def plan_for(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, skip: Optional[torch.Tensor]) -> Plan:
    """:func:`plan` for these CUDA tensors (their shapes, alignment and card)."""
    n, c1, h, wd = x.shape
    ptrs = [x, w, out] + ([skip] if skip is not None else [])
    aligned = all(t.data_ptr() % 16 == 0 for t in ptrs)
    c2 = 0 if skip is None else skip.shape[1]
    return plan(n, h, wd, c1, c2, out.shape[1], aligned, _sms(x.device.index or 0))


def launch(
    p: Plan,
    x: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    w_gemm: torch.Tensor,
    out: torch.Tensor,
    skip: Optional[torch.Tensor] = None,
) -> None:
    """Launch the k4s2 kernel on the current stream; raises if the launch
    fails. ``w_gemm`` is :func:`pack_weight`'s matrix, ``out`` (N, Cout, 2H,
    2W) channels-last."""
    n, c1, h, wd = x.shape
    c2 = 0 if skip is None else skip.shape[1]
    cout = out.shape[1]
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tiles = _tiles_on(x.device, n, h, wd, p.bn, cout, PHASES // p.phases, TILE_M * p.mblocks)
        err = fn(
            x.data_ptr(), skip.data_ptr() if skip is not None else None, scale.data_ptr(), shift.data_ptr(),
            w_gemm.data_ptr(), out.data_ptr(), n, h, wd, c1, c2, cout, p.phases,
            p.mblocks, p.bn, p.region_stages, p.w_stages, int(p.resident), p.region_rows, tiles.data_ptr(), p.units,
            p.grid, p.smem, stream,
        )
    if err in _ERRORS:
        raise ValueError(f"fused_norm_act_up_conv (k4s2, width {wd}): {_ERRORS[err]}")
    if err != 0:
        raise RuntimeError(f"fused_norm_act_up_conv k4s2 kernel launch failed: CUDA error {err}")


def fused_norm_act_up_conv(
    x: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    w: torch.Tensor,
    skip: Optional[torch.Tensor] = None,
    stride: int = 2,
    padding: int = 1,
) -> torch.Tensor:
    """``conv_transpose2d(cat([relu(x * scale + shift), skip]), w)``; see the
    module docstring.

    x: (N, C1, H, W) channels-last, bfloat16 on CUDA; scale, shift: (C1,)
    float32; w: (C1 + C2, Cout, k, k) in x's dtype (a ConvTranspose2d
    weight; k4 with stride 2, padding 1, or k3 with stride 1, padding 1);
    skip: optional (N, C2, H, W) channels-last in x's dtype. Returns (N,
    Cout, 2H, 2W) or (N, Cout, H, W) channels-last. Launches on the current
    stream and does not synchronise.
    """
    route = _check(x, scale, shift, w, skip, stride, padding)
    if x.device.type == "cpu":
        return reference_norm_act_up_conv(x, scale, shift, w, skip, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, c1, h, wd = x.shape
    if route == "k3s1":
        out = torch.empty((n, w.shape[1], h, wd), dtype=x.dtype, device=x.device, memory_format=_CL)
        w27 = gemm_weight(w, c1, outconv.pack_weight)
        outconv.launch(outconv.plan_for(x, w27, out, skip), x, scale, shift, w27, out, skip)
    else:
        out = torch.empty((n, w.shape[1], 2 * h, 2 * wd), dtype=x.dtype, device=x.device, memory_format=_CL)
        w_gemm = gemm_weight(w, c1)
        launch(plan_for(x, w_gemm, out, skip), x, scale, shift, w_gemm, out, skip)
    fused_norm_act_up_conv.launches += 1
    fused_norm_act_up_conv.routes[route] += 1
    return out


fused_norm_act_up_conv.launches = 0
fused_norm_act_up_conv.routes = collections.Counter()
