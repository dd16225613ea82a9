"""The colour generator's input conv on a dense geometric input, in one launch.

It computes

    out = leaky_relu(conv2d(x, w, padding=1), slope)

with ``x`` (N, Cin, H, W) a depth (Cin 1) or optical-flow (Cin 2) frame and
``w`` (Cout, Cin, 3, 3), channels-last in and out.

It replaces no Pallas kernel: the JAX package leaves this conv to XLA. It was
added because on the H100 the library chain (cuDNN's conv, its layout copies
at one input channel, and a separate LeakyReLU that reads and writes the
whole output again) took 18.2 ms a serving chunk of 4 rounds of 4,096
frames, against the 2.6 ms that its bytes need (each input read once, each
output written once). ``ColorVideoGenerator`` (``models/cgen.py``) takes the
op for a depth or flow input in eval mode in bfloat16 on CUDA
(``models.layers.inconv_fused``): one launch a sampling round. A
segmentation input takes ``ops/onehot_conv.py`` instead: a gather of weight
rows by label, another algorithm.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/inconv.cu`` and counts it in ``inconv3x3.launches``, and by the
template instance the source takes for its shape (:func:`instance`) in
``inconv3x3.instances``; a shape the kernel cannot take raises. On a CPU
tensor it runs :func:`reference_inconv3x3`, the plain version (the conv
and LeakyReLU as two ops). There is no fallback from the one to the
other.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from dcvgan_torch.ops import build

_CL = torch.channels_last

MAX_THREADS = 256  # the CUDA source's kMaxThreads: a CTA is channel groups x pixels a pass
TILE_PIXELS = 512  # a tile is this many pixels of whole image rows, at least one row
PAD = 8  # the CUDA source's kPad: zero elements on each side of a staged row
SMEM_LIMIT = 232_448  # dynamic shared memory one block may opt into on Hopper
# (Cin, Cout, W) of the CUDA source's instances specialised at compile time;
# every other shape takes its Cin's generic instance
SPECIALISED = ((1, 64, 64), (2, 64, 64))


@dataclasses.dataclass(frozen=True)
class Plan:
    rows: int  # image rows a tile: the CTAs walk the N x ceil(H / rows) tiles
    vec: bool  # input staged in 16-byte pieces (x aligned, W * Cin a multiple of 8)
    threads: int  # a CTA: Cout / channels_a_thread groups x the pixels of one pass
    smem: int  # dynamic shared memory bytes: two tile buffers


def channels_a_thread(cin: int) -> int:
    """Output channels one thread computes: its 9 * Cin of each in f32 registers."""
    return 8 if cin <= 2 else 4


def instance(cin: int, cout: int, w: int) -> str:
    """The template instance ``csrc/inconv.cu`` launches for this shape:
    ``"<Cin>x<Cout>x<W>"`` where it is one of :data:`SPECIALISED`, else
    ``"generic"``."""
    return f"{cin}x{cout}x{w}" if (cin, cout, w) in SPECIALISED else "generic"


def _smem_bytes(w: int, cin: int, rows: int) -> int:
    """The CUDA source's layout: two buffers of ``rows`` + 2 staged rows, each
    row its W * Cin inputs (rounded up to 8) between ``PAD`` zeros a side."""
    return 2 * (rows + 2) * (-(-w * cin // 8) * 8 + 2 * PAD) * 2


@functools.lru_cache(maxsize=64)
def plan(n: int, h: int, w: int, cin: int, cout: int, aligned: bool = True) -> Plan:
    """The schedule of one call from its shape; raises ``ValueError`` for a
    shape the kernel cannot take: Cin outside 1-4, Cout not a multiple of 8,
    more output channels than one CTA's threads own, or a tile of one image
    row that does not fit in shared memory."""
    if n * h * w == 0:
        raise ValueError(f"empty shape {(n, cin, h, w)}")
    if not 1 <= cin <= 4:
        raise ValueError(f"Cin must be 1 to 4, got {cin}")
    if cout < 8 or cout % 8:
        raise ValueError(f"Cout must be a multiple of 8, got {cout}")
    cpt = channels_a_thread(cin)
    groups = cout // cpt
    if groups > MAX_THREADS:
        raise ValueError(f"at most {MAX_THREADS * cpt} output channels at Cin {cin}, got {cout}")
    rows = max(1, min(h, TILE_PIXELS // w))
    smem = _smem_bytes(w, cin, rows)
    if smem > SMEM_LIMIT:
        raise ValueError(f"two tiles of an image row of width {w} x {cin} need {smem} bytes of shared memory, "
                         f"over {SMEM_LIMIT}")
    return Plan(rows, aligned and (w * cin) % 8 == 0, groups * (MAX_THREADS // groups), smem)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, Cin, H, W), got shape {tuple(x.shape)}")
    cin = x.shape[1]
    if w.dim() != 4 or w.shape[1] != cin or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"w must be (Cout, {cin}, 3, 3), got {tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"w must have x's dtype {x.dtype}, got {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"w must be on {x.device}, got {w.device}")
    if not x.is_contiguous(memory_format=_CL):
        raise ValueError("x must be contiguous in torch.channels_last format")
    if x.device.type == "cuda" and x.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16, got {x.dtype}")


def reference_inconv3x3(x: torch.Tensor, w: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """The plain version: the conv (padding 1) and LeakyReLU as two ops."""
    return F.leaky_relu(F.conv2d(x, w, padding=1), slope).contiguous(memory_format=_CL)


@functools.cache
def _kernel():
    fn = build.library("inconv").dcvgan_inconv3x3
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def inconv3x3(x: torch.Tensor, w: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """``leaky_relu(conv2d(x, w, padding=1), slope)``; see the module docstring.

    x: (N, Cin, H, W) channels-last, bfloat16 with Cin 1 to 4 on CUDA; w:
    (Cout, Cin, 3, 3) in x's dtype, any strides, Cout a multiple of 8 on
    CUDA. Returns (N, Cout, H, W) channels-last in x's dtype. Launches on the
    current stream and does not synchronise.
    """
    _check(x, w)
    if x.device.type == "cpu":
        return reference_inconv3x3(x, w, slope)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    pl = plan(n, h, wd, cin, cout, x.data_ptr() % 16 == 0)
    out = torch.empty((n, cout, h, wd), dtype=x.dtype, device=x.device, memory_format=_CL)
    if out.numel() >= 2**31:
        raise ValueError("tensors with 2**31 or more elements are not supported")
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, cin, cout, *w.stride(), pl.rows,
                 int(pl.vec), pl.threads, pl.smem, float(slope), stream)
    if err != 0:
        raise RuntimeError(f"inconv3x3 kernel launch failed: CUDA error {err}")
    inconv3x3.launches += 1
    inconv3x3.instances[instance(cin, cout, wd)] += 1
    return out


inconv3x3.launches = 0
inconv3x3.instances = collections.Counter()
