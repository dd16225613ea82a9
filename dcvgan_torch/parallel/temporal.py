"""Time sharding of the 3D-conv video critics over the ``time`` ranks.

Counterpart of ``dcvgan_tpu/parallel/temporal.py``. The time ranks of one
data row (``Layout.time_group``) each hold ``t_local = T / time``
consecutive frames of the row's clips:

- :func:`halo_exchange`: each rank receives the first ``halo`` frames of
  its right neighbour, the overlap a time-valid kernel of ``halo + 1``
  frames needs; the last rank receives zeros;
- :func:`time_sharded_conv3d`: a time-valid, spatially padded 3D conv of
  this rank's frames that equals the unsharded conv on the first
  ``T - kt + 1`` frames, with the last rank's invalid tail set to 0 (the
  shapes stay ``t_local`` on every rank).

**Transport.** JAX sends the halo point to point (``ppermute``). Here each
time rank writes its first ``halo`` frames into its own slot of a zeroed
``[time, ...]`` buffer, the buffer is SUM all-reduced over the time group
and rank ``i`` reads slot ``i + 1``: one collective that NCCL and gloo both
take for CUDA tensors (gloo has no point-to-point send of a CUDA tensor,
and NCCL refuses two ranks on one card, so the same code runs on the
one-card machine and on several cards). Each slot has one writer, so the
sum is exact; the buffer travels as bytes (``uint8``), which makes it exact
in any dtype. The backward is the same collective on the cotangent: the
receiver writes it into the sender's slot, and the sender adds what it
reads there to the gradient of its first ``halo`` frames.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dcvgan_torch.parallel.mesh import Layout


def _exchange(part: torch.Tensor, group, n: int, write: int, read: int) -> torch.Tensor:
    """Every rank writes ``part`` into slot ``write`` of a zeroed
    ``[n, *part.shape]`` buffer, the buffer is summed over ``group``, and
    slot ``read`` comes back (zeros when ``read`` is outside ``0..n-1``)."""
    buf = part.new_zeros((n,) + tuple(part.shape))
    if 0 <= write < n:
        buf[write] = part
    bytes_ = buf.view(-1).view(torch.uint8)
    dist.all_reduce(bytes_, group=group)
    if 0 <= read < n:
        return buf[read]
    return torch.zeros_like(part)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group, n: int, idx: int, halo: int):
        ctx.group, ctx.n, ctx.idx, ctx.halo, ctx.t_local = group, n, idx, halo, x.shape[1]
        # slot idx carries this rank's first frames; the last rank has no
        # right neighbour and reads zeros
        received = _exchange(x[:, :halo].contiguous(), group, n, idx, idx + 1 if idx < n - 1 else n)
        return torch.cat([x, received], 1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        halo, idx, n, t_local = ctx.halo, ctx.idx, ctx.n, ctx.t_local
        dx = grad[:, :t_local].clone()
        # the cotangent of what this rank received goes to its sender's slot
        # (the last rank's zeros came from nobody); this rank reads its own
        back = _exchange(grad[:, t_local:].contiguous(), ctx.group, n,
                         idx + 1 if idx < n - 1 else n, idx)
        dx[:, :halo] += back
        return dx, None, None, None, None


def halo_exchange(x_local: torch.Tensor, group, halo: int) -> torch.Tensor:
    """``x_local`` ``(B, t_local, ...)`` with its right neighbour's first
    ``halo`` frames appended: ``(B, t_local + halo, ...)``; the last rank of
    ``group`` appends zeros. Differentiable: the appended frames' gradient
    goes back to the neighbour's first frames. Channels-last clips
    ``(B, T, H, W, C)`` travel as they lie in memory."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    return _HaloExchange.apply(x_local, group, n, idx, halo)


def conv3d_time_valid(x: torch.Tensor, weight: torch.Tensor, spatial_stride: int) -> torch.Tensor:
    """Time-valid, spatially padded (1) conv of an NCDHW ``x`` with a torch
    ``(Cout, Cin, kt, kh, kw)`` weight."""
    return F.conv3d(x, weight.to(x.dtype), None, (1, spatial_stride, spatial_stride), (0, 1, 1))


def time_sharded_conv3d(
    x: torch.Tensor, weight: torch.Tensor, layout: Layout, spatial_stride: int = 2
) -> Tuple[torch.Tensor, int]:
    """3D conv with the time axis sharded over ``layout``'s time ranks.

    ``x``: the row's clips ``(B, T, H, W, Cin)`` (every time rank holds
    them; this rank convolves its frames ``t_local * time_index ..``);
    ``weight``: ``(Cout, Cin, kt, kh, kw)``. Returns ``(y, valid_t)``: ``y``
    is this rank's ``(B, t_local, H', W', Cout)``, frames of the unsharded
    convolution, with the frames at global positions ``>= valid_t = T - kt
    + 1`` (the last rank's tail) set to 0.
    """
    kt = weight.shape[2]
    t, nt = x.shape[1], layout.time
    if t % nt:
        raise ValueError(f"T={t} not divisible by time axis {nt}")
    t_local = t // nt
    if kt - 1 > t_local:
        raise ValueError(
            f"halo {kt - 1} exceeds local time extent {t_local}; use fewer time shards"
        )
    idx = layout.time_index
    xh = halo_exchange(x[:, idx * t_local: (idx + 1) * t_local], layout.time_group, kt - 1)
    y = conv3d_time_valid(xh.movedim(-1, 1), weight, spatial_stride)
    valid_t = t - kt + 1
    keep = (idx * t_local + torch.arange(t_local, device=y.device)) < valid_t
    y = y * keep.view(1, 1, -1, 1, 1).to(y.dtype)
    return y.movedim(1, -1), valid_t
