"""Process groups, the (dcn, data, time) layout and the collectives of
data and time parallelism.

Counterpart of ``dcvgan_tpu/parallel/mesh.py``. The JAX package runs one
program over a ``jax.sharding.Mesh`` and lets XLA insert the reductions;
here every card runs its own process (``torchrun``), the processes form one
``torch.distributed`` group, and the train step reduces explicitly:

- :func:`init_distributed` joins the group ``torchrun`` describes in the
  environment (``multihost_init``);
- :func:`create_layout` sizes the ``dcn``, ``data`` and ``time`` axes with
  ``create_mesh``'s rules and binds this process's rank to them;
- :func:`shard_batch` keeps this rank's data row of a global batch,
  :func:`replicate` broadcasts rank 0's state, :func:`all_reduce_mean_`
  averages a list of tensors in one collective and :func:`all_reduce_sum`
  is a sum whose backward sums the gradient over the ranks.

The ``time`` ranks of one data row hold the same rows of the batch, as JAX
replicates the batch over its ``time`` axis; the time-sharded critics
(``parallel/temporal.py``) split the clip's frames over them.

One difference from ``create_mesh``: a layout that leaves ranks of the
world unused raises. JAX takes a subset of the devices there (a debug batch
of 4 on an 8-chip host uses 4); a process cannot sit out the collectives of
the others.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from dcvgan_torch.utils.device import resolve_device

# a collective that waits this long has lost a peer: fail instead of hanging.
# Long enough for what only rank 0 does while the others wait at a barrier
# or in the next step's all-reduce (an evaluation that does not split over
# the ranks, sample logging, a checkpoint write)
TIMEOUT = datetime.timedelta(minutes=10)
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(
    backend: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Optional[torch.device]:
    """Join the process group that ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this process's device.

    Does nothing and returns None without that environment, or when the
    group exists already (then it returns ``device`` as a ``torch.device``,
    or None). The backend is ``nccl`` unless the caller names ``gloo``; a
    failed NCCL init raises, nothing falls back. The device is
    ``cuda:{LOCAL_RANK}`` unless the caller passes one (two gloo ranks can
    share ``cuda:0`` that way; NCCL refuses two ranks on one card).
    """
    if dist.is_initialized():
        return None if device is None else torch.device(device)
    if not all(k in os.environ for k in _LAUNCH_ENV):
        return None
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    dev = resolve_device(device if device is not None else f"cuda:{os.environ['LOCAL_RANK']}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend,
        init_method="env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=TIMEOUT,
    )
    return dev


@dataclass(frozen=True)
class Layout:
    """This process's place in the ``dcn`` x ``data`` x ``time`` layout: rank
    ``(dcn_index * data + data_index) * time + time_index``, as the JAX mesh
    orders its devices. The batch-parallel axes are ``dcn`` and ``data``;
    the ``time`` ranks of one data row (:attr:`row`) hold the same rows.

    Collectives run over the default process group; ``host_group`` is a
    gloo group over the same ranks for tensors on the host (the default
    group itself under gloo), ``time_group`` the group of this row's time
    ranks (None when ``time`` is 1)."""

    dcn: int = 1
    data: int = 1
    time: int = 1
    rank: int = 0
    host_group: Any = None
    time_group: Any = None

    @property
    def world(self) -> int:
        return self.dcn * self.data * self.time

    @property
    def row(self) -> int:
        """The batch-parallel index, ``dcn_index * data + data_index``."""
        return self.rank // self.time

    @property
    def time_index(self) -> int:
        return self.rank % self.time

    def rows(self, local: int, parts: int = 1, device=None) -> torch.Tensor:
        """This rank's rows of a global batch made of ``parts`` blocks of
        ``local * dcn * data`` rows each (``[real; fake]`` is 2), as
        indices: those of its data row."""
        n = local * self.dcn * self.data
        own = torch.arange(self.row * local, (self.row + 1) * local, device=device)
        return torch.cat([own + p * n for p in range(parts)])


SINGLE = Layout()


def create_layout(
    config=None,
    data: Optional[int] = None,
    time: Optional[int] = None,
    batchsize: Optional[int] = None,
    dcn: Optional[int] = None,
    world: Optional[int] = None,
    rank: Optional[int] = None,
) -> Layout:
    """The (dcn, data, time) layout over ``world`` processes (default: the
    process group's size, 1 without one), with ``create_mesh``'s rules.

    ``data=-1`` -> world / (dcn * time), shrunk to a divisor of
    ``batchsize`` when one is given; explicit arguments win over the
    config; ``dcn`` is an outer batch-parallel factor with the same math as
    ``data``. Raises where ``create_mesh`` raises, and also when the layout
    leaves ranks unused (see the module docstring).

    Under a process group a ``Layout`` of more than one rank creates the
    gloo ``host_group`` (NCCL groups) and, with ``time > 1``, one time group
    per data row, so every rank must call this.
    """
    if config is not None:
        data = config.mesh.data if data is None else data
        time = config.mesh.time if time is None else time
        dcn = config.mesh.dcn if dcn is None else dcn
        batchsize = config.batchsize if batchsize is None else batchsize
    dcn = 1 if dcn is None else dcn
    time = 1 if time is None else time
    grouped = dist.is_initialized()
    n = world if world is not None else (dist.get_world_size() if grouped else 1)
    if data is None or data == -1:
        if n % (dcn * time):
            raise ValueError(f"{n} devices not divisible by dcn*time={dcn * time}")
        data = n // (dcn * time)
        if batchsize is not None:
            while data > 1 and batchsize % (dcn * data):
                data -= 1
    used = dcn * data * time
    if used > n:
        raise ValueError(f"mesh {dcn}x{data}x{time} exceeds {n} visible devices")
    if batchsize is not None and batchsize % (dcn * data):
        raise ValueError(
            f"batchsize {batchsize} not divisible by batch-parallel mesh "
            f"size dcn*data={dcn * data}"
        )
    if used < n:
        raise ValueError(
            f"mesh {dcn}x{data}x{time} leaves {n - used} of {n} ranks unused; "
            f"a process cannot sit out the collectives (launch {used})"
        )
    if rank is None:
        rank = dist.get_rank() if grouped else 0
    host_group = time_group = None
    if grouped and n > 1 and dist.get_backend() != "gloo":
        host_group = dist.new_group(backend="gloo")
    if grouped and time > 1:
        # every rank creates every row's group, in row order
        for row in range(dcn * data):
            group = dist.new_group(list(range(row * time, (row + 1) * time)))
            if row == rank // time:
                time_group = group
    return Layout(dcn=dcn, data=data, time=time, rank=rank, host_group=host_group,
                  time_group=time_group)


def batch_size_divisor(layout: Layout) -> int:
    """Total batch-parallel ways (what per-step batches must divide by)."""
    return layout.dcn * layout.data


def shard_batch(batch: Dict[str, Any], layout: Layout) -> Dict[str, Any]:
    """Data row r's rows ``r*B/W .. (r+1)*B/W`` of every array (numpy or
    torch) of a global batch dict, W the batch-parallel ways; the dict
    itself when W is 1."""
    w = batch_size_divisor(layout)
    if w == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % w:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not split {w} ways")
        b = v.shape[0] // w
        out[k] = v[layout.row * b: (layout.row + 1) * b]
    return out


def _host_group(layout: Layout, t: torch.Tensor):
    return layout.host_group if t.device.type == "cpu" else None


def replicate(state, layout: Layout) -> None:
    """Broadcast rank 0's parameters, buffers, Adam states and EMA of a
    ``GANState`` to every rank, in place (nothing in a world of 1)."""
    if layout.world == 1:
        return
    tensors: List[torch.Tensor] = []
    for name, module in state.models.items():
        tensors += list(module.parameters()) + list(module.buffers())
        opt = state.opt[name].state
        for p in module.parameters():
            s = opt.get(p, {})
            tensors += [s[k] for k in sorted(s) if torch.is_tensor(s[k])]
    for avg in (state.ema or {}).values():
        tensors += list(avg.values())
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0, group=_host_group(layout, t))


def all_reduce_mean_(tensors: Sequence[torch.Tensor], layout: Layout) -> None:
    """Average float32 ``tensors`` over the ranks in place, through one
    SUM all-reduce of one flat buffer (``pmean``)."""
    if layout.world == 1 or not tensors:
        return
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=_host_group(layout, flat))
        flat /= layout.world
        offset = 0
        for t in tensors:
            t.copy_(flat[offset: offset + t.numel()].view(t.shape))
            offset += t.numel()


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce over ``group`` whose backward all-reduces the gradient
    over it: d(sum_r x_r)/dx_r passes every rank's upstream gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (default: every rank),
    differentiably."""
    return _AllReduceSum.apply(x, group)


def gather_to_first(x: np.ndarray, layout: Layout) -> Optional[np.ndarray]:
    """Every rank's ``x`` stacked on rank 0, ``(world, ...)`` in rank order;
    None on the other ranks. Runs on the host group (``gather_object``)."""
    if layout.world == 1:
        return x[None]
    out = [None] * layout.world if layout.rank == 0 else None
    dist.gather_object(x, out, dst=0, group=layout.host_group)
    return None if out is None else np.stack(out)


def broadcast_from_first(obj, layout: Layout):
    """Rank 0's ``obj`` on every rank (``broadcast_object_list`` on the host
    group)."""
    if layout.world == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=layout.host_group)
    return box[0]


def barrier(layout: Layout) -> None:
    """Wait for every rank (on the host group); nothing in a world of 1."""
    if layout.world > 1:
        dist.barrier(group=layout.host_group)


def stop_anywhere(flag: bool, layout: Layout) -> bool:
    """Whether any rank's ``flag`` is set: a MAX all-reduce on the host
    group, so that every rank leaves its loop at the same step."""
    if layout.world == 1:
        return flag
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=layout.host_group)
    return bool(t.item())


def first_rank_first(fn):
    """``fn()`` on rank 0 before every other rank runs it (a cold start's
    preprocessing writes the dataset's tree once); ``fn()`` alone without a
    process group."""
    grouped = dist.is_initialized() and dist.get_world_size() > 1
    if grouped and dist.get_rank() > 0:
        dist.barrier()
    out = fn()
    if grouped and dist.get_rank() == 0:
        dist.barrier()
    return out
