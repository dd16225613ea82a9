"""Gloo-rank cases of the time-sharded critics (``mesh.time > 1``) and the
measures their tests hold.

The cases run in the ranks that ``torch_dist_util.run_ranks`` starts
(``"torch_time_util.<case>"``) and import nothing of JAX. A payload's
``lesion`` breaks the port in the ranks on purpose, so that
``test_torch_time_sharded_lesion.py`` can show that the measures catch it:

- ``"halo_backward"``: the halo exchange's backward keeps the rank's own
  frames' gradient and drops the cotangent of the frames it sent;
- ``"bn_without_time"``: the masked BatchNorm sums its statistics over the
  ranks of one time index (the data axis) only, not over the time ranks.
"""

from __future__ import annotations

import numpy as np
import torch

# the time-sharded conv against JAX's and the unsharded conv
# (tests/test_temporal.py's tolerance)
CONV_RTOL, CONV_ATOL = 2e-5, 1e-5
# masked BatchNorm and the critics' logits and statistics: the JAX parity
# suite's f32 tolerance
ATOL = 2e-4


def _lesion(payload, world: int, layout_time: int) -> None:
    import torch.distributed as dist

    from dcvgan_torch.models import layers
    from dcvgan_torch.parallel import mesh, temporal

    lesion = payload.get("lesion")
    if lesion == "halo_backward":
        def backward(ctx, grad):
            return grad[:, :ctx.t_local].clone(), None, None, None, None

        temporal._HaloExchange.backward = staticmethod(backward)
    elif lesion == "bn_without_time":
        # every rank creates every group, in the same order
        groups = [dist.new_group([r for r in range(world) if r % layout_time == t])
                  for t in range(layout_time)]
        own = groups[dist.get_rank() % layout_time]
        layers.all_reduce_sum = lambda x, group=None: mesh.all_reduce_sum(x, own)
    elif lesion is not None:
        raise KeyError(lesion)


def _frames(x: torch.Tensor, layout) -> torch.Tensor:
    t_local = x.shape[1] // layout.time
    return x[:, layout.time_index * t_local: (layout.time_index + 1) * t_local]


def temporal_ops(rank, world, payload) -> dict:
    """For each ``nt`` of ``payload["nts"]`` (``data = world / nt``): the
    halo exchange of a frame-numbered clip (halo 3 and 1); the time-sharded
    conv of ``payload["x"]`` with ``payload["w"]`` and its gradients under
    the cotangent ``payload["ct"]``; the masked BatchNorm's train-mode
    forward over this rank's rows and frames of ``payload["bn_x"]``, its
    gradients and running statistics; the time-sharded video and gradient
    critics' logits and statistics for each set of ``payload["critics"]``."""
    from dcvgan_torch.config import ExperimentConfig
    from dcvgan_torch.models.layers import batch_norm3d
    from dcvgan_torch.parallel import create_layout, shard_batch
    from dcvgan_torch.parallel.temporal import halo_exchange, time_sharded_conv3d
    from dcvgan_torch.train.step import DCVGAN

    out = {}
    for nt in payload["nts"]:
        layout = create_layout(data=world // nt, time=nt, world=world, rank=rank)
        if nt == payload.get("lesion_nt"):
            _lesion(payload, world, nt)
        res = out[nt] = {"time_index": layout.time_index, "row": layout.row}
        clip = _frames(payload["halo_x"], layout)
        res["halo"] = {h: halo_exchange(clip, layout.time_group, h) for h in (1, 3)}

        x = payload["x"].clone().requires_grad_(True)
        w = payload["w"].clone().requires_grad_(True)
        y, valid = time_sharded_conv3d(x, w, layout, spatial_stride=2)
        (y * _frames(payload["ct"], layout)).sum().backward()
        res["conv"] = {"y": y.detach(), "valid": valid, "dx": x.grad, "dw": w.grad}

        rows = shard_batch({"x": payload["bn_x"], "ct": payload["bn_ct"]}, layout)
        xb = _frames(rows["x"], layout).movedim(-1, 1).clone().requires_grad_(True)
        bn = batch_norm3d(xb.shape[1])
        bn.load_state_dict(payload["bn"], strict=False)
        t_local = xb.shape[2]
        mask = layout.time_index * t_local + torch.arange(t_local) < payload["bn_valid"]
        yb = bn.masked(xb, mask, True, True)
        (yb.movedim(1, -1) * _frames(rows["ct"], layout)).sum().backward()
        res["bn"] = {"y": yb.detach().movedim(1, -1), "dx": xb.grad.movedim(1, -1),
                     "dweight": bn.weight.grad, "dbias": bn.bias.grad,
                     "mean": bn.running_mean.clone(), "var": bn.running_var.clone()}

        res["critics"] = {}
        for kind, crit in payload["critics"].items():
            gan = DCVGAN(ExperimentConfig.from_dict(crit["config"]), device="cpu")
            inputs = shard_batch({"xg": crit["xg"], "xc": crit["xc"]}, layout)
            res["critics"][kind] = {}
            for name in ("vdis", "gdis"):
                module = gan._build(name)
                module.load_state_dict(crit["state"][name])
                noise = crit["noise"].get(name)
                if noise is not None:
                    noise = shard_batch(noise, layout)
                with torch.no_grad():
                    logits = module(_frames(inputs["xg"], layout), _frames(inputs["xc"], layout),
                                    train=True, update_stats=True, noise=noise, layout=layout)
                res["critics"][kind][name] = {
                    "logits": logits,
                    "stats": {k: v.clone() for k, v in module.state_dict().items()
                              if "running" in k},
                }
    return out


def time_layout_steps(rank, world, payload) -> dict:
    """``torch_dist_util.train_steps`` under a payload's ``lesion``."""
    import torch_dist_util

    mesh = payload.get("mesh", {})
    _lesion(payload, world, mesh.get("time", 1))
    return torch_dist_util.train_steps(rank, world, payload)


def max_rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def conv_grads(results, nt) -> tuple:
    """The time-sharded conv's input and weight gradients summed over the
    time ranks of data row 0 (each rank's input gradient holds its own
    frames and, through the halo's backward, the frames it sent)."""
    row = [r[nt] for r in results if r[nt]["row"] == 0]
    return (sum(r["conv"]["dx"] for r in row), sum(r["conv"]["dw"] for r in row))


def gather_frames(results, nt, part, key) -> torch.Tensor:
    """The ranks' frames of ``part[key]`` (``(B, t_local, ...)``), the time
    ranks of each data row concatenated in time, the rows in batch."""
    rows = {}
    for r in results:
        rows.setdefault(r[nt]["row"], {})[r[nt]["time_index"]] = r[nt][part][key]
    return torch.cat([torch.cat([rows[d][t] for t in sorted(rows[d])], 1) for d in sorted(rows)])
