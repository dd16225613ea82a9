"""Carry weights and training state from the JAX package into the port.

The inverse of ``dcvgan_tpu/compat/torch_import.py``: flax parameter and
batch-stats trees (nested dicts of numpy arrays) become port state dicts,
whose names are the reference torch modules':

- conv ``(kH, kW, I, O)`` -> ``(O, I, kH, kW)``; 3D conv
  ``(kT, kH, kW, I, O)`` -> ``(O, I, kT, kH, kW)``;
- ConvTranspose with ``transpose_kernel=True`` ``(kH, kW, O, I)`` ->
  ``(I, O, kH, kW)``;
- BatchNorm ``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``;
  a GroupNorm (``trainer.norm: group``) has no ``batch_stats`` entry and
  gives ``weight/bias`` only;
- GRU cell: flax's ``ir/iz`` biases already hold ``b_ir + b_hr``, so they go
  to ``bias_ih`` with ``bias_hh``'s r and z parts 0; ``in.bias`` goes to
  ``bias_ih``'s n part and ``hn.bias`` to ``bias_hh``'s n part.

Adam's state crosses the same way: optax's ``ScaleByAdamState(count, mu,
nu)`` has the parameters' tree shape, so ``mu`` and ``nu`` go through the
parameter conversion and land in ``torch.optim.Adam``'s ``step``,
``exp_avg`` and ``exp_avg_sq``. :func:`load_gan_state_` fills a whole port
``GANState`` from the numpy trees of a JAX ``GANState``.

A weights file (``--weights``) is an npz whose keys are
``{ggen|cgen|idis|vdis|gdis}/{params|batch_stats|ema}/<flax path joined by '/'>``.
"""

from __future__ import annotations

from pathlib import Path
import copy
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

Tree = Dict[str, Any]
StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def conv_weight(k) -> torch.Tensor:
    """A flax kernel to torch's layout, one axis permutation for both kinds:
    conv (kH, kW, I, O) -> (O, I, kH, kW); ConvTranspose with
    ``transpose_kernel=True`` (kH, kW, O, I) -> (I, O, kH, kW)."""
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def conv3d_weight(k) -> torch.Tensor:
    """A flax 3D kernel (kT, kH, kW, I, O) -> torch's (O, I, kT, kH, kW)."""
    return _t(np.asarray(k).transpose(4, 3, 0, 1, 2))


def _bn(sd: StateDict, prefix: str, params: Tree, stats: Optional[Tree]) -> None:
    """A norm layer's entries; ``stats`` is None for a GroupNorm."""
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    if stats is None:
        return
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def gru_cell(cell: Tree, prefix: str = "recurrent") -> StateDict:
    """flax GRUCell tree -> torch GRUCell state dict (see module docstring)."""
    w_ih = np.concatenate([np.asarray(cell[g]["kernel"]).T for g in ("ir", "iz", "in")])
    w_hh = np.concatenate([np.asarray(cell[g]["kernel"]).T for g in ("hr", "hz", "hn")])
    b_n = np.asarray(cell["hn"]["bias"])
    zeros = np.zeros_like(b_n)
    b_ih = np.concatenate([np.asarray(cell[g]["bias"]) for g in ("ir", "iz", "in")])
    b_hh = np.concatenate([zeros, zeros, b_n])
    return {
        f"{prefix}.weight_ih": _t(w_ih),
        f"{prefix}.weight_hh": _t(w_hh),
        f"{prefix}.bias_ih": _t(b_ih),
        f"{prefix}.bias_hh": _t(b_hh),
    }


def ggen_from_jax(params: Tree, batch_stats: Tree) -> StateDict:
    """GeometricVideoGenerator (params, batch_stats) -> port state dict.

    ``ups_i`` / ``bns_i`` sit at ``main.{3i}`` / ``main.{3i+1}``; the last
    conv ``ups_n`` at ``main.{3n}``.
    """
    sd = gru_cell(params["recurrent"]["cell"])
    n_up = 0
    while f"bns_{n_up}" in params:
        n_up += 1
    for i in range(n_up):
        sd[f"main.{3 * i}.weight"] = conv_weight(params[f"ups_{i}"]["kernel"])
        _bn(sd, f"main.{3 * i + 1}", params[f"bns_{i}"], batch_stats.get(f"bns_{i}"))
    sd[f"main.{3 * n_up}.weight"] = conv_weight(params[f"ups_{n_up}"]["kernel"])
    return sd


def cgen_from_jax(params: Tree, batch_stats: Tree) -> StateDict:
    """ColorVideoGenerator (params, batch_stats) -> port state dict."""
    sd = {"inconv.main.0.weight": conv_weight(params["inconv"]["kernel"])}
    i = 0
    while f"down{i}_conv" in params:
        sd[f"down_blocks.{i}.main.0.weight"] = conv_weight(params[f"down{i}_conv"]["kernel"])
        _bn(sd, f"down_blocks.{i}.main.1", params[f"down{i}_bn"], batch_stats.get(f"down{i}_bn"))
        i += 1
    i = 0
    while f"up{i}_conv" in params:
        sd[f"up_blocks.{i}.main.0.weight"] = conv_weight(params[f"up{i}_conv"]["kernel"])
        _bn(sd, f"up_blocks.{i}.main.1", params[f"up{i}_bn"], batch_stats.get(f"up{i}_bn"))
        i += 1
    sd["outconv.main.0.weight"] = conv_weight(params["outconv"]["kernel"])
    return sd


def _critic_from_jax(
    params: Tree, batch_stats: Tree, convs: Dict[str, str], bns: Dict[str, str],
    weight: Callable,
) -> StateDict:
    sd = {f"{theirs}.weight": weight(params[ours]["kernel"]) for ours, theirs in convs.items()}
    for ours, theirs in bns.items():
        _bn(sd, theirs, params[ours], batch_stats.get(ours))
    return sd


def idis_from_jax(params: Tree, batch_stats: Tree) -> StateDict:
    """ImageDiscriminator: stems have Noise at 0 and the conv at 1; ``main``
    has convs at 1, 5, 9 and BatchNorms at 2, 6."""
    convs = {"conv_g": "conv_g.1", "conv_c": "conv_c.1",
             "conv_1": "main.1", "conv_2": "main.5", "conv_3": "main.9"}
    return _critic_from_jax(
        params, batch_stats, convs, {"bn_1": "main.2", "bn_2": "main.6"}, conv_weight)


def vdis_from_jax(params: Tree, batch_stats: Tree) -> StateDict:
    """VideoDiscriminator: stems have the 3D conv at 0; ``main`` as in idis."""
    convs = {"conv_g": "conv_g.0", "conv_c": "conv_c.0",
             "conv_1": "main.1", "conv_2": "main.5", "conv_3": "main.9"}
    return _critic_from_jax(
        params, batch_stats, convs, {"bn_1": "main.2", "bn_2": "main.6"}, conv3d_weight)


def gdis_from_jax(params: Tree, batch_stats: Tree) -> StateDict:
    """GradientDiscriminator: one ``main`` with 3D convs at 1, 5, 9, 13 and
    BatchNorms at 2, 6, 10."""
    convs = {"conv_1": "main.1", "conv_2": "main.5", "conv_3": "main.9", "conv_4": "main.13"}
    bns = {"bn_1": "main.2", "bn_2": "main.6", "bn_3": "main.10"}
    return _critic_from_jax(params, batch_stats, convs, bns, conv3d_weight)


FROM_JAX: Dict[str, Callable[[Tree, Tree], StateDict]] = {
    "ggen": ggen_from_jax,
    "cgen": cgen_from_jax,
    "idis": idis_from_jax,
    "vdis": vdis_from_jax,
    "gdis": gdis_from_jax,
}


def param_dict(name: str, module: torch.nn.Module, tree: Tree, batch_stats: Tree) -> StateDict:
    """A parameter-shaped flax tree (parameters, an EMA, an Adam moment) of
    model ``name`` as ``{parameter name of module: tensor}``, on the
    parameters' device. The tree goes through the state-dict conversion and
    a scratch copy of ``module``, so that names and layouts are the
    module's own."""
    scratch = copy.deepcopy(module)
    scratch.load_state_dict(FROM_JAX[name](tree, batch_stats))
    return {k: p.detach() for k, p in scratch.named_parameters()}


def load_adam_state_(
    opt: torch.optim.Optimizer, module: torch.nn.Module, name: str,
    count: int, mu: Tree, nu: Tree, batch_stats: Tree,
) -> None:
    """optax ``ScaleByAdamState(count, mu, nu)`` into ``opt``'s state."""
    exp_avg = param_dict(name, module, mu, batch_stats)
    exp_avg_sq = param_dict(name, module, nu, batch_stats)
    for k, p in module.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": exp_avg[k].clone(memory_format=torch.preserve_format),
            "exp_avg_sq": exp_avg_sq[k].clone(memory_format=torch.preserve_format),
        }


def load_gan_state_(state, trees: Dict[str, Any]) -> None:
    """Fill a port ``GANState`` in place from a JAX ``GANState`` given as
    numpy trees::

        {"step": int,
         "<model>": {"params": tree, "batch_stats": tree,
                     "opt": {"count": int, "mu": tree, "nu": tree}},  # opt optional
         "ema": {"ggen": tree, "cgen": tree} | None}

    A model without ``opt`` keeps a fresh optimizer state. The EMA is taken
    when both the trees and ``state`` carry one.
    """
    for name, module in state.models.items():
        t = trees[name]
        stats = t.get("batch_stats", {})
        device = next(module.parameters()).device
        with torch.no_grad():
            new = param_dict(name, module, t["params"], stats)
            for k, p in module.named_parameters():
                p.copy_(new[k])
            sd = FROM_JAX[name](t["params"], stats)
            for k, b in module.named_buffers():
                if k.endswith(("running_mean", "running_var")):
                    b.copy_(sd[k].to(device))
        state.opt[name].state.clear()
        if "opt" in t:
            o = t["opt"]
            load_adam_state_(state.opt[name], module, name, int(o["count"]), o["mu"], o["nu"], stats)
    state.step = int(trees["step"])
    ema: Optional[Tree] = trees.get("ema")
    if state.ema is not None and ema is not None:
        for name in ("ggen", "cgen"):
            module = getattr(state, name)
            stats = trees[name].get("batch_stats", {})
            state.ema[name] = {
                k: v.clone() for k, v in param_dict(name, module, ema[name], stats).items()
            }


def read_weights_npz(path: Union[str, Path]) -> Dict[str, Dict[str, Tree]]:
    """``{model: {"params" | "batch_stats" | "ema": tree}}`` from an npz whose
    keys are ``model/collection/<flax path>``."""
    out: Dict[str, Dict[str, Tree]] = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            if len(parts) < 3:
                raise ValueError(f"bad weights key {key!r}: want model/collection/path")
            node = out.setdefault(parts[0], {}).setdefault(parts[1], {})
            for p in parts[2:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return out
