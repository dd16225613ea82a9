"""Carry generator weights from the JAX package into the port.

The inverse of ``dcvgan_tpu/compat/torch_import.py``: flax parameter and
batch-stats trees (nested dicts of numpy arrays) become port state dicts,
whose names are the reference torch modules':

- conv ``(kH, kW, I, O)`` -> ``(O, I, kH, kW)``;
- ConvTranspose with ``transpose_kernel=True`` ``(kH, kW, O, I)`` ->
  ``(I, O, kH, kW)``;
- BatchNorm ``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``;
- GRU cell: flax's ``ir/iz`` biases already hold ``b_ir + b_hr``, so they go
  to ``bias_ih`` with ``bias_hh``'s r and z parts 0; ``in.bias`` goes to
  ``bias_ih``'s n part and ``hn.bias`` to ``bias_hh``'s n part.

A weights file (``--weights``) is an npz whose keys are
``{ggen|cgen}/{params|batch_stats|ema}/<flax path joined by '/'>``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Union

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


def _bn(sd: StateDict, prefix: str, params: Tree, stats: Tree) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
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
        _bn(sd, f"main.{3 * i + 1}", params[f"bns_{i}"], batch_stats[f"bns_{i}"])
    sd[f"main.{3 * n_up}.weight"] = conv_weight(params[f"ups_{n_up}"]["kernel"])
    return sd


def cgen_from_jax(params: Tree, batch_stats: Tree) -> StateDict:
    """ColorVideoGenerator (params, batch_stats) -> port state dict."""
    sd = {"inconv.main.0.weight": conv_weight(params["inconv"]["kernel"])}
    i = 0
    while f"down{i}_conv" in params:
        sd[f"down_blocks.{i}.main.0.weight"] = conv_weight(params[f"down{i}_conv"]["kernel"])
        _bn(sd, f"down_blocks.{i}.main.1", params[f"down{i}_bn"], batch_stats[f"down{i}_bn"])
        i += 1
    i = 0
    while f"up{i}_conv" in params:
        sd[f"up_blocks.{i}.main.0.weight"] = conv_weight(params[f"up{i}_conv"]["kernel"])
        _bn(sd, f"up_blocks.{i}.main.1", params[f"up{i}_bn"], batch_stats[f"up{i}_bn"])
        i += 1
    sd["outconv.main.0.weight"] = conv_weight(params["outconv"]["kernel"])
    return sd


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
