"""The benchmark's weights: drawn on the run's device from ``--seed`` in two
large calls (one normal, one uniform draw over every parameter), then cut
into the parameters and scaled to the reference init of each
(``reference.models.param_specs``). Both the program and the reference are
handed these; the program's own init is overwritten.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference import models, streams


def draw(cfg, seed: int, device) -> Dict[str, models.Params]:
    """``{model: {name: float32 tensor}}`` on ``device``."""
    specs = models.param_specs(cfg)
    total = sum(math.prod(shape) for spec in specs.values() for _, shape, _ in spec)
    g = streams.named(streams.base_key(seed, device), "params_init")
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for model, spec in specs.items():
        P = {}
        for name, shape, init in spec:
            n = math.prod(shape)
            if init == "n0.02":
                t = normal[at: at + n] * 0.02
            elif init == "n1":
                t = normal[at: at + n] * 0.02 + 1.0
            elif init == "zero":
                t = torch.zeros(n, device=device)
            elif init == "one":
                t = torch.ones(n, device=device)
            elif init.startswith("u"):
                t = uniform[at: at + n] * float(init[1:])
            else:
                raise ValueError(f"unknown init {init!r} of {model}.{name}")
            P[name] = t.reshape(shape).clone()
            at += n
        out[model] = P
    return out


def load_into(module: torch.nn.Module, P: models.Params, model: str) -> None:
    """Copy ``P`` into ``module``'s parameters, which must be the same names
    and shapes (raises otherwise)."""
    named = dict(module.named_parameters())
    if set(named) != set(P) or any(tuple(named[k].shape) != tuple(v.shape) for k, v in P.items()):
        raise ValueError(
            f"{model}: the program's parameters differ from the reference's: "
            f"{sorted(set(named) ^ set(P)) or 'shapes'}")
    with torch.no_grad():
        for k, v in P.items():
            named[k].copy_(v)


def load_running(module: torch.nn.Module, running: Dict[str, tuple]) -> None:
    """Copy BatchNorm running statistics ``{prefix: (mean, var)}`` into
    ``module``'s buffers."""
    buffers = dict(module.named_buffers())
    with torch.no_grad():
        for prefix, (mean, var) in running.items():
            buffers[prefix + ".running_mean"].copy_(mean)
            buffers[prefix + ".running_var"].copy_(var)
