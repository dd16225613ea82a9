"""Training and serving state.

Counterpart of ``dcvgan_tpu/train/state.py``. :class:`GANState` is the
whole five-model training state: the modules with float32 master parameters
and their BatchNorm statistics (none under ``trainer.norm: group``), one
Adam optimizer per model, the 1-based
global step and, when ``trainer.ema_decay > 0``, an EMA of the generator
parameters by parameter name. The train step updates it in place.

:class:`GeneratorState` is what sampling and serving read: the two
generators and, where present, their EMA. ``GANState.generators()`` makes
one from a training state with the parameters cast once to the compute
dtype; a ``GANState`` itself also samples (its layers cast on use).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from dcvgan_torch.models.cgen import ColorVideoGenerator
from dcvgan_torch.models.ggen import GeometricVideoGenerator
from dcvgan_torch.models.layers import cast_for_compute

ParamDict = Dict[str, torch.Tensor]
MODEL_NAMES = ("ggen", "cgen", "idis", "vdis", "gdis")
GENERATOR_NAMES = ("ggen", "cgen")


def _with_params(module: torch.nn.Module, avg: ParamDict, name: str) -> torch.nn.Module:
    """A copy of ``module`` with its parameters replaced by ``avg``."""
    module = copy.deepcopy(module)
    params = dict(module.named_parameters())
    if set(avg) != set(params):
        raise ValueError(
            f"EMA of {name} does not match its parameters: "
            f"{sorted(set(avg) ^ set(params))}"
        )
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(avg[k])
    return module


def _copy_params(module: torch.nn.Module) -> ParamDict:
    return {k: p.detach().clone() for k, p in module.named_parameters()}


@dataclass
class GeneratorState:
    ggen: GeometricVideoGenerator
    cgen: ColorVideoGenerator
    ema: Optional[Dict[str, ParamDict]] = None  # {"ggen": {...}, "cgen": {...}}

    def with_ema_params(self) -> "GeneratorState":
        """Copies of the generators with their parameters swapped for the
        EMA (identity when there is none). BatchNorm running statistics stay
        the live models'; the result carries no ``ema``."""
        if self.ema is None:
            return self
        return GeneratorState(
            ggen=_with_params(self.ggen, self.ema["ggen"], "ggen"),
            cgen=_with_params(self.cgen, self.ema["cgen"], "cgen"),
        )


@dataclass
class GANState:
    ggen: GeometricVideoGenerator
    cgen: ColorVideoGenerator
    idis: torch.nn.Module
    vdis: torch.nn.Module
    gdis: torch.nn.Module
    opt: Dict[str, torch.optim.Optimizer] = field(default_factory=dict)
    step: int = 0  # 1-based after the first train step
    ema: Optional[Dict[str, ParamDict]] = None

    @property
    def models(self) -> Dict[str, torch.nn.Module]:
        return {name: getattr(self, name) for name in MODEL_NAMES}

    def with_reseeded_ema(self) -> "GANState":
        """Re-seed the EMA at the current generator parameters (nothing to do
        when EMA is disabled). Use after replacing generator parameters
        wholesale, so that the average tracks the new weights."""
        if self.ema is not None:
            self.ema = {name: _copy_params(getattr(self, name)) for name in GENERATOR_NAMES}
        return self

    def with_ema_params(self) -> GeneratorState:
        """The generators sampling should read: copies with the EMA for
        parameters when there is one, else the live modules. BatchNorm
        running statistics stay the live models'."""
        return GeneratorState(self.ggen, self.cgen, self.ema).with_ema_params()

    def generators(self, dtype: Optional[torch.dtype] = None) -> GeneratorState:
        """A serving copy of the generators (and their EMA): parameters cast
        once to ``dtype`` (default: the compute dtype), so that a forward
        casts nothing. Independent of this state from then on."""
        out = {}
        for name in GENERATOR_NAMES:
            live = getattr(self, name)
            target = dtype or live.compute_dtype
            device = next(live.parameters()).device
            out[name] = cast_for_compute(copy.deepcopy(live), device, target)
        ema = None
        if self.ema is not None:
            ema = {
                name: {
                    k: self.ema[name][k].to(p.dtype).clone()
                    for k, p in out[name].named_parameters()
                }
                for name in GENERATOR_NAMES
            }
        return GeneratorState(out["ggen"], out["cgen"], ema)
