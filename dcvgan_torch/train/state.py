"""The generators' state: the two modules and, where present, their EMA.

Counterpart of the generator part of ``dcvgan_tpu/train/state.py``. The
modules hold their parameters in the compute dtype (BatchNorm in float32)
on the device they run on; ``ema`` holds the averaged parameters of each,
by parameter name, the same way.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from dcvgan_torch.models.cgen import ColorVideoGenerator
from dcvgan_torch.models.ggen import GeometricVideoGenerator

ParamDict = Dict[str, torch.Tensor]


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
        swapped = {}
        for name in ("ggen", "cgen"):
            module = copy.deepcopy(getattr(self, name))
            params = dict(module.named_parameters())
            avg = self.ema[name]
            if set(avg) != set(params):
                raise ValueError(
                    f"EMA of {name} does not match its parameters: "
                    f"{sorted(set(avg) ^ set(params))}"
                )
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(avg[k])
            swapped[name] = module
        return GeneratorState(ggen=swapped["ggen"], cgen=swapped["cgen"])
