"""Debug aids: the port's counterpart of ``dcvgan_tpu/utils/debug.py``."""

from __future__ import annotations

from typing import Set, Tuple

import torch
from torch import nn


class ShapeProbe(nn.Module):
    """Identity layer that prints its input's shape and dtype, and with
    ``stats=True`` its mean, std, min and max.

    Usage: put it into a module's forward, e.g.
    ``x = ShapeProbe(tag="after-down3")(x)``, and take it out when done. The
    JAX layer prints once per trace; this eager one prints once per distinct
    ``(shape, dtype)``. The statistics print on every call, and each call
    then waits for the device and copies four numbers to the host.
    """

    def __init__(self, tag: str = "", stats: bool = False):
        super().__init__()
        self.tag, self.stats = tag, stats
        self._seen: Set[Tuple[Tuple[int, ...], torch.dtype]] = set()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        label = f"shape-probe{':' + self.tag if self.tag else ''}"
        key = (tuple(x.shape), x.dtype)
        if key not in self._seen:
            self._seen.add(key)
            print(f"[{label}] {key[0]} {x.dtype}")
        if self.stats:
            with torch.no_grad():
                v = x.detach().float()
                m, s, lo, hi = (t.item() for t in (v.mean(), v.std(unbiased=False), v.min(), v.max()))
            print(f"[{label}] mean={m:.4f} std={s:.4f} min={lo:.4f} max={hi:.4f}")
        return x
