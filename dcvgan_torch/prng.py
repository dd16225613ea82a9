"""Deterministic random streams as seeded ``torch.Generator``s.

Counterpart of ``dcvgan_tpu/prng.py``. Every draw flows from one base seed
through ``for_step`` and *named* derivations, as the JAX package folds keys:
a derived generator depends only on its parent's seed and the step or name,
never on how much the parent has been drawn from. The same table of named
tags is the contract.

The bits differ from the JAX package's: a torch generator is a Philox
(CUDA) or Mersenne Twister (CPU) stream, not threefry, and CPU and CUDA
generators give different numbers from one seed. Tests that compare the two
packages draw their inputs with numpy and feed both sides.
"""

from __future__ import annotations

from typing import Union

import torch

_NAMED_TAGS = {
    "ggen_content": 1,
    "ggen_motion": 2,
    "ggen_init": 3,
    "cgen_color": 4,
    "cgen_dropout": 5,
    "idis_noise": 6,
    "vdis_noise": 7,
    "gdis_noise": 8,
    "t_rand": 9,
    "d_fake": 10,
    "g_fake": 11,
    "params_init": 12,
    "eval": 13,
    "host": 14,
    "sample": 15,
    "joint": 16,
    "serve-microbatch": 17,
}

_MASK64 = (1 << 64) - 1


def _mix(seed: int, data: int) -> int:
    """splitmix64 of ``seed`` combined with ``data``: a 64-bit seed."""
    z = (seed ^ ((data + 0x9E3779B97F4A7C15) * 0xBF58476D1CE4E5B9)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _generator(seed: int, device: Union[str, torch.device]) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def base_key(seed: int, device: Union[str, torch.device] = "cpu") -> torch.Generator:
    """The experiment's root generator on ``device``."""
    return _generator(_mix(seed & _MASK64, 0), device)


def fold_in(gen: torch.Generator, data: int) -> torch.Generator:
    """A generator that is a pure function of ``gen``'s seed and ``data``
    (``jax.random.fold_in``)."""
    return _generator(_mix(gen.initial_seed(), data & _MASK64), gen.device)


def for_step(gen: torch.Generator, step: int) -> torch.Generator:
    """The per-iteration generator: a pure function of ``gen``'s seed and ``step``."""
    return fold_in(gen, step)


def named(gen: torch.Generator, name: str) -> torch.Generator:
    """A stably named generator derived from ``gen``'s seed."""
    return _generator(_mix(gen.initial_seed(), 1 << 32 | _NAMED_TAGS[name]), gen.device)


def on_device(gen: torch.Generator, device: Union[str, torch.device]) -> torch.Generator:
    """A generator with ``gen``'s seed on ``device`` (``gen`` itself when it
    is there already). The numbers drawn differ between device types."""
    if gen.device == torch.device(device):
        return gen
    return _generator(gen.initial_seed(), device)
