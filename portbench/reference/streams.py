"""The program's random streams, re-derived: a frozen copy of the seed
derivation of ``dcvgan_torch/prng.py`` (splitmix64 over a 64-bit seed, named
tags), so that the reference draws, on the same device type, the numbers the
program drew inside itself. Only the derivation is copied; every draw below
is made by the reference in the order the program makes it.
"""

from __future__ import annotations

import torch

NAMED_TAGS = {
    "ggen_content": 1, "ggen_motion": 2, "ggen_init": 3, "cgen_color": 4,
    "cgen_dropout": 5, "idis_noise": 6, "vdis_noise": 7, "gdis_noise": 8,
    "t_rand": 9, "d_fake": 10, "g_fake": 11, "params_init": 12, "eval": 13,
    "host": 14, "sample": 15, "joint": 16, "serve-microbatch": 17,
}
MASK64 = (1 << 64) - 1


def mix(seed: int, data: int) -> int:
    z = (seed ^ ((data + 0x9E3779B97F4A7C15) * 0xBF58476D1CE4E5B9)) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def base_key(seed: int, device) -> torch.Generator:
    return generator(mix(seed & MASK64, 0), device)


def fold_in(gen: torch.Generator, data: int) -> torch.Generator:
    return generator(mix(gen.initial_seed(), data & MASK64), gen.device)


def named(gen: torch.Generator, name: str) -> torch.Generator:
    return generator(mix(gen.initial_seed(), 1 << 32 | NAMED_TAGS[name]), gen.device)


def on_device(gen: torch.Generator, device) -> torch.Generator:
    return generator(gen.initial_seed(), device)
