"""GAN objectives, as plain functions on logits.

Counterpart of ``dcvgan_tpu/losses.py``. Both flavours:

- ``adversarial``: BCE-with-logits against ones / zeros, as a mean:
  ``BCEWithLogits(x, 1) = softplus(-x)``, ``BCEWithLogits(x, 0) = softplus(x)``.
- ``hinge``: D: ``mean(relu(1 - y_real)) + mean(relu(1 + y_fake))``; G:
  ``mean(softplus(-y_i)) + mean(softplus(-y_v))``. The generator term omits
  gdis, as the reference does.

Losses are computed in float32 whatever the compute dtype of the logits.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch
import torch.nn.functional as F


def bce_logits_real(y: torch.Tensor) -> torch.Tensor:
    """mean BCEWithLogits(y, ones)."""
    return F.softplus(-y.float()).mean()


def bce_logits_fake(y: torch.Tensor) -> torch.Tensor:
    """mean BCEWithLogits(y, zeros)."""
    return F.softplus(y.float()).mean()


def adversarial_dis_loss(y_real: torch.Tensor, y_fake: torch.Tensor) -> torch.Tensor:
    return bce_logits_real(y_real) + bce_logits_fake(y_fake)


def adversarial_gen_loss(
    y_fake_i: torch.Tensor, y_fake_v: torch.Tensor, y_fake_g: torch.Tensor
) -> torch.Tensor:
    return bce_logits_real(y_fake_i) + bce_logits_real(y_fake_v) + bce_logits_real(y_fake_g)


def hinge_dis_loss(y_real: torch.Tensor, y_fake: torch.Tensor) -> torch.Tensor:
    return F.relu(1.0 - y_real.float()).mean() + F.relu(1.0 + y_fake.float()).mean()


def hinge_gen_loss(
    y_fake_i: torch.Tensor, y_fake_v: torch.Tensor, y_fake_g: torch.Tensor
) -> torch.Tensor:
    """``y_fake_g`` is unused on purpose: the reference's hinge generator
    term has no gdis part."""
    del y_fake_g
    return F.softplus(-y_fake_i.float()).mean() + F.softplus(-y_fake_v.float()).mean()


class LossPair(NamedTuple):
    dis: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    gen: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


LOSS_REGISTRY: Dict[str, LossPair] = {
    "adversarial-loss": LossPair(adversarial_dis_loss, adversarial_gen_loss),
    "hinge-loss": LossPair(hinge_dis_loss, hinge_gen_loss),
}


def get_loss(name: str) -> LossPair:
    """Loss lookup by config name."""
    if name not in LOSS_REGISTRY:
        raise KeyError(f"unknown loss {name!r}; have {sorted(LOSS_REGISTRY)}")
    return LOSS_REGISTRY[name]
