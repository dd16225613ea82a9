"""Shared layers and initialisers.

Counterpart of ``dcvgan_tpu/models/layers.py`` for the layers the sampling
path uses. Initialisation follows the reference: 2D convs and transposed
convs N(0, 0.02), BatchNorm2d scale N(1, 0.02) and bias 0, the GRU cell
U(+-1/sqrt(hidden)). Every initialiser takes an explicit ``torch.Generator``.

BatchNorm is torch's own: eps 1e-5 and momentum 0.1 (flax's 0.9). Weights
that come from the JAX package carry flax's running variance, which is the
biased batch variance; eval mode reads it as it is, so sampling agrees.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv2d_kernel_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    """N(0, 0.02), the reference init of Conv2d / ConvTranspose2d."""
    nn.init.normal_(w, 0.0, 0.02, generator=generator)


def bn2d_scale_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    """BatchNorm2d scale ~ N(1, 0.02)."""
    nn.init.normal_(w, 1.0, 0.02, generator=generator)


def uniform_symmetric_init_(
    w: torch.Tensor, bound: float, generator: torch.Generator
) -> None:
    """U(-bound, bound): torch's GRUCell default with bound = 1/sqrt(hidden)."""
    nn.init.uniform_(w, -bound, bound, generator=generator)


def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Reference init of every 2D conv, transposed conv and BatchNorm2d."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                conv2d_kernel_init_(m.weight, generator)
            elif isinstance(m, nn.BatchNorm2d):
                bn2d_scale_init_(m.weight, generator)
                m.bias.zero_()


def batch_norm(num_features: int) -> nn.BatchNorm2d:
    """BatchNorm2d with the reference's eps 1e-5 and torch momentum 0.1."""
    return nn.BatchNorm2d(num_features, eps=1e-5, momentum=0.1)


def fold_batch_norm(bn: nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BatchNorm as a per-channel affine in f32:
    ``scale = weight * rsqrt(var + eps)``, ``shift = bias - mean * scale``."""
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    shift = bn.bias.float() - bn.running_mean.float() * scale
    return scale, shift


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def same_pad_conv(in_ch: int, out_ch: int) -> nn.Conv2d:
    """Conv k4 s2 p1: halves H and W exactly."""
    return nn.Conv2d(in_ch, out_ch, 4, 2, 1, bias=False)


def up_conv(in_ch: int, out_ch: int) -> nn.ConvTranspose2d:
    """Transposed conv k4 s2 p1: doubles H and W exactly."""
    return nn.ConvTranspose2d(in_ch, out_ch, 4, 2, 1, bias=False)


def cast_for_compute(
    module: nn.Module, device: torch.device, dtype: torch.dtype
) -> nn.Module:
    """Move ``module`` to ``device`` in ``dtype``, channels-last. BatchNorm
    parameters and running statistics stay float32: the JAX package keeps
    them in f32 and normalises in f32 whatever the compute dtype."""
    module.to(device=device, dtype=dtype, memory_format=torch.channels_last)
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.float()
    return module


def fold_time(x: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) -> (B*T, ...): per-frame nets see time as batch."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def unfold_time(x: torch.Tensor, batch: int) -> torch.Tensor:
    """(B*T, ...) -> (B, T, ...)."""
    return x.reshape((batch, -1) + tuple(x.shape[1:]))
