"""The three critics: image, video and temporal-gradient discriminators.

Counterpart of ``dcvgan_tpu/models/discriminators.py`` on one device (the
time-sharded branches are not ported). All three are pair critics over
(geometry, colour); inputs are channels-last, ``(B, H, W, C)`` frames or
``(B, T, H, W, C)`` videos, and are viewed as NCHW / NCDHW without a copy.

- ImageDiscriminator: two Noise + conv stems (geometry / colour, ndf/2
  each), concatenated **[colour | geometry]**, then three Noise + conv
  (+ BatchNorm + LeakyReLU) stages to a ``(B, 4, 4)`` logit map.
- VideoDiscriminator: the same two-stream design with 3D convs (kernel 4,
  strides (1, 2, 2), valid in time); the stems have **no** Noise; logits
  ``(B, T - 12, 4, 4)``.
- GradientDiscriminator: a critic over the temporal differences
  ``x[1:] - x[:-1]`` of the geometry; the colour input is accepted and
  ignored, as in the reference; logits ``(B, T - 13, 4, 4)``.

``train`` gates only the BatchNorm statistics (batch or running) and
``update_stats`` whether a train-mode forward moves the running ones; Noise
is a static flag applied in both modes. ``noise`` maps a Noise layer's name
(``noise_g``, ``noise_c``, ``noise_1``, ...) to its unit-normal draw in the
input layout (channels last); a layer without an entry draws from
``generator``. ``norm="group"`` (``trainer.norm``) puts a
:class:`ChannelGroupNorm` in each BatchNorm's slot (scale N(1, 0.02) in the
image critic, 1 in the video critics, as their BatchNorms).

State-dict names are the reference modules': stems ``conv_g`` / ``conv_c``
with the conv at index 1 (idis, after its Noise) or 0 (vdis); ``main`` with
convs at 1, 5, 9 (, 13) and BatchNorms at 2, 6 (, 10).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn

from dcvgan_torch.models.layers import (
    Noise,
    Norm,
    init_weights_,
    norm_layer,
    same_pad_conv,
    time_valid_conv3d,
)

NoiseDraws = Optional[Mapping[str, torch.Tensor]]


def _to_channels_first(x: torch.Tensor) -> torch.Tensor:
    """(B, ..., C) -> (B, C, ...) as a view: channels-last memory."""
    return x.movedim(-1, 1)


class _Critic(nn.Module):
    ndim = 2  # spatial dims of the convs: 2 (frames) or 3 (videos)

    def __init__(self, use_noise: bool, noise_sigma: float, norm: str):
        super().__init__()
        self.use_noise = use_noise
        self.noise_sigma = noise_sigma
        self.norm = norm
        self.compute_dtype = torch.float32

    def _stage(self, cin: int, cout: int, norm: bool) -> list:
        """[Noise, conv (, norm, LeakyReLU)]: four slots of ``main``."""
        conv = same_pad_conv if self.ndim == 2 else time_valid_conv3d
        layers = [Noise(self.use_noise, self.noise_sigma), conv(cin, cout)]
        if norm:
            layers += [norm_layer(self.norm, cout, self.ndim), nn.LeakyReLU(0.2)]
        return layers

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_weights_(self, generator)

    def _run_main(self, h, train, update_stats, noise, generator):
        """``main``: stage k is slots 4k..4k+3, its Noise named noise_{k+1}."""
        noise = noise or {}
        for i, layer in enumerate(self.main):
            if isinstance(layer, Noise):
                draw = noise.get(f"noise_{i // 4 + 1}")
                h = layer(h, None if draw is None else _to_channels_first(draw), generator)
            elif isinstance(layer, Norm):
                h = layer(h, train, update_stats)
            else:
                h = layer(h)
        return h.squeeze(1)


class _PairCritic(_Critic):
    """The two-stream body shared by the image and video critics."""

    stem_noise = True

    def __init__(self, ch_g=1, ch_c=3, use_noise=False, noise_sigma=0.0, ndf=64, norm="batch"):
        super().__init__(use_noise, noise_sigma, norm)
        conv = same_pad_conv if self.ndim == 2 else time_valid_conv3d

        def stem(cin):
            layers = [Noise(use_noise, noise_sigma)] if self.stem_noise else []
            return nn.Sequential(*layers, conv(cin, ndf // 2), nn.LeakyReLU(0.2))

        self.conv_g = stem(ch_g)
        self.conv_c = stem(ch_c)
        self.main = nn.Sequential(
            *self._stage(ndf, ndf * 2, True),
            *self._stage(ndf * 2, ndf * 4, True),
            *self._stage(ndf * 4, 1, False),
        )

    def _stem(self, stem, x, draw, generator):
        h = _to_channels_first(x).to(self.compute_dtype)
        for layer in stem:
            if isinstance(layer, Noise):
                h = layer(h, None if draw is None else _to_channels_first(draw), generator)
            else:
                h = layer(h)
        return h

    def forward(
        self,
        xg: torch.Tensor,
        xc: torch.Tensor,
        train: bool = True,
        update_stats: bool = True,
        noise: NoiseDraws = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        noise = noise or {}
        hg = self._stem(self.conv_g, xg, noise.get("noise_g"), generator)
        hc = self._stem(self.conv_c, xc, noise.get("noise_c"), generator)
        h = torch.cat([hc, hg], dim=1)  # [colour | geometry]
        return self._run_main(h, train, update_stats, noise, generator)


class ImageDiscriminator(_PairCritic):
    """Per-frame pair critic: (B, H, W, ch_g), (B, H, W, ch_c) -> (B, 4, 4)."""

    ndim = 2
    stem_noise = True


class VideoDiscriminator(_PairCritic):
    """3D-conv pair critic: (B, T, H, W, ch) pair -> (B, T - 12, 4, 4)."""

    ndim = 3
    stem_noise = False


class GradientDiscriminator(_Critic):
    """Critic on temporal differences of the geometry video:
    (B, T, H, W, ch_g) -> (B, T - 13, 4, 4). ``xc`` is ignored."""

    ndim = 3

    def __init__(self, ch_g=1, ch_c=3, use_noise=False, noise_sigma=0.0, ndf=64, norm="batch"):
        super().__init__(use_noise, noise_sigma, norm)
        del ch_c
        self.main = nn.Sequential(
            *self._stage(ch_g, ndf, True),
            *self._stage(ndf, ndf * 2, True),
            *self._stage(ndf * 2, ndf * 4, True),
            *self._stage(ndf * 4, 1, False),
        )

    def forward(
        self,
        xg: torch.Tensor,
        xc: Optional[torch.Tensor] = None,
        train: bool = True,
        update_stats: bool = True,
        noise: NoiseDraws = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        del xc
        xg = xg.to(self.compute_dtype)
        h = _to_channels_first(xg[:, 1:] - xg[:, :-1])
        return self._run_main(h, train, update_stats, noise, generator)
