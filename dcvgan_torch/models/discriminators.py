"""The three critics: image, video and temporal-gradient discriminators.

Counterpart of ``dcvgan_tpu/models/discriminators.py``. All three are pair critics over
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

**Time sharding** (``mesh.time > 1``; the JAX package's ``_TimeShard`` and
``_time_sharded`` forwards): given a ``layout`` of more than one time rank,
the video and gradient critics take this rank's ``t_local = T / time``
frames of the row's clips and compute the same logits as the unsharded
forward, with the same parameters. Each time-valid conv (kt 4) takes a
3-frame halo from the right neighbour (``parallel/temporal.py``) and
shrinks the valid global frames by 3; the local extent stays ``t_local``
and the frames past the valid ones are set to 0 after each conv (an output
frame t reads inputs t..t+3 only, so they never reach a valid one). The
BatchNorms run as :class:`MaskedSyncBatchNorm` over the valid frames of
every rank; the gradient critic's temporal difference takes a 1-frame halo
(valid ``T - 1``). The logits are gathered over the time group (scattered
into zeros, summed, cut to the valid frames), so every time rank of a row
returns that row's whole ``(B, T', 4, 4)``. Noise: JAX folds the noise key
per shard, a stream that cannot be replayed here; the port takes each
rank's frames of the unsharded layer's draw (given, or drawn from
``generator`` at the unsharded shape), so the sharded forward draws what
the unsharded one draws. Only ``trainer.norm: batch`` is sharded (the JAX
forward puts a masked BatchNorm in every norm slot whatever ``norm`` says).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dcvgan_torch.models.layers import (
    MaskedSyncBatchNorm,
    Noise,
    Norm,
    init_weights_,
    leaky_relu,
    norm_layer,
    same_pad_conv,
    time_valid_conv3d,
)
from dcvgan_torch.parallel.mesh import Layout, all_reduce_sum
from dcvgan_torch.parallel.temporal import halo_exchange

NoiseDraws = Optional[Mapping[str, torch.Tensor]]


def _to_channels_first(x: torch.Tensor) -> torch.Tensor:
    """(B, ..., C) -> (B, C, ...) as a view: channels-last memory."""
    return x.movedim(-1, 1)


class _TimeShard:
    """Bookkeeping of a critic forward over this rank's frames of the
    row's clips (see the module docstring); tensors are NCDHW."""

    HALO = 3  # kt - 1 of the critics' time-valid convs

    def __init__(self, layout: Layout, t_local: int, device):
        # before any collective, so that every rank raises alike
        if t_local < self.HALO:
            raise ValueError(
                f"local time extent {t_local} < halo {self.HALO}; use fewer time shards"
            )
        self.group = layout.time_group
        self.n = layout.time
        self.t_local = t_local
        self.start = layout.time_index * t_local
        self.gpos = self.start + torch.arange(t_local, device=device)

    def mask(self, valid_t: int) -> torch.Tensor:
        return self.gpos < valid_t

    def masked(self, y: torch.Tensor, valid_t: int) -> torch.Tensor:
        return y * self.mask(valid_t).view(1, 1, -1, 1, 1).to(y.dtype)

    def conv(self, conv: nn.Module, x: torch.Tensor, valid_t: int):
        """Halo-extended time-valid conv: (masked y, new valid_t)."""
        xh = halo_exchange(x.movedim(1, -1), self.group, self.HALO).movedim(-1, 1)
        valid_t -= self.HALO
        return self.masked(conv(xh), valid_t), valid_t

    def noise(self, layer: Noise, h: torch.Tensor, valid_t: int, draw, generator) -> torch.Tensor:
        """``layer`` on this rank's frames, with its frames of the unsharded
        layer's draw: ``draw`` (channels-last, ``valid_t`` frames) or one
        drawn from ``generator`` at the unsharded shape; zeros past it."""
        if not layer.use_noise:
            return h
        if draw is None:
            shape = (h.shape[0], h.shape[1], valid_t) + tuple(h.shape[3:])
            draw = layer.unit_draw(shape, generator, h.device)
        else:
            draw = _to_channels_first(draw)
        own = draw[:, :, self.start: self.start + self.t_local]
        return layer(h, F.pad(own, (0, 0, 0, 0, 0, self.t_local - own.shape[2])))

    def gather_valid(self, y: torch.Tensor, valid_t: int) -> torch.Tensor:
        """Every rank's frames of ``y``, in order, cut to the valid ones:
        scattered into zeros and summed over the time group (in float32)."""
        pad = (0, 0, 0, 0, self.start, (self.n - 1) * self.t_local - self.start)
        full = all_reduce_sum(F.pad(y.float(), pad), self.group)
        return full[:, :, :valid_t].to(y.dtype)


def _sharded_in_time(layout: Optional[Layout]) -> bool:
    return layout is not None and layout.time > 1


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

    def _run_main_sharded(self, h, ts: _TimeShard, valid_t, train, update_stats, noise, generator):
        """``main`` over this rank's frames, then the logits gathered."""
        noise = noise or {}
        for i, layer in enumerate(self.main):
            if isinstance(layer, Noise):
                h = ts.noise(layer, h, valid_t, noise.get(f"noise_{i // 4 + 1}"), generator)
            elif isinstance(layer, nn.Conv3d):
                h, valid_t = ts.conv(layer, h, valid_t)
            elif isinstance(layer, MaskedSyncBatchNorm):
                h = layer.masked(h, ts.mask(valid_t), train, update_stats)
            elif isinstance(layer, Norm):
                raise ValueError("the time-sharded critics take trainer.norm: batch")
            else:
                h = layer(h)
        return ts.gather_valid(h, valid_t).squeeze(1)


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
        layout: Optional[Layout] = None,
    ) -> torch.Tensor:
        """``layout`` of more than one time rank: ``xg`` and ``xc`` are
        this rank's frames and the forward is time-sharded (the module
        docstring; the video critic only)."""
        noise = noise or {}
        if _sharded_in_time(layout):
            return self._time_sharded(xg, xc, train, update_stats, noise, generator, layout)
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

    def _time_sharded(self, xg, xc, train, update_stats, noise, generator, layout):
        """The same logits from this rank's frames (module docstring)."""
        ts = _TimeShard(layout, xg.shape[1], xg.device)
        v = ts.t_local * ts.n  # the global T
        hg, _ = ts.conv(self.conv_g[0], _to_channels_first(xg).to(self.compute_dtype), v)
        hc, v = ts.conv(self.conv_c[0], _to_channels_first(xc).to(self.compute_dtype), v)
        h = torch.cat([leaky_relu(hc), leaky_relu(hg)], dim=1)  # [colour | geometry]
        return self._run_main_sharded(h, ts, v, train, update_stats, noise, generator)


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
        layout: Optional[Layout] = None,
    ) -> torch.Tensor:
        """``layout`` of more than one time rank: ``xg`` is this rank's
        frames and the forward is time-sharded (the module docstring)."""
        del xc
        xg = xg.to(self.compute_dtype)
        if _sharded_in_time(layout):
            # the temporal difference through a 1-frame halo: the last global
            # frame has no successor, so T - 1 frames are valid
            ts = _TimeShard(layout, xg.shape[1], xg.device)
            xh = halo_exchange(xg, ts.group, 1)
            v = ts.t_local * ts.n - 1
            h = ts.masked(_to_channels_first(xh[:, 1:] - xh[:, :-1]), v)
            return self._run_main_sharded(h, ts, v, train, update_stats, noise, generator)
        h = _to_channels_first(xg[:, 1:] - xg[:, :-1])
        return self._run_main(h, train, update_stats, noise, generator)
