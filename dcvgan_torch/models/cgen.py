"""Colour video generator: the per-frame U-Net colouriser.

Counterpart of ``dcvgan_tpu/models/cgen.py``. Geometry frames become RGB,
conditioned on one colour latent per video concatenated at the 1x1
bottleneck. Inconv = conv3x3 + LeakyReLU(0.01); six down blocks at 64 px
(conv k4 s2 p1 + BatchNorm + LeakyReLU 0.2); six up blocks (transposed conv
k4 s2 p1 + BatchNorm [+ Dropout2d on the first two] + ReLU) with skips;
outconv = transposed conv3x3 + tanh. Segmentation inputs are re-binarised
to a +-1 one-hot by argmax.

The inconv has two fused paths, by input, in eval mode in bfloat16 on CUDA;
train mode, float32 and the CPU keep the modules. A segmentation input's
argmax, one-hot, inconv and LeakyReLU are one launch of
:func:`onehot_conv3x3` (``ops/onehot_conv.py``: the conv of a +-1 one-hot as
a gather of weight rows, ``models.layers.onehot_fused``), inside the span
``cgen.onehot_conv``. A depth or optical-flow input's inconv and LeakyReLU
are one launch of :func:`inconv3x3` (``ops/inconv.py``: a dense 3x3 stencil
with the weights in registers, ``models.layers.inconv_fused``), inside the
span ``cgen.inconv`` (spans: ``utils/trace.py``).

In eval mode the down path runs on :func:`fused_norm_act_conv`: there a
BatchNorm is a per-channel affine, so down block i (i >= 1) is exactly
``fused_norm_act_conv(raw_{i-1}, fold(bn_{i-1}), w_i)`` where ``raw_{i-1}``
is block i-1's conv output; the activation the kernel feeds its product is
written once to ``xn_out`` and kept as the skip ``hs[i]``. Only down0's conv
and the last block's BatchNorm + LeakyReLU (at 1x1) run as plain ops. The
fused down path runs inside the span ``cgen.down``.

In eval mode in bfloat16 on CUDA the up path runs on
:func:`fused_norm_act_up_conv` (``_up_fused``): up block i (i >= 1) is
``fused_norm_act_up_conv(raw_{i-1}, fold(bn_{i-1}), w_i, skip=hs[n - i])``,
which applies block i-1's BatchNorm + ReLU to its raw conv output as it
loads it and takes the skip as the rest of its input channels, so no
BatchNorm, ReLU or concatenation runs as an op of its own; the outconv takes
raw up5 and ``hs[0]`` the same way (k3 s1 p1: the op's tap-partials route,
``ops/outconv.py``, inside the span ``cgen.outconv``), and tanh follows it. Up0's
conv (on the 1x1 bottleneck with the latent, ngf*4 + dim_z channels) stays
on cuDNN and writes raw. The fused up path runs inside the span
``cgen.up``. Float32, CPU, train-mode and GroupNorm forwards keep the
unfused up path.

Train mode (``train=True``) uses batch statistics, which depend on the conv
output, so the down path runs unfused, as in the JAX package, whose kernel
has no backward. The first two up blocks drop whole channels per frame with
probability 0.5 between BatchNorm and ReLU (one draw per (frame, channel),
kept values doubled); the keep masks are an input that a train-mode
forward requires, drawn by the caller before the forward
(:meth:`dropout_masks`), so that a recomputed forward uses the same masks.
``update_stats`` says whether the forward moves the running BatchNorm
statistics.

``norm="group"`` (``trainer.norm``) puts a :class:`ChannelGroupNorm` in
each BatchNorm's slot. A GroupNorm normalises each frame by its own
statistics, so it does not fold into the per-channel affine the fused
kernel applies: under ``norm="group"`` the eval-mode down path runs
unfused too, as the JAX package runs it on every path, and makes no
``fused_norm_act_conv`` launch.

The state-dict naming is the reference's: ``inconv.main.0``,
``down_blocks.{i}.main.{0,1}``, ``up_blocks.{i}.main.{0,1}``,
``outconv.main.0``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dcvgan_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    decodes_fused,
    fold_batch_norm,
    fold_time,
    inconv_fused,
    init_weights_,
    leaky_relu,
    norm_layer,
    onehot_fused,
    same_pad_conv,
    unfold_time,
    up_conv,
)
from dcvgan_torch.ops.fused_block import fused_norm_act_conv
from dcvgan_torch.ops.fused_up import fused_norm_act_up_conv
from dcvgan_torch.ops.inconv import inconv3x3
from dcvgan_torch.ops.onehot_conv import onehot_conv3x3
from dcvgan_torch.utils import trace


class _Block(nn.Module):
    """A ``main`` Sequential, for the reference's state-dict names."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        self.main = nn.Sequential(*layers)


class ColorVideoGenerator(nn.Module):
    def __init__(
        self,
        in_ch: int = 1,
        dim_z: int = 10,
        geometric_info: str = "depth",
        ngf: int = 64,
        video_length: int = 16,
        image_size: int = 64,
        norm: str = "batch",
    ):
        super().__init__()
        self.in_ch = in_ch
        self.norm = norm
        self.dim_z = dim_z
        self.geometric_info = geometric_info
        self.video_length = video_length
        self.compute_dtype = torch.float32
        down_mults = self._down_mults(image_size)
        n = len(down_mults)
        up_mults = list(reversed(down_mults[:-1])) + [1]

        self.inconv = _Block(
            Conv2d(in_ch, ngf, 3, 1, 1, bias=False), nn.LeakyReLU(0.01)
        )
        downs, cin = [], ngf
        for mult in down_mults:
            cout = ngf * mult
            downs.append(
                _Block(same_pad_conv(cin, cout), norm_layer(norm, cout), nn.LeakyReLU(0.2))
            )
            cin = cout
        self.down_blocks = nn.ModuleList(downs)

        ups, cin = [], ngf * down_mults[-1] + dim_z
        for i, mult in enumerate(up_mults):
            if i > 0:
                cin += ngf * down_mults[n - 1 - i]  # skip hs[n - i]
            cout = ngf * mult
            # the channel dropout of the first two blocks has no parameters;
            # its slot keeps the reference's indices within the block
            layers = [up_conv(cin, cout), norm_layer(norm, cout)]
            if i < 2:
                layers.append(nn.Identity())
            layers.append(nn.ReLU())
            ups.append(_Block(*layers))
            cin = cout
        self.up_blocks = nn.ModuleList(ups)
        self.outconv = _Block(
            ConvTranspose2d(cin + ngf, 3, 3, 1, 1, bias=False), nn.Tanh()
        )

    @staticmethod
    def _down_mults(image_size: int) -> List[int]:
        # 64 px: [1, 2, 4, 4, 4, 4], the reference's channel schedule
        return [1, 2] + [4] * (int(math.log2(image_size)) - 2)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_weights_(self, generator)

    def dropout_masks(
        self, n: int, generator: torch.Generator, device: torch.device
    ) -> List[torch.Tensor]:
        """The keep masks of up blocks 0 and 1 for ``n`` frames, boolean
        ``(n, C)`` on ``device``, drawn from ``generator`` in that order."""
        return [
            torch.rand((n, self.up_blocks[i].main[0].out_channels),
                       generator=generator, device=device) >= 0.5
            for i in range(2)
        ]

    def forward(
        self,
        x: torch.Tensor,
        z: torch.Tensor,
        train: bool = False,
        update_stats: bool = True,
        dropout_masks: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Geometry frames ``(N, in_ch, H, W)`` and latents ``(N, dim_z)`` to
        RGB frames ``(N, 3, H, W)``, channels-last.

        In train mode ``dropout_masks`` (required) are the keep masks of up
        blocks 0 and 1, boolean ``(N, C)``.
        """
        if train and dropout_masks is None:
            raise ValueError("a train-mode forward takes its dropout masks (dropout_masks())")
        dtype = self.compute_dtype
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
        if self.geometric_info == "segmentation" and onehot_fused(x, train):
            with trace.span("cgen.onehot_conv"):
                hs = [onehot_conv3x3(x, self.inconv.main[0].weight.to(dtype), 0.01)]
        elif inconv_fused(x, train, self.geometric_info):
            with trace.span("cgen.inconv"):
                hs = [inconv3x3(x, self.inconv.main[0].weight.to(dtype), 0.01)]
        else:
            if self.geometric_info == "segmentation":
                # argmax cuts the gradient here, as stop_gradient does in JAX
                idx = x.argmax(dim=1)
                x = F.one_hot(idx, x.shape[1]).to(dtype) * 2.0 - 1.0
                x = x.permute(0, 3, 1, 2)  # NHWC memory: a channels-last view
            hs = [self.inconv.main(x)]
        if train or self.norm == "group":
            h = hs[0]
            for blk in self.down_blocks:
                h = leaky_relu(blk.main[1](blk.main[0](h), train, update_stats), 0.2)
                hs.append(h)
        else:
            with trace.span("cgen.down"):
                h = self._down_fused(hs)

        n = len(self.down_blocks)
        h = torch.cat([h, z.to(dtype).reshape(z.shape[0], -1, 1, 1)], dim=1)
        if decodes_fused(h, train, self.norm):
            with trace.span("cgen.up"):
                return self._up_fused(h, hs)
        for i, blk in enumerate(self.up_blocks):
            if i > 0:
                h = torch.cat([h, hs[n - i]], dim=1)
            h = blk.main[1](blk.main[0](h), train, update_stats)
            if train and i < 2:
                keep = dropout_masks[i].to(h.device)
                h = h * (keep.to(dtype) * 2.0)[:, :, None, None]
            h = F.relu(h)
        return self.outconv.main(torch.cat([h, hs[0]], dim=1))

    def _down_fused(self, hs: List[torch.Tensor]) -> torch.Tensor:
        """The eval-mode down path on the fused op; appends the skips to
        ``hs`` and returns the bottleneck activation."""
        dtype = hs[0].dtype
        raw = self.down_blocks[0].main[0](hs[0])
        for i in range(1, len(self.down_blocks)):
            scale, shift = fold_batch_norm(self.down_blocks[i - 1].main[1])
            raw = raw.contiguous(memory_format=torch.channels_last)
            skip = torch.empty_like(raw)
            w = self.down_blocks[i].main[0].weight.to(dtype)
            raw = fused_norm_act_conv(raw, scale, shift, w, 0.2, xn_out=skip)
            hs.append(skip)
        last = self.down_blocks[-1].main
        h = leaky_relu(last[1](raw), 0.2)
        hs.append(h)
        return h

    def _up_fused(self, h: torch.Tensor, hs: List[torch.Tensor]) -> torch.Tensor:
        """The eval-mode up path and outconv on the fused transposed conv,
        from the bottleneck ``h`` (with the latent) and the skips ``hs``."""
        dtype, n = h.dtype, len(self.down_blocks)
        raw = self.up_blocks[0].main[0](h).contiguous(memory_format=torch.channels_last)
        for i in range(1, len(self.up_blocks)):
            scale, shift = fold_batch_norm(self.up_blocks[i - 1].main[1])
            w = self.up_blocks[i].main[0].weight.to(dtype)
            raw = fused_norm_act_up_conv(raw, scale, shift, w, hs[n - i])
        scale, shift = fold_batch_norm(self.up_blocks[-1].main[1])
        w = self.outconv.main[0].weight.to(dtype)
        with trace.span("cgen.outconv"):
            raw = fused_norm_act_up_conv(raw, scale, shift, w, hs[0], stride=1, padding=1)
        return self.outconv.main[1](raw)

    def forward_videos(
        self,
        xs: torch.Tensor,
        z: torch.Tensor,
        train: bool = False,
        update_stats: bool = True,
        dropout_masks: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Colourise geometry videos ``(B, T, H, W, in_ch)`` with one latent
        per video ``(B, dim_z)``, repeated over T, to ``(B, T, H, W, 3)``."""
        b, t = xs.shape[:2]
        z = z[:, None, :].expand(b, t, z.shape[-1]).reshape(b * t, -1)
        frames = fold_time(xs).permute(0, 3, 1, 2)
        ys = self(frames, z, train, update_stats, dropout_masks)
        return unfold_time(ys.permute(0, 2, 3, 1), b)
