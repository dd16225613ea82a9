"""Geometric-information video generator (eval mode).

Counterpart of ``dcvgan_tpu/models/ggen.py``. Per video, a content code is
drawn once and repeated over time; a motion code is the state of a GRU cell
fed N(0, 1) noise ``e_t`` from an N(0, 1) initial state ``h0``. Frames decode
independently (time folded into the batch) through a transposed-conv stack:
dim_z -> 8*ngf at 4x4, doubling the resolution to ``image_size``, with
BatchNorm + ReLU between stages; the head is tanh, or a softmax over
channels for segmentation.

The state-dict naming is the reference's: ``recurrent.*`` (``nn.GRUCell``)
and ``main.{3i}`` / ``main.{3i+1}`` for the i-th transposed conv and its
BatchNorm, ``main.{3n}`` for the last conv.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from dcvgan_torch.models.layers import (
    batch_norm,
    fold_time,
    init_weights_,
    uniform_symmetric_init_,
    unfold_time,
    up_conv,
)


class GeometricVideoGenerator(nn.Module):
    def __init__(
        self,
        dim_z_content: int = 40,
        dim_z_motion: int = 10,
        channel: int = 1,
        geometric_info: str = "depth",
        ngf: int = 64,
        video_length: int = 16,
        image_size: int = 64,
    ):
        super().__init__()
        self.dim_z_content = dim_z_content
        self.dim_z_motion = dim_z_motion
        self.channel = channel
        self.geometric_info = geometric_info
        self.video_length = video_length
        self.image_size = image_size
        self.recurrent = nn.GRUCell(dim_z_motion, dim_z_motion)

        n_up = int(math.log2(image_size // 4))  # strided stages after 4x4
        # dim_z -> 8*ngf at 4x4 (ConvTranspose k4 s1 p0 on 1x1), then one
        # stage per doubling with channel multipliers min(8, 2^k) down to 1
        layers = [
            nn.ConvTranspose2d(self.dim_z, ngf * 8, 4, 1, 0, bias=False),
            batch_norm(ngf * 8),
            nn.ReLU(),
        ]
        cin = ngf * 8
        for i in range(n_up - 1):
            cout = ngf * min(8, 2 ** (n_up - 2 - i))
            layers += [up_conv(cin, cout), batch_norm(cout), nn.ReLU()]
            cin = cout
        head = nn.Softmax(dim=1) if geometric_info == "segmentation" else nn.Tanh()
        layers += [up_conv(cin, channel), head]
        self.main = nn.Sequential(*layers)

    @property
    def dim_z(self) -> int:
        return self.dim_z_content + self.dim_z_motion

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Reference init from ``generator`` (GRU: U(+-1/sqrt(hidden)))."""
        bound = 1.0 / math.sqrt(self.dim_z_motion)
        with torch.no_grad():
            for p in self.recurrent.parameters():
                uniform_symmetric_init_(p, bound, generator)
        init_weights_(self.main, generator)

    def motion(self, e: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
        """GRU states ``(B, T, dzm)``: ``h_t = GRUCell(e_t, h_{t-1})``."""
        dtype = self.recurrent.weight_ih.dtype
        h = h0.to(dtype)
        e = e.to(dtype)
        states = []
        for t in range(e.shape[1]):
            h = self.recurrent(e[:, t], h)
            states.append(h)
        return torch.stack(states, dim=1)

    def latents(
        self, z_content: torch.Tensor, e: torch.Tensor, h0: torch.Tensor
    ) -> torch.Tensor:
        """Per-frame latents ``(B, T, dim_z)`` = [content | motion]."""
        z_m = self.motion(e, h0)
        z_c = z_content.to(z_m.dtype)[:, None, :].expand(-1, z_m.shape[1], -1)
        return torch.cat([z_c, z_m], dim=-1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Decode per-frame latents ``(N, dim_z)`` to frames
        ``(N, image_size, image_size, channel)``."""
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm arrives with the training slice; call .eval()"
            )
        dtype = self.main[0].weight.dtype
        x = z.to(dtype).reshape(z.shape[0], -1, 1, 1)
        x = self.main(x.contiguous(memory_format=torch.channels_last))
        return x.permute(0, 2, 3, 1)

    def forward(
        self, z_content: torch.Tensor, e: torch.Tensor, h0: torch.Tensor
    ) -> torch.Tensor:
        """Geometry videos ``(B, T, H, W, C)`` from explicit latents."""
        z = self.latents(z_content, e, h0)
        return unfold_time(self.decode(fold_time(z)), z.shape[0])
