"""Geometric-information video generator.

Counterpart of ``dcvgan_tpu/models/ggen.py``. Per video, a content code is
drawn once and repeated over time; a motion code is the state of a GRU cell
fed N(0, 1) noise ``e_t`` from an N(0, 1) initial state ``h0``. Frames decode
independently (time folded into the batch) through a transposed-conv stack:
dim_z -> 8*ngf at 4x4, doubling the resolution to ``image_size``, with
BatchNorm + ReLU between stages; the head is tanh, or a softmax over
channels for segmentation.

``train`` selects batch statistics in the decoder's BatchNorms and
``update_stats`` whether that forward moves their running statistics
(``models/layers.py``). ``norm="group"`` (``trainer.norm``) puts a
:class:`ChannelGroupNorm` in each BatchNorm's slot; it ignores both.

In eval mode in bfloat16 on CUDA under BatchNorm the decoder runs on
:func:`fused_norm_act_up_conv` (``_decode_fused``): the first conv (k4 s1
p0 on 1x1) stays on cuDNN and writes its raw output, and each strided stage
applies the previous stage's BatchNorm (folded into a per-channel affine)
and ReLU as it loads its input, so no BatchNorm or ReLU runs as an op of its
own; the head follows the last stage. There a softmax head is one launch of
:func:`softmax_codes` (``ops/softmax_codes.py``, inside the span
``ggen.softmax_codes``), which also writes the probabilities' uint8 serving
codes and their int64 sum: :meth:`GeometricVideoGenerator.forward` hands
them on with the videos (:func:`codes_of`), so ``cli.serve`` does not
quantise the geometry video again. A tanh head keeps its module. Float32,
CPU, train-mode and GroupNorm forwards run the modules in order.

The state-dict naming is the reference's: ``recurrent.*`` (an
``nn.GRUCell``'s four tensors) and ``main.{3i}`` / ``main.{3i+1}`` for the
i-th transposed conv and its BatchNorm, ``main.{3n}`` for the last conv.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn as nn

from dcvgan_torch.models.layers import (
    ConvTranspose2d,
    Norm,
    decodes_fused,
    fold_batch_norm,
    fold_time,
    init_weights_,
    norm_layer,
    uniform_symmetric_init_,
    unfold_time,
    up_conv,
)
from dcvgan_torch.ops.fused_up import fused_norm_act_up_conv
from dcvgan_torch.ops.softmax_codes import SoftmaxCodes, softmax_codes
from dcvgan_torch.utils import trace


class Codes(NamedTuple):
    """A geometry video's uint8 serving codes, ``quantize(videos)`` in the
    videos' layout, and their int64 sum (a scalar tensor)."""

    u8: torch.Tensor
    total: torch.Tensor


def codes_of(videos: torch.Tensor) -> Optional[Codes]:
    """The codes :meth:`GeometricVideoGenerator.forward` made with
    ``videos`` (a fused softmax head), or None. A tensor made from the
    videos (a slice, a copy, a concatenation) carries none."""
    return getattr(videos, "_codes", None)


class GRUCell(nn.Module):
    """A GRU cell with the flax cell's parameters: one bias for each of the
    r and z gates, and separate input and hidden biases for the n gate.

        r = sigmoid(W_ir x + b_r + W_hr h)
        z = sigmoid(W_iz x + b_z + W_hz h)
        n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
        h' = (1 - z) * n + z * h

    ``nn.GRUCell`` owns two bias vectors for r and z; both would receive the
    same gradient and both would step, so their sum would move twice as far
    under Adam as the flax cell's single bias. Here ``bias_ih`` holds
    ``[b_r | b_z | b_in]`` and ``bias_hn`` holds ``b_hn``.

    The state dict keeps ``nn.GRUCell``'s names: it writes ``bias_hh`` as
    ``[0 | 0 | b_hn]``, and on loading adds a ``bias_hh``'s r and z parts
    into ``bias_ih``.
    """

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden_size, input_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden_size, hidden_size))
        self.bias_ih = nn.Parameter(torch.empty(3 * hidden_size))
        self.bias_hn = nn.Parameter(torch.empty(hidden_size))
        bound = 1.0 / math.sqrt(hidden_size)
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound)

    def bias_hh(self, dtype: torch.dtype) -> torch.Tensor:
        """``[0 | 0 | b_hn]``: the hidden bias in ``nn.GRUCell``'s layout."""
        b = self.bias_hn.to(dtype)
        return torch.cat([b.new_zeros(2 * self.hidden_size), b])

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        return torch._VF.gru_cell(
            x, h.to(dt), self.weight_ih.to(dt), self.weight_hh.to(dt),
            self.bias_ih.to(dt), self.bias_hh(dt),
        )

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for name in ("weight_ih", "weight_hh", "bias_ih"):
            p = getattr(self, name)
            destination[prefix + name] = p if keep_vars else p.detach()
        b = self.bias_hh(self.bias_hn.dtype)
        destination[prefix + "bias_hh"] = b if keep_vars else b.detach()

    def _load_from_state_dict(
        self, state_dict, prefix, local_metadata, strict, missing_keys,
        unexpected_keys, error_msgs,
    ):
        names = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
        missing = [prefix + n for n in names if prefix + n not in state_dict]
        if strict:
            unexpected_keys.extend(
                k for k in state_dict
                if k.startswith(prefix) and k[len(prefix):] not in names
            )
        if missing:
            missing_keys.extend(missing)
            return
        h = self.hidden_size
        with torch.no_grad():
            b_ih = state_dict[prefix + "bias_ih"].clone()
            b_hh = state_dict[prefix + "bias_hh"]
            b_ih[: 2 * h] += b_hh[: 2 * h].to(b_ih)
            for name, value in (
                ("weight_ih", state_dict[prefix + "weight_ih"]),
                ("weight_hh", state_dict[prefix + "weight_hh"]),
                ("bias_ih", b_ih),
                ("bias_hn", b_hh[2 * h:]),
            ):
                p = getattr(self, name)
                if p.shape != value.shape:
                    error_msgs.append(
                        f"size mismatch for {prefix}{name}: {tuple(value.shape)} "
                        f"against {tuple(p.shape)}"
                    )
                    continue
                p.copy_(value)


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
        norm: str = "batch",
    ):
        super().__init__()
        self.dim_z_content = dim_z_content
        self.dim_z_motion = dim_z_motion
        self.channel = channel
        self.geometric_info = geometric_info
        self.video_length = video_length
        self.image_size = image_size
        self.recurrent = GRUCell(dim_z_motion, dim_z_motion)
        self.compute_dtype = torch.float32
        self.norm = norm

        n_up = int(math.log2(image_size // 4))  # strided stages after 4x4
        # dim_z -> 8*ngf at 4x4 (ConvTranspose k4 s1 p0 on 1x1), then one
        # stage per doubling with channel multipliers min(8, 2^k) down to 1
        layers = [
            ConvTranspose2d(self.dim_z, ngf * 8, 4, 1, 0, bias=False),
            norm_layer(norm, ngf * 8),
            nn.ReLU(),
        ]
        cin = ngf * 8
        for i in range(n_up - 1):
            cout = ngf * min(8, 2 ** (n_up - 2 - i))
            layers += [up_conv(cin, cout), norm_layer(norm, cout), nn.ReLU()]
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
        h = h0.to(self.compute_dtype)
        e = e.to(self.compute_dtype)
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

    def decode(
        self, z: torch.Tensor, train: bool = False, update_stats: bool = True
    ) -> torch.Tensor:
        """Decode per-frame latents ``(N, dim_z)`` to frames
        ``(N, image_size, image_size, channel)``."""
        return self._decode(z, train, update_stats)[0]

    def _decode(
        self, z: torch.Tensor, train: bool, update_stats: bool
    ) -> Tuple[torch.Tensor, Optional[Codes]]:
        """:meth:`decode`'s frames and, from a fused softmax head, their
        codes ``(N, H, W, channel)`` (else None)."""
        x = z.to(self.compute_dtype).reshape(z.shape[0], -1, 1, 1)
        x = x.contiguous(memory_format=torch.channels_last)
        if decodes_fused(x, train, self.norm):
            out = self._decode_fused(x)
            if isinstance(out, SoftmaxCodes):
                return out.probs.permute(0, 2, 3, 1), Codes(out.codes.permute(0, 2, 3, 1), out.total)
            return out.permute(0, 2, 3, 1), None
        for layer in self.main:
            if isinstance(layer, Norm):
                x = layer(x, train, update_stats)
            else:
                x = layer(x)
        return x.permute(0, 2, 3, 1), None

    def _decode_fused(self, x: torch.Tensor) -> Union[torch.Tensor, SoftmaxCodes]:
        """The eval-mode decoder on the fused transposed conv: latents
        ``(N, dim_z, 1, 1)`` to the head's output ``(N, channel, H, W)``; a
        softmax head gives :class:`SoftmaxCodes` (the probabilities, their
        codes and sum)."""
        convs = [m for m in self.main if isinstance(m, nn.ConvTranspose2d)]
        norms = [m for m in self.main if isinstance(m, Norm)]
        raw = convs[0](x).contiguous(memory_format=torch.channels_last)
        for conv, norm in zip(convs[1:], norms):
            scale, shift = fold_batch_norm(norm)
            raw = fused_norm_act_up_conv(raw, scale, shift, conv.weight.to(x.dtype))
        if isinstance(self.main[-1], nn.Softmax):
            with trace.span("ggen.softmax_codes"):
                return softmax_codes(raw)
        return self.main[-1](raw)

    def forward(
        self,
        z_content: torch.Tensor,
        e: torch.Tensor,
        h0: torch.Tensor,
        train: bool = False,
        update_stats: bool = True,
    ) -> torch.Tensor:
        """Geometry videos ``(B, T, H, W, C)`` from explicit latents; from a
        fused softmax head they carry their :class:`Codes` (:func:`codes_of`)."""
        z = self.latents(z_content, e, h0)
        frames, codes = self._decode(fold_time(z), train, update_stats)
        videos = unfold_time(frames, z.shape[0])
        if codes is not None:
            videos._codes = Codes(unfold_time(codes.u8, z.shape[0]), codes.total)
        return videos
