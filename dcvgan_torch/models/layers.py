"""Shared layers and initialisers.

Counterpart of ``dcvgan_tpu/models/layers.py``. Initialisation follows the
reference: 2D convs and transposed convs N(0, 0.02), BatchNorm2d scale
N(1, 0.02) and bias 0, the GRU cell U(+-1/sqrt(hidden)); 3D convs and their
BatchNorms keep torch's defaults (U(+-1/sqrt(fan_in)), scale 1), because the
reference's init matches 2D layers only. Every initialiser takes an explicit
``torch.Generator``.

**Compute dtype.** Parameters are float32 masters; a layer casts its weight
to its input's dtype on use, as flax's ``nn.Conv(dtype=...)`` does, so the
input's dtype is the compute dtype, gradients arrive in float32 and Adam
runs in float32. A module whose parameters were cast once
(:func:`cast_for_compute`, the serving copy) pays nothing for the cast.
Each model carries its ``compute_dtype`` and casts its inputs to it.

**BatchNorm** has flax's semantics: it normalises in float32 whatever the
input's dtype and rounds once; in train mode it uses the biased batch
variance and stores that *biased* variance in the running statistics with
momentum 0.9 (torch's 0.1), where torch would store the unbiased one.
Whether a train-mode forward writes the running statistics is an explicit
argument: the train step decides which of its forwards do. Under data
parallelism with global-batch statistics (:func:`sync_batch_norms`) a
train-mode forward takes the mean and variance of the whole batch over the
ranks of the default process group, as the JAX package's BatchNorm computes
them for a batch sharded under ``jit``. The video critics' BatchNorms are
:class:`MaskedSyncBatchNorm`, whose ``masked`` forward takes the statistics
of the valid frames of every rank for the time-sharded critics.

**GroupNorm** (``trainer.norm: group``, :class:`ChannelGroupNorm`) takes
BatchNorm's place at the same slots. It normalises each sample over groups
of contiguous channels and has no running statistics, so train and eval
compute the same thing. Both are :class:`Norm` layers, called as
``layer(x, train, update_stats)``; :func:`norm_layer` builds either.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from dcvgan_torch.parallel.mesh import all_reduce_sum

BN_MOMENTUM = 0.1  # torch's convention: new = (1 - m) * old + m * batch


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
    """Reference init of every 2D conv, transposed conv and BatchNorm2d, and
    torch's default init of every 3D conv and BatchNorm3d. A GroupNorm in a
    BatchNorm's slot takes that BatchNorm's init."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                conv2d_kernel_init_(m.weight, generator)
            elif isinstance(m, nn.BatchNorm2d) or (
                isinstance(m, ChannelGroupNorm) and not m.init_ones
            ):
                bn2d_scale_init_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, nn.Conv3d):
                # kaiming_uniform(a=sqrt(5)) is U(+-1/sqrt(fan_in))
                fan_in = m.weight[0].numel()
                uniform_symmetric_init_(m.weight, 1.0 / math.sqrt(fan_in), generator)
            elif isinstance(m, (nn.BatchNorm3d, ChannelGroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that casts its weight to the input's dtype on use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` that casts its weight to the input's dtype on use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that casts its weight to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), None, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation,
        )


class Norm:
    """A normalisation layer, called as ``layer(x, train, update_stats)``:
    :class:`BatchNorm2d`, :class:`BatchNorm3d` or :class:`ChannelGroupNorm`."""


class _FlaxBatchNorm(Norm):
    """Forward shared by :class:`BatchNorm2d` and :class:`BatchNorm3d`."""

    # set by sync_batch_norms(): train-mode statistics over every rank's rows
    global_batch = False

    def forward(
        self, x: torch.Tensor, train: bool = False, update_stats: bool = True
    ) -> torch.Tensor:
        """Eval mode (``train=False``) normalises with the running statistics.
        Train mode normalises with the batch's mean and biased variance, in
        float32, and, when ``update_stats``, moves the running statistics
        towards them (the biased variance, as flax stores it). With
        ``global_batch`` the batch is every rank's rows together."""
        if not train:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps,
            )
        if self.global_batch:
            return self._global_batch_forward(x, update_stats)
        out, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps
        )
        if update_stats:
            with torch.no_grad():
                # invstd = rsqrt(var + eps) with the biased variance
                var = (invstd.float().pow(-2) - self.eps).clamp_(min=0.0)
                self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean.float(), alpha=BN_MOMENTUM)
                self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
        return out

    def _global_batch_forward(
        self, x: torch.Tensor, update_stats: bool, mask_t: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Statistics of the global batch: each rank sums x, x^2 and its
        count in float32, one differentiable SUM all-reduce of the packed
        ``[2C + 1]`` vector adds the ranks' sums, and mean = s1 / n,
        var = s2 / n - mean^2 (flax's fast variance, clamped at 0). With
        ``mask_t`` (a per-frame 0/1 mask of an NCDHW ``x``) only the frames
        it keeps count."""
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        xf = x.float()
        if mask_t is None:
            xm = xf
            count = xf.new_full((1,), x.numel() // c)
        else:
            m = mask_t.float()
            xm = xf * m.view(1, 1, -1, 1, 1)
            count = (m.sum() * (x.numel() // (c * x.shape[2]))).reshape(1)
        total = all_reduce_sum(torch.cat([xm.sum(dims), (xm * xf).sum(dims), count]))
        n = total[2 * c]
        mean = total[:c] / n
        var = (total[c: 2 * c] / n - mean * mean).clamp(min=0.0)
        shape = (1, c) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        out = ((xf - mean.view(shape)) * mul.view(shape) + self.bias.float().view(shape)).to(x.dtype)
        if update_stats:
            with torch.no_grad():
                self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
                self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
        return out


def running_statistics(module: nn.Module) -> list:
    """The running means and variances of every BatchNorm of ``module``."""
    return [t for m in module.modules() if isinstance(m, _FlaxBatchNorm)
            for t in (m.running_mean, m.running_var)]


def sync_batch_norms(module: nn.Module) -> None:
    """Give every BatchNorm of ``module`` global-batch statistics over the
    default process group."""
    for m in module.modules():
        if isinstance(m, _FlaxBatchNorm):
            m.global_batch = True


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    pass


class MaskedSyncBatchNorm(BatchNorm3d):
    """The video critics' BatchNorm3d, which their time-sharded forward
    calls as :meth:`masked` (the JAX package's ``MaskedSyncBatchNorm``).

    Called as a :class:`Norm` it is :class:`BatchNorm3d`; the parameters,
    buffers and state-dict names are the same in both modes, so one
    checkpoint drives both. ``masked`` takes this rank's frames of the
    clips, NCDHW, and a per-frame validity mask: in train mode the mean and
    biased variance are those of the valid frames of every rank (the whole
    data x time world: Σx, Σx² and the count in float32, one SUM
    all-reduce), which are the unsharded critic's statistics; the running
    statistics move with flax's momentum 0.9; eps 1e-5. Eval mode reads the
    running statistics.
    """

    def masked(
        self, x: torch.Tensor, mask_t: torch.Tensor, train: bool, update_stats: bool = True
    ) -> torch.Tensor:
        if not train:
            return self(x, False)
        return self._global_batch_forward(x, update_stats, mask_t)


def batch_norm(num_features: int) -> BatchNorm2d:
    """BatchNorm over (N, H, W) with the reference's eps 1e-5."""
    return BatchNorm2d(num_features, eps=1e-5, momentum=BN_MOMENTUM)


def batch_norm3d(num_features: int) -> MaskedSyncBatchNorm:
    """BatchNorm over (N, T, H, W) with the reference's eps 1e-5."""
    return MaskedSyncBatchNorm(num_features, eps=1e-5, momentum=BN_MOMENTUM)


GN_MAX_GROUPS = 32


class ChannelGroupNorm(Norm, nn.Module):
    """GroupNorm over contiguous channel groups, per sample, with no state:
    the JAX package's ``ChannelGroupNorm``.

    The group count is the largest divisor of the channel count that is at
    most ``GN_MAX_GROUPS``. The mean and the biased variance over a
    group's channels and every spatial (and temporal) position are taken in
    float32 whatever the input's dtype, then ``y * weight + bias`` in
    float32, rounded once to the input's dtype; eps 1e-5. ``train`` and
    ``update_stats`` are accepted and ignored. ``init_ones`` says which
    BatchNorm's init it takes (:func:`init_weights_`): scale 1 (3D critics)
    or N(1, 0.02).
    """

    def __init__(self, num_channels: int, init_ones: bool = False):
        super().__init__()
        groups = min(GN_MAX_GROUPS, num_channels)
        while num_channels % groups:
            groups -= 1
        self.num_groups = groups
        self.eps = 1e-5
        self.init_ones = init_ones
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(
        self, x: torch.Tensor, train: bool = False, update_stats: bool = True
    ) -> torch.Tensor:
        del train, update_stats
        y = F.group_norm(
            x.float(), self.num_groups, self.weight.float(), self.bias.float(), self.eps
        ).to(x.dtype)
        # keep the input's channels-last layout for the conv after
        fmt = {4: torch.channels_last, 5: torch.channels_last_3d}.get(x.dim())
        if fmt is not None and x.is_contiguous(memory_format=fmt):
            y = y.contiguous(memory_format=fmt)
        return y


def norm_layer(kind: str, num_features: int, ndim: int = 2) -> nn.Module:
    """The normalisation of one BatchNorm slot: ``kind`` is ``trainer.norm``
    ("batch" or "group"), ``ndim`` the spatial dims of the convs around it
    (2, or 3 for the video critics, whose norms take torch's init)."""
    if kind == "group":
        return ChannelGroupNorm(num_features, init_ones=ndim == 3)
    if kind != "batch":
        raise ValueError(f"trainer.norm must be 'batch' or 'group', got {kind!r}")
    return batch_norm(num_features) if ndim == 2 else batch_norm3d(num_features)


def fold_batch_norm(bn: nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BatchNorm as a per-channel affine in f32:
    ``scale = weight * rsqrt(var + eps)``, ``shift = bias - mean * scale``."""
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    shift = bn.bias.float() - bn.running_mean.float() * scale
    return scale, shift


def decodes_fused(x: torch.Tensor, train: bool, norm: str) -> bool:
    """Whether a generator's decoder runs on the fused transposed conv
    (``ops.fused_up.fused_norm_act_up_conv``) for input ``x``: eval mode
    under BatchNorm (a per-channel affine, :func:`fold_batch_norm`),
    bfloat16, on CUDA. Train mode (batch statistics), ``norm: group`` (per
    sample), float32 and the CPU keep the unfused modules."""
    return not train and norm == "batch" and x.dtype == torch.bfloat16 and x.is_cuda


def onehot_fused(x: torch.Tensor, train: bool) -> bool:
    """Whether the colour generator's segmentation input runs on
    ``ops.onehot_conv.onehot_conv3x3`` (argmax, +-1 one-hot, inconv and
    LeakyReLU in one launch) for input ``x``: eval mode, bfloat16, on CUDA.
    Train mode, float32 and the CPU keep the unfused modules."""
    return not train and x.dtype == torch.bfloat16 and x.is_cuda


def inconv_fused(x: torch.Tensor, train: bool, geometric_info: str) -> bool:
    """Whether the colour generator's inconv and its LeakyReLU run on
    ``ops.inconv.inconv3x3`` (one launch) for a dense geometric input ``x``
    (depth, optical flow): eval mode, bfloat16, on CUDA. A segmentation
    input takes :func:`onehot_fused`'s op instead; train mode, float32 and
    the CPU keep the unfused modules."""
    return not train and geometric_info != "segmentation" and x.dtype == torch.bfloat16 and x.is_cuda


class RowsOfBatch(NamedTuple):
    """Draws of a batch of ``total`` rows from ``generator``, of which this
    rank keeps ``rows``: a rank's share of a global batch's draw."""

    generator: torch.Generator
    rows: torch.Tensor
    total: int


class Noise(nn.Module):
    """Additive Gaussian noise, ``x + sigma * N(0, 1)``, whenever
    ``use_noise`` is set: a static flag, applied in train and eval alike.

    The unit-normal draw is ``noise`` when given (shaped like ``x``), else it
    comes from ``generator``: a ``torch.Generator``, or a
    :class:`RowsOfBatch` whose rows of the whole batch's draw it takes.
    """

    def __init__(self, use_noise: bool, sigma: float = 0.2):
        super().__init__()
        self.use_noise = use_noise
        self.sigma = sigma

    def forward(
        self,
        x: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[Union[torch.Generator, RowsOfBatch]] = None,
    ) -> torch.Tensor:
        if not self.use_noise:
            return x
        if noise is None:
            noise = self.unit_draw(x.shape, generator, x.device)
        # sigma rounded to the compute dtype first, as the JAX package does
        sigma = torch.tensor(self.sigma).to(x.dtype).item()
        return x + noise.to(x.dtype) * sigma

    @staticmethod
    def unit_draw(
        shape, generator: Optional[Union[torch.Generator, RowsOfBatch]], device
    ) -> torch.Tensor:
        """The unit-normal draw of a tensor of ``shape`` from ``generator``."""
        if isinstance(generator, RowsOfBatch):
            total = (generator.total,) + tuple(shape[1:])
            return torch.randn(total, generator=generator.generator, device=device)[generator.rows]
        return torch.randn(tuple(shape), generator=generator, device=device)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def same_pad_conv(in_ch: int, out_ch: int) -> Conv2d:
    """Conv k4 s2 p1: halves H and W exactly."""
    return Conv2d(in_ch, out_ch, 4, 2, 1, bias=False)


def time_valid_conv3d(in_ch: int, out_ch: int) -> Conv3d:
    """The video critics' conv: kernel 4, strides (1, 2, 2), padding
    (0, 1, 1), no bias: valid in time (T -> T - 3), halved in space."""
    return Conv3d(in_ch, out_ch, 4, (1, 2, 2), (0, 1, 1), bias=False)


def up_conv(in_ch: int, out_ch: int) -> ConvTranspose2d:
    """Transposed conv k4 s2 p1: doubles H and W exactly."""
    return ConvTranspose2d(in_ch, out_ch, 4, 2, 1, bias=False)


def _channels_last_(module: nn.Module) -> None:
    """Conv weights into channels-last memory (4D and 5D), in place, with
    ``Tensor.to(memory_format=...)``: it writes channels-last strides even
    where one input channel makes both layouts coincide (``contiguous``
    would leave such a weight's strides as they are). cuDNN picks the
    output's layout from the strides, and a weight left looking contiguous
    turns the activations after it back to NCHW, with a copy before every
    channels-last conv."""
    for p in module.parameters():
        if p.dim() == 4:
            p.data = p.data.to(memory_format=torch.channels_last)
        elif p.dim() == 5:
            p.data = p.data.to(memory_format=torch.channels_last_3d)


def cast_for_compute(
    module: nn.Module, device: torch.device, dtype: torch.dtype
) -> nn.Module:
    """The serving placement: move ``module`` to ``device`` with its
    parameters cast once to ``dtype``, channels-last, and make ``dtype`` its
    compute dtype. Norm parameters (and BatchNorm's running statistics) stay
    float32: the JAX package keeps them in f32 and normalises in f32
    whatever the compute dtype."""
    module.to(device=device, dtype=dtype)
    for m in module.modules():
        if isinstance(m, Norm):
            m.float()
    _channels_last_(module)
    module.compute_dtype = dtype
    return module


def place_for_training(
    module: nn.Module, device: torch.device, dtype: torch.dtype
) -> nn.Module:
    """The training placement: move ``module`` to ``device`` with float32
    master parameters, channels-last, and make ``dtype`` its compute dtype."""
    module.to(device=device, dtype=torch.float32)
    _channels_last_(module)
    module.compute_dtype = dtype
    return module


def fold_time(x: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) -> (B*T, ...): per-frame nets see time as batch."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def unfold_time(x: torch.Tensor, batch: int) -> torch.Tensor:
    """(B*T, ...) -> (B, T, ...)."""
    return x.reshape((batch, -1) + tuple(x.shape[1:]))
