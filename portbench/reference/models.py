"""The plain reference of DCVGAN's five models, in float32 PyTorch.

Written from the model's description (raahii/dcvgan, as the program's model
docstrings restate it), as functions of a dict of parameters, with no fused
kernel, no channels-last layout, no cast and no data parallelism:

- ggen: a GRU cell over N(0, 1) inputs gives the motion code; [content |
  motion] per frame decodes through transposed convs (k4) with BatchNorm and
  ReLU to a tanh (softmax for segmentation) frame;
- cgen: a per-frame U-Net: conv3x3 + LeakyReLU(0.01), six down blocks (conv
  k4 s2 p1, BatchNorm, LeakyReLU 0.2), the colour code at the bottleneck,
  six up blocks (transposed conv, BatchNorm, channel dropout on the first
  two, ReLU) with skips, a transposed conv3x3 and tanh;
- idis / vdis: pair critics over (geometry, colour) with 2D / 3D convs
  (3D: kernel 4, strides (1, 2, 2), valid in time), [colour | geometry] after
  the stems; gdis: a 3D critic over the geometry's temporal differences.

BatchNorm in train mode takes the batch mean and the biased variance (eps
1e-5); in eval mode the running statistics. Parameter names and shapes are
the program's ``named_parameters()``, so one set of weights loads into both.

``Arith`` decides the precision of every product (conv, transposed conv,
matmul) and of the videos the generators hand on: ``f32`` with TF32 off is
the reference; ``fp8`` is the precision step below the configurations'
bfloat16 that the control computes in: both operands of each product, and
each generated video, rounded to float8 e4m3 with a per-tensor scale, and
the gradient flowing back into each to float8 e5m2 (the program keeps the
videos in bfloat16; the gradient critic's temporal differences are taken of
them).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
EPS = 1e-5
CRITICS = ("idis", "vdis", "gdis")
MODELS = ("ggen", "cgen") + CRITICS


def _scaled(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale that maps its
    largest magnitude to the format's largest value."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _scaled(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _scaled(g, torch.float8_e5m2)


class Arith:
    """How the operands of a product are rounded before it runs in float32."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown arithmetic {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return x
        if self.kind == "bf16":
            return x.to(torch.bfloat16).float()
        return _Fp8.apply(x)

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor as the arithmetic keeps it between models."""
        return self(x)

    def conv(self, x, w, stride, padding):
        f = F.conv2d if w.dim() == 4 else F.conv3d
        return f(self(x), self(w), None, stride, padding)

    def conv_t(self, x, w, stride, padding):
        return F.conv_transpose2d(self(x), self(w), None, stride, padding)

    def linear(self, x, w, b=None):
        return F.linear(self(x), self(w), b)


F32 = Arith("f32")


# ---------------------------------------------------------------- shapes
def down_mults(image_size: int) -> List[int]:
    return [1, 2] + [4] * (int(math.log2(image_size)) - 2)


def param_specs(cfg) -> Dict[str, List[Tuple[str, tuple, str]]]:
    """``{model: [(name, shape, init)]}`` of every parameter, where ``init``
    is the reference's: ``n0.02`` N(0, 0.02) for 2D convs, ``n1`` N(1, 0.02)
    and ``zero`` for BatchNorm2d, ``one``/``zero`` for BatchNorm3d, ``u<b>``
    U(-b, b) for the GRU (b = 1/sqrt(hidden)) and 3D convs (1/sqrt(fan_in))."""
    gi = cfg.geometric_info
    ch = gi.channel
    out: Dict[str, List[Tuple[str, tuple, str]]] = {}

    # ggen
    g, dzm = cfg.ggen.ngf, cfg.ggen.dim_z_motion
    dz = cfg.ggen.dim_z_content + dzm
    ub = f"u{1.0 / math.sqrt(dzm)!r}"
    spec = [("recurrent.weight_ih", (3 * dzm, dzm), ub), ("recurrent.weight_hh", (3 * dzm, dzm), ub),
            ("recurrent.bias_ih", (3 * dzm,), ub), ("recurrent.bias_hn", (dzm,), ub)]
    n_up = int(math.log2(cfg.image_size // 4))
    chans = [dz, g * 8] + [g * min(8, 2 ** (n_up - 2 - i)) for i in range(n_up - 1)]
    for i in range(n_up):
        spec += [(f"main.{3 * i}.weight", (chans[i], chans[i + 1], 4, 4), "n0.02"),
                 (f"main.{3 * i + 1}.weight", (chans[i + 1],), "n1"),
                 (f"main.{3 * i + 1}.bias", (chans[i + 1],), "zero")]
    spec.append((f"main.{3 * n_up}.weight", (chans[-1], ch, 4, 4), "n0.02"))
    out["ggen"] = spec

    # cgen
    c, dzc = cfg.cgen.ngf, cfg.cgen.dim_z_color
    dm = down_mults(cfg.image_size)
    n = len(dm)
    spec = [("inconv.main.0.weight", (c, ch, 3, 3), "n0.02")]
    cin = c
    for i, m in enumerate(dm):
        spec += [(f"down_blocks.{i}.main.0.weight", (c * m, cin, 4, 4), "n0.02"),
                 (f"down_blocks.{i}.main.1.weight", (c * m,), "n1"),
                 (f"down_blocks.{i}.main.1.bias", (c * m,), "zero")]
        cin = c * m
    cin = c * dm[-1] + dzc
    for i, m in enumerate(up_mults(cfg.image_size)):
        if i > 0:
            cin += c * dm[n - 1 - i]
        spec += [(f"up_blocks.{i}.main.0.weight", (cin, c * m, 4, 4), "n0.02"),
                 (f"up_blocks.{i}.main.1.weight", (c * m,), "n1"),
                 (f"up_blocks.{i}.main.1.bias", (c * m,), "zero")]
        cin = c * m
    spec.append(("outconv.main.0.weight", (cin + c, 3, 3, 3), "n0.02"))
    out["cgen"] = spec

    # critics
    for name in ("idis", "vdis"):
        d = getattr(cfg, name).ndf
        k = (4, 4) if name == "idis" else (4, 4, 4)
        stem = 1 if name == "idis" else 0
        spec = [(f"conv_g.{stem}.weight", (d // 2, ch) + k), (f"conv_c.{stem}.weight", (d // 2, 3) + k),
                ("main.1.weight", (d * 2, d) + k), ("main.2.weight", (d * 2,)), ("main.2.bias", (d * 2,)),
                ("main.5.weight", (d * 4, d * 2) + k), ("main.6.weight", (d * 4,)),
                ("main.6.bias", (d * 4,)), ("main.9.weight", (1, d * 4) + k)]
        out[name] = [(nm, shp, _critic_init(nm, shp, name == "idis")) for nm, shp in spec]
    d = cfg.gdis.ndf
    k = (4, 4, 4)
    spec = [("main.1.weight", (d, ch) + k), ("main.2.weight", (d,)), ("main.2.bias", (d,)),
            ("main.5.weight", (d * 2, d) + k), ("main.6.weight", (d * 2,)), ("main.6.bias", (d * 2,)),
            ("main.9.weight", (d * 4, d * 2) + k), ("main.10.weight", (d * 4,)),
            ("main.10.bias", (d * 4,)), ("main.13.weight", (1, d * 4) + k)]
    out["gdis"] = [(nm, shp, _critic_init(nm, shp, False)) for nm, shp in spec]
    return out


def _critic_init(name: str, shape: tuple, two_d: bool) -> str:
    """2D critic: convs N(0, 0.02), BatchNorm2d scale N(1, 0.02); 3D:
    convs U(+-1/sqrt(fan_in)), BatchNorm3d scale 1; biases 0."""
    if name.endswith(".bias"):
        return "zero"
    if len(shape) == 1:
        return "n1" if two_d else "one"
    if two_d:
        return "n0.02"
    return f"u{1.0 / math.sqrt(math.prod(shape[1:]))!r}"


def up_mults(image_size: int) -> List[int]:
    dm = down_mults(image_size)
    return list(reversed(dm[:-1])) + [1]


def bn_names(params: Params) -> List[str]:
    """The BatchNorm layers of a model: the prefixes of its 1-d scales."""
    return [k[: -len(".weight")] for k, v in params.items()
            if k.endswith(".weight") and v.dim() == 1]


# ------------------------------------------------------------ BatchNorm
class Stats:
    """BatchNorm mode of one forward: ``train`` (batch statistics), ``eval``
    (``running[prefix] = (mean, var)``), or ``record`` (batch statistics,
    stored into ``running`` as they are computed)."""

    def __init__(self, mode: str, running: Optional[Dict[str, Tuple]] = None):
        self.mode = mode
        self.running = {} if running is None else running

    def __call__(self, x: torch.Tensor, P: Params, prefix: str) -> torch.Tensor:
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.mode == "eval":
            mean, var = self.running[prefix]
        else:
            mean = x.mean(dims)
            var = (x - mean.view(shape)).pow(2).mean(dims)
            if self.mode == "record":
                self.running[prefix] = (mean.detach(), var.detach())
        inv = torch.rsqrt(var + EPS) * P[prefix + ".weight"]
        return (x - mean.view(shape)) * inv.view(shape) + P[prefix + ".bias"].view(shape)


# ---------------------------------------------------------------- ggen
def gru_states(P: Params, e: torch.Tensor, h0: torch.Tensor, A: Arith) -> torch.Tensor:
    """``h_t = GRU(e_t, h_{t-1})``, r / z / n gates, one bias each for r and
    z and separate input and hidden biases for n; ``(B, T, hidden)``."""
    hid = h0.shape[1]
    w_ih, w_hh = P["recurrent.weight_ih"], P["recurrent.weight_hh"]
    b = P["recurrent.bias_ih"]
    h, out = h0, []
    for t in range(e.shape[1]):
        gi = A.linear(e[:, t], w_ih, b)
        gh = A.linear(h, w_hh)
        r = torch.sigmoid(gi[:, :hid] + gh[:, :hid])
        z = torch.sigmoid(gi[:, hid: 2 * hid] + gh[:, hid: 2 * hid])
        n = torch.tanh(gi[:, 2 * hid:] + r * (gh[:, 2 * hid:] + P["recurrent.bias_hn"]))
        h = (1 - z) * n + z * h
        out.append(h)
    return torch.stack(out, 1)


def ggen(P: Params, z_content, e, h0, stats: Stats, cfg, A: Arith = F32) -> torch.Tensor:
    """Geometry videos ``(B, T, H, W, C)`` in [-1, 1]."""
    b, t = e.shape[:2]
    zm = gru_states(P, e, h0, A)
    z = torch.cat([z_content[:, None, :].expand(-1, t, -1), zm], -1)
    x = z.reshape(b * t, -1, 1, 1)
    n_up = int(math.log2(cfg.image_size // 4))
    for i in range(n_up):
        x = A.conv_t(x, P[f"main.{3 * i}.weight"], 1 if i == 0 else 2, 0 if i == 0 else 1)
        x = F.relu(stats(x, P, f"main.{3 * i + 1}"))
    x = A.conv_t(x, P[f"main.{3 * n_up}.weight"], 2, 1)
    x = torch.softmax(x, 1) if cfg.geometric_info.name == "segmentation" else torch.tanh(x)
    return A.store(x.permute(0, 2, 3, 1).reshape(b, t, *x.shape[2:], x.shape[1]))


# ---------------------------------------------------------------- cgen
def cgen(P: Params, xg: torch.Tensor, z_color: torch.Tensor, stats: Stats, cfg,
         masks=None, A: Arith = F32) -> torch.Tensor:
    """Colour videos ``(B, T, H, W, 3)`` from geometry videos and one colour
    code a video; ``masks`` (train mode) are the keep masks of up blocks 0
    and 1, ``(B*T, C)``, kept values doubled."""
    b, t = xg.shape[:2]
    x = xg.reshape(b * t, *xg.shape[2:]).permute(0, 3, 1, 2)
    if cfg.geometric_info.name == "segmentation":
        x = F.one_hot(x.argmax(1), x.shape[1]).float().permute(0, 3, 1, 2) * 2.0 - 1.0
    z = z_color[:, None, :].expand(-1, t, -1).reshape(b * t, -1)
    hs = [F.leaky_relu(A.conv(x, P["inconv.main.0.weight"], 1, 1), 0.01)]
    h = hs[0]
    n = len(down_mults(cfg.image_size))
    for i in range(n):
        h = A.conv(h, P[f"down_blocks.{i}.main.0.weight"], 2, 1)
        h = F.leaky_relu(stats(h, P, f"down_blocks.{i}.main.1"), 0.2)
        hs.append(h)
    h = torch.cat([h, z[:, :, None, None]], 1)
    for i in range(n):
        if i > 0:
            h = torch.cat([h, hs[n - i]], 1)
        h = stats(A.conv_t(h, P[f"up_blocks.{i}.main.0.weight"], 2, 1), P, f"up_blocks.{i}.main.1")
        if masks is not None and i < 2:
            h = h * (masks[i].float() * 2.0)[:, :, None, None]
        h = F.relu(h)
    y = torch.tanh(A.conv_t(torch.cat([h, hs[0]], 1), P["outconv.main.0.weight"], 1, 1))
    return A.store(y.permute(0, 2, 3, 1).reshape(b, t, *y.shape[2:], 3))


# -------------------------------------------------------------- critics
class NoiseDraws:
    """The critics' additive noise ``x + sigma * N(0, 1)``, drawn in layer
    order from one generator at each input's channels-first shape, as the
    program draws it; ``sigma`` None turns it off."""

    def __init__(self, sigma: Optional[float], generator: Optional[torch.Generator]):
        self.sigma = sigma
        self.generator = generator

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.sigma is None:
            return x
        d = torch.randn(tuple(x.shape), generator=self.generator, device=x.device)
        return x + d * self.sigma


def _to_cf(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def pair_critic(P: Params, xg, xc, stats: Stats, noise: NoiseDraws, video: bool,
                A: Arith = F32) -> torch.Tensor:
    """idis (frames ``(B, H, W, C)``) or vdis (videos ``(B, T, H, W, C)``):
    logits ``(B, 4, 4)`` / ``(B, T - 12, 4, 4)``."""
    st = (1, 2, 2) if video else 2
    pad = (0, 1, 1) if video else 1
    stem = 0 if video else 1
    hs = []
    for part, x in (("g", xg), ("c", xc)):
        h = _to_cf(x)
        if not video:
            h = noise(h)
        hs.append(F.leaky_relu(A.conv(h, P[f"conv_{part}.{stem}.weight"], st, pad), 0.2))
    h = torch.cat([hs[1], hs[0]], 1)  # [colour | geometry]
    for k, bn in ((1, "main.2"), (5, "main.6")):
        h = A.conv(noise(h), P[f"main.{k}.weight"], st, pad)
        h = F.leaky_relu(stats(h, P, bn), 0.2)
    return A.conv(noise(h), P["main.9.weight"], st, pad).squeeze(1)


def gradient_critic(P: Params, xg, stats: Stats, noise: NoiseDraws, A: Arith = F32) -> torch.Tensor:
    """gdis over ``x[1:] - x[:-1]`` of the geometry: ``(B, T - 13, 4, 4)``."""
    h = _to_cf(xg[:, 1:] - xg[:, :-1])
    for k, bn in ((1, "main.2"), (5, "main.6"), (9, "main.10")):
        h = A.conv(noise(h), P[f"main.{k}.weight"], (1, 2, 2), (0, 1, 1))
        h = F.leaky_relu(stats(h, P, bn), 0.2)
    return A.conv(noise(h), P["main.13.weight"], (1, 2, 2), (0, 1, 1)).squeeze(1)


def critic(name: str, P: Params, xg, xc, t_rand: int, stats: Stats, noise: NoiseDraws,
           A: Arith = F32) -> torch.Tensor:
    if name == "idis":
        return pair_critic(P, xg[:, t_rand], xc[:, t_rand], stats, noise, False, A)
    if name == "vdis":
        return pair_critic(P, xg, xc, stats, noise, True, A)
    return gradient_critic(P, xg, stats, noise, A)


# ---------------------------------------------------------------- losses
def dis_loss(kind: str, y_real, y_fake):
    if kind == "hinge-loss":
        return F.relu(1.0 - y_real).mean() + F.relu(1.0 + y_fake).mean()
    return F.softplus(-y_real).mean() + F.softplus(y_fake).mean()


def gen_loss(kind: str, y_i, y_v, y_g):
    if kind == "hinge-loss":  # the reference's hinge generator term omits gdis
        return F.softplus(-y_i).mean() + F.softplus(-y_v).mean()
    return F.softplus(-y_i).mean() + F.softplus(-y_v).mean() + F.softplus(-y_g).mean()
