"""The yardstick's arithmetic: the card's published peaks, rates, quantiles,
kernels' bounds and model FLOPs.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, 700 W). The bounds
are copies of the repo's smoke script (``site_bound``, ``dequant_bound_ms``):
each input byte read once, each output byte written once, operations over
the taps that touch the image. Model FLOPs are counted by
``torch.utils.flop_counter`` over the benchmark's own reference on ``meta``
tensors: convolutions, transposed convolutions and matmuls, forward and
backward; elementwise work is not counted.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Sequence

import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12
PEAK_BYTES_PER_S = 3.35e12


# ---------------------------------------------------------------- statistics
def quartile_spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, quartiles as ``statistics.quantiles(n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_seconds(intervals: Sequence[tuple]) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


# ---------------------------------------------------------------- kernels
def fused_site_bound(n: int, h: int, c: int, cout: int, dtype: torch.dtype, xn: bool):
    """(bound_s, flops, bytes) of one ``fused_norm_act_conv`` call on an
    ``(n, c, h, h)`` input to ``cout`` channels, with the activation written
    out when ``xn``: the larger of operations over the dtype's peak and
    bytes over the memory's."""
    es = torch.finfo(dtype).bits // 8
    oh = h // 2
    taps = (4 * oh - 2) ** 2
    flops = 2 * n * cout * c * taps
    nbytes = (n * h * h * c * (2 if xn else 1) + 16 * c * cout + n * oh * oh * cout) * es + 8 * c
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S), flops, nbytes


def ingest_bound(tensors: Sequence[torch.Tensor], out_dtype: torch.dtype) -> float:
    """Seconds to read each input once and write it once in ``out_dtype``
    (dequantisation: uint8 in, the compute dtype out), or the f32
    operations of ``x / 127.5 - 1`` if that is longer."""
    es = torch.finfo(out_dtype).bits // 8
    n = sum(t.numel() for t in tensors)
    nbytes = sum(t.numel() * (t.element_size() + es) for t in tensors)
    return max(nbytes / PEAK_BYTES_PER_S, 2 * n / PEAK_FLOPS[torch.float32])


# ---------------------------------------------------------------- model FLOPs
def _count(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def _meta_weights(cfg) -> Dict[str, Dict[str, torch.Tensor]]:
    from portbench.reference import models

    return {m: {k: torch.empty(shape, device="meta", requires_grad=True) for k, shape, _ in spec}
            for m, spec in models.param_specs(cfg).items()}


def train_step_flops(cfg, batchsize: int) -> int:
    """Operations of one train step at ``batchsize``: the D phase's fakes,
    six critic forwards and their backward, the G phase's generators, three
    critic forwards and the backward through critics and generators."""
    from portbench.reference import models

    P = _meta_weights(cfg)
    b, t, s = batchsize, cfg.video_length, cfg.image_size
    ch = cfg.geometric_info.channel
    train = models.Stats("train")
    off = models.NoiseDraws(None, None)

    def gen(grad: bool):
        with torch.set_grad_enabled(grad):
            z = [torch.empty(shape, device="meta") for shape in
                 ((b, cfg.ggen.dim_z_content), (b, t, cfg.ggen.dim_z_motion),
                  (b, cfg.ggen.dim_z_motion), (b, cfg.cgen.dim_z_color))]
            xg = models.ggen(P["ggen"], z[0], z[1], z[2], train, cfg)
            return xg, models.cgen(P["cgen"], xg, z[3], train, cfg)

    def step():
        real = (torch.empty(b, t, s, s, ch, device="meta"), torch.empty(b, t, s, s, 3, device="meta"))
        xg_f, xc_f = gen(False)
        d = sum(models.dis_loss(cfg.loss, models.critic(n, P[n], *real, 0, train, off),
                                models.critic(n, P[n], xg_f, xc_f, 0, train, off))
                for n in models.CRITICS)
        torch.autograd.grad(d, [p for n in models.CRITICS for p in P[n].values()])
        xg_f, xc_f = gen(True)
        y = [models.critic(n, P[n], xg_f, xc_f, 0, train, off) for n in models.CRITICS]
        g = models.gen_loss(cfg.loss, *y)
        torch.autograd.grad(g, [p for n in ("ggen", "cgen") for p in P[n].values()],
                            allow_unused=True)

    return _count(step)


def sample_flops(cfg, batchsize: int) -> int:
    """Operations of one eval-mode sampling round of ``batchsize`` videos."""
    from portbench.reference import models

    P = _meta_weights(cfg)
    b, t = batchsize, cfg.video_length
    running = {}
    for m in ("ggen", "cgen"):
        for prefix in models.bn_names(P[m]):
            c = P[m][prefix + ".weight"].shape[0]
            running[prefix] = (torch.empty(c, device="meta"), torch.empty(c, device="meta"))
    stats = models.Stats("eval", running)

    def round_():
        with torch.no_grad():
            xg = models.ggen(P["ggen"], torch.empty(b, cfg.ggen.dim_z_content, device="meta"),
                             torch.empty(b, t, cfg.ggen.dim_z_motion, device="meta"),
                             torch.empty(b, cfg.ggen.dim_z_motion, device="meta"), stats, cfg)
            models.cgen(P["cgen"], xg, torch.empty(b, cfg.cgen.dim_z_color, device="meta"), stats, cfg)

    return _count(round_)
