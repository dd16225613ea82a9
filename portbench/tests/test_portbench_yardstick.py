"""The yardstick's arithmetic: quantiles, spreads, rates, idle share, the
kernels' bounds at the flagship shapes and the model FLOP counts."""

import statistics

import pytest
import torch

from portbench import harness, yardstick
from portbench.reference import models

FLAGSHIP_SITES = [(32, 64, 128), (16, 128, 256), (8, 256, 256), (4, 256, 256), (2, 256, 256)]


@pytest.mark.parametrize("values,q,want", [
    ([1, 2, 3, 4, 5], 50, 3.0), ([1, 2, 3, 4], 50, 2.5), ([10], 95, 10.0),
    (list(range(101)), 95, 95.0), ([0, 100], 95, 95.0)])
def test_percentile(values, q, want):
    assert yardstick.percentile(values, q) == pytest.approx(want)


def test_quartile_spread_is_statistics_quantiles():
    xs = [100.0, 101.0, 99.0, 102.0, 98.0, 100.5]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert yardstick.quartile_spread(xs) == pytest.approx((q3 - q1) / med)


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0), ([(0, 1)], 1.0), ([(0, 2), (1, 3)], 3.0), ([(0, 1), (2, 3)], 2.0),
    ([(0, 10), (2, 3), (4, 5)], 10.0), ([(5, 6), (0, 1), (0.5, 2)], 3.0)])
def test_union_seconds(intervals, want):
    assert yardstick.union_seconds(intervals) == pytest.approx(want)


def test_idle_share_from_union():
    from portbench.trace import idle_percent

    r = harness.Readings(trace={"busy_s": 0.75, "window_s": 1.0})
    assert idle_percent(r) == pytest.approx(25.0)
    assert idle_percent(harness.Readings()) is None


def test_fused_block_bound_at_the_flagship_is_0781_ms():
    """PERF.md's kernel table: 0.781 ms (bytes) for one cgen forward at
    B=256 (4,096 frames), five sites, activation written out."""
    total = sum(yardstick.fused_site_bound(4096, h, c, co, torch.bfloat16, True)[0]
                for h, c, co in FLAGSHIP_SITES)
    assert total * 1e3 == pytest.approx(0.781, abs=5e-4)


def test_dequant_bound_at_the_flagship_is_47_us():
    """PERF.md's kernel table: 4.7 us for a train step's colour and depth
    batches at batch 20, uint8 in and bfloat16 out."""
    xs = [torch.empty(20, 16, 64, 64, 3, dtype=torch.uint8),
          torch.empty(20, 16, 64, 64, 1, dtype=torch.uint8)]
    assert yardstick.ingest_bound(xs, torch.bfloat16) * 1e6 == pytest.approx(4.7, abs=0.01)


def _flagship(batch=20):
    cfg = harness.load_config(harness.ROOT / "configs" / "mug-depth.yml", 0)
    cfg.batchsize = batch
    return cfg


@pytest.mark.parametrize("batch,xla_gflop", [(20, 2235.4), (128, 14304.5)])
def test_train_step_flops_beside_xla(batch, xla_gflop):
    """The reference's count of a step against XLA's cost analysis of the
    JAX step (``BENCH_r05.json``): 2,446.9 and 15,660.3 GFLOP, 9.5% above
    it at both batches (XLA leaves out part of the transposed convolutions'
    and backward work that the counter charges). The count scales with the
    batch."""
    gflop = yardstick.train_step_flops(_flagship(batch), batch) / 1e9
    assert gflop == pytest.approx({20: 2446.9, 128: 15660.3}[batch], rel=1e-3)
    assert 1.05 < gflop / xla_gflop < 1.12


def test_sample_flops_per_video():
    cfg = _flagship()
    per_video = yardstick.sample_flops(cfg, 256) / 256 / 1e9
    assert per_video == pytest.approx(18.763, rel=1e-3)
    assert yardstick.sample_flops(cfg, 2) * 128 == yardstick.sample_flops(cfg, 256)


def test_param_specs_count():
    specs = models.param_specs(_flagship())
    n = {m: sum(torch.Size(shape).numel() for _, shape, _ in spec) for m, spec in specs.items()}
    assert set(n) == set(models.MODELS) and all(v > 0 for v in n.values())
