"""A traced run of each cell on the card, short: every per-layer metric the
cell lists is read, each share stays at or under 100%, and the device
numbers are there. Skips without a card."""

import time

import pytest

from portbench import harness

BENCH = harness.load_bench()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_traced_run_reads_every_metric(cell, card):
    r = harness.run(cell, 2**31 + 3, 4.0, True, time.time())
    assert r["correct"], r["checks"]
    want = {m["name"] for m in harness.metrics_for(BENCH, cell, "per_layer")}
    assert set(r["metrics"]) == want
    for name, m in r["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, name
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert len(r["breakdown"]["device_ops"]) <= 10 and len(r["breakdown"]["idle_gaps"]) <= 10
