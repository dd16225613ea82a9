"""The cell ``surreal-depth3.sample-b256`` and its traffic ``sample_cgen`` on the
CPU at a tiny size (the look for a card skipped): a sound run is correct;
the traffic's bound of a ``fused_norm_act_up_conv`` call is ``chip_smoke.py``'s
``up_bound`` at mug-depth's ten sites and surreal-depth3's six cgen sites;
the traced chunks' ranges count one colour-generator forward and its six
fused up convs a sampling round, and nothing outside the span; both new
readers find nothing without their ranges; the fp8 control is not correct
by ``video_gap``, at ngf 16 on the CPU and at the cell's size on the card
(``gpu``)."""

import time

import pytest

import chip_smoke
from portbench import harness, judge, weights
from portbench.reference import models, steps, streams

CELL = "surreal-depth3.sample-b256"
SMALL = {"batchsize": 4, "rounds": 2, "sampled_chunks": [2, 4]}
SEEDS = (2**31 + 77, 5, 99)


def _params():
    return harness.load_file(harness.ROOT / "workloads" / f"{CELL}.json")["params"]


def _traffic():
    return harness.load_module(harness.ROOT / "traffic" / "sample_cgen.py")


def test_the_cell_loads_through_the_harness():
    bench = harness.load_bench()
    wl, entry = harness.cell_spec(bench, CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == ("surreal-depth3", "sample-b256", 1)
    workload = harness.load_file(harness.ROOT / "workloads" / f"{CELL}.json")
    assert workload["traffic"] == "sample_cgen" and workload["params"]["limits"] == {"video_gap": 3.0}
    mug = harness.load_file(harness.ROOT / "workloads" / "mug-depth.sample-b256.json")
    assert workload["params"] == mug["params"]  # mug-depth's traffic, parameter for parameter
    cfg = harness.load_config(harness.REPO / entry["file"], 3)
    assert (cfg.ggen.ngf, cfg.cgen.ngf, cfg.geometric_info.name, cfg.geometric_info.channel) == (64, 96, "depth", 1)
    layers = {m["name"] for m in harness.metrics_for(bench, CELL, "per_layer")}
    assert {"cgen.fused_up_roofline", "cgen.device_ms.sample", "fused_block_roofline", "conv.device_ms.sample",
            "sample.mfu", "serve.dispatch_ms", "device_idle.sample"} == layers


def test_sound_run_is_correct(tiny):
    r = harness.run(CELL, 2**31 + 99, 2.0, False, time.time(), device="cpu", overrides=tiny, params=SMALL)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"sample_videos_per_s", "peak_mem_gb", "setup_s"}
    assert set(r["checks"]) == {"video_gap"}
    assert r["counters"]["cgen_calls"] == r["counters"]["cgen_fused_up_calls"] == 0  # untraced: no range opened


def _up_sites():
    """mug-depth's ten fused up sites and surreal-depth3's six cgen sites:
    (H, C_x, C_skip, Cout, route)."""
    from dcvgan_torch.models.cgen import ColorVideoGenerator
    from dcvgan_torch.models.ggen import GeometricVideoGenerator

    mug = chip_smoke.decoder_sites(GeometricVideoGenerator(ngf=64), ColorVideoGenerator(ngf=64))
    return [site[1:] for site in mug + chip_smoke.wide_cgen_up_sites()]


@pytest.mark.parametrize("site", _up_sites(), ids=lambda s: f"{s[4]}-h{s[0]}-{s[1]}+{s[2]}-{s[3]}")
def test_up_bound_is_the_smoke_scripts(site):
    h, c1, c2, cout, route = site
    bound_s, flops, nbytes = _traffic().up_bound(4096, h, c1, c2, cout, route)
    assert bound_s * 1e3 == pytest.approx(chip_smoke.up_bound(4096, h, c1, c2, cout, route)[0], rel=1e-12)
    assert bound_s == pytest.approx(max(flops / 989e12, nbytes / 3.35e12))


def test_up_bound_counts_live_channels_and_taps():
    # up5 at cgen ngf 96: 96 + 96 live channels (the kernel stages 128 + 128),
    # 126 x 126 taps that touch the 32 x 32 image a phase-summed output plane
    bound_s, flops, nbytes = _traffic().up_bound(4096, 32, 96, 96, 96, "k4s2")
    assert flops == 2 * 4096 * 192 * 96 * 126 ** 2
    assert nbytes == 2 * (4096 * 32 * 32 * 192 + 192 * 96 * 16 + 4096 * 64 * 64 * 96) + 8 * 96


class _StubSpan:
    """A profiler span that records nothing (the CPU has no device trace)."""

    def open(self):
        pass

    def measure(self):
        pass

    def close(self):
        pass

    def summarize(self):
        return {"busy_s": 0.0, "window_s": 0.0, "ranges": {}, "conv_s": 0.0, "device_ops": [],
                "idle_gaps": []}


def test_traced_chunks_count_one_forward_and_six_up_convs_a_round(tiny, monkeypatch):
    import dcvgan_torch.models.cgen as cgen_mod
    import dcvgan_torch.models.ggen as ggen_mod
    from portbench import trace as trace_mod

    # the CPU taken as the card: both decoders' fused up stages run their plain versions
    monkeypatch.setattr(trace_mod, "Span", _StubSpan)
    monkeypatch.setattr(cgen_mod, "decodes_fused", lambda x, train, norm: not train)
    monkeypatch.setattr(ggen_mod, "decodes_fused", lambda x, train, norm: not train)
    wl, entry = harness.cell_spec(harness.load_bench(), CELL)
    params = {**_params(), "batchsize": 2, "sampled_chunks": [2, 4]}  # 4 rounds a chunk, as the cell
    cfg = harness.load_config(harness.REPO / entry["file"], 7, tiny)
    ctx = harness.Context(CELL, cfg, params, 7, 1.0, True, "cpu", time.time(), harness.WORK)
    traffic = _traffic()
    calls = {"cgen": 0, "ggen": 0}
    up = cgen_mod.fused_norm_act_up_conv

    def counted(name):
        def call(*a, **k):
            calls[name] += 1
            return up(*a, **k)

        return call

    cgen_up, ggen_up = counted("cgen"), counted("ggen")
    monkeypatch.setattr(cgen_mod, "fused_norm_act_up_conv", cgen_up)
    monkeypatch.setattr(ggen_mod, "fused_norm_act_up_conv", ggen_up)
    out = traffic.measure(ctx)
    c = out.readings.counters
    assert c["traced_chunks"] == params["trace_chunks"] == 3 and params["rounds"] == 4
    assert (c["cgen_calls"], c["cgen_fused_up_calls"]) == (12, 72)
    assert calls["cgen"] > c["cgen_fused_up_calls"]  # the calls outside the span ran, unranged and uncounted
    assert calls["ggen"] > 0  # ggen's own name is not ranged
    n, ngf = params["batchsize"] * cfg.video_length, cfg.cgen.ngf
    widths = [ngf * m for m in (4, 4, 4, 2, 1, 1)]  # up0-5's outputs; site i takes up(i-1)'s and its skip's
    want = sum(traffic.up_bound(n, 2 << i, widths[i], widths[i], widths[i + 1], "k4s2")[0] for i in range(5))
    want += traffic.up_bound(n, 64, ngf, ngf, 3, "k3s1")[0]
    assert c["cgen_fused_up_bound_s"] == pytest.approx(12 * want)
    assert cgen_mod.fused_norm_act_up_conv is cgen_up  # the traffic's wrapper is gone after the run
    out.release()


@pytest.mark.parametrize("metric", ["cgen.fused_up_roofline", "cgen.device_ms.sample"])
def test_readers_find_nothing_without_their_ranges(metric):
    reader = harness.load_module(harness.ROOT / "metrics" / f"{metric}.py")
    assert reader.read(harness.Readings()) is None
    other = {"busy_s": 1.0, "window_s": 1.0, "ranges": {"fused_block": [0.5, 60]}, "conv_s": 0.1}
    counters = {"traced_chunks": 3, "cgen_fused_up_bound_s": 0.0, "fused_bound_s": 0.1}
    assert reader.read(harness.Readings(counters=counters, trace=other)) is None
    ranged = dict(other, ranges={"cgen": [0.3, 12], "cgen_fused_up": [0.2, 72]})
    value = reader.read(harness.Readings(counters=dict(counters, cgen_fused_up_bound_s=0.05), trace=ranged))
    assert value == pytest.approx(25.0 if metric == "cgen.fused_up_roofline" else 100.0)


def _control_fails(seed, device, overrides, batch):
    _, entry = harness.cell_spec(harness.load_bench(), CELL)
    cfg = harness.load_config(harness.REPO / entry["file"], seed, overrides)
    w = weights.draw(cfg, seed, device)
    running = steps.calibrate(cfg, w, seed, device, batchsize=8)
    gen = streams.fold_in(streams.base_key(seed, device), 0)
    want = steps.sample_round(cfg, w, running, gen, batch).cpu().numpy()
    got = steps.sample_round(cfg, w, running, gen, batch, models.Arith("fp8")).cpu().numpy()
    return judge.video_gap(got, want) > _params()["limits"]["video_gap"]


@pytest.mark.parametrize("seed", SEEDS)
def test_video_control_is_not_correct(seed):
    assert _control_fails(seed, "cpu", {"ggen.ngf": 16, "cgen.ngf": 24}, 8)


@pytest.mark.gpu
def test_control_on_the_card_at_the_cell_size(card):
    assert _control_fails(2**32 + 5, card, {}, _params()["batchsize"])
