"""The cell ``surreal-segm.sample-b256`` and its traffic ``sample_segm`` on the
CPU at a tiny size (the look for a card skipped): a sound run is correct;
a segmentation input encoded as a 0/1 one-hot or with ties taken by the
last class is not, by ``cgen_gap``; at ngf 16 in bfloat16 the fp8 control
and those ties, and out-of-bounds taps given the nearest label, read over
``cgen_gap``'s limit and the program under it; the fp8 control is not
correct by ``video_gap`` either; and the traced chunks' ranges count one
``onehot_conv3x3`` and one ggen decode a sampling round (4 a chunk) and
nothing outside the span. On the card (``gpu``): the fp8 controls and the
faults of the one-hot input at the cell's own size."""

import time

import pytest
import torch
import torch.nn.functional as F

from portbench import harness, judge, weights
from portbench.reference import models, steps, streams

CELL = "surreal-segm.sample-b256"
SMALL = {"batchsize": 4, "rounds": 2, "sampled_chunks": [2, 4]}
SEEDS = (2**31 + 77, 5, 99)


def _params():
    return harness.load_file(harness.ROOT / "workloads" / f"{CELL}.json")["params"]


def _run(tiny, seed=2**31 + 99, seconds=2.0):
    return harness.run(CELL, seed, seconds, False, time.time(), device="cpu", overrides=tiny, params=SMALL)


def test_sound_run_is_correct(tiny):
    r = _run(tiny)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    e2e = {m["name"] for m in harness.metrics_for(harness.load_bench(), CELL, "end_to_end")}
    assert set(r["metrics"]) == e2e == {"sample_videos_per_s", "peak_mem_gb", "setup_s"}
    assert set(r["checks"]) == {"video_gap", "cgen_gap"}
    assert r["counters"]["onehot_calls"] == 0  # untraced: no range opened


def _zero_one_hot(p, w, slope=0.01):
    """The op with the one-hot left as 0/1 (the ``2 * x - 1`` dropped)."""
    x = F.one_hot(p.argmax(1), p.shape[1]).to(p.dtype).permute(0, 3, 1, 2)
    return F.leaky_relu(F.conv2d(x, w, padding=1), slope).contiguous(memory_format=torch.channels_last)


def _ties_last(p, w, slope=0.01):
    """The op with a tie taken by the last of the tied classes."""
    from dcvgan_torch.ops.onehot_conv import onehot_conv3x3

    flipped = p.flip(1).contiguous(memory_format=torch.channels_last)
    return onehot_conv3x3(flipped, w.flip(1).contiguous(), slope)


def _border_replicate(p, w, slope=0.01):
    """The op with each out-of-bounds tap given the label of the nearest
    pixel in the image, where it should be left out."""
    x = F.one_hot(p.argmax(1), p.shape[1]).permute(0, 3, 1, 2) * 2.0 - 1.0
    y = F.conv2d(F.pad(x.float(), (1, 1, 1, 1), mode="replicate"), w.float())
    return F.leaky_relu(y, slope).to(w.dtype).contiguous(memory_format=torch.channels_last)


def _faulty_run(tiny, monkeypatch, fault):
    import dcvgan_torch.models.cgen as cgen_mod

    monkeypatch.setattr(cgen_mod, "onehot_fused", lambda x, train: not train)
    monkeypatch.setattr(cgen_mod, "onehot_conv3x3", fault)
    return _run(tiny)


def test_a_zero_one_hot_input_is_not_correct(tiny, monkeypatch):
    r = _faulty_run(tiny, monkeypatch, _zero_one_hot)
    assert not r["correct"], r["checks"]
    assert r["checks"]["cgen_gap"]["value"] > r["checks"]["cgen_gap"]["limit"]


def test_ties_taken_by_the_last_class_are_not_correct(tiny, monkeypatch):
    r = _faulty_run(tiny, monkeypatch, _ties_last)
    assert not r["correct"], r["checks"]
    assert r["checks"]["cgen_gap"]["value"] > r["checks"]["cgen_gap"]["limit"]


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


def test_traced_chunks_count_one_call_of_each_a_round(tiny, monkeypatch):
    import dcvgan_torch.models.cgen as cgen_mod
    import dcvgan_torch.models.ggen as ggen_mod
    from portbench import trace as trace_mod

    # the CPU taken as the card: the eval decode and the one-hot op run their plain versions
    monkeypatch.setattr(trace_mod, "Span", _StubSpan)
    monkeypatch.setattr(cgen_mod, "onehot_fused", lambda x, train: not train)
    monkeypatch.setattr(ggen_mod, "decodes_fused", lambda x, train, norm: not train)
    bench = harness.load_bench()
    wl, entry = harness.cell_spec(bench, CELL)
    workload = harness.load_file(harness.ROOT / "workloads" / f"{CELL}.json")
    params = {**workload["params"], **SMALL}
    cfg = harness.load_config(harness.REPO / entry["file"], 7, tiny)
    ctx = harness.Context(CELL, cfg, params, 7, 1.0, True, "cpu", time.time(), harness.WORK)
    traffic = harness.load_module(harness.ROOT / "traffic" / f"{workload['traffic']}.py")
    calls = {"op": 0}
    op = cgen_mod.onehot_conv3x3

    def counted(*a, **k):
        calls["op"] += 1
        return op(*a, **k)

    monkeypatch.setattr(cgen_mod, "onehot_conv3x3", counted)
    out = traffic.measure(ctx)
    c = out.readings.counters
    assert c["traced_chunks"] == params["trace_chunks"] == 3
    assert c["onehot_calls"] == c["ggen_decode_calls"] == params["rounds"] * c["traced_chunks"]
    assert calls["op"] > c["onehot_calls"]  # the calls outside the span ran, unranged and uncounted
    n, ch = params["batchsize"] * cfg.video_length, cfg.geometric_info.channel
    want = c["onehot_calls"] * traffic.onehot_bound(n, ch, 64, 64, cfg.cgen.ngf, torch.float32)[0]
    assert c["onehot_bound_s"] == pytest.approx(want)
    assert cgen_mod.onehot_conv3x3 is counted  # the traffic's wrapper is gone after the run
    out.release()


def test_onehot_bound_at_the_serving_shape():
    from portbench.traffic import sample_segm

    bound_s, flops, nbytes = sample_segm.onehot_bound(4096, 25, 64, 64, 64)
    assert nbytes == 4096 * 64 * 64 * (25 + 64) * 2 + 9 * 25 * 64 * 4
    assert bound_s == pytest.approx(nbytes / 3.35e12) and bound_s == pytest.approx(0.892e-3, rel=1e-3)
    assert flops / 67e12 < bound_s  # bytes bound it


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
    assert _control_fails(seed, "cpu", {"ggen.ngf": 16, "cgen.ngf": 16}, 8)


@pytest.mark.gpu
def test_control_on_the_card_at_the_cell_size(card):
    assert _control_fails(2**32 + 5, card, {}, _params()["batchsize"])


def _cgen_readings(seed, device, overrides, batch, faults=()):
    """``cgen_gap`` of the program's colour generator as the cell serves it,
    of the fp8 control and of the program with each fault put in place of
    ``onehot_conv3x3``."""
    import dcvgan_torch.models.cgen as cgen_mod
    from dcvgan_torch.train.step import DCVGAN
    from portbench.traffic.sample_segm import cgen_gap

    _, entry = harness.cell_spec(harness.load_bench(), CELL)
    cfg = harness.load_config(harness.REPO / entry["file"], seed, overrides)
    w = weights.draw(cfg, seed, device)
    running = steps.calibrate(cfg, w, seed, device, batchsize=8)
    gan = DCVGAN(cfg, device=device)
    state = gan.init_state(seed)
    for m in ("ggen", "cgen"):
        weights.load_into(getattr(state, m), w[m], m)
        weights.load_running(getattr(state, m), running[m])
    cgen = state.generators().cgen
    out = {"program": cgen_gap(cfg, w, running, cgen, seed, batch, device),
           "fp8": cgen_gap(cfg, w, running, None, seed, batch, device, models.Arith("fp8"))}
    op = cgen_mod.onehot_conv3x3
    for fault in faults:
        cgen_mod.onehot_conv3x3 = fault
        try:
            out[fault.__name__] = cgen_gap(cfg, w, running, cgen, seed, batch, device)
        finally:
            cgen_mod.onehot_conv3x3 = op
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_cgen_control_and_faults_are_not_correct(seed, monkeypatch):
    import dcvgan_torch.models.cgen as cgen_mod

    # bfloat16 at ngf 16 (the tiny run's ngf 8 in float32 leaves the border fault at the limit)
    monkeypatch.setattr(cgen_mod, "onehot_fused", lambda x, train: x.dtype == torch.bfloat16 and not train)
    r = _cgen_readings(seed, "cpu", {"ggen.ngf": 16, "cgen.ngf": 16}, 4, (_ties_last, _border_replicate))
    limit = _params()["limits"]["cgen_gap"]
    assert r["program"] <= limit < min(r["fp8"], r["_ties_last"], r["_border_replicate"]), r


@pytest.mark.gpu
def test_cgen_control_and_faults_on_the_card_at_the_cell_size(card):
    r = _cgen_readings(2**32 + 7, card, {}, _params()["batchsize"], (_ties_last, _border_replicate))
    limit = _params()["limits"]["cgen_gap"]
    assert r["program"] <= limit < min(r["fp8"], r["_ties_last"], r["_border_replicate"]), r
