"""BENCHMARK.json against the harness's files: every cell, configuration,
traffic kind and per-layer metric is a file of its own, found by name, and
the core names none of them."""

import json
import re

import pytest

from portbench import harness

BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    wl, cfg = harness.cell_spec(BENCH, cell)
    workload = harness.load_file(harness.ROOT / "workloads" / f"{cell}.json")
    assert workload["why"] == wl["why"] and len(wl["why"]) <= 200
    traffic = harness.load_module(harness.ROOT / "traffic" / f"{workload['traffic']}.py")
    assert callable(traffic.measure)
    assert (harness.REPO / cfg["file"]).is_file()
    assert wl["chips"] == 1
    assert set(workload["params"]["limits"]) and all(v > 0 for v in workload["params"]["limits"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_and_more(cell):
    e2e = {m["name"] for m in harness.metrics_for(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e - {"setup_s"}) >= 1
    layers = harness.metrics_for(BENCH, cell, "per_layer")
    assert layers and all(m["moves"] in e2e for m in layers)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_reader(metric):
    reader = harness.load_module(harness.ROOT / "metrics" / f"{metric}.py")
    assert reader.read(harness.Readings()) is None  # nothing to read: nothing returned


def test_names_units_and_layers():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_provenance(entry):
    import yaml

    raw = yaml.safe_load((harness.REPO / entry["file"]).read_text())
    block = raw[harness.BENCH_KEY]
    assert block["source"] == entry["source"] and block["reduced"] == entry["reduced"]
    cfg = harness.load_config(harness.REPO / entry["file"], 5)
    assert cfg.seed == 5 and cfg.trainer.precision == "bfloat16"


def test_core_names_no_cell_config_or_metric():
    core = (harness.ROOT / "harness.py").read_text() + (harness.ROOT / "run.py").read_text()
    for n in CELLS + [c["name"] for c in BENCH["configs"]] + [m["name"] for m in BENCH["per_layer"]]:
        assert n not in core


def test_bench_json_is_small():
    assert len(json.dumps(BENCH)) < 64 * 1024
