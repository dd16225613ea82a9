"""The harness core: one run of one cell, found by name.

``BENCHMARK.json`` names the cell; ``portbench/workloads/<cell>.json`` holds
its traffic kind, the kind's parameters and the limits of its output check;
``portbench/traffic/<kind>.py`` drives the program for the window; each
per-layer metric is read by ``portbench/metrics/<metric>.py``. The core
names no cell, configuration, traffic kind or metric.

A run: refuse without the cards the cell asks for; load the configuration
through the program's ``load_config``; let the traffic build, warm up and
measure (``measure(ctx) -> Outcome``); read the peak memory; let the
traffic free the program's state; check that no JAX module was loaded; run
the output check; print the check's numbers beside their limits as the
last lines of standard error, and one JSON line as the last of standard
output.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import yaml

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
WORK = ROOT / "_work"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dcvgan_tpu")
BENCH_KEY = "benchmark"  # the configuration file's block of provenance


class HarnessError(RuntimeError):
    """A run that cannot give a result (exit code 1, nothing printed)."""


@dataclasses.dataclass
class Context:
    cell: str
    config: object  # the program's ExperimentConfig
    params: dict  # the workload file's traffic parameters
    seed: int
    seconds: float
    trace: bool
    device: str
    t_process: float
    work: Path


@dataclasses.dataclass
class Readings:
    """What per-layer readers read: host spans (seconds), counters, and the
    traced span's summary (``trace.summarize``) when traced."""

    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Optional[dict] = None


@dataclasses.dataclass
class Outcome:
    """A traffic's measurement. ``check`` runs after the window, once
    ``release`` has freed the program's state, and returns ``[(name, value,
    limit)]``; a value above its limit is not correct."""

    end_to_end: Dict[str, float]
    t_window: float  # host time of the first timed operation
    attempted: int
    failed: int
    readings: Readings
    check: Callable[[], List[Tuple[str, float, float]]]
    release: Callable[[], None]


def load_bench(root: Path = REPO) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_spec(bench: dict, cell: str) -> Tuple[dict, dict]:
    for w in bench["workloads"]:
        if w["name"] == cell:
            cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
            return w, cfg
    raise HarnessError(f"no cell {cell!r} in BENCHMARK.json")


def load_file(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A harness module by file path (names may hold dots and dashes)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_config(path: Path, seed: int, overrides: Optional[dict] = None):
    """The program's configuration from the frozen file: its provenance
    block dropped, run-time paths set, the seed given, then the program's
    own ``load_config``."""
    from dcvgan_torch.config import load_config as program_load_config

    raw = yaml.safe_load(Path(path).read_text())
    raw.pop(BENCH_KEY, None)
    raw["seed"] = int(seed)
    for key, value in (overrides or {}).items():
        node = raw
        *parents, last = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = value
    WORK.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile("w", suffix=".yml", dir=WORK, delete=False) as f:
        yaml.safe_dump(raw, f)
    try:
        return program_load_config(f.name)
    finally:
        os.unlink(f.name)


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def metrics_for(bench: dict, cell: str, kind: str) -> List[dict]:
    """The cell's ``end_to_end`` metrics, or its ``per_layer`` ones: those
    listing the cell, or listing no cells and moving a metric it reports."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in reported)]


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(WORK / "cache" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def run(cell: str, seed: int, seconds: float, trace: bool, t_process: float,
        device: Optional[str] = None, overrides: Optional[dict] = None,
        params: Optional[dict] = None, bench: Optional[dict] = None,
        workload: Optional[dict] = None) -> dict:
    """One run of ``cell``; returns the result record. ``device`` None means
    the card, which must be there. A test passes ``"cpu"`` and shrinks the
    run: ``overrides`` of configuration keys (dotted) and ``params`` of the
    workload's; ``bench`` and ``workload`` stand in for the files."""
    import torch

    bench = bench or load_bench()
    wl, cfg_entry = cell_spec(bench, cell)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
            raise HarnessError(f"{cell} needs {wl['chips']} CUDA device(s); "
                               f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
        torch.cuda.reset_peak_memory_stats()
    if trace and device == "cpu":
        raise HarnessError("--trace 1 needs the card")
    set_cache_dirs()
    workload = workload or load_file(ROOT / "workloads" / f"{cell}.json")
    config = load_config(REPO / cfg_entry["file"], seed, overrides)
    ctx = Context(cell, config, {**workload["params"], **(params or {})}, seed, seconds, trace,
                  device, t_process, WORK)
    traffic = load_module(ROOT / "traffic" / f"{workload['traffic']}.py")
    out: Outcome = traffic.measure(ctx)

    on_card = device != "cpu"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    out.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise HarnessError(f"the run loaded {', '.join(found)}")
    checks = out.check()
    correct = all(value <= limit for _, value, limit in checks) and out.failed == 0

    values = dict(out.end_to_end, setup_s=out.t_window - t_process, peak_mem_gb=peak / 1e9)
    metrics = {}
    if not trace:
        for m in metrics_for(bench, cell, "end_to_end"):
            if m["name"] not in values:
                raise HarnessError(f"{cell} does not report {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in metrics_for(bench, cell, "per_layer"):
            value = load_module(ROOT / "metrics" / f"{m['name']}.py").read(out.readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name() if on_card else "cpu",
                         "count": wl["chips"], "memory_peak_bytes": peak}}
    if trace:
        t = out.readings.trace or {}
        result["device"].update(busy_s=t.get("busy_s", 0.0), window_s=t.get("window_s", 0.0))
        result["breakdown"] = {"device_ops": t.get("device_ops", []),
                               "idle_gaps": t.get("idle_gaps", [])}
    # a number that is not finite (nothing to compare, a video not found)
    # is not correct and prints as null: JSON has no infinity
    result["checks"] = {name: {"value": value if math.isfinite(value) else None, "limit": limit}
                        for name, value, limit in checks}
    result["counters"] = dict(out.readings.counters)
    return result


def main(argv: Optional[List[str]] = None, t_process: Optional[float] = None) -> int:
    import argparse

    t_process = t_process or time.time()
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace), t_process)
    except HarnessError as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"info counters {json.dumps(result.pop('counters'))}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
