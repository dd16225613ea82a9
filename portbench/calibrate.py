"""The readings a cell's output-check limits are set from (not run by the
benchmark's runs)::

    python3 -m portbench.calibrate --workload <cell> --seeds <n> [--first-seed S]
        [--control-seeds 3] [--seconds 2] [--out cal.json]

In one process, on the card at the cell's own size:

- the program: ``n`` runs of the cell (``--seconds`` windows), each check's
  numbers (the lower readings: the largest over the seeds);
- the control: the reference put in the program's place in fp8 (e4m3
  operands, e5m2 gradients; the step below the configuration's bfloat16);
- each fault the cell can have, planted in the reference put in the
  program's place: a train step on half its batch (train); one video of a
  round altered where it is produced, and half a round's videos left out
  and the other half repeated (sample). A state left unchanged reads 1 by
  the training check's measure and needs no run.

Prints one JSON line per reading and writes all of them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from portbench import data, harness, judge, weights
from portbench.reference import models, steps, streams


def program_readings(cell: str, seeds, seconds: float) -> list:
    out = []
    for seed in seeds:
        r = harness.run(cell, seed, seconds, False, time.time())
        out.append({"seed": seed, "correct": r["correct"],
                    "checks": {k: v["value"] for k, v in r["checks"].items()},
                    "numbers": r["counters"].get("numbers"), "detail": r["counters"].get("detail"),
                    "metrics": {k: v["value"] for k, v in r["metrics"].items()}})
        print(json.dumps({"program": out[-1]}), flush=True)
    return out


def train_controls(cell: str, seeds) -> list:
    bench = harness.load_bench()
    _, cfg_entry = harness.cell_spec(bench, cell)
    train = harness.load_module(harness.ROOT / "traffic" / "train.py")
    out = []
    for seed in seeds:
        cfg = harness.load_config(harness.REPO / cfg_entry["file"], seed)
        tree = Path(data.tree(Path(cfg.dataset.processed_root), image_size=cfg.image_size)["path"])
        w = weights.draw(cfg, seed, "cuda")
        batches = [steps.read_batch(tree, cfg, seed, 0, i, "cuda") for i in range(train.CHECKED_STEPS)]
        ref = steps.train_steps(cfg, w, batches, seed, "cuda")
        row = {"seed": seed}
        for name, kw in (("control_fp8", {"arith": models.Arith("fp8")}),
                         ("fault_half_batch", {"half_batch": True}),
                         ("bf16_reference", {"arith": models.Arith("bf16")})):
            o = steps.train_steps(cfg, w, batches, seed, "cuda", **kw)
            cpu = {m: {k: v.cpu() for k, v in d.items()} for m, d in o["params"].items()}
            grads = {m: {k: v.cpu() for k, v in d.items()} for m, d in o["grads1"].items()}
            row[name] = judge.train_gaps(o["losses"], grads, cpu, ref, w)
            row[name]["detail"] = judge.train_gap_detail(o["losses"], grads, cpu, ref, w)
        out.append(row)
        print(json.dumps({"control": row}), flush=True)
    return out


def sample_controls(cell: str, seeds) -> list:
    bench = harness.load_bench()
    _, cfg_entry = harness.cell_spec(bench, cell)
    p = harness.load_file(harness.ROOT / "workloads" / f"{cell}.json")["params"]
    out = []
    for seed in seeds:
        cfg = harness.load_config(harness.REPO / cfg_entry["file"], seed)
        w = weights.draw(cfg, seed, "cuda")
        running = steps.calibrate(cfg, w, seed, "cuda")
        gen = streams.fold_in(streams.fold_in(streams.base_key(seed, "cuda"), 0), 0)
        want = steps.sample_round(cfg, w, running, gen, p["batchsize"]).cpu().numpy()
        fp8 = steps.sample_round(cfg, w, running, gen, p["batchsize"], models.Arith("fp8")).cpu().numpy()
        bf16 = steps.sample_round(cfg, w, running, gen, p["batchsize"], models.Arith("bf16")).cpu().numpy()
        altered = want.copy()
        altered[int(np.random.default_rng(seed).integers(0, len(want)))] += np.uint8(64)
        half = want.copy()
        half[len(half) // 2:] = half[: len(half) - len(half) // 2]
        row = {"seed": seed, "control_fp8": {"video_gap": judge.video_gap(fp8, want)},
               "fault_altered_video": {"video_gap": judge.video_gap(altered, want)},
               "fault_half_batch": {"video_gap": judge.video_gap(half, want)},
               "bf16_reference": {"video_gap": judge.video_gap(bf16, want)}}
        out.append(row)
        print(json.dumps({"control": row}), flush=True)
    return out


CONTROLS = {"train": train_controls, "sample": sample_controls, "closed_http": sample_controls}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=4_000_000_000)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    kind = harness.load_file(harness.ROOT / "workloads" / f"{args.workload}.json")["traffic"]
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    record = {"cell": args.workload, "card": torch.cuda.get_device_name(),
              "program": program_readings(args.workload, seeds, args.seconds)}
    if kind in CONTROLS:
        record["controls"] = CONTROLS[kind](args.workload, seeds[: args.control_seeds])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
