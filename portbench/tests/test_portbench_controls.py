"""The output check's controls: the reference put in the program's place
in fp8 (e4m3 operands and generated videos with a per-tensor scale, e5m2
gradients; the step below the configuration's bfloat16) comes out as not
correct under each cell's limits. On the CPU at ngf 8 (a size a test run
holds); on the card at the cell's own size (``gpu``)."""

import pytest

from portbench import harness, judge, weights
from portbench.reference import models, steps, streams

BENCH = harness.load_bench()
KINDS = {w["name"]: harness.load_file(harness.ROOT / "workloads" / f"{w['name']}.json")
         for w in BENCH["workloads"]}
VIDEOS = [c for c, w in KINDS.items() if w["traffic"] in ("sample", "closed_http")]
SEEDS = (2**31 + 77, 5, 99)


def _config(cell, seed, overrides):
    _, entry = harness.cell_spec(BENCH, cell)
    return harness.load_config(harness.REPO / entry["file"], seed, overrides)


def _video_control_fails(cell, seed, device, overrides, batch):
    cfg = _config(cell, seed, overrides)
    w = weights.draw(cfg, seed, device)
    running = steps.calibrate(cfg, w, seed, device, batchsize=8)
    gen = streams.fold_in(streams.base_key(seed, device), 0)
    want = steps.sample_round(cfg, w, running, gen, batch).cpu().numpy()
    got = steps.sample_round(cfg, w, running, gen, batch, models.Arith("fp8")).cpu().numpy()
    return judge.video_gap(got, want) > KINDS[cell]["params"]["limits"]["video_gap"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", VIDEOS)
def test_video_control_is_not_correct(cell, seed):
    assert _video_control_fails(cell, seed, "cpu", {"ggen.ngf": 16, "cgen.ngf": 16}, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", VIDEOS)
def test_control_on_the_card_at_the_cell_size(cell, card):
    assert _video_control_fails(cell, 2**32 + 5, card, {}, KINDS[cell]["params"]["batchsize"])
