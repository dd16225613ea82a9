"""The head-to-head protocol of the port (``dcvgan_torch.tools.headtohead``)
against the repository's JAX tools, on the same mp4 directories.

- ``score_dirs`` against ``tools/headtohead_score.score_dirs`` and
  ``score_trajectory`` against ``tools/score_iters.score_trajectory``, on
  the committed ``results/headtohead/tpurun_samples_seed3`` (128 mp4 files
  of the JAX package's seed-3 run at iteration 1600) and a real set the
  port's synthetic preprocessor writes: ``is``, ``fid``, ``prd`` and
  ``prd_f1_8`` within 1e-4 relative (the trajectory's rows are rounded to 4
  decimals on both sides, so a row may also differ by one unit of the last
  place), under one extractor fingerprint;
- ``main`` on a 2-step ngf-8 run on the CPU: ``sample_run`` writes one
  ``iter_*`` directory a snapshot, of n mp4 files that read back as
  (16, 64, 64, 3) uint8, and ``scores.json`` holds a finite row each;
- the 16-frame crop refuses a shorter clip, as the JAX tool's does.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import yaml

from dcvgan_torch.data.preprocess import get_preprocessor
from dcvgan_torch.io.video import read_video, write_video
from dcvgan_torch.tools import headtohead
from torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")
REPO = Path(__file__).resolve().parents[1]
SAMPLES = REPO / "results" / "headtohead" / "tpurun_samples_seed3"
METRICS = ["is", "fid", "prd"]
SCORES = ("is", "fid", "prd", "prd_f1_8")
RTOL = 1e-4


@pytest.fixture(scope="module")
def real_dir(tmp_path_factory):
    train = tmp_path_factory.mktemp("data") / "synthetic" / "train"
    get_preprocessor("synthetic")(Path("unused"), train, "train", 16, 64, 1)
    return headtohead.real_set(train)


def test_the_real_set_has_one_mp4_a_listed_video(real_dir):
    files = sorted(real_dir.glob("*.mp4"))
    assert len(files) == 64
    assert read_video(files[0]).shape == (24, 64, 64, 3)
    assert headtohead.real_set(real_dir.parent) == real_dir  # written once


def test_score_dirs_matches_the_jax_tool(real_dir):
    from tools import headtohead_score

    gen = SAMPLES / "iter_001600"
    want = headtohead_score.score_dirs(gen, real_dir, METRICS)
    got = headtohead.score_dirs(gen, real_dir, METRICS, device="cpu")
    assert set(got) == set(want) == set(SCORES)
    for k in SCORES:
        assert abs(got[k] - want[k]) <= RTOL * abs(want[k]), (k, got[k], want[k])
    assert 0 <= got["prd"] <= 1 and 0 <= got["prd_f1_8"] <= 1
    assert headtohead.get_extractor(device="cpu").fingerprint == headtohead_score.get_extractor().fingerprint


def test_score_trajectory_matches_the_jax_tool(real_dir):
    from tools import score_iters

    want = score_iters.score_trajectory(SAMPLES, real_dir, METRICS)
    got = headtohead.score_trajectory(SAMPLES, real_dir, METRICS, device="cpu")
    assert [r["iteration"] for r in got] == [r["iteration"] for r in want] == [1600]
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"iteration", *SCORES}
        for k in SCORES:
            assert abs(g[k] - w[k]) <= RTOL * abs(w[k]) + 1e-4, (k, g[k], w[k])


def test_read_clips_refuses_a_clip_shorter_than_16_frames(tmp_path):
    write_video(np.zeros((10, 64, 64, 3), np.uint8), tmp_path / "short.mp4")
    with pytest.raises(ValueError, match="only 10 frames"):
        headtohead.read_clips([tmp_path / "short.mp4"])


# ------------------------------------------------------ a run through main
N, BATCH = 3, 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``main`` on ``configs/headtohead-tpu.yml`` at ngf/ndf 8 in f32, 8
    videos in batches of 4 (2 steps), a snapshot and an evaluation each
    step."""
    root = tmp_path_factory.mktemp("h2h")
    raw = yaml.safe_load((REPO / "configs" / "headtohead-tpu.yml").read_text())
    for name in ("ggen", "cgen"):
        raw[name]["ngf"] = 8
    for name in ("idis", "vdis", "gdis"):
        raw[name]["ndf"] = 8
    raw.update(batchsize=4, n_epochs=1, snapshot_interval=1, evaluation_interval=1, log_interval=1,
               trainer={"precision": "float32"})
    raw["dataset"].update(number_limit=8, n_workers=0)
    raw["evaluation"].update(num_samples=4, batchsize=2)
    config = root / "tiny.yml"
    config.write_text(yaml.safe_dump(raw))
    out = root / "out"
    summary = headtohead.main(["--config", str(config), "--out", str(out), "--n", str(N),
                               "--batch", str(BATCH), "--ref-limit", "16", "--device", "cpu"])
    return out, summary


def test_sample_run_writes_n_videos_for_each_snapshot(run):
    out, summary = run
    dirs = sorted((out / "samples").iterdir())
    assert [d.name for d in dirs] == ["iter_000001", "iter_000002"] and summary["steps"] == 2
    for d in dirs:
        files = sorted(d.glob("*.mp4"))
        assert [f.name for f in files] == [f"{i:06d}.mp4" for i in range(N)]
        for f in files:
            v = read_video(f)
            assert v.shape == (16, 64, 64, 3) and v.dtype == np.uint8


def test_sample_run_resamples_nothing_and_refuses_an_absent_ema(run):
    out, _ = run
    run_dir = out / "work" / "result" / "headtohead" / "headtohead-tpu"
    before = {f: f.stat().st_mtime_ns for f in (out / "samples").rglob("*.mp4")}
    assert headtohead.sample_run(run_dir, out / "samples", N, BATCH, device="cpu") == [1, 2]
    assert before == {f: f.stat().st_mtime_ns for f in (out / "samples").rglob("*.mp4")}
    with pytest.raises(ValueError, match="carries no EMA"):
        headtohead.sample_run(run_dir, out / "ema", N, BATCH, ema=True, device="cpu")


def test_main_scores_every_snapshot_and_writes_its_records(run):
    out, summary = run
    rows = json.loads((out / "scores.json").read_text())
    assert rows == summary["rows"] and [r["iteration"] for r in rows] == [1, 2]
    for r in rows:
        assert set(r) == {"iteration", *SCORES} and all(np.isfinite(r[k]) for k in SCORES)
        assert 0 <= r["prd"] <= 1 and 0 <= r["prd_f1_8"] <= 1
    assert summary["losses_finite"] and set(summary["seconds"]) == {"train", "sample", "score"}
    assert summary["extractor"] == headtohead.get_extractor(device="cpu").fingerprint
    assert len(summary["in_training_eval"]["fid"]) == 3  # step 0 and each step
    recorded = json.loads((out / "summary.json").read_text())
    assert len(recorded["losses"]["loss_gen"]) == 2
