"""The port's trainer, evaluator and server over data-parallel ranks on the
CPU: gloo ranks (``tests/torch_dist_util.py``) for training and
evaluation, CPU replicas for serving.

- ``cli.train`` on 2 ranks (global batch 4 of the synthetic dataset, ngf 8,
  f32, 4 steps): only rank 0 writes the run directory, both ranks end
  equal, the losses are one rank's at the global batch, a checkpoint
  restores rank 0's state, and a run resumed from its step-2 checkpoint
  reaches the uninterrupted run's state bit for bit;
- the evaluation split over 2 ranks against one rank;
- ``GenerationServer`` with two CPU replicas against one device, and
  ``cli.serve --mesh 2 --device cpu`` against ``--mesh 1``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from dcvgan_torch.cli import serve as port_serve
from dcvgan_torch.config import ExperimentConfig
from dcvgan_torch.data.preprocess import get_preprocessor
from dcvgan_torch.train.checkpoint import CheckpointManager
from dcvgan_torch.train.step import DCVGAN
from torch_dist_util import run_ranks
from torch_port_util import LOSSES, MODEL_NAMES, replicas_equal, within
from torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

REPO = Path(__file__).resolve().parents[1]
DEBUG = REPO / "configs" / "debug-mock-depth.yml"
WEIGHTS = REPO / "assets" / "extractor-synthetic.npz"
STEPS = 4  # 2 epochs of 2 global batches of 4 (8 videos)
# one rank with the same global-batch BatchNorm arithmetic: the first
# step's losses agree to rounding (tests/test_torch_data_parallel.py), later
# ones within Adam's +-lr flips of gradients of rounding noise
LOSS_ATOL = 1e-4


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    get_preprocessor("synthetic")(root / "raw", root / "synthetic" / "train", "train", 16, 64, -1)
    return root


def _config(path: Path, data_root: Path, run_root: Path, n_epochs: int) -> Path:
    raw = yaml.safe_load(DEBUG.read_text())
    raw.update(batchsize=4, n_epochs=n_epochs, log_dir=str(run_root / "result"),
               tensorboard_dir=str(run_root / "runs"), snapshot_interval=2,
               log_samples_interval=1000)
    raw["dataset"] = {"name": "synthetic", "path": "unused", "n_workers": 1, "number_limit": 8,
                      "processed_root": str(data_root)}
    path.write_text(yaml.safe_dump(raw))
    return path


def _train(tmp: Path, data_root: Path, world: int, n_epochs: int = 2, run_root=None, **over):
    run_root = run_root or tmp / "run"
    cwds = [tmp / f"cwd{r}" for r in range(world)]
    for c in cwds:
        c.mkdir(parents=True, exist_ok=True)
    cfg = _config(tmp / f"cfg{n_epochs}.yml", data_root, run_root, n_epochs)
    payload = {"cwd": [str(c) for c in cwds],
               "argv": ["--config", str(cfg), "--device", "cpu", "--dist-backend", "gloo"], **over}
    results = run_ranks("train_cli", world, payload, tmp / f"ranks{n_epochs}")
    return results, run_root / "result" / "debug-mock-depth", cwds


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, data_root):
    tmp = tmp_path_factory.mktemp("two")
    return _train(tmp, data_root, 2)


def _states(results):
    return [[{"metrics": {}, "grads": {n: {} for n in MODEL_NAMES}, **r["state"]}] for r in results]


def test_two_ranks_train_like_one_rank_and_only_rank_0_writes(tmp_path, data_root, two_ranks):
    results, run_dir, cwds = two_ranks
    assert [r["world"] for r in results] == [2, 2]
    replicas_equal(_states(results))
    assert results[0]["metrics"] == results[1]["metrics"] and len(results[0]["metrics"]) == STEPS
    # rank 0 alone wrote the run directory: one log, one table, two checkpoints
    assert all(not any(c.iterdir()) for c in cwds)
    assert sorted(p.name for p in run_dir.iterdir()) == ["config.yml", "log", "models"]
    assert sorted(p.name for p in (run_dir / "models").iterdir()) == ["step_2.pt", "step_4.pt"]
    log = (run_dir / "log").read_text()
    assert log.count("(start training)") == 1 and log.count("ranks: 2 (dcn 1 x data 2)") == 1
    # the checkpoint holds rank 0's final state
    gan = DCVGAN(ExperimentConfig.from_dict(yaml.safe_load((run_dir / "config.yml").read_text())),
                 device="cpu")
    restored = CheckpointManager(run_dir / "models").restore(gan.init_state(0))
    for name in MODEL_NAMES:
        for k, v in restored.models[name].state_dict().items():
            assert torch.equal(v, results[0]["state"]["models"][name][k]), (name, k)
    # the losses of one process at the global batch
    one, _, _ = _train(tmp_path, data_root, 1, global_batch_norm=True)
    for got, want in zip(results[0]["metrics"], one[0]["metrics"]):
        for k in LOSSES:
            within(got[k], want[k], LOSS_ATOL)


def test_two_ranks_resume_every_rank_from_rank_0s_checkpoint(tmp_path, data_root, two_ranks):
    first, run_dir, _ = _train(tmp_path, data_root, 2, n_epochs=1)
    assert len(first[0]["metrics"]) == 2
    second, _, _ = _train(tmp_path, data_root, 2, n_epochs=2)
    assert len(second[0]["metrics"]) == 2
    log = (run_dir / "log").read_text()
    assert log.count("resumed from checkpoint at step 2") == 1
    want = two_ranks[0]
    assert second[0]["metrics"] == want[0]["metrics"][2:]
    replicas_equal(_states(second) + _states(want))


def test_evaluation_over_two_ranks_scores_what_one_rank_scores(tmp_path, data_root):
    raw = yaml.safe_load(DEBUG.read_text())
    payload = {"config": raw, "data": str(data_root), "num": 10, "batch": 4, "weights": str(WEIGHTS)}
    two = run_ranks("evaluate", 2, payload, tmp_path / "two")
    one = run_ranks("evaluate", 1, payload, tmp_path / "one")[0]
    assert two[1]["feats"] is None and two[0]["feats"].shape == one["feats"].shape == (10, 128)
    within(two[0]["feats"], one["feats"], 1e-5, 1e-4)
    for r in two:  # every rank returns rank 0's scores
        assert r["scores"].keys() == one["scores"].keys() == {"is", "fid"}
        for k, v in one["scores"].items():
            within(r["scores"][k], v, 1e-5, 1e-4)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_server_with_two_cpu_replicas_serves_one_devices_bytes(precision):
    """Each replica samples its rows of the round's latents; on the CPU the
    bytes equal one device's exactly (f32 and bf16)."""
    raw = yaml.safe_load(DEBUG.read_text())
    raw["trainer"]["precision"] = precision
    gan = DCVGAN(ExperimentConfig.from_dict(raw), device="cpu")
    state = gan.init_state(3).generators()
    one = port_serve.GenerationServer(gan, state, batchsize=4, iters_per_chunk=2)
    two = port_serve.GenerationServer(gan, state, batchsize=4, iters_per_chunk=2,
                                      mesh=["cpu", "cpu"])
    try:
        for seed in (0, 5):
            for got, want in zip(two.generate(20, seed, with_geo=True),
                                 one.generate(20, seed, with_geo=True)):
                assert got.dtype == np.uint8 and got.shape == want.shape
                np.testing.assert_array_equal(got, want)
        assert two.info()["n_chips"] == 1 and len(two.state) == 2
    finally:
        one.close()
        two.close()
    with pytest.raises(ValueError, match="replicas"):
        port_serve.GenerationServer(gan, state, batchsize=3, mesh=["cpu", "cpu"])


def test_cli_serve_mesh_2_on_the_cpu_writes_the_bytes_of_mesh_1(tmp_path, two_ranks):
    _, run_dir, _ = two_ranks
    out = {}
    for n in (1, 2):
        stats = port_serve.main([str(run_dir), "-1", "--device", "cpu", "--mesh", str(n),
                                 "-b", "4", "--iters-per-chunk", "2", "--chunks", "2",
                                 "--sink", "npy", "--with-geo", "--out", str(tmp_path / str(n))])
        assert stats["replicas"] == n and stats["videos"] == 16
        out[n] = {p.name: np.load(p) for p in sorted((tmp_path / str(n)).glob("*.npy"))}
    assert out[1].keys() == out[2].keys() and len(out[1]) == 4
    for name, want in out[1].items():
        np.testing.assert_array_equal(out[2][name], want)
