"""The port's trainer, checkpoints and training CLI on the CPU.

``configs/debug-mock-depth.yml`` (the self-generating mock dataset, ngf 8,
f32) runs through ``dcvgan_torch.cli.train`` with ``--device cpu`` in a
temporary directory.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from dcvgan_torch.cli import train as cli_train
from dcvgan_torch.config import load_config
from dcvgan_torch.logging.logger import Logger
from dcvgan_torch.train.checkpoint import CheckpointManager
from dcvgan_torch.train.step import DCVGAN
from dcvgan_torch.train.trainer import LOSS_NAMES, Trainer

REPO = Path(__file__).resolve().parents[1]
DEBUG = REPO / "configs" / "debug-mock-depth.yml"


def _config(tmp_path, name="cfg.yml", **over):
    raw = yaml.safe_load(DEBUG.read_text())
    for k, v in over.items():
        raw[k] = {**raw.get(k, {}), **v} if isinstance(v, dict) else v
    path = tmp_path / name
    path.write_text(yaml.safe_dump(raw))
    return path


def _log(run_dir: Path) -> str:
    return (run_dir / "log").read_text()


def _rows(log: str):
    """The table rows of a log as lists of floats (epoch, iteration, losses...)."""
    rows = []
    for line in log.splitlines():
        cells = line.split("]", 1)[-1].split()
        if len(cells) >= 6 and cells[0].isdigit() and cells[1].isdigit():
            rows.append([float(c) for c in cells[:6]])
    return rows


def _states_equal(a, b) -> None:
    assert a.step == b.step
    for name in a.models:
        sa, sb = a.models[name].state_dict(), b.models[name].state_dict()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (name, k)
        oa, ob = a.opt[name].state_dict()["state"], b.opt[name].state_dict()["state"]
        assert oa.keys() == ob.keys()
        for i in oa:
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(oa[i][k], ob[i][k]), (name, i, k)
    assert (a.ema is None) == (b.ema is None)
    if a.ema is not None:
        for name in a.ema:
            for k in a.ema[name]:
                assert torch.equal(a.ema[name][k], b.ema[name][k]), (name, k)


def test_cli_trains_logs_a_row_and_writes_a_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = cli_train.main(["--config", str(DEBUG), "--device", "cpu"])
    run_dir = tmp_path / "result" / "mock" / "debug-mock-depth"
    log = _log(run_dir)
    assert "(start training)" in log and "device: cpu" in log
    rows = _rows(log)
    assert len(rows) == 1 and rows[0][:2] == [1.0, 1.0]
    assert all(np.isfinite(v) and v > 0 for v in rows[0][2:])
    # fresh critics sit near 2 ln 2, the generator loss near 2
    assert all(abs(v - 2 * np.log(2)) < 0.2 for v in rows[0][3:6]) and 1.5 < rows[0][2] < 2.6
    assert (run_dir / "models" / "step_1.pt").exists() and (run_dir / "config.yml").exists()
    assert trainer.state.step == 1 and trainer.ckpt.latest_step() == 1
    assert load_config(run_dir / "config.yml").ggen.ngf == 8
    assert (tmp_path / "data" / "processed" / "mock" / "train" / "list.txt").exists()


def test_cli_says_that_evaluation_is_not_ported(tmp_path, monkeypatch):
    # evaluation is ported: the CLI no longer says it skips the metrics, it
    # scores them at step 0 and logs the extractor's fingerprint once
    monkeypatch.chdir(tmp_path)
    cfg = _config(tmp_path, evaluation={"metrics": ["is", "fid"], "num_samples": 2,
                                        "extractor_weights": "assets/extractor-synthetic.npz"},
                  experiment_name="with-eval")
    trainer = cli_train.main(["--config", str(cfg), "--device", "cpu"])
    log = _log(tmp_path / "result" / "mock" / "with-eval")
    assert "not ported" not in log and "skipping metrics" not in log
    assert log.count("eval extractor: small-npz/sha256=") == 1
    header = next(line for line in log.splitlines() if "loss_gen" in line)
    assert "is" in header.split() and "fid" in header.split()
    assert trainer.evaluator is not None and trainer.evaluator.metrics == ["is", "fid"]
    assert trainer.evaluate(1) is None
    assert np.isfinite(trainer.logger.metrics["fid"].value)


def test_cli_raises_without_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.main(["--config", str(DEBUG)])


class _StopAfter(Logger):
    """Sets the trainer's stop flag once ``iteration`` has been logged."""

    def __init__(self, *args, stop_at=None):
        super().__init__(*args)
        self.stop_at, self.trainer = stop_at, None

    def update(self, name, value):
        super().update(name, value)
        if name == "iteration" and value == self.stop_at:
            self.trainer._stop.set()


def _trainer(tmp_path, tag, stop_at=None, **over):
    """Batch 1 over the mock dataset's three videos: three steps an epoch."""
    cfg = load_config(_config(tmp_path, f"{tag}.yml", batchsize=1, n_epochs=2,
                              snapshot_interval=100, log_samples_interval=100, **over))
    cfg.log_dir, cfg.tensorboard_dir = str(tmp_path / tag), str(tmp_path / tag / "runs")
    cfg.dataset.processed_root = str(tmp_path / "processed")
    run_dir = Path(cfg.log_dir) / cfg.experiment_name
    logger = _StopAfter(run_dir, None, stop_at=stop_at)
    trainer = Trainer(cfg, cli_train.build_dataset(cfg), logger=logger, device="cpu")
    logger.trainer = trainer
    return trainer, run_dir


@pytest.mark.parametrize("ema", [0.0, 0.9], ids=["plain", "ema"])
def test_mid_epoch_resume_reaches_the_uninterrupted_runs_state(tmp_path, ema):
    over = {"trainer": {"ema_decay": ema}}
    whole, _ = _trainer(tmp_path, "whole", **over)
    want = whole.train()
    assert want.step == 6

    first, run_dir = _trainer(tmp_path, "resumed", stop_at=2, **over)
    stopped = first.train()  # leaves through the forced checkpoint, mid-epoch
    assert stopped.step == 2 and first.ckpt.all_steps() == [2]
    assert "interrupted (preemption/SIGTERM) at iteration 2" in _log(run_dir)

    second, _ = _trainer(tmp_path, "resumed", **over)
    assert "resumed from checkpoint at step 2" in _log(run_dir)
    assert second.state.step == 2 and second.epoch == 0 and second._resume_skip == 2
    got = second.train()
    _states_equal(got, want)
    assert second.ckpt.all_steps() == [2, 6]
    rows = _rows(_log(run_dir))
    assert [r[1] for r in rows] == [1, 2, 3, 4, 5, 6]


def test_checkpoint_is_idempotent_atomic_and_handles_ema_transitions(tmp_path, caplog):
    cfg = load_config(DEBUG)
    cfg.trainer.ema_decay = 0.9
    gan = DCVGAN(cfg, device="cpu")
    state = gan.init_state(0)
    state.step = 3
    mgr = CheckpointManager(tmp_path / "models")
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(gan.init_state(1))
    mgr.save(state)
    stamp = (tmp_path / "models" / "step_3.pt").stat().st_mtime_ns
    mgr.save(state, force=True)  # the same step again: left as it is
    assert (tmp_path / "models" / "step_3.pt").stat().st_mtime_ns == stamp
    assert [p.name for p in (tmp_path / "models").iterdir()] == ["step_3.pt"]  # no temp file left
    mgr.wait()
    _states_equal(mgr.restore(gan.init_state(1)), state)
    with pytest.raises(FileNotFoundError, match="available steps"):
        mgr.restore(gan.init_state(1), step=9)

    # the file has an EMA, the config has none: dropped with a warning
    plain = DCVGAN(load_config(DEBUG), device="cpu")  # ema_decay 0
    with caplog.at_level("WARNING"):
        restored = mgr.restore(plain.init_state(1))
    assert restored.ema is None and "dropping the stored average" in caplog.text
    # the file has none, the config has one: seeded at the restored generators
    restored.step = 4
    mgr.save(restored)
    seeded = mgr.restore(gan.init_state(2))
    assert seeded.step == 4
    for name in ("ggen", "cgen"):
        for k, p in getattr(seeded, name).named_parameters():
            assert torch.equal(seeded.ema[name][k], p)


def test_sigterm_leaves_a_checkpoint(tmp_path):
    cfg = _config(tmp_path, batchsize=1, n_epochs=10000, snapshot_interval=10**6,
                  log_samples_interval=10**6, experiment_name="sigterm")
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dcvgan_torch.cli.train", "--config", str(cfg), "--device", "cpu"],
        cwd=tmp_path, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    log = tmp_path / "result" / "mock" / "sigterm" / "log"
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline and proc.poll() is None:
            if log.exists() and len(_rows(log.read_text())) >= 2:
                break
            time.sleep(0.2)
        assert proc.poll() is None, "the trainer ended before it was signalled"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    text = log.read_text()
    assert "interrupted (preemption/SIGTERM) at iteration" in text
    steps = CheckpointManager(tmp_path / "result" / "mock" / "sigterm" / "models").all_steps()
    assert len(steps) == 1 and steps[0] >= 2
    assert steps[0] == int(_rows(text)[-1][1]) or steps[0] == int(_rows(text)[-1][1]) + 1
