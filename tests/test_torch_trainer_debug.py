"""The port trainer's ``trainer.profile`` and ``trainer.debug_nans`` on the CPU.

``profile`` traces the training loop into ``<run_dir>/profile`` (the JAX
trainer's ``jax.profiler`` trace); ``debug_nans`` raises
``FloatingPointError`` at the first step whose losses or gradients are not
finite, held here against the JAX trainer (``jax_debug_nans``) on one
imported state: a NaN in one image-critic weight makes both raise with the
key on, and both finish the step with NaN losses with it off.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from dcvgan_torch.cli import train as cli_train
from dcvgan_torch.compat.from_jax import load_gan_state_
from dcvgan_torch.config import ExperimentConfig as PortConfig
from dcvgan_torch.config import load_config
from dcvgan_torch.logging.logger import Logger as PortLogger
from dcvgan_torch.train.trainer import Trainer as PortTrainer
from dcvgan_tpu.config import ExperimentConfig as JaxConfig
from dcvgan_tpu.data.dataset import VideoDataset as JaxDataset
from dcvgan_tpu.data.mock import generate_mock_dataset
from dcvgan_tpu.logging.logger import Logger as JaxLogger
from dcvgan_tpu.parallel.mesh import replicate
from dcvgan_tpu.train.trainer import Trainer as JaxTrainer
from torch_port_util import jax_native_built, jax_trees, one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_native_built", "one_intra_op_thread")

REPO = Path(__file__).resolve().parents[1]
DEBUG = REPO / "configs" / "debug-mock-depth.yml"


# ------------------------------------------------------------------ profile
def _profiled_run(tmp_path, profile: bool) -> Path:
    """Two steps of ``configs/debug-mock-depth.yml`` (batch 2 of the mock
    dataset's three videos: one step an epoch); returns the run directory."""
    raw = yaml.safe_load(DEBUG.read_text())
    raw.update(batchsize=2, n_epochs=2, snapshot_interval=100, log_samples_interval=100)
    raw["trainer"] = {**raw.get("trainer", {}), "profile": profile}
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(raw))
    cfg = load_config(path)
    cfg.log_dir, cfg.tensorboard_dir = str(tmp_path / "result"), str(tmp_path / "runs")
    cfg.dataset.processed_root = str(tmp_path / "processed")
    trainer = PortTrainer(cfg, cli_train.build_dataset(cfg), device="cpu")
    assert trainer.train().step == 2
    return trainer.run_dir


def test_profile_writes_a_trace_of_the_training_loop(tmp_path):
    run_dir = _profiled_run(tmp_path, profile=True)
    traces = sorted((run_dir / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].name.startswith("rank0-")
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the steps' operators, forward and backward
    assert any(n.startswith("aten::conv") for n in names)
    assert any("backward" in n.lower() for n in names)
    assert f"profile: {traces[0]}" in (run_dir / "log").read_text()


def test_profile_off_writes_no_trace(tmp_path):
    run_dir = _profiled_run(tmp_path, profile=False)
    assert not (run_dir / "profile").exists()


# --------------------------------------------------------------- debug_nans
class _JaxRecorder(JaxLogger):
    def __init__(self, *args):
        super().__init__(*args)
        self.seen = {}

    def update(self, name, value):
        super().update(name, value)
        self.seen.setdefault(name, []).append(value)


class _PortRecorder(PortLogger):
    def __init__(self, *args):
        super().__init__(*args)
        self.seen = {}

    def update(self, name, value):
        super().update(name, value)
        self.seen.setdefault(name, []).append(value)


def _raw(tmp_path, debug_nans: bool) -> dict:
    """One step (batch 2 of the mock dataset's three videos) at ngf 8, f32."""
    return {
        "experiment_name": "nan", "batchsize": 2, "n_epochs": 1, "seed": 0,
        "video_length": 16, "image_size": 64,
        "log_interval": 1, "log_samples_interval": 1000, "snapshot_interval": 1000,
        "evaluation_interval": 10**6,
        "geometric_info": {"name": "depth", "channel": 1},
        "dataset": {"name": "mock", "path": "unused", "n_workers": 1, "extension": "png",
                    "processed_root": str(tmp_path / "processed")},
        "evaluation": {"batchsize": 2, "num_samples": 2, "metrics": []},
        "ggen": {"dim_z_content": 8, "dim_z_motion": 4, "ngf": 8},
        "cgen": {"dim_z_color": 4, "ngf": 8},
        "idis": {"use_noise": True, "noise_sigma": 0.1, "ndf": 8},
        "vdis": {"use_noise": False, "ndf": 8},
        "gdis": {"use_noise": False, "ndf": 8},
        "trainer": {"precision": "float32", "debug_nans": debug_nans},
    }


def _nan_in_idis(state):
    """``state`` with one element of one image-critic parameter NaN."""
    ms = state.idis
    leaves, treedef = jax.tree_util.tree_flatten(ms.params)
    leaves[0] = leaves[0].at[(0,) * leaves[0].ndim].set(jnp.nan)
    return state.replace(idis=ms.replace(params=jax.tree_util.tree_unflatten(treedef, leaves)))


@pytest.fixture
def jax_debug_nans_restored():
    """The JAX trainer switches ``jax_debug_nans`` on for the process; put
    it back after the test."""
    before = jax.config.jax_debug_nans
    yield
    jax.config.update("jax_debug_nans", before)


@pytest.mark.parametrize("debug_nans", [True, False], ids=["on", "off"])
def test_debug_nans_raises_where_the_jax_trainer_raises(tmp_path, debug_nans, jax_debug_nans_restored):
    raw = _raw(tmp_path, debug_nans)
    generate_mock_dataset(tmp_path / "processed" / "mock" / "train")

    jcfg = JaxConfig.from_dict({**raw, "log_dir": str(tmp_path / "jax"), "tensorboard_dir": str(tmp_path / "jax_tb")})
    jcfg.validate()
    jlog = _JaxRecorder(Path(jcfg.log_dir) / "nan", None)
    jax_ds = JaxDataset(name="mock", preprocess_func=None, video_length=16, image_size=64,
                        geometric_info="depth", extension="png",
                        processed_root=jcfg.dataset.processed_root)
    jt = JaxTrainer(jcfg, jax_ds, logger=jlog)
    with jax.debug_nans(False):  # writing the NaN is not the fault under test
        jt.state = replicate(_nan_in_idis(jt.state), jt.mesh)

    pcfg = PortConfig.from_dict({**raw, "log_dir": str(tmp_path / "port"), "tensorboard_dir": str(tmp_path / "port_tb")})
    pcfg.validate()
    plog = _PortRecorder(Path(pcfg.log_dir) / "nan", None)
    pt = PortTrainer(pcfg, cli_train.build_dataset(pcfg), logger=plog, device="cpu")
    load_gan_state_(pt.state, jax_trees(jt.state))  # the same state, its NaN too
    assert sum(int(p.isnan().sum()) for p in pt.state.idis.parameters()) == 1

    if debug_nans:
        with pytest.raises(FloatingPointError):
            jt.train()
        with pytest.raises(FloatingPointError, match=r"step 1 has NaN .*loss_idis.*idis gradients"):
            pt.train()
        for recorder in (jlog, plog):  # no step was logged
            assert "loss_idis" not in recorder.seen
    else:
        assert int(jt.train().step) == 1
        assert pt.train().step == 1
        for recorder in (jlog, plog):
            assert np.isnan(recorder.seen["loss_idis"]).all()
            assert np.isnan(recorder.seen["loss_gen"]).all()
