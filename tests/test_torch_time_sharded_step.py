"""The data x time train step of the port (``mesh.time > 1``) over gloo
ranks against the JAX package on its virtual CPU devices.

f32, ngf/ndf 8, 16 frames of 32x32 (``tests/test_temporal.py``'s shapes),
a global batch of 2, the video and gradient critics without noise (JAX
folds their noise key per shard, a stream the port does not replay), the
image critic with noise; every draw is the global step's, read from JAX's
streams (``step_draws``).

- the step at ``data 2 x time 2`` and ``data 1 x time 4`` (4 ranks each)
  against JAX's unsharded ``jitted_train_step``, the semantics the
  time-sharded step is to match: losses within 2e-4 relative, gradients
  through ``gradients_close`` at scale 1, running statistics and
  parameters as the data-parallel tests hold them, every rank equal;
- the same against JAX's own ``time_sharded_train_step`` on a mesh of the
  same shape;
- the refusals with JAX's texts (``sync_batchnorm: false``, ``dcn > 1``),
  the critics' halo error at ``time 8`` of 16 frames before any step, and
  a layout without the config's time ranks;
- a halo whose backward drops the neighbour's cotangent fails the
  generators' and the video critics' gradients;
- 2 time ranks drawing their own numbers (the video critic's noise on)
  against one rank at the same global batch, plain and under the trio of
  levers;
- ``cli.train`` on 2 ranks at ``time 2`` trains and checkpoints.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dcvgan_torch import prng as port_prng
from dcvgan_torch.config import ExperimentConfig
from dcvgan_torch.data.preprocess import get_preprocessor
from dcvgan_torch.parallel import create_layout
from dcvgan_torch.train.checkpoint import CheckpointManager
from dcvgan_torch.train.step import DCVGAN as PortGAN
from dcvgan_tpu.parallel.mesh import create_mesh, replicate, shard_batch
from dcvgan_tpu.train.step import DCVGAN as JaxGAN
from torch_dist_util import run_ranks, state_payload
from torch_port_util import (
    LOSSES, MODEL_NAMES, DataParallelCase, gradients_close, jax_state,
    no_persistent_compile_cache, port_state, replicas_equal, step_batch, step_configs,  # noqa: F401
    step_draws, step_raw, within,
)
from torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("no_persistent_compile_cache", "one_intra_op_thread")
S, GB, WORLD = 32, 2, 4
LAYOUTS = [(2, 2), (1, 4)]  # (data, time)
NO_NOISE = {"use_noise": False}
TRIO = {"shared_fakes": True, "critic_joint_batch": True, "critic_stat_reuse": True}
REPO = Path(__file__).resolve().parents[1]
DEBUG = REPO / "configs" / "debug-mock-depth.yml"


class TimeCase(DataParallelCase):
    """``DataParallelCase`` at this file's shapes, with the config's
    ``mesh`` set per launch."""

    def __init__(self):
        over = dict(batchsize=GB, image_size=S, vdis=NO_NOISE, gdis=NO_NOISE, mesh={"time": 2},
                    trainer={"precision": "float32", "ema_decay": 0.9})
        self.raw = step_raw(**over)
        jcfg, self.pcfg = step_configs(**over)
        self.jgan = JaxGAN(jcfg)
        self.jstate = jax_state(self.jgan, seed=11)
        self.pstate = port_state(PortGAN(self.pcfg, device="cpu"), self.jstate)
        self.batch = step_batch(12, np.uint8, GB, size=S)
        self.draws = step_draws(self.jgan, self.jstate, self.key(), 1, batch=GB, size=S)

    def launch(self, data, time, tmp: Path):
        payload = self.payload([(self.batch, self.draws)], mesh={"data": data, "time": time})
        payload["config"] = dict(self.raw, mesh={"data": data, "time": time})
        return run_ranks("train_steps", data * time, payload, tmp)

    def jax_time_sharded(self, data, time, devices):
        mesh = create_mesh(data=data, time=time, devices=devices[:data * time])
        step = self.jgan.time_sharded_train_step(mesh)
        out = step(replicate(self.jstate, mesh), shard_batch(self.batch, mesh), self.key())
        return jax.block_until_ready(out)


@pytest.fixture(scope="module")
def case():
    return TimeCase()


@pytest.fixture(scope="module")
def port_runs(case, tmp_path_factory):
    runs = {}

    def get(data, time):
        if (data, time) not in runs:
            runs[data, time] = case.launch(data, time, tmp_path_factory.mktemp(f"d{data}t{time}"))
        return runs[data, time]

    return get


@pytest.fixture(scope="module")
def jax_unsharded(case):
    out = case.jgan.jitted_train_step(
        case.jstate, {k: jnp.asarray(v) for k, v in case.batch.items()}, case.key())
    return jax.block_until_ready(out)


@pytest.mark.parametrize("data,time", LAYOUTS, ids=["data2-time2", "data1-time4"])
def test_time_sharded_step_matches_jax_unsharded_step(case, port_runs, jax_unsharded, data, time):
    results = port_runs(data, time)
    assert len(results) == data * time
    case.match_jax(*jax_unsharded, results)


@pytest.mark.parametrize("data,time", LAYOUTS, ids=["data2-time2", "data1-time4"])
def test_time_sharded_step_matches_jax_time_sharded_train_step(devices, case, port_runs, data, time):
    results = port_runs(data, time)
    case.match_jax(*case.jax_time_sharded(data, time, devices), results)


def test_a_halo_backward_that_drops_the_neighbours_cotangent_fails_the_gradients(
    case, jax_unsharded, tmp_path
):
    """The lesion of ``test_torch_time_sharded_lesion.py`` at the step:
    the critics' first layers and both generators lie before a halo, and
    ``gradients_close`` against JAX's unsharded step fails for them."""
    payload = case.payload([(case.batch, case.draws)], mesh={"data": 1, "time": 4},
                           lesion="halo_backward")
    payload["config"] = dict(case.raw, mesh={"data": 1, "time": 4})
    results = run_ranks("torch_time_util.time_layout_steps", 4, payload, tmp_path)
    pstate = case.port_result(results[0][0])
    caught = []
    for name in MODEL_NAMES:
        try:
            gradients_close(case.jgan, case.jstate, jax_unsharded[0], pstate, name)
        except AssertionError:
            caught.append(name)
    assert caught == ["ggen", "cgen", "vdis", "gdis"], caught


@pytest.mark.parametrize("levers", [{}, TRIO], ids=["plain", "trio"])
def test_two_time_ranks_compute_what_one_rank_computes_drawing_their_own_numbers(tmp_path, levers):
    """The step draws its own numbers, the video critic's noise included:
    each time rank keeps its frames of the unsharded draw. Two time ranks
    against one rank with the same global-batch BatchNorm arithmetic, as
    ``test_torch_data_parallel.py`` holds two data ranks: the first step's
    losses within 1e-5 and gradients within 1e-4 relative L2, the second
    step's losses within 1e-4."""
    trainer = {"precision": "float32", "ema_decay": 0.9, **levers}
    raw = step_raw(batchsize=GB, image_size=S, trainer=trainer)
    state = state_payload(PortGAN(ExperimentConfig.from_dict(raw), device="cpu").init_state(0))
    steps = [(step_batch(3, np.uint8, GB, size=S), None), (step_batch(4, np.uint8, GB, size=S), None)]
    timed = dict(raw, mesh={"data": 1, "time": 2})
    two = run_ranks("train_steps", 2, {"config": timed, "state": state, "steps": steps,
                                       "mesh": {"data": 1, "time": 2}}, tmp_path / "two")
    replicas_equal(two)
    one = run_ranks("train_steps", 1, {"config": raw, "state": state, "steps": steps,
                                       "global_batch_norm": True}, tmp_path / "one")[0]
    for k in LOSSES:
        within(two[0][0]["metrics"][k], one[0]["metrics"][k], 1e-5)
        within(two[0][1]["metrics"][k], one[1]["metrics"][k], 1e-4)
    for name in MODEL_NAMES:
        g = torch.cat([t.flatten() for t in two[0][0]["grads"][name].values()])
        w = torch.cat([t.flatten() for t in one[0]["grads"][name].values()])
        assert (g - w).norm() <= 1e-4 * w.norm(), name


# ----------------------------------------------------------------- refusals
def test_time_sharding_refuses_what_jax_refuses(devices):
    _, pcfg = step_configs(mesh={"time": 2}, trainer={"sync_batchnorm": False})
    jcfg, _ = step_configs(mesh={"time": 2}, trainer={"sync_batchnorm": False})
    with pytest.raises(ValueError) as want:
        JaxGAN(jcfg).time_sharded_train_step(create_mesh(data=1, time=2, devices=devices[:2]))
    gan = PortGAN(pcfg, device="cpu")
    with pytest.raises(ValueError) as got:
        gan.train_step(gan.init_state(0), step_batch(0, np.uint8), port_prng.base_key(0))
    assert str(got.value) == str(want.value) == "mesh.time > 1 requires trainer.sync_batchnorm=true"

    jcfg, pcfg = step_configs(mesh={"time": 2, "dcn": 2})
    with pytest.raises(NotImplementedError) as want:
        JaxGAN(jcfg).time_sharded_train_step(
            create_mesh(data=1, time=2, dcn=2, devices=devices[:4]))
    gan = PortGAN(pcfg, device="cpu", layout=create_layout(pcfg, data=1, world=4))
    with pytest.raises(NotImplementedError) as got:
        gan.train_step(gan.init_state(0), step_batch(0, np.uint8), port_prng.base_key(0))
    assert str(got.value) == str(want.value)

    # time 8 of 16 frames: the critics' halo error, before any step
    _, pcfg = step_configs(mesh={"time": 8})
    gan = PortGAN(pcfg, device="cpu", layout=create_layout(pcfg, data=1, world=8))
    state = gan.init_state(0)
    with pytest.raises(ValueError, match="local time extent 2 < halo 3"):
        gan.train_step(state, step_batch(0, np.uint8), port_prng.base_key(0))
    assert state.step == 0

    # a layout without the config's time ranks: one process at mesh.time 2
    _, pcfg = step_configs(mesh={"time": 2})
    gan = PortGAN(pcfg, device="cpu")
    with pytest.raises(ValueError, match="mesh.time=2 but this process's layout has 1"):
        gan.train_step(gan.init_state(0), step_batch(0, np.uint8), port_prng.base_key(0))


# -------------------------------------------------------------- cli.train
@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    get_preprocessor("synthetic")(root / "raw", root / "synthetic" / "train", "train", 16, 64, -1)
    return root


def _train(tmp: Path, data_root: Path, world: int, mesh: dict):
    raw = yaml.safe_load(DEBUG.read_text())
    raw.update(batchsize=4, n_epochs=1, log_dir=str(tmp / "result"),
               tensorboard_dir=str(tmp / "runs"), snapshot_interval=2, log_samples_interval=1000,
               mesh=mesh)
    raw["dataset"] = {"name": "synthetic", "path": "unused", "n_workers": 1, "number_limit": 8,
                      "processed_root": str(data_root)}
    tmp.mkdir(parents=True)
    cfg = tmp / "cfg.yml"
    cfg.write_text(yaml.safe_dump(raw))
    cwds = [tmp / f"cwd{r}" for r in range(world)]
    for c in cwds:
        c.mkdir(parents=True, exist_ok=True)
    payload = {"cwd": [str(c) for c in cwds],
               "argv": ["--config", str(cfg), "--device", "cpu", "--dist-backend", "gloo"]}
    return run_ranks("train_cli", world, payload, tmp / "ranks"), tmp / "result" / "debug-mock-depth"


def test_cli_train_on_two_time_ranks_trains_and_checkpoints(tmp_path, data_root):
    results, run_dir = _train(tmp_path / "two", data_root, 2, {"data": 1, "time": 2})
    assert [r["world"] for r in results] == [2, 2]
    replicas_equal([[{"metrics": {}, "grads": {n: {} for n in MODEL_NAMES}, **r["state"]}]
                    for r in results])
    assert results[0]["metrics"] == results[1]["metrics"] and len(results[0]["metrics"]) == 2
    log = (run_dir / "log").read_text()
    assert log.count("ranks: 2 (dcn 1 x data 1 x time 2), global-batch BatchNorm") == 1
    gan = PortGAN(ExperimentConfig.from_dict(yaml.safe_load((run_dir / "config.yml").read_text())),
                  device="cpu")
    restored = CheckpointManager(run_dir / "models").restore(gan.init_state(0))
    assert restored.step == 2
    for name in MODEL_NAMES:
        for k, v in restored.models[name].state_dict().items():
            assert torch.equal(v, results[0]["state"]["models"][name][k]), (name, k)
    assert all(np.isfinite(list(m.values())).all() for m in results[0]["metrics"])
