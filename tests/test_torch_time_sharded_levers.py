"""The train step's levers under time sharding (``mesh.time > 1``): the
port on 2 gloo ranks at ``data 1 x time 2`` against the JAX package's
``time_sharded_train_step`` on a mesh of the same shape.

One case, one JAX compile: the fast-path trio (``shared_fakes``,
``critic_joint_batch``, ``critic_stat_reuse``) with ``ggen_double_step``,
at ``tests/test_torch_time_sharded_step.py``'s shapes (f32, ngf/ndf 8, 16
frames of 32x32, a global batch of 2, the video and gradient critics
without noise, every draw the global step's from JAX's streams). Held as
that file holds the plain step: losses within 2e-4 relative, gradients
through ``gradients_close`` at scale 1 (ggen's from its two Adam steps),
running statistics at 2e-4, every rank equal; parameters within 2.5 lr,
ggen's within 4.5 lr (it moves 2 lr a step, as
``tests/test_torch_levers_quirks_remat.py`` holds it), and Adam's counts
(ggen 2, the others 1).
"""

import jax
import numpy as np
import pytest

from dcvgan_torch.train.step import DCVGAN as PortGAN
from dcvgan_tpu.parallel.mesh import create_mesh, replicate, shard_batch
from dcvgan_tpu.train.step import DCVGAN as JaxGAN
from torch_dist_util import run_ranks
from torch_port_util import (
    ATOL_F32, LOSSES, LR, MODEL_NAMES, DataParallelCase, flatten_tree, gradients_close, jax_state,
    no_persistent_compile_cache, numpy_tree, port_stats, port_state, port_tree, replicas_equal,  # noqa: F401
    step_batch, step_configs, step_draws, step_raw, within,
)
from torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("no_persistent_compile_cache", "one_intra_op_thread")
S, GB, DATA, TIME = 32, 2, 1, 2
NO_NOISE = {"use_noise": False}
LEVERS = {"shared_fakes": True, "critic_joint_batch": True, "critic_stat_reuse": True,
          "ggen_double_step": True}
COUNTS = {"ggen": 2, "cgen": 1, "idis": 1, "vdis": 1, "gdis": 1}


@pytest.fixture(scope="module")
def levers(devices, tmp_path_factory):
    case = DataParallelCase.__new__(DataParallelCase)
    mesh = {"data": DATA, "time": TIME}
    over = dict(batchsize=GB, image_size=S, vdis=NO_NOISE, gdis=NO_NOISE, mesh=mesh,
                trainer={"precision": "float32", "ema_decay": 0.9, **LEVERS})
    case.raw = step_raw(**over)
    jcfg, case.pcfg = step_configs(**over)
    case.jgan = JaxGAN(jcfg)
    case.jstate = jax_state(case.jgan, seed=13)
    case.pstate = port_state(PortGAN(case.pcfg, device="cpu"), case.jstate)
    case.batch = step_batch(14, np.uint8, GB, size=S)
    draws = step_draws(case.jgan, case.jstate, case.key(), 1, batch=GB, size=S)
    assert draws.d_latents is None and set(draws.d_noise["idis"]) == {"joint"}
    results = run_ranks("train_steps", DATA * TIME, case.payload([(case.batch, draws)], mesh=mesh),
                        tmp_path_factory.mktemp("levers"))
    jmesh = create_mesh(data=DATA, time=TIME, devices=devices[:DATA * TIME])
    step = case.jgan.time_sharded_train_step(jmesh)
    jafter, jm = jax.block_until_ready(
        step(replicate(case.jstate, jmesh), shard_batch(case.batch, jmesh), case.key()))
    return case, results, jafter, jm


def test_levers_under_time_sharding_losses_and_ranks_match_jax(levers):
    _, results, jafter, jm = levers
    assert len(results) == DATA * TIME and int(jafter.step) == 1
    replicas_equal(results)
    for k in LOSSES:
        within(results[0][0]["metrics"][k], np.asarray(jm[k]), ATOL_F32, ATOL_F32)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_levers_under_time_sharding_follow_jax(levers, name):
    case, results, jafter, _ = levers
    pstate = case.port_result(results[0][0])
    gradients_close(case.jgan, case.jstate, jafter, pstate, name, n_steps=COUNTS[name])
    module = getattr(pstate, name)
    got = flatten_tree(port_tree(name, module, dict(module.named_parameters())))
    want = flatten_tree(numpy_tree(getattr(jafter, name).params))
    for k in want:
        within(got[k], want[k], (4.5 if name == "ggen" else 2.5) * LR)
    stats = port_stats(name, module)
    for k, v in flatten_tree(numpy_tree(getattr(jafter, name).batch_stats)).items():
        within(stats[k], v, ATOL_F32, ATOL_F32)
    assert int(getattr(jafter, name).opt_state[1].count) == COUNTS[name]
    assert {float(s["step"]) for s in pstate.opt[name].state.values()} == {float(COUNTS[name])}
