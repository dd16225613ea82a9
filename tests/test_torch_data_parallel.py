"""Data-parallel training of the port over gloo ranks with global-batch
statistics (``trainer.sync_batchnorm: true``), against the JAX package on
its virtual CPU devices.

f32, ngf/ndf 8, 16 frames of 64x64, a global batch of 4 over 2 ranks
(``tests/torch_dist_util.py`` starts them; ``DataParallelCase`` in
``tests/torch_port_util.py`` holds the state and batch).

- the step against ``jitted_train_step`` on a batch sharded over a
  ``data=2`` mesh, with the global draws ``step_draws`` reads: losses
  within 2e-4, gradients through ``gradients_close``, statistics and
  parameters as the one-device step test holds them;
- 2 ranks against 1 rank at the same global batch, the step drawing its own
  numbers, plain and under the trio of levers;
- dcn 2 x data 2 against a flat data 4, at 4 ranks (per-replica statistics,
  where the rank's coordinates pick its draws).

``test_torch_data_parallel_replica.py`` holds the per-replica step.
"""

import numpy as np
import pytest
import torch

from dcvgan_torch.parallel import create_layout
from torch_dist_util import run_ranks
from torch_port_util import (
    ATOL_F32, LOSSES, LR, MODEL_NAMES, WORLD, DataParallelCase, no_persistent_compile_cache,  # noqa: F401
    replicas_equal, step_batch, step_draws, within,
)
from torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("no_persistent_compile_cache", "one_intra_op_thread")


@pytest.fixture(scope="module")
def case():
    return DataParallelCase()


TRIO = {"shared_fakes": True, "critic_joint_batch": True, "critic_stat_reuse": True}


# ------------------------------------------------- global-batch statistics
def test_global_batch_step_matches_jax_on_a_data_mesh(tmp_path, case):
    draws = step_draws(case.jgan, case.jstate, case.key(), 1, batch=case.batch["color"].shape[0])
    jafter, jm = case.jax_step(per_replica=False)
    results = run_ranks("train_steps", WORLD, case.payload([(case.batch, draws)]), tmp_path)
    case.match_jax(jafter, jm, results)


@pytest.mark.parametrize("levers", [{}, TRIO], ids=["plain", "trio"])
def test_two_ranks_compute_what_one_rank_computes_on_the_global_batch(tmp_path, levers):
    """The step draws its own numbers: every rank keeps its rows of the
    global batch's latents, masks and noise ([real; fake] under
    ``critic_joint_batch``), so 2 ranks compute what one process computes at
    the global batch. Held against one rank with the same global-batch
    BatchNorm arithmetic (s1, s2 sums), first step: gradients within 1e-4
    relative L2 (measured 6e-7 to 7.5e-6 over two states), statistics
    within 1e-5, losses within 1e-5 (2.4e-7); the second step's losses
    within 1e-4 (9.5e-6: Adam's first step turns a gradient of rounding
    noise into +-lr). One rank's own path, ``native_batch_norm``, rounds
    its variance otherwise, which the generators' gradients amplify at these
    weights (ggen 2.4% in L2); its losses are held at the JAX parity
    tolerance (measured 2.1e-5)."""
    case = DataParallelCase(**levers)
    steps = [(case.batch, None), (step_batch(13, np.uint8, case.batch["color"].shape[0]), None)]
    two = run_ranks("train_steps", WORLD, case.payload(steps), tmp_path / "two")
    replicas_equal(two)
    one = run_ranks("train_steps", 1, case.payload(steps, global_batch_norm=True), tmp_path / "one")[0]
    plain = run_ranks("train_steps", 1, case.payload(steps[:1]), tmp_path / "plain")[0]
    got, want = two[0][0], one[0]
    for k in LOSSES:
        within(got["metrics"][k], want["metrics"][k], 1e-5)
        within(two[0][1]["metrics"][k], one[1]["metrics"][k], 1e-4)
        within(got["metrics"][k], plain[0]["metrics"][k], ATOL_F32, ATOL_F32)
    for name in MODEL_NAMES:
        g = torch.cat([t.flatten() for t in got["grads"][name].values()])
        w = torch.cat([t.flatten() for t in want["grads"][name].values()])
        assert (g - w).norm() <= 1e-4 * w.norm(), name
        for k, v in want["models"][name].items():
            if "running" in k:
                within(got["models"][name][k].numpy(), v.numpy(), 1e-5)
            elif v.is_floating_point():
                within(got["models"][name][k].numpy(), v.numpy(), 2.5 * LR)


def test_dcn_by_data_equals_a_flat_data_axis_at_four_ranks(tmp_path):
    """dcn is an outer batch-parallel factor: ranks in (dcn, data) order
    draw and reduce as the flat axis does, bit for bit."""
    case = DataParallelCase(sync_batchnorm=False)
    payload = case.payload([(case.batch, None)])
    dcn = run_ranks("train_steps", 4, dict(payload, mesh={"dcn": 2, "data": 2}), tmp_path / "dcn")
    flat = run_ranks("train_steps", 4, dict(payload, mesh={"data": 4}), tmp_path / "flat")
    replicas_equal(dcn + flat)
    layouts = [create_layout(dcn=2, data=2, world=4, rank=r) for r in range(4)]
    assert [(lay.dcn, lay.data, lay.rank) for lay in layouts] == [(2, 2, r) for r in range(4)]
