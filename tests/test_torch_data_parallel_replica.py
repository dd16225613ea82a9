"""Data-parallel training of the port over 2 gloo ranks with per-replica
statistics (``trainer.sync_batchnorm: false``) against the JAX package's
``sharded_train_step`` on a ``data=2`` mesh of its virtual CPU devices,
plain and under the trio of levers (``shared_fakes``,
``critic_joint_batch``, ``critic_stat_reuse``).

Each rank is handed replica r's draws, which ``step_draws(replica=r)``
reads from JAX's streams with r folded into the step's key.

Losses, statistics and parameters are held as JAX's; gradients as JAX's
divided by the world. Under this JAX (0.9) ``shard_map`` transposes the
broadcast of the replicated parameters into a ``psum``, so ``jax.grad``
inside the per-replica step already sums the replicas' gradients and the
step's ``pmean`` then averages W equal sums: JAX applies the sum, W times
the mean its docstring names. The port applies the mean (DDP's gradient);
Adam is invariant to the factor but for eps and the coupled weight decay,
which is why the parameters agree within 2.5 lr all the same.
"""

import pytest

from torch_dist_util import run_ranks
from torch_port_util import (
    WORLD, DataParallelCase, no_persistent_compile_cache, step_draws,  # noqa: F401
)
from torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("no_persistent_compile_cache", "one_intra_op_thread")
TRIO = {"shared_fakes": True, "critic_joint_batch": True, "critic_stat_reuse": True}


@pytest.mark.parametrize("levers", [{}, TRIO], ids=["plain", "trio"])
def test_per_replica_step_matches_jax_sharded_train_step(tmp_path, levers):
    case = DataParallelCase(sync_batchnorm=False, **levers)
    local = case.batch["color"].shape[0] // WORLD
    draws = [step_draws(case.jgan, case.jstate, case.key(), 1, batch=local, replica=r)
             for r in range(WORLD)]
    jafter, jm = case.jax_step(per_replica=True)
    results = run_ranks("train_steps", WORLD, case.payload([(case.batch, draws)]), tmp_path)
    case.match_jax(jafter, jm, results, grad_scale=1.0 / WORLD)
