"""The two-rank comparisons have teeth: a global-batch BatchNorm whose
backward keeps each rank's own gradient of the sums, instead of
all-reducing it, is caught by the measures that
``test_torch_data_parallel.py`` and ``chip_smoke.py`` phase 12 hold.

f32, ngf/ndf 8, a global batch of 4 over 2 gloo ranks, 3 steps, against
one rank with the same global-batch arithmetic (where the lesion changes
nothing: a world of one sums nothing). The lesioned ranks stay equal to
each other (the gradients are still averaged over the ranks), so only a
comparison with one rank shows it. Measured here (run with ``-s``): the
first step's gradients 0.24-0.50 relative L2 by model, the 3 steps'
updates 0.49-0.81 (intact ranks: 6e-7 to 7.5e-6 on the gradients,
``test_torch_data_parallel.py``).
"""

import numpy as np
import pytest
import torch

from torch_dist_util import run_ranks
from torch_port_util import (
    MODEL_NAMES, DataParallelCase, no_persistent_compile_cache,  # noqa: F401
    replicas_equal, step_batch,
)
from torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("no_persistent_compile_cache", "one_intra_op_thread")
# what the comparisons hold intact ranks to: the gradients within 1e-4
# relative L2 on the CPU (test_torch_data_parallel.py); on the card the
# first step's gradients within 2e-2 and the updates within 0.3
# (chip_smoke.py, DP_GRAD_L2 and DP_UPDATE_L2)
CAUGHT_GRAD_L2, CAUGHT_UPDATE_L2 = 2e-2, 0.3


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.float().flatten() for t in tensors])


def _params(models: dict, name: str) -> torch.Tensor:
    return _flat(v for k, v in models[name].items() if "running" not in k and "num_batches" not in k)


def test_a_backward_that_skips_the_all_reduce_is_caught(tmp_path):
    case = DataParallelCase()
    b = case.batch["color"].shape[0]
    steps = [(case.batch, None), (step_batch(13, np.uint8, b), None), (step_batch(14, np.uint8, b), None)]
    init = {n: _params(case.payload([])["state"]["models"], n) for n in MODEL_NAMES}
    two = run_ranks("train_steps", 2, case.payload(steps, local_backward=True), tmp_path / "two")
    replicas_equal(two)
    one = run_ranks("train_steps", 1, case.payload(steps, global_batch_norm=True), tmp_path / "one")[0]
    for name in MODEL_NAMES:
        g, w = _flat(two[0][0]["grads"][name].values()), _flat(one[0]["grads"][name].values())
        grad_l2 = ((g - w).norm() / w.norm()).item()
        # the snapshots hold the live tensors: the last step's parameters
        a, c = _params(two[0][-1]["models"], name) - init[name], _params(one[-1]["models"], name) - init[name]
        update_l2 = ((a - c).norm() / c.norm()).item()
        print(f"{name}: first step's gradients {grad_l2:.3e}, 3 steps' updates {update_l2:.3e} relative L2")
        assert grad_l2 > CAUGHT_GRAD_L2 and update_l2 > CAUGHT_UPDATE_L2, name
