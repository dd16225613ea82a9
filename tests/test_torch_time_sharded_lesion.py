"""The time-sharded comparisons have teeth: each of two lesions of the
port, made in the gloo ranks (``torch_time_util``), fails the limits that
``test_torch_temporal.py`` holds.

- a halo exchange whose backward drops the neighbour's cotangent: the
  time-sharded conv's input gradient against the unsharded conv's (rtol
  2e-5, atol 1e-5); ``test_torch_time_sharded_step.py`` shows the same
  lesion failing the step's gradients against JAX's (``gradients_close``);
- a masked BatchNorm that skips the time all-reduce (its sums go over the
  ranks of one time index only): its output and running mean against
  flax's, and the critics' logits against the port's unsharded forward
  (2e-4).

``time 4`` of 16 frames, ``data 1``, 4 ranks, the shapes of that file.
"""

import numpy as np
import pytest

from dcvgan_torch.parallel.temporal import conv3d_time_valid
from test_torch_temporal import (  # noqa: F401
    CRITICS, WORLD, _jax_masked_bn, _mesh, _port_unsharded, inputs, payload_of,
)
from torch_dist_util import run_ranks
from torch_port_util import no_persistent_compile_cache  # noqa: F401
from torch_port_util import one_intra_op_thread  # noqa: F401
from torch_time_util import ATOL, CONV_ATOL, CONV_RTOL, conv_grads, gather_frames, max_rel

pytestmark = pytest.mark.usefixtures("no_persistent_compile_cache", "one_intra_op_thread")
NT = 4


def _lesioned(inputs, lesion, tmp):
    payload = payload_of(inputs, nts=(NT,), lesion=lesion, lesion_nt=NT)
    return run_ranks("torch_time_util.temporal_ops", WORLD, payload, tmp)


def _off(got, want, rtol, atol) -> bool:
    return bool((np.abs(got - want) > atol + rtol * np.abs(want)).any())


def test_a_halo_backward_that_drops_the_neighbours_cotangent_is_caught(tmp_path, inputs):
    ranks = _lesioned(inputs, "halo_backward", tmp_path)
    x = inputs["x"].clone().requires_grad_(True)
    w = inputs["w"].clone().requires_grad_(True)
    y = conv3d_time_valid(x.movedim(-1, 1), w, 2).movedim(1, -1)
    (y * inputs["ct"][:, :y.shape[1]]).sum().backward()
    dx, dw = conv_grads(ranks, NT)
    print(f"conv gradients: input {max_rel(dx, x.grad):.3e}, weight {max_rel(dw, w.grad):.3e} "
          f"of the largest")
    assert _off(dx.numpy(), x.grad.numpy(), CONV_RTOL, CONV_ATOL)
    # the weight's gradient is each rank's own: the lesion leaves it
    np.testing.assert_allclose(dw.numpy(), w.grad.numpy(), rtol=CONV_RTOL, atol=CONV_ATOL)


def test_a_masked_batch_norm_without_the_time_all_reduce_is_caught(devices, tmp_path, inputs):
    ranks = _lesioned(inputs, "bn_without_time", tmp_path)
    y, _, _, new = _jax_masked_bn(inputs, _mesh(NT, devices))
    got = gather_frames(ranks, NT, "bn", "y").numpy()
    print(f"masked BatchNorm output {max_rel(got, np.asarray(y)):.3e} of the largest")
    assert _off(got, np.asarray(y), 0.0, ATOL)
    assert _off(ranks[0][NT]["bn"]["mean"].numpy(), np.asarray(new["mean"]), 0.0, ATOL)
    for kind in ("plain", "noise"):
        crit = inputs["critics"][kind]
        for name in CRITICS:
            plain, _ = _port_unsharded(crit, name)
            # rank 0's logits: under the lesion the time ranks disagree
            got = ranks[0][NT]["critics"][kind][name]["logits"]
            print(f"{kind} {name} logits {max_rel(got, plain):.3e} of the largest")
            assert _off(got.numpy(), plain.numpy(), 0.0, ATOL)

