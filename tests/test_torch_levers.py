"""The train step's opt-in levers in the port against the JAX step.

From the same state and the same draws as ``tests/test_torch_train_step.py``
(``torch_port_util.run_pair``), with the lever set on both sides:

- the fast-path trio of ``configs/demo-synthetic-fastpath.yml``
  (``shared_fakes`` + ``critic_joint_batch`` + ``critic_stat_reuse``, one
  JAX compile): losses, gradients, every model's running statistics,
  parameters and Adam's state;
- ``shared_fakes`` alone (``configs/demo-synthetic-sharedfakes.yml``, one
  compile): losses, the generators' gradients and statistics.

The tolerances are the train-step suite's (its module docstring), not
tightened. Measured per tensor, relative to the tensor's largest gradient,
and whole-model relative L2:

- trio, two states (seeds 20, 40): up to 1.4e-2 (cgen) and 6.4e-3; the
  video critics up to 7.1e-3, the image critic 6.7e-6; losses 8.1e-6;
- ``shared_fakes``, seed 42: up to 2.5e-2 (cgen) and 7.9e-3.

At seed 22 cgen's up1 transposed conv was off by 8.0e-2 under
``shared_fakes``, and the step *without* the lever, from the same state, by
8.3e-2 at up1's BatchNorm bias: that state's BatchNorm over 2x2 pixels
amplifies the 1e-4 differences of the fakes to about the suite's 8e-2
whatever the lever (ROADMAP §C). The ``shared_fakes`` fixture takes seed
42, and the seed-22 state stays in the suite as a case of its own, which
holds the lever's gap to JAX to the plain step's gap plus a margin.
"""

import numpy as np
import pytest

from torch_port_util import (
    ATOL_F32, LOSSES, LR, MODEL_NAMES, flatten_tree, gradient_gaps, gradients_close, numpy_tree,
    one_intra_op_thread, port_stats, port_tree, run_pair, step_batch, step_configs, within,
)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

TRIO = {"shared_fakes": True, "critic_joint_batch": True, "critic_stat_reuse": True}


@pytest.fixture(scope="module")
def trio():
    jcfg, pcfg = step_configs(trainer=TRIO)
    return run_pair(jcfg, pcfg, seed=20, batch=step_batch(21, np.uint8))


def test_trio_losses_match_jax(trio):
    _, _, jafter, jm, pgan, pstate, pm = trio
    assert pstate.step == int(jafter.step) == 1
    draws = pgan.last_draws
    assert draws.d_latents is None and set(draws.d_noise["vdis"]) == {"joint"}
    for k in LOSSES:
        within(pm[k].numpy(), np.asarray(jm[k]), ATOL_F32, ATOL_F32)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_trio_gradients_match_jax(trio, name):
    jgan, jbefore, jafter, _, _, pstate, _ = trio
    gradients_close(jgan, jbefore, jafter, pstate, name)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_trio_running_statistics_match_jax(trio, name):
    """The generators' from the one shared forward, each critic's from its
    one joint-batch forward (a second advance, or none, is off by tens of
    percent of the move)."""
    _, jbefore, jafter, _, _, pstate, _ = trio
    got = port_stats(name, getattr(pstate, name))
    want = flatten_tree(numpy_tree(getattr(jafter, name).batch_stats))
    old = flatten_tree(numpy_tree(getattr(jbefore, name).batch_stats))
    assert set(got) == set(want) and got
    for k in want:
        within(got[k], want[k], ATOL_F32, ATOL_F32)
        assert np.abs(want[k] - old[k]).max() > 1e-3  # they did move


def test_trio_parameters_and_adam_state_follow_jax(trio):
    _, _, jafter, _, _, pstate, _ = trio
    for name in MODEL_NAMES:
        module = getattr(pstate, name)
        got = flatten_tree(port_tree(name, module, dict(module.named_parameters())))
        want = flatten_tree(numpy_tree(getattr(jafter, name).params))
        for k in want:
            within(got[k], want[k], 2.5 * LR)
        steps = {float(s["step"]) for s in pstate.opt[name].state.values()}
        assert steps == {1.0} and int(getattr(jafter, name).opt_state[1].count) == 1


@pytest.fixture(scope="module")
def shared():
    jcfg, pcfg = step_configs(trainer={"shared_fakes": True})
    return run_pair(jcfg, pcfg, seed=42, batch=step_batch(43, np.uint8))


def test_shared_fakes_losses_match_jax(shared):
    _, _, _, jm, pgan, _, pm = shared
    assert pgan.last_draws.d_latents is None and pgan.last_draws.d_dropout is None
    for k in LOSSES:
        within(pm[k].numpy(), np.asarray(jm[k]), ATOL_F32, ATOL_F32)


@pytest.mark.parametrize("name", ["ggen", "cgen"])
def test_shared_fakes_generators_follow_jax(shared, name):
    """Gradients through the one shared graph, and statistics from that one
    forward."""
    jgan, jbefore, jafter, _, _, pstate, _ = shared
    gradients_close(jgan, jbefore, jafter, pstate, name)
    got = port_stats(name, getattr(pstate, name))
    want = flatten_tree(numpy_tree(getattr(jafter, name).batch_stats))
    for k in want:
        within(got[k], want[k], ATOL_F32, ATOL_F32)


# the seed-22 state: the lever's cgen gradient may stray from JAX's as far
# as the plain step's does from the same state, plus this much (per tensor,
# relative to the tensor's largest gradient; and in relative L2)
SEED22_MARGIN, SEED22_L2_MARGIN = 1e-2, 5e-3


@pytest.fixture(scope="module")
def seed22(shared):
    """``shared_fakes`` (reusing ``shared``'s compiled JAX step) and the
    plain step from the seed-22 state; the cgen gradients' gaps to JAX."""
    batch = step_batch(23, np.uint8)
    lever = run_pair(*step_configs(trainer={"shared_fakes": True}), seed=22, batch=batch,
                     jgan=shared[0])
    plain = run_pair(*step_configs(), seed=22, batch=batch)
    return {label: gradient_gaps(jgan, jbefore, jafter, pstate, "cgen")
            for label, (jgan, jbefore, jafter, _, _, pstate, _) in
            (("lever", lever), ("plain", plain))}


def test_shared_fakes_strays_no_further_than_the_plain_step_at_seed_22(seed22):
    """At this state the port's cgen gradient lies about the suite's 8e-2
    from JAX's with the lever and without it: the BatchNorm over 2x2 pixels,
    not the lever. The lever must add no gap of its own."""
    (lever, lever_l2), (plain, plain_l2) = seed22["lever"], seed22["plain"]
    print(f"seed 22 cgen gradient gap to JAX: shared_fakes {lever:.3e} per tensor, "
          f"{lever_l2:.3e} L2; plain step {plain:.3e}, {plain_l2:.3e}")
    assert plain > 0.05  # the state is the ill-conditioned one
    assert lever <= plain + SEED22_MARGIN
    assert lever_l2 <= plain_l2 + SEED22_L2_MARGIN
