"""The rest of the train step's levers, and the configs the port trains.

- ``ggen_double_step`` with ``num_gen_update: 2``
  (``configs/demo-synthetic-quirks.yml``) against the JAX step over steps 1
  and 2 (one JAX compile): which models step, Adam's counts, parameters,
  gradients; and two Adam steps on one gradient against optax's;
- ``remat``, port against port (``jax.checkpoint`` is exact, so remat on
  and off give the same step): bit for bit, from the same state and key,
  alone and under the shared-fakes levers; the recompute moves no running
  statistics and redraws no dropout mask;
- an undrawn step under each lever replays from its key and varies with it;
- every config under ``configs/`` builds in the port and passes the lever
  check (only the multi-device layouts are refused).

The quirks step at the train-step suite's tolerances, measured: losses
7.2e-7; at step 2 gradients per tensor up to 2.8e-2 of the tensor's
largest (cgen) and 5.6e-3 in L2.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcvgan_torch import prng as port_prng
from dcvgan_torch.config import OptimizerConfig, load_config
from dcvgan_torch.models.layers import batch_norm
from dcvgan_torch.train.state import MODEL_NAMES
from dcvgan_torch.train.step import DCVGAN as PortGAN
from dcvgan_torch.train.step import StepDraws, _recomputed, make_optimizer
from dcvgan_tpu.config import OptimizerConfig as JaxOptimizerConfig
from dcvgan_tpu.train.step import make_optimizer as jax_make_optimizer
from torch_port_util import (
    ATOL_F32, LOSSES, LR, flatten_tree, gradients_close, numpy_tree, one_intra_op_thread,
    port_tree, run_pair, step_batch, step_configs, within,
)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.yml"))
TRIO = {"shared_fakes": True, "critic_joint_batch": True, "critic_stat_reuse": True}


# ----------------------------------------------------------- ggen double step
@pytest.fixture(scope="module")
def quirks():
    """Step 1 (critics shut by ``num_gen_update: 2``) and step 2 (all step),
    each from its own state; one compiled JAX step serves both."""
    jcfg, pcfg = step_configs(num_gen_update=2, trainer={"ggen_double_step": True})
    batch = step_batch(31, np.float32)
    return {s: run_pair(jcfg, pcfg, seed=30 + s, batch=batch, step0=s) for s in (0, 1)}


@pytest.mark.parametrize("step0,critics_step", [(0, False), (1, True)], ids=["step1", "step2"])
def test_quirks_steps_match_jax(quirks, step0, critics_step):
    """ggen's Adam steps twice (count 2, each parameter moved about 2 lr),
    cgen once, the critics on every second step. A flipped sign of a
    rounding-noise gradient moves a parameter 2 lr the other way per step,
    so ggen is held at 4.5 lr."""
    _, jbefore, jafter, jm, _, pstate, pm = quirks[step0]
    assert pstate.step == int(jafter.step) == step0 + 1
    for k in LOSSES:
        within(pm[k].numpy(), np.asarray(jm[k]), ATOL_F32, ATOL_F32)
    for name in MODEL_NAMES:
        module = getattr(pstate, name)
        got = flatten_tree(port_tree(name, module, dict(module.named_parameters())))
        want = flatten_tree(numpy_tree(getattr(jafter, name).params))
        old = flatten_tree(numpy_tree(getattr(jbefore, name).params))
        count = {"ggen": 2, "cgen": 1}.get(name, int(critics_step))
        assert int(getattr(jafter, name).opt_state[1].count) == count
        assert {float(s["step"]) for s in pstate.opt[name].state.values()} == {float(count)}
        if count == 0:
            for k in old:
                np.testing.assert_array_equal(got[k], old[k])
            continue
        for k in want:
            within(got[k], want[k], (4.5 if name == "ggen" else 2.5) * LR)
        moved = max(float(np.abs(got[k] - old[k]).max()) for k in old)
        if name == "ggen":
            assert 1.9 * LR < moved <= 2.01 * LR
        else:
            assert 0.9 * LR < moved <= 1.01 * LR


@pytest.mark.parametrize("name", ["ggen", "cgen"])
def test_quirks_generator_gradients_match_jax(quirks, name):
    jgan, jbefore, jafter, _, _, pstate, _ = quirks[1]
    gradients_close(jgan, jbefore, jafter, pstate, name, n_steps=2 if name == "ggen" else 1)


@pytest.mark.parametrize("decay", [0.0, 0.5])
def test_two_adam_steps_on_one_gradient_match_optax_and_leave_the_gradient(decay):
    """torch's Adam adds the weight decay to a copy of ``.grad``: the second
    step sees the gradient the first did, and the second decay term uses
    the updated parameters, as ``gated_update(..., n_steps=2)`` does."""
    rng = np.random.default_rng(5)
    p0 = rng.normal(size=(3, 4, 5)).astype(np.float32)
    g = (rng.normal(size=p0.shape) * rng.choice([1e-6, 1e-2, 1.0], p0.shape)).astype(np.float32)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(OptimizerConfig(decay=decay), [p])
    p.grad = torch.from_numpy(g.copy())
    for _ in range(2):
        opt.step()
        assert torch.equal(p.grad, torch.from_numpy(g))
    tx = jax_make_optimizer(JaxOptimizerConfig(decay=decay))
    params, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for _ in range(2):
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
    within(p.detach().numpy(), np.asarray(params), 1e-6, 1e-6)
    within(opt.state[p]["exp_avg"].numpy(), np.asarray(state[1].mu), 1e-7, 1e-5)
    assert float(opt.state[p]["step"]) == 2.0 == int(state[1].count)


# ---------------------------------------------------------------------- remat
def _step(levers, key=1, draws=None):
    _, pcfg = step_configs(trainer=levers)
    gan = PortGAN(pcfg, device="cpu")
    state, m = gan.train_step(gan.init_state(0), step_batch(3, np.uint8),
                              port_prng.base_key(key), draws)
    return state, m


def _assert_same_step(a, b):
    (sa, ma), (sb, mb) = a, b
    for k in LOSSES:
        assert torch.equal(ma[k], mb[k]), k
    for name in MODEL_NAMES:
        ma_, mb_ = getattr(sa, name), getattr(sb, name)
        for (k, p), q in zip(ma_.named_parameters(), mb_.parameters()):
            assert torch.equal(p.grad, q.grad) and torch.equal(p, q), (name, k)
            s, t = sa.opt[name].state[p], sb.opt[name].state[q]
            for part in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(s[part], t[part]), (name, k, part)
        for (k, x), y in zip(ma_.named_buffers(), mb_.buffers()):
            assert torch.equal(x, y), (name, k)


@pytest.mark.parametrize("levers", [{}, {"shared_fakes": True}, TRIO], ids=["plain", "shared", "trio"])
def test_remat_gives_the_step_without_it(levers):
    """Losses, gradients, parameters, Adam's state and running statistics
    equal bit for bit: the recompute runs the same ops on the same inputs
    and masks on the CPU."""
    _assert_same_step(_step({**levers, "remat": True}), _step(levers))


def test_recompute_moves_the_running_statistics_once():
    """A checkpointed forward's backward runs the forward again; that second
    run must not move a BatchNorm's running statistics a second time."""
    bn, plain = batch_norm(4), batch_norm(4)
    x = torch.randn(8, 4, 3, 3, generator=torch.Generator().manual_seed(0)) * 3 + 1
    forward = _recomputed(lambda update_stats, x: bn(x, True, update_stats) ** 2)
    y = forward(True, x.clone().requires_grad_())
    after_forward = bn.running_mean.clone(), bn.running_var.clone()
    y.sum().backward()  # recomputes
    plain(x, True, True)
    for got, once in zip((bn.running_mean, bn.running_var), after_forward):
        assert torch.equal(got, once)
    assert torch.equal(bn.running_mean, plain.running_mean)
    assert torch.equal(bn.running_var, plain.running_var)
    assert bn.running_mean.abs().min() > 1e-3  # it did move, once


def test_remat_step_draws_each_dropout_mask_once():
    """Undrawn steps: the masks come from the key's ``cgen_dropout`` stream.
    Drawn again inside the recompute they would come from an advanced
    generator, and cgen's gradient would change as it does below under
    other masks."""
    remat, plain = _step({"remat": True}), _step({})
    grads = [p.grad for p in remat[0].cgen.parameters()]
    assert all(torch.equal(a, p.grad) for a, p in zip(grads, plain[0].cgen.parameters()))
    b, t = step_batch(3, np.uint8)["color"].shape[:2]
    other = plain[0].cgen.dropout_masks(b * t, torch.Generator().manual_seed(9), torch.device("cpu"))
    moved = _step({"remat": True}, draws=StepDraws(g_dropout=other))
    assert not all(torch.equal(a, p.grad) for a, p in zip(grads, moved[0].cgen.parameters()))


# -------------------------------------------------------------------- replays
LEVERS = {
    "shared_fakes": {"shared_fakes": True},
    "critic_joint_batch": {"critic_joint_batch": True},
    "critic_stat_reuse": {"critic_stat_reuse": True},
    "remat": {"remat": True},
    "ggen_double_step": {"ggen_double_step": True},
    "norm_group": {"norm": "group", "ema_decay": 0.5},
}


@pytest.mark.parametrize("lever", sorted(LEVERS))
def test_undrawn_step_under_each_lever_replays_from_its_key_and_varies_with_it(lever):
    def run(key):
        state, m = _step(LEVERS[lever], key=key)
        weights = sum(float(p.detach().double().sum()) for mod in state.models.values()
                      for p in mod.parameters())
        return [m[k].item() for k in LOSSES] + [weights]

    first = run(1)
    assert first == run(1) and first != run(2)


# ------------------------------------------------------------ every config
@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_every_config_builds_and_passes_the_lever_check(path):
    cfg = load_config(path)
    gan = PortGAN(cfg, device="cpu")
    gan._refuse_levers()
    for name in MODEL_NAMES:
        module = gan._build(name)
        assert sum(p.numel() for p in module.parameters()) > 0
