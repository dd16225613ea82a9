"""One training iteration of the port against ``DCVGAN.train_step`` of the
JAX package, from the same ``GANState`` and the same random draws.

The JAX step draws inside itself from named keys. Here each key is rebuilt
with the public ``dcvgan_tpu.prng`` functions and the flax modules are run
once outside ``jit`` with ``record_jax_draws`` to read the latents, dropout
masks and critic noise the step will draw; the port's step takes them as
``StepDraws``. The JAX package is not touched.

The JAX step is compiled for three configurations in all (module-scoped
fixtures): f32 adversarial with EMA and a uint8 batch, f32 hinge with gated
updates, and bf16.

Gradients are held against JAX's, and the optimizer separately on shared
gradients: Adam's first update is +-lr wherever the gradient is not 0, so a
parameter whose gradient is rounding noise may differ by 2 lr between the
packages after a whole step.

**The gradient tolerance.** On identical inputs the critics' gradients
agree with JAX's to 2e-4 of their size (``test_torch_discriminators.py``)
and the generators' to 1e-2 (``test_torch_layers_train.py``: BatchNorms
over 8 values amplify f32 rounding). Inside a step the critics' inputs are
not identical: the fakes come from the two packages' own generator
forwards, which differ by up to 1e-4 in f32 (12 layers with batch
statistics), and at these random weights the video critics' gradients are
sums of large cancelling terms: the JAX gradient itself moves by 1.5% of
its size when its fake inputs move by 1e-4 (measured). The image critic,
which sees one frame, agrees to 3e-5.
Measured over two seeds, per tensor and relative to the tensor's largest
gradient: up to 3.1e-2 (cgen), 1.7e-2 (vdis), 2.5e-3 (gdis); whole-model
relative L2 error up to 8.6e-3. Held at 8e-2 per tensor and 3e-2 in L2,
idis at 2e-4: a missing loss term, a wrong phase or stale fakes change
gradients by tens of percent.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcvgan_torch import prng as port_prng
from dcvgan_torch.compat.from_jax import load_gan_state_
from dcvgan_torch.train.state import MODEL_NAMES
from dcvgan_torch.train.step import DCVGAN as PortGAN
from dcvgan_tpu.train.step import DCVGAN as JaxGAN
from torch_port_util import (
    ATOL_F32, LOSSES, LR, flatten_tree, from_torch, gradients_close, jax_state, jax_trees,
    numpy_tree, port_state, port_tree, randomize_tree, run_pair, step_batch, step_configs, within,
)
from torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


# ----------------------------------------------------- f32, EMA, uint8 batch
@pytest.fixture(scope="module")
def f32_step():
    jcfg, pcfg = step_configs(trainer={"precision": "float32", "ema_decay": 0.9})
    return run_pair(jcfg, pcfg, seed=0, batch=step_batch(1, np.uint8))


def test_f32_step_losses_match_jax(f32_step):
    _, _, jafter, jm, _, pstate, pm = f32_step
    assert pstate.step == int(jafter.step) == 1
    for k in LOSSES:
        assert pm[k].dim() == 0 and pm[k].dtype == torch.float32
        within(pm[k].numpy(), np.asarray(jm[k]), ATOL_F32, ATOL_F32)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_f32_step_gradients_match_jax(f32_step, name):
    jgan, jbefore, jafter, _, _, pstate, _ = f32_step
    gradients_close(jgan, jbefore, jafter, pstate, name)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_f32_step_batch_norm_statistics_match_jax(f32_step, name):
    _, jbefore, jafter, _, _, pstate, _ = f32_step
    sd = {k: v.numpy() for k, v in getattr(pstate, name).state_dict().items()}
    got = flatten_tree(from_torch(name)(sd)[1])
    want = flatten_tree(numpy_tree(getattr(jafter, name).batch_stats))
    old = flatten_tree(numpy_tree(getattr(jbefore, name).batch_stats))
    assert set(got) == set(want) and got
    for k in want:
        within(got[k], want[k], ATOL_F32, ATOL_F32)
        assert np.abs(want[k] - old[k]).max() > 1e-3  # they did move


def test_f32_step_parameters_adam_state_and_ema_follow_jax(f32_step):
    """After a whole step: Adam took one step everywhere, every parameter is
    within 2.5 lr of JAX's (see the module docstring) and the EMA within
    (1 - decay) of that."""
    _, _, jafter, _, _, pstate, _ = f32_step
    for name in MODEL_NAMES:
        module = getattr(pstate, name)
        got = flatten_tree(port_tree(name, module, dict(module.named_parameters())))
        want = flatten_tree(numpy_tree(getattr(jafter, name).params))
        for k in want:
            within(got[k], want[k], 2.5 * LR)
        steps = {float(s["step"]) for s in pstate.opt[name].state.values()}
        assert steps == {1.0} and int(getattr(jafter, name).opt_state[1].count) == 1
        assert all(p.dtype == torch.float32 for p in module.parameters())
    for name in ("ggen", "cgen"):
        got = flatten_tree(port_tree(name, getattr(pstate, name), pstate.ema[name]))
        want = flatten_tree(numpy_tree(jafter.ema[name]))
        for k in want:
            within(got[k], want[k], 0.25 * LR + 1e-6)


def test_uint8_batch_equals_the_batch_dequantised_on_the_host(f32_step):
    jgan, jbefore, _, _, pgan, _, pm = f32_step
    state = port_state(pgan, jbefore)
    _, m = pgan.train_step(state, step_batch(1, np.float32), port_prng.base_key(3), pgan.last_draws)
    for k in LOSSES:
        assert m[k].item() == pm[k].item(), k
    xg, xc = pgan.ingest(step_batch(1, np.uint8))
    xg_f, xc_f = pgan.ingest(step_batch(1, np.float32))
    assert torch.equal(xg, xg_f) and torch.equal(xc, xc_f) and xc.dtype == torch.float32


# ------------------------------------------------- hinge and gated updates
@pytest.fixture(scope="module")
def gated():
    """``num_gen_update: 2`` and ``num_dis_update: 3`` under the hinge loss,
    from step 1 (so step 2: critics step, generators do not) and from step 2
    (step 3: the other way round). One compiled JAX step serves both."""
    jcfg, pcfg = step_configs(loss="hinge-loss", num_gen_update=2, num_dis_update=3)
    batch = step_batch(2, np.float32)
    return {s: run_pair(jcfg, pcfg, seed=s, batch=batch, step0=s) for s in (1, 2)}


@pytest.mark.parametrize("step0,stepping", [(1, ("idis", "vdis", "gdis")), (2, ("ggen", "cgen"))])
def test_gates_and_hinge_loss_match_jax(gated, step0, stepping):
    _, jbefore, jafter, jm, _, pstate, pm = gated[step0]
    assert pstate.step == int(jafter.step) == step0 + 1
    for k in LOSSES:
        within(pm[k].numpy(), np.asarray(jm[k]), ATOL_F32, ATOL_F32)
    for name in MODEL_NAMES:
        module = getattr(pstate, name)
        got = flatten_tree(port_tree(name, module, dict(module.named_parameters())))
        old = flatten_tree(numpy_tree(getattr(jbefore, name).params))
        count = int(getattr(jafter, name).opt_state[1].count)
        steps = {float(s["step"]) for s in pstate.opt[name].state.values()}
        if name in stepping:
            assert count == 1 and steps == {1.0}
            assert all(np.abs(got[k] - old[k]).max() > 0.5 * LR for k in old), name
        else:  # a shut gate leaves the parameters and Adam's count alone
            assert count == 0 and steps == {0.0}
            for k in old:
                np.testing.assert_array_equal(got[k], old[k])
        # ... while the running statistics advance all the same
        sd = {k: v.numpy() for k, v in module.state_dict().items()}
        stats = flatten_tree(from_torch(name)(sd)[1])
        want = flatten_tree(numpy_tree(getattr(jafter, name).batch_stats))
        for k in want:
            within(stats[k], want[k], ATOL_F32, ATOL_F32)


def test_hinge_generator_gradient_has_no_gdis_part(gated):
    # the hinge generator term omits gdis: with the generators stepping
    # (step 3), ggen's gradient equals JAX's, which has no gdis part either
    jgan, jbefore, jafter, _, _, pstate, _ = gated[2]
    gradients_close(jgan, jbefore, jafter, pstate, "ggen")
    gradients_close(jgan, jbefore, jafter, pstate, "cgen")


# --------------------------------------------------------------------- bf16
# bf16 compute over f32 parameters against the JAX package in bf16. The
# forward differences of the bf16 module tests pass through critics whose
# logits are O(1), and a softplus mean over 32 to 128 of them; measured over
# the four losses and two seeds: max |diff| 2.1e-3 (the generator loss,
# after the critics' Adam step); held at 1e-2.
BF16_LOSS_ATOL = 1e-2


def test_bf16_step_matches_jax_in_bf16_and_stays_finite():
    jcfg, pcfg = step_configs(trainer={"precision": "bfloat16"})
    _, _, jafter, jm, _, pstate, pm = run_pair(jcfg, pcfg, seed=4, batch=step_batch(5, np.uint8))
    for k in LOSSES:
        assert np.isfinite(pm[k].item())
        within(pm[k].numpy(), np.asarray(jm[k], np.float32), BF16_LOSS_ATOL)
    for name, module in pstate.models.items():
        for k, p in module.named_parameters():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, (name, k)
            assert torch.isfinite(p).all() and torch.isfinite(p.grad).all(), (name, k)
        for s in pstate.opt[name].state.values():
            assert s["exp_avg"].dtype == torch.float32
        for k, b in module.named_buffers():
            assert torch.isfinite(b.float()).all(), (name, k)
        # and the step moved the f32 masters by about lr, not by a bf16 ulp
        want = flatten_tree(numpy_tree(getattr(jafter, name).params))
        got = flatten_tree(port_tree(name, module, dict(module.named_parameters())))
        for k in want:
            within(got[k], want[k], 2.5 * LR)


# ------------------------------------------- the optimizer, shared gradients
@pytest.mark.parametrize("name", ["ggen", "idis", "gdis"])
def test_adam_matches_optax_over_three_steps_of_shared_gradients(name):
    jcfg, pcfg = step_configs()
    jgan, pgan = JaxGAN(jcfg), PortGAN(pcfg, device="cpu")
    jstate = jax_state(jgan, seed=6)
    pstate = port_state(pgan, jstate)
    module, opt = getattr(pstate, name), pstate.opt[name]
    params = getattr(jstate, name).params
    opt_state = jgan.tx[name].init(params)
    rng = np.random.default_rng(7)
    for _ in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)
                                                   * rng.choice([1e-6, 1e-2, 1.0])), params)
        # the same gradients into the port: through the weight conversion
        scratch = copy.deepcopy(pstate)
        load_gan_state_(scratch, {**jax_trees(jstate), name: {
            "params": numpy_tree(grads), "batch_stats": numpy_tree(getattr(jstate, name).batch_stats)}})
        for p, g in zip(module.parameters(), getattr(scratch, name).parameters()):
            p.grad = g.detach().clone()
        opt.step()
        updates, opt_state = jgan.tx[name].update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    got = flatten_tree(port_tree(name, module, dict(module.named_parameters())))
    for k, v in flatten_tree(numpy_tree(params)).items():
        within(got[k], v, 1e-6, 1e-6)
    by_param = {k: opt.state[p] for k, p in module.named_parameters()}
    for moment, want in (("exp_avg", opt_state[1].mu), ("exp_avg_sq", opt_state[1].nu)):
        got = flatten_tree(port_tree(name, module, {k: s[moment] for k, s in by_param.items()}))
        for k, v in flatten_tree(numpy_tree(want)).items():
            within(got[k], v, 1e-7, 1e-5)
    assert {float(s["step"]) for s in by_param.values()} == {3.0} and int(opt_state[1].count) == 3


def test_whole_state_crosses_from_jax_with_adam_moments_and_ema():
    jcfg, pcfg = step_configs(trainer={"precision": "float32", "ema_decay": 0.9})
    jgan, pgan = JaxGAN(jcfg), PortGAN(pcfg, device="cpu")
    jstate = jax_state(jgan, seed=8, step=7)
    trees = jax_trees(jstate)
    rng = np.random.default_rng(9)
    for name in MODEL_NAMES:  # non-trivial moments
        trees[name]["opt"] = {"count": 7, "mu": randomize_tree(trees[name]["params"], rng),
                              "nu": randomize_tree(trees[name]["params"], rng)}
    pstate = pgan.init_state(0)
    load_gan_state_(pstate, trees)
    assert pstate.step == 7
    for name in MODEL_NAMES:
        module = getattr(pstate, name)
        got = flatten_tree(port_tree(name, module, dict(module.named_parameters())))
        for k, v in flatten_tree(trees[name]["params"]).items():
            np.testing.assert_array_equal(got[k], v)
        by_param = {k: pstate.opt[name].state[p] for k, p in module.named_parameters()}
        mu = flatten_tree(port_tree(name, module, {k: s["exp_avg"] for k, s in by_param.items()}))
        for k, v in flatten_tree(trees[name]["opt"]["mu"]).items():
            np.testing.assert_array_equal(mu[k], v)
        assert {float(s["step"]) for s in by_param.values()} == {7.0}
    for name in ("ggen", "cgen"):
        got = flatten_tree(port_tree(name, getattr(pstate, name), pstate.ema[name]))
        for k, v in flatten_tree(trees["ema"][name]).items():
            np.testing.assert_array_equal(got[k], v)


# ------------------------------------------------------ multi-device layouts
@pytest.mark.parametrize("section,key,value", [
    ("trainer", "sync_batchnorm", False),
    ("mesh", "time", 2), ("mesh", "data", 4), ("mesh", "dcn", 2),
])
def test_each_lever_raises_not_implemented(section, key, value):
    """``mesh.time > 1`` is refused in a world of one rank: the time-sharded
    critics need the layout's time ranks (``test_torch_time_sharded_step.py``
    trains them). The data-parallel settings train: one process is a world
    of one rank, whatever the mesh asks (the trainer's ``create_layout``
    checks the mesh against the world), and per-replica statistics there
    are the rank's own."""
    _, pcfg = step_configs(**{section: {key: value}})
    gan = PortGAN(pcfg, device="cpu")
    if key == "time":
        with pytest.raises(ValueError, match="mesh.time=2 but this process's layout has 1 time"):
            gan.train_step(gan.init_state(0), step_batch(0, np.uint8), port_prng.base_key(0))
        return
    _, m = gan.train_step(gan.init_state(0), step_batch(0, np.uint8), port_prng.base_key(0))
    assert all(np.isfinite(m[k].item()) for k in LOSSES)


def test_undrawn_step_replays_from_its_key_and_varies_with_it():
    _, pcfg = step_configs(trainer={"precision": "float32", "ema_decay": 0.5})
    gan = PortGAN(pcfg, device="cpu")
    batch = step_batch(3, np.uint8)

    def run(seed):
        _, m = gan.train_step(gan.init_state(0), batch, port_prng.base_key(seed))
        return [m[k].item() for k in LOSSES]

    assert run(1) == run(1) and run(1) != run(2)
