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
from dcvgan_torch.config import ExperimentConfig as PortConfig
from dcvgan_torch.train.state import MODEL_NAMES
from dcvgan_torch.train.step import DCVGAN as PortGAN
from dcvgan_torch.train.step import Latents, StepDraws
from dcvgan_tpu import prng as jax_prng
from dcvgan_tpu.compat import (
    cgen_from_torch, gdis_from_torch, ggen_from_torch, idis_from_torch, vdis_from_torch,
)
from dcvgan_tpu.config import ExperimentConfig as JaxConfig
from dcvgan_tpu.models import ColorVideoGenerator as JaxCGen
from dcvgan_tpu.train.state import GANState as JaxGANState
from dcvgan_tpu.train.state import ModelState
from dcvgan_tpu.train.step import DCVGAN as JaxGAN
from torch_port_util import (
    ATOL_F32, as_tensors, numpy_tree, randomize_tree, record_jax_draws, within,
)

B, T, S = 2, 16, 64
FROM_TORCH = {"ggen": ggen_from_torch, "cgen": cgen_from_torch, "idis": idis_from_torch,
              "vdis": vdis_from_torch, "gdis": gdis_from_torch}
LOSSES = ("loss_idis", "loss_vdis", "loss_gdis", "loss_gen")
LR = 2e-4


def _raw(**over):
    raw = {
        "batchsize": B, "seed": 0, "video_length": T, "image_size": S,
        "geometric_info": {"name": "depth", "channel": 1},
        "ggen": {"dim_z_content": 8, "dim_z_motion": 4, "ngf": 8},
        "cgen": {"dim_z_color": 4, "ngf": 8},
        "idis": {"use_noise": True, "noise_sigma": 0.1, "ndf": 8},
        "vdis": {"use_noise": True, "noise_sigma": 0.1, "ndf": 8},
        "gdis": {"use_noise": False, "noise_sigma": 0.2, "ndf": 8},
        "trainer": {"precision": "float32"},
    }
    for k, v in over.items():
        raw[k] = {**raw.get(k, {}), **v} if isinstance(v, dict) else v
    return raw


def _configs(**over):
    raw = _raw(**over)
    jcfg, pcfg = JaxConfig.from_dict(copy.deepcopy(raw)), PortConfig.from_dict(copy.deepcopy(raw))
    jcfg.trainer.donate_state = False
    jcfg.validate()
    pcfg.validate()
    return jcfg, pcfg


def _batch(seed, dtype):
    rng = np.random.default_rng(seed)
    u8 = {"color": rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8),
          "depth": rng.integers(0, 256, (B, T, S, S, 1), dtype=np.uint8)}
    if dtype == np.uint8:
        return u8
    return {k: v.astype(np.float32) / np.float32(127.5) - np.float32(1.0) for k, v in u8.items()}


def _jax_state(gan: JaxGAN, seed: int, step: int = 0) -> JaxGANState:
    """A JAX state whose parameters and statistics are drawn at a scale that
    keeps activations O(1), with fresh Adam states."""
    template = jax.eval_shape(lambda: gan.init_state(jax_prng.base_key(0)))
    rng = np.random.default_rng(seed)
    models = {}
    for name in MODEL_NAMES:
        ms = getattr(template, name)
        params = jax.tree.map(jnp.asarray, randomize_tree(ms.params, rng))
        stats = jax.tree.map(jnp.asarray, randomize_tree(ms.batch_stats, rng))
        models[name] = ModelState(params=params, batch_stats=stats,
                                  opt_state=gan.tx[name].init(params))
    ema = None
    if gan.config.trainer.ema_decay > 0:
        ema = {n: jax.tree.map(jnp.asarray, randomize_tree(getattr(template, n).params, rng))
               for n in ("ggen", "cgen")}
    return JaxGANState(step=jnp.asarray(step, jnp.int32), ema=ema, **models)


def _trees(state: JaxGANState) -> dict:
    trees = {"step": int(state.step), "ema": None if state.ema is None else numpy_tree(state.ema)}
    for name, ms in state.models.items():
        adam = ms.opt_state[1]
        trees[name] = {
            "params": numpy_tree(ms.params), "batch_stats": numpy_tree(ms.batch_stats),
            "opt": {"count": int(adam.count), "mu": numpy_tree(adam.mu), "nu": numpy_tree(adam.nu)},
        }
    return trees


def _port_state(pgan: PortGAN, jstate: JaxGANState):
    state = pgan.init_state(0)
    load_gan_state_(state, _trees(jstate))
    return state


def _draws(gan: JaxGAN, state: JaxGANState, key, step: int) -> StepDraws:
    """The draws ``gan.train_step`` makes at 1-based ``step`` under ``key``."""
    cfg = gan.config
    kstep = jax_prng.for_step(key, step)
    t_rand = int(jax.random.randint(jax_prng.named(kstep, "t_rand"), (), 0, cfg.video_length))
    gv = {"params": state.ggen.params, "batch_stats": state.ggen.batch_stats}
    cv = {"params": state.cgen.params, "batch_stats": state.cgen.batch_stats}

    def fakes(k):
        (xg, _), d = record_jax_draws(lambda: gan.ggen.apply(
            gv, B, train=True, rngs={"latent": jax_prng.named(k, "ggen_motion")},
            mutable=["batch_stats"]))
        _, dc = record_jax_draws(lambda: gan.cgen.apply(
            cv, xg, train=True,
            rngs={"latent": jax_prng.named(k, "cgen_color"),
                  "dropout": jax_prng.named(k, "cgen_dropout")},
            mutable=["batch_stats"], method=JaxCGen.forward_videos))
        z = d["z"][0].reshape(B, T, -1)
        lat = Latents(*as_tensors([z[:, 0, : cfg.ggen.dim_z_content], d["e"][0], d["h0"][0],
                                   dc["z_color"][0].reshape(B, T, -1)[:, 0]]))
        return lat, as_tensors(dc["dropout"])

    def noise(name, k):
        lead = (B, S, S) if name == "idis" else (B, T, S, S)
        ms = getattr(state, name)
        _, d = record_jax_draws(lambda: gan.modules[name].apply(
            {"params": ms.params, "batch_stats": ms.batch_stats},
            jnp.zeros(lead + (1,), gan.dtype), jnp.zeros(lead + (3,), gan.dtype), True,
            rngs={"noise": k}, mutable=["batch_stats"]))
        return as_tensors(d["noise"][0])

    kd, kg = jax_prng.named(kstep, "d_fake"), jax_prng.named(kstep, "g_fake")
    d_lat, d_drop = fakes(kd)
    g_lat, g_drop = fakes(kg)
    d_noise, g_noise = {}, {}
    for name in ("idis", "vdis", "gdis"):
        nkey = jax_prng.named(kstep, f"{name}_noise")
        d_noise[name] = {"real": noise(name, jax_prng.named(nkey, "d_fake")),
                         "fake": noise(name, jax_prng.named(nkey, "g_fake"))}
        g_noise[name] = noise(name, jax_prng.named(kg, f"{name}_noise"))
    return StepDraws(t_rand, d_lat, g_lat, d_drop, g_drop, d_noise, g_noise)


def _port_tree(name, module, values):
    """Per-parameter tensors of ``module`` (gradients, say) as a flax tree."""
    sd = {k: v.detach().clone() for k, v in module.state_dict().items()}
    for k, v in values.items():
        if k == "recurrent.bias_hn":
            sd["recurrent.bias_hh"] = torch.cat([torch.zeros(2 * v.numel()), v.detach()])
        else:
            sd[k] = v.detach()
    return FROM_TORCH[name]({k: v.numpy() for k, v in sd.items()})[0]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _jax_grads(before: JaxGANState, after: JaxGANState, name: str, cfg):
    """The gradient the JAX step fed Adam, from its first moment: from zero
    moments ``mu = (1 - b1) * (g + decay * p)``."""
    opt = getattr(cfg, name).optimizer
    mu = _flat(numpy_tree(getattr(after, name).opt_state[1].mu))
    p = _flat(numpy_tree(getattr(before, name).params))
    return {k: mu[k] / np.float32(1.0 - opt.b1) - np.float32(opt.decay) * p[k] for k in mu}


def _run_pair(jcfg, pcfg, seed, batch, step0=0):
    jgan, pgan = JaxGAN(jcfg), PortGAN(pcfg, device="cpu")
    jstate = _jax_state(jgan, seed, step0)
    pstate = _port_state(pgan, jstate)
    key = jax_prng.base_key(3)
    draws = _draws(jgan, jstate, key, step0 + 1)
    jafter, jmetrics = jgan.jitted_train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    pstate, pmetrics = pgan.train_step(pstate, batch, port_prng.base_key(3), draws)
    pgan.last_draws = draws
    return jgan, jstate, jafter, jmetrics, pgan, pstate, pmetrics


# ----------------------------------------------------- f32, EMA, uint8 batch
@pytest.fixture(scope="module")
def f32_step():
    jcfg, pcfg = _configs(trainer={"precision": "float32", "ema_decay": 0.9})
    return _run_pair(jcfg, pcfg, seed=0, batch=_batch(1, np.uint8))


def test_f32_step_losses_match_jax(f32_step):
    _, _, jafter, jm, _, pstate, pm = f32_step
    assert pstate.step == int(jafter.step) == 1
    for k in LOSSES:
        assert pm[k].dim() == 0 and pm[k].dtype == torch.float32
        within(pm[k].numpy(), np.asarray(jm[k]), ATOL_F32, ATOL_F32)


GRAD_RTOL, GRAD_L2 = 8e-2, 3e-2  # see the module docstring


def _gradients_close(jgan, jbefore, jafter, pstate, name):
    want = _jax_grads(jbefore, jafter, name, jgan.config)
    module = getattr(pstate, name)
    got = _flat(_port_tree(name, module, {k: p.grad for k, p in module.named_parameters()}))
    assert set(got) == set(want) and len(got) > 3
    rtol = ATOL_F32 if name == "idis" else GRAD_RTOL
    for k, g in want.items():
        scale = float(np.abs(g).max())
        assert scale > 0, k
        within(got[k], g, rtol * scale + 1e-6)
    a = np.concatenate([got[k].ravel() for k in want])
    b = np.concatenate([want[k].ravel() for k in want])
    assert np.linalg.norm(a - b) <= GRAD_L2 * np.linalg.norm(b)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_f32_step_gradients_match_jax(f32_step, name):
    jgan, jbefore, jafter, _, _, pstate, _ = f32_step
    _gradients_close(jgan, jbefore, jafter, pstate, name)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_f32_step_batch_norm_statistics_match_jax(f32_step, name):
    _, jbefore, jafter, _, _, pstate, _ = f32_step
    sd = {k: v.numpy() for k, v in getattr(pstate, name).state_dict().items()}
    got = _flat(FROM_TORCH[name](sd)[1])
    want = _flat(numpy_tree(getattr(jafter, name).batch_stats))
    old = _flat(numpy_tree(getattr(jbefore, name).batch_stats))
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
        got = _flat(_port_tree(name, module, dict(module.named_parameters())))
        want = _flat(numpy_tree(getattr(jafter, name).params))
        for k in want:
            within(got[k], want[k], 2.5 * LR)
        steps = {float(s["step"]) for s in pstate.opt[name].state.values()}
        assert steps == {1.0} and int(getattr(jafter, name).opt_state[1].count) == 1
        assert all(p.dtype == torch.float32 for p in module.parameters())
    for name in ("ggen", "cgen"):
        got = _flat(_port_tree(name, getattr(pstate, name), pstate.ema[name]))
        want = _flat(numpy_tree(jafter.ema[name]))
        for k in want:
            within(got[k], want[k], 0.25 * LR + 1e-6)


def test_uint8_batch_equals_the_batch_dequantised_on_the_host(f32_step):
    jgan, jbefore, _, _, pgan, _, pm = f32_step
    state = _port_state(pgan, jbefore)
    _, m = pgan.train_step(state, _batch(1, np.float32), port_prng.base_key(3), pgan.last_draws)
    for k in LOSSES:
        assert m[k].item() == pm[k].item(), k
    xg, xc = pgan.ingest(_batch(1, np.uint8))
    xg_f, xc_f = pgan.ingest(_batch(1, np.float32))
    assert torch.equal(xg, xg_f) and torch.equal(xc, xc_f) and xc.dtype == torch.float32


# ------------------------------------------------- hinge and gated updates
@pytest.fixture(scope="module")
def gated():
    """``num_gen_update: 2`` and ``num_dis_update: 3`` under the hinge loss,
    from step 1 (so step 2: critics step, generators do not) and from step 2
    (step 3: the other way round). One compiled JAX step serves both."""
    jcfg, pcfg = _configs(loss="hinge-loss", num_gen_update=2, num_dis_update=3)
    batch = _batch(2, np.float32)
    return {s: _run_pair(jcfg, pcfg, seed=s, batch=batch, step0=s) for s in (1, 2)}


@pytest.mark.parametrize("step0,stepping", [(1, ("idis", "vdis", "gdis")), (2, ("ggen", "cgen"))])
def test_gates_and_hinge_loss_match_jax(gated, step0, stepping):
    _, jbefore, jafter, jm, _, pstate, pm = gated[step0]
    assert pstate.step == int(jafter.step) == step0 + 1
    for k in LOSSES:
        within(pm[k].numpy(), np.asarray(jm[k]), ATOL_F32, ATOL_F32)
    for name in MODEL_NAMES:
        module = getattr(pstate, name)
        got = _flat(_port_tree(name, module, dict(module.named_parameters())))
        old = _flat(numpy_tree(getattr(jbefore, name).params))
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
        stats = _flat(FROM_TORCH[name](sd)[1])
        want = _flat(numpy_tree(getattr(jafter, name).batch_stats))
        for k in want:
            within(stats[k], want[k], ATOL_F32, ATOL_F32)


def test_hinge_generator_gradient_has_no_gdis_part(gated):
    # the hinge generator term omits gdis: with the generators stepping
    # (step 3), ggen's gradient equals JAX's, which has no gdis part either
    jgan, jbefore, jafter, _, _, pstate, _ = gated[2]
    _gradients_close(jgan, jbefore, jafter, pstate, "ggen")
    _gradients_close(jgan, jbefore, jafter, pstate, "cgen")


# --------------------------------------------------------------------- bf16
# bf16 compute over f32 parameters against the JAX package in bf16. The
# forward differences of the bf16 module tests pass through critics whose
# logits are O(1), and a softplus mean over 32 to 128 of them; measured over
# the four losses and two seeds: max |diff| 2.1e-3 (the generator loss,
# after the critics' Adam step); held at 1e-2.
BF16_LOSS_ATOL = 1e-2


def test_bf16_step_matches_jax_in_bf16_and_stays_finite():
    jcfg, pcfg = _configs(trainer={"precision": "bfloat16"})
    _, _, jafter, jm, _, pstate, pm = _run_pair(jcfg, pcfg, seed=4, batch=_batch(5, np.uint8))
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
        want = _flat(numpy_tree(getattr(jafter, name).params))
        got = _flat(_port_tree(name, module, dict(module.named_parameters())))
        for k in want:
            within(got[k], want[k], 2.5 * LR)


# ------------------------------------------- the optimizer, shared gradients
@pytest.mark.parametrize("name", ["ggen", "idis", "gdis"])
def test_adam_matches_optax_over_three_steps_of_shared_gradients(name):
    jcfg, pcfg = _configs()
    jgan, pgan = JaxGAN(jcfg), PortGAN(pcfg, device="cpu")
    jstate = _jax_state(jgan, seed=6)
    pstate = _port_state(pgan, jstate)
    module, opt = getattr(pstate, name), pstate.opt[name]
    params = getattr(jstate, name).params
    opt_state = jgan.tx[name].init(params)
    rng = np.random.default_rng(7)
    for _ in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)
                                                   * rng.choice([1e-6, 1e-2, 1.0])), params)
        # the same gradients into the port: through the weight conversion
        scratch = copy.deepcopy(pstate)
        load_gan_state_(scratch, {**_trees(jstate), name: {
            "params": numpy_tree(grads), "batch_stats": numpy_tree(getattr(jstate, name).batch_stats)}})
        for p, g in zip(module.parameters(), getattr(scratch, name).parameters()):
            p.grad = g.detach().clone()
        opt.step()
        updates, opt_state = jgan.tx[name].update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    got = _flat(_port_tree(name, module, dict(module.named_parameters())))
    for k, v in _flat(numpy_tree(params)).items():
        within(got[k], v, 1e-6, 1e-6)
    by_param = {k: opt.state[p] for k, p in module.named_parameters()}
    for moment, want in (("exp_avg", opt_state[1].mu), ("exp_avg_sq", opt_state[1].nu)):
        got = _flat(_port_tree(name, module, {k: s[moment] for k, s in by_param.items()}))
        for k, v in _flat(numpy_tree(want)).items():
            within(got[k], v, 1e-7, 1e-5)
    assert {float(s["step"]) for s in by_param.values()} == {3.0} and int(opt_state[1].count) == 3


def test_whole_state_crosses_from_jax_with_adam_moments_and_ema():
    jcfg, pcfg = _configs(trainer={"precision": "float32", "ema_decay": 0.9})
    jgan, pgan = JaxGAN(jcfg), PortGAN(pcfg, device="cpu")
    jstate = _jax_state(jgan, seed=8, step=7)
    trees = _trees(jstate)
    rng = np.random.default_rng(9)
    for name in MODEL_NAMES:  # non-trivial moments
        trees[name]["opt"] = {"count": 7, "mu": randomize_tree(trees[name]["params"], rng),
                              "nu": randomize_tree(trees[name]["params"], rng)}
    pstate = pgan.init_state(0)
    load_gan_state_(pstate, trees)
    assert pstate.step == 7
    for name in MODEL_NAMES:
        module = getattr(pstate, name)
        got = _flat(_port_tree(name, module, dict(module.named_parameters())))
        for k, v in _flat(trees[name]["params"]).items():
            np.testing.assert_array_equal(got[k], v)
        by_param = {k: pstate.opt[name].state[p] for k, p in module.named_parameters()}
        mu = _flat(_port_tree(name, module, {k: s["exp_avg"] for k, s in by_param.items()}))
        for k, v in _flat(trees[name]["opt"]["mu"]).items():
            np.testing.assert_array_equal(mu[k], v)
        assert {float(s["step"]) for s in by_param.values()} == {7.0}
    for name in ("ggen", "cgen"):
        got = _flat(_port_tree(name, getattr(pstate, name), pstate.ema[name]))
        for k, v in _flat(trees["ema"][name]).items():
            np.testing.assert_array_equal(got[k], v)


# ------------------------------------------------------------------- levers
@pytest.mark.parametrize("section,key,value", [
    ("trainer", "shared_fakes", True), ("trainer", "critic_joint_batch", True),
    ("trainer", "critic_stat_reuse", True), ("trainer", "remat", True),
    ("trainer", "ggen_double_step", True), ("trainer", "sync_batchnorm", False),
    ("mesh", "time", 2), ("mesh", "data", 4), ("mesh", "dcn", 2),
])
def test_each_lever_raises_not_implemented(section, key, value):
    _, pcfg = _configs(**{section: {key: value}})
    gan = PortGAN(pcfg, device="cpu")
    with pytest.raises(NotImplementedError, match=key):
        gan.train_step(gan.init_state(0), _batch(0, np.uint8), port_prng.base_key(0))


def test_group_norm_raises_not_implemented():
    _, pcfg = _configs(trainer={"norm": "group"})
    with pytest.raises(NotImplementedError, match="norm"):
        PortGAN(pcfg, device="cpu")


def test_undrawn_step_replays_from_its_key_and_varies_with_it():
    _, pcfg = _configs(trainer={"precision": "float32", "ema_decay": 0.5})
    gan = PortGAN(pcfg, device="cpu")
    batch = _batch(3, np.uint8)

    def run(seed):
        _, m = gan.train_step(gan.init_state(0), batch, port_prng.base_key(seed))
        return [m[k].item() for k in LOSSES]

    assert run(1) == run(1) and run(1) != run(2)
