"""Train-mode layers and generators of the port against the JAX package.

BatchNorm's train-mode output and stored statistics against flax's, the
two generators' train-mode forwards with injected latents and dropout masks,
and the GRU cell's parametrisation under one Adam step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcvgan_torch.compat.from_jax import cgen_from_jax, ggen_from_jax
from dcvgan_torch.config import OptimizerConfig
from dcvgan_torch.models.cgen import ColorVideoGenerator as PortCGen
from dcvgan_torch.models.ggen import GeometricVideoGenerator as PortGGen
from dcvgan_torch.models.layers import Noise, batch_norm, batch_norm3d, place_for_training
from dcvgan_torch.train.step import make_optimizer as port_make_optimizer
from dcvgan_tpu.compat import cgen_from_torch, ggen_from_torch
from dcvgan_tpu.config import OptimizerConfig as JaxOptimizerConfig
from dcvgan_tpu.models import ColorVideoGenerator as JaxCGen
from dcvgan_tpu.models import GeometricVideoGenerator as JaxGGen
from dcvgan_tpu.models.layers import batch_norm as jax_batch_norm
from dcvgan_tpu.train.step import make_optimizer as jax_make_optimizer
from torch_port_util import ATOL_F32, NGF, nchw, randomize_tree, record_jax_draws, within
from torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

DZC, DZM, DZ_COLOR, B, T = 6, 4, 4, 2, 4
CPU = torch.device("cpu")
# normalised outputs agree near 1e-5 in f32 (flax takes the variance as
# E[x^2] - E[x]^2, torch by Welford's sums); bf16 outputs are each rounded
# once from f32 values that far apart: one bf16 ulp of values up to 4
BN_ATOL_F32, BN_ATOL_BF16 = 2e-5, 2.0**-6
# generator frames in [-1, 1], bf16 against JAX in bf16: the roundings of the
# eval-mode cases (test_torch_ggen, test_torch_cgen) here also move the batch
# statistics of 8 frames, which every pixel of a channel then shares.
# Measured over three seeds: max |diff| 5.8e-2 (ggen), 4.9e-2 (cgen), mean
# 3.8e-3 and 3.0e-3; held at max 8e-2, mean 6e-3. The stored statistics are
# f32 sums over bf16 activations and are held at the same maximum.
GEN_BF16_ATOL, GEN_BF16_MEAN = 8e-2, 6e-3
GEN_GRAD_RTOL = 3e-2  # see test_generator_gradients_match_jax_on_the_same_draws


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(6, 5, 5, 8), (3, 4, 5, 5, 8)], ids=["2d", "3d"])
def test_batch_norm_train_mode_matches_flax(shape, dtype):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    rng = np.random.default_rng(len(shape))
    c = shape[-1]
    x = (rng.normal(size=shape) * rng.uniform(0.5, 2, c) + rng.normal(size=c)).astype(np.float32)
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": rng.normal(size=c).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(size=c).astype(np.float32),
                        "var": rng.uniform(0.5, 2, c).astype(np.float32)},
    }
    jx = jnp.asarray(x).astype(jdt)
    want, mut = jax_batch_norm(True, jdt, None).apply(variables, jx, mutable=["batch_stats"])
    bn = (batch_norm if len(shape) == 4 else batch_norm3d)(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
        tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt).movedim(-1, 1)
        got = bn(tx, train=True)
        assert got.dtype == tdt
        within(got.movedim(1, -1).float().numpy(), np.asarray(want, np.float32),
               BN_ATOL_BF16 if dtype == "bf16" else BN_ATOL_F32)
        # the stored variance is the biased one, as flax stores it
        within(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), 1e-6)
        within(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), 1e-5)
        # ... and not the unbiased one torch's own BatchNorm would store
        batch_var = tx.float().movedim(1, 0).reshape(c, -1).var(1).numpy()
        unbiased = 0.9 * variables["batch_stats"]["var"] + 0.1 * batch_var
        assert np.abs(bn.running_var.numpy() - unbiased).max() > 1e-4
        # eval mode reads the statistics and writes nothing
        stored = bn.running_var.clone()
        want_eval = jax_batch_norm(False, jdt, None).apply(
            {"params": variables["params"], "batch_stats": mut["batch_stats"]}, jx)
        within(bn(tx).movedim(1, -1).float().numpy(), np.asarray(want_eval, np.float32),
               BN_ATOL_BF16 if dtype == "bf16" else BN_ATOL_F32)
        assert torch.equal(bn.running_var, stored)


def test_noise_is_a_static_flag():
    x = torch.ones(2, 3)
    draw = torch.full((2, 3), 2.0)
    assert torch.equal(Noise(False, 0.5)(x, draw), x)
    assert torch.equal(Noise(True, 0.5)(x, draw), x + 1.0)


def _ggen(jdt, tdt, seed):
    kw = dict(dim_z_content=DZC, dim_z_motion=DZM, channel=1, ngf=NGF, video_length=T)
    jm = JaxGGen(dtype=jdt, **kw)
    v = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "latent": jax.random.key(1)}, 1, train=False))
    rng = np.random.default_rng(seed)
    variables = {"params": randomize_tree(v["params"], rng),
                 "batch_stats": randomize_tree(v["batch_stats"], rng)}
    pm = PortGGen(**kw)
    pm.load_state_dict(ggen_from_jax(variables["params"], variables["batch_stats"]))
    return jm, variables, place_for_training(pm, CPU, tdt)


def _cgen(jdt, tdt, seed, geo="depth", in_ch=1):
    jm = JaxCGen(in_ch=in_ch, dim_z=DZ_COLOR, geometric_info=geo, ngf=NGF, video_length=T, dtype=jdt)
    v = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 64, 64, in_ch)), jnp.zeros((1, DZ_COLOR)), train=False))
    rng = np.random.default_rng(seed)
    variables = {"params": randomize_tree(v["params"], rng),
                 "batch_stats": randomize_tree(v["batch_stats"], rng)}
    pm = PortCGen(in_ch=in_ch, dim_z=DZ_COLOR, geometric_info=geo, ngf=NGF, video_length=T)
    pm.load_state_dict(cgen_from_jax(variables["params"], variables["batch_stats"]))
    return jm, variables, place_for_training(pm, CPU, tdt)


def _frames_close(got, want, atol):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    within(got, want, atol)
    if atol == GEN_BF16_ATOL:
        assert np.abs(got - want).mean() <= GEN_BF16_MEAN


def _stats_close(port_module, from_torch, jax_stats, atol):
    _, got = from_torch({k: v.numpy() for k, v in port_module.state_dict().items()})
    assert set(got) == set(jax_stats)
    for bn, s in got.items():
        within(s["mean"], np.asarray(jax_stats[bn]["mean"]), atol)
        within(s["var"], np.asarray(jax_stats[bn]["var"]), atol)


@pytest.mark.parametrize(
    "jdt,tdt,atol", [(jnp.float32, torch.float32, ATOL_F32), (jnp.bfloat16, torch.bfloat16, GEN_BF16_ATOL)],
    ids=["f32", "bf16"])
def test_ggen_train_mode_matches_jax(jdt, tdt, atol):
    jm, variables, pm = _ggen(jdt, tdt, seed=0)
    (want, mut), draws = record_jax_draws(lambda: jm.apply(
        variables, B, train=True, rngs={"latent": jax.random.key(3)}, mutable=["batch_stats"]))
    e, h0 = draws["e"][0], draws["h0"][0]
    z_content = draws["z"][0].reshape(B, T, -1)[:, 0, :DZC]
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    with torch.no_grad():
        quiet = pm(torch.from_numpy(z_content), torch.from_numpy(e), torch.from_numpy(h0),
                   train=True, update_stats=False)
        assert all(torch.equal(v, before[k]) for k, v in pm.state_dict().items())
        got = pm(torch.from_numpy(z_content), torch.from_numpy(e), torch.from_numpy(h0), train=True)
    assert torch.equal(got, quiet) and got.dtype == tdt
    _frames_close(got, want, atol)
    _stats_close(pm, ggen_from_torch, mut["batch_stats"], atol)


@pytest.mark.parametrize(
    "jdt,tdt,atol", [(jnp.float32, torch.float32, ATOL_F32), (jnp.bfloat16, torch.bfloat16, GEN_BF16_ATOL)],
    ids=["f32", "bf16"])
def test_cgen_train_mode_matches_jax_with_the_same_dropout_masks(jdt, tdt, atol):
    jm, variables, pm = _cgen(jdt, tdt, seed=1)
    xs = np.random.default_rng(2).uniform(-1, 1, (B, T, 64, 64, 1)).astype(np.float32)
    (want, mut), draws = record_jax_draws(lambda: jm.apply(
        variables, jnp.asarray(xs, jdt), train=True,
        rngs={"latent": jax.random.key(4), "dropout": jax.random.key(5)},
        mutable=["batch_stats"], method=JaxCGen.forward_videos))
    masks = [torch.from_numpy(m) for m in draws["dropout"]]
    assert len(masks) == 2 and masks[0].shape == (B * T, 4 * NGF) and masks[0].dtype == torch.bool
    z = torch.from_numpy(draws["z_color"][0].reshape(B, T, -1)[:, 0])
    with torch.no_grad():
        got = pm.forward_videos(torch.from_numpy(xs), z, train=True, dropout_masks=masks)
    assert got.shape == (B, T, 64, 64, 3) and got.dtype == tdt
    _frames_close(got, want, atol)
    _stats_close(pm, cgen_from_torch, mut["batch_stats"], atol)
    with torch.no_grad():  # other masks, another output: the masks are used
        other = pm.forward_videos(torch.from_numpy(xs), z, train=True, update_stats=False,
                                  dropout_masks=[~m for m in masks])
    assert not torch.allclose(other.float(), got.float(), atol=1e-3)


def test_generator_gradients_match_jax_on_the_same_draws():
    """ggen into cgen, train mode: every parameter's gradient of a scalar
    loss of the videos, relative to the tensor's largest gradient (or to a
    twentieth of the model's largest where the tensor's own is smaller: a
    BatchNorm's gradient ahead of another BatchNorm is a residual of terms
    that cancel).

    The colour generator's innermost BatchNorms normalise 8 to 32 values per
    channel here (1x1 and 2x2 pixels of 8 frames) and their backward passes
    divide by those values' variance, which amplifies the f32 rounding
    differences between the frameworks' forward passes (1e-5). Measured:
    up to 9.7e-3 (cgen) and 4.0e-3 (ggen); held at 3e-2. A wrong mask, a
    missing skip or a detached path changes gradients by tens of percent."""
    jg, gv, pg = _ggen(jnp.float32, torch.float32, seed=10)
    jc, cv, pc = _cgen(jnp.float32, torch.float32, seed=11)
    target = np.random.default_rng(12).uniform(-1, 1, (B, T, 64, 64, 3)).astype(np.float32)
    rngs_g = {"latent": jax.random.key(3)}
    rngs_c = {"latent": jax.random.key(4), "dropout": jax.random.key(5)}

    def loss(gp, cp):
        xg, _ = jg.apply({"params": gp, "batch_stats": gv["batch_stats"]}, B, train=True,
                         rngs=rngs_g, mutable=["batch_stats"])
        xc, _ = jc.apply({"params": cp, "batch_stats": cv["batch_stats"]}, xg, train=True,
                         rngs=rngs_c, mutable=["batch_stats"], method=JaxCGen.forward_videos)
        return jnp.mean((xc - target) ** 2) + jnp.mean(xg ** 2)

    _, draws = record_jax_draws(lambda: loss(gv["params"], cv["params"]))
    want_g, want_c = jax.grad(loss, argnums=(0, 1))(gv["params"], cv["params"])
    z = draws["z"][0].reshape(B, T, -1)
    xg = pg(torch.from_numpy(z[:, 0, :DZC]), torch.from_numpy(draws["e"][0]),
            torch.from_numpy(draws["h0"][0]), train=True, update_stats=False)
    xc = pc.forward_videos(
        xg, torch.from_numpy(draws["z_color"][0].reshape(B, T, -1)[:, 0]), train=True,
        update_stats=False, dropout_masks=[torch.from_numpy(m) for m in draws["dropout"]])
    (((xc - torch.from_numpy(target)) ** 2).mean() + (xg ** 2).mean()).backward()
    for module, from_torch, want in ((pg, ggen_from_torch, want_g), (pc, cgen_from_torch, want_c)):
        sd = {k: v.detach().clone() for k, v in module.state_dict().items()}
        for k, p in module.named_parameters():
            if k == "recurrent.bias_hn":
                sd["recurrent.bias_hh"] = torch.cat([torch.zeros(2 * DZM), p.grad])
            else:
                sd[k] = p.grad
        got, _ = from_torch({k: v.numpy() for k, v in sd.items()})

        floor = 0.05 * max(float(jnp.abs(g).max()) for g in jax.tree.leaves(want))

        def check(got, want):
            for k, v in want.items():
                if isinstance(v, dict):
                    check(got[k], v)
                else:
                    v = np.asarray(v)
                    within(got[k], v, GEN_GRAD_RTOL * max(float(np.abs(v).max()), floor))

        check(got, want)


def test_cgen_dropout_from_a_generator_keeps_half_and_doubles():
    _, _, pm = _cgen(jnp.float32, torch.float32, seed=3)
    x = nchw(np.random.default_rng(4).uniform(-1, 1, (8, 64, 64, 1)).astype(np.float32))
    z = torch.zeros(8, DZ_COLOR)
    def masks(seed):
        return pm.dropout_masks(8, torch.Generator().manual_seed(seed), x.device)

    with torch.no_grad():
        a = pm(x, z, train=True, update_stats=False, dropout_masks=masks(1))
        b = pm(x, z, train=True, update_stats=False, dropout_masks=masks(1))
        c = pm(x, z, train=True, update_stats=False, dropout_masks=masks(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_cgen_segmentation_passes_no_gradient_to_its_input():
    jm, variables, pm = _cgen(jnp.float32, torch.float32, seed=5, geo="segmentation", in_ch=25)
    x = np.random.default_rng(6).uniform(0, 1, (B, 64, 64, 25)).astype(np.float32)
    z = np.random.default_rng(7).normal(size=(B, DZ_COLOR)).astype(np.float32)
    xt = nchw(x).requires_grad_(True)
    masks = [torch.ones(B, 4 * NGF, dtype=torch.bool)] * 2
    y = pm(xt, torch.from_numpy(z), train=True, update_stats=False, dropout_masks=masks)
    w = pm.inconv.main[0].weight
    gw, gx = torch.autograd.grad(y.sum(), [w, xt], allow_unused=True)
    assert gx is None and gw.abs().sum() > 0
    gx_jax = jax.grad(lambda x: jm.apply(
        variables, x, jnp.asarray(z), train=True, rngs={"dropout": jax.random.key(0)},
        mutable=["batch_stats"])[0].sum())(jnp.asarray(x))
    assert float(jnp.abs(gx_jax).max()) == 0.0


# ---------------------------------------------------------------- GRU + Adam
def test_gru_biases_move_as_the_flax_cell_under_adam():
    """One Adam step on the GRU from the same weights and the gradients of a
    shared scalar loss: the r and z biases (one vector each in flax, two in
    ``nn.GRUCell``, whose sum would move twice as far) move alike."""
    jm, variables, pm = _ggen(jnp.float32, torch.float32, seed=8)
    rng = np.random.default_rng(9)
    e = rng.normal(size=(B, T, DZM)).astype(np.float32)
    h0 = rng.normal(size=(B, DZM)).astype(np.float32)
    target = rng.normal(size=(B, T, DZM)).astype(np.float32)

    cell0 = variables["params"]["recurrent"]["cell"]

    def jax_loss(cell):
        params = {**variables["params"], "recurrent": {"cell": cell}}
        states = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          jnp.asarray(e), jnp.asarray(h0),
                          method=lambda m, e, h0: m.recurrent(e, initial_carry=h0))
        return jnp.sum((states - target) ** 2)

    grads = jax.grad(jax_loss)(cell0)
    tx = jax_make_optimizer(JaxOptimizerConfig())
    updates, _ = tx.update(grads, tx.init(cell0), cell0)
    want = optax.apply_updates(cell0, updates)

    opt = port_make_optimizer(OptimizerConfig(), pm.recurrent.parameters())
    states = pm.motion(torch.from_numpy(e), torch.from_numpy(h0))
    ((states - torch.from_numpy(target)) ** 2).sum().backward()
    # the port's gradients are the flax cell's
    h = DZM
    g_ih = pm.recurrent.bias_ih.grad.numpy()
    for i, gate in enumerate(("ir", "iz", "in")):
        within(g_ih[i * h:(i + 1) * h], np.asarray(grads[gate]["bias"]), 1e-4, 1e-4)
    within(pm.recurrent.bias_hn.grad.numpy(), np.asarray(grads["hn"]["bias"]), 1e-4, 1e-4)
    opt.step()

    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    got = ggen_from_torch(sd)[0]["recurrent"]["cell"]
    lr = OptimizerConfig().lr
    for gate in ("ir", "iz", "in", "hn"):
        moved = np.asarray(want[gate]["bias"]) - np.asarray(cell0[gate]["bias"])
        assert np.abs(np.abs(moved) - lr).max() < 1e-6  # Adam's first step is +-lr
        # tolerance 2% of that step: a doubled bias would be off by 100%
        within(got[gate]["bias"], np.asarray(want[gate]["bias"]), 0.02 * lr)
    for gate in ("ir", "iz", "in", "hr", "hz", "hn"):
        within(got[gate]["kernel"], np.asarray(want[gate]["kernel"]), 0.02 * lr)
    # one bias vector per r and z gate: nn.GRUCell's second one (bias_hh's r
    # and z parts) would get the same gradient and step too
    assert set(dict(pm.recurrent.named_parameters())) == {"weight_ih", "weight_hh", "bias_ih", "bias_hn"}
    assert pm.recurrent.bias_hn.numel() == h


def test_gru_state_dict_keeps_the_reference_names_and_sums_loaded_biases():
    pm = PortGGen(dim_z_content=DZC, dim_z_motion=DZM, ngf=NGF, video_length=T)
    sd = pm.state_dict()
    h = DZM
    assert {"recurrent.weight_ih", "recurrent.weight_hh", "recurrent.bias_ih",
            "recurrent.bias_hh"} <= set(sd)
    assert torch.equal(sd["recurrent.bias_hh"][: 2 * h], torch.zeros(2 * h))
    ref = torch.nn.GRUCell(DZM, DZM)  # a reference checkpoint: two full bias vectors
    full = dict(sd)
    for k, v in ref.state_dict().items():
        full[f"recurrent.{k}"] = v.clone()
    pm.load_state_dict(full)
    x, h0 = torch.randn(3, DZM), torch.randn(3, DZM)
    with torch.no_grad():
        torch.testing.assert_close(pm.recurrent(x, h0), ref(x, h0))
    want = ref.bias_ih.detach().clone()
    want[: 2 * h] += ref.bias_hh.detach()[: 2 * h]
    torch.testing.assert_close(pm.recurrent.bias_ih.detach(), want)
    with pytest.raises(RuntimeError, match="bias_hh"):
        pm.load_state_dict({k: v for k, v in full.items() if k != "recurrent.bias_hh"})
