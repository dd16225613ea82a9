"""The port's three critics against the JAX package's.

Weights come from a randomised flax tree through ``compat/from_jax.py``;
inputs are drawn with numpy; the Noise layers' draws are read from the flax
run (``record_jax_draws``) and handed to the port. Train and eval mode, with
and without noise: the logits, and the running statistics after one
train-mode forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvgan_torch.compat import from_jax
from dcvgan_torch.models import discriminators as port
from dcvgan_torch.models.layers import place_for_training
from dcvgan_tpu.compat import gdis_from_torch, idis_from_torch, vdis_from_torch
from dcvgan_tpu.models import GradientDiscriminator, ImageDiscriminator, VideoDiscriminator
from torch_port_util import ATOL_F32, as_tensors, randomize_tree, record_jax_draws, within
from torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

NDF, B, T = 8, 2, 16
S2, S3 = 64, 32  # frame size for the image critic, and for the two video critics
JAX = {"idis": ImageDiscriminator, "vdis": VideoDiscriminator, "gdis": GradientDiscriminator}
PORT = {"idis": port.ImageDiscriminator, "vdis": port.VideoDiscriminator,
        "gdis": port.GradientDiscriminator}
FROM_TORCH = {"idis": idis_from_torch, "vdis": vdis_from_torch, "gdis": gdis_from_torch}
# bf16 against JAX in bf16: four to five conv stages, each rounding its
# output to bf16 in both frameworks but summing in another order, and a
# BatchNorm that rounds once. Measured over three seeds: max |diff| 9.8e-3
# on logits up to 2.0 (one bf16 ulp there is 1.6e-2); held at 2e-2. The
# running variances are f32 sums of bf16 activations: measured 8.9e-5, held
# at 5e-4.
BF16_ATOL, BF16_STATS_ATOL = 2e-2, 5e-4


def _inputs(name, seed):
    rng = np.random.default_rng(seed)
    lead = (B, S2, S2) if name == "idis" else (B, T, S3, S3)
    return (rng.uniform(-1, 1, lead + (1,)).astype(np.float32),
            rng.uniform(-1, 1, lead + (3,)).astype(np.float32))


def _models(name, use_noise, jdt=jnp.float32, tdt=torch.float32, seed=0):
    kw = dict(ch_g=1, ch_c=3, use_noise=use_noise, noise_sigma=0.1, ndf=NDF)
    jm = JAX[name](dtype=jdt, **kw)
    xg, xc = _inputs(name, 0)
    v = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "noise": jax.random.key(0)}, jnp.asarray(xg), jnp.asarray(xc)))
    rng = np.random.default_rng(seed)
    variables = {"params": randomize_tree(v["params"], rng),
                 "batch_stats": randomize_tree(v["batch_stats"], rng)}
    pm = PORT[name](**kw)
    pm.load_state_dict(from_jax.FROM_JAX[name](variables["params"], variables["batch_stats"]))
    return jm, variables, place_for_training(pm, torch.device("cpu"), tdt)


def _jax_forward(jm, variables, xg, xc, train, jdt=jnp.float32):
    def run():
        return jm.apply(variables, jnp.asarray(xg, jdt), jnp.asarray(xc, jdt), train,
                        rngs={"noise": jax.random.key(5)}, mutable=["batch_stats"])
    (y, mut), draws = record_jax_draws(run)
    return np.asarray(y, np.float32), mut["batch_stats"], draws["noise"][0]


@pytest.mark.parametrize("use_noise", [False, True], ids=["plain", "noise"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["idis", "vdis", "gdis"])
def test_logits_and_running_statistics_match_jax(name, train, use_noise):
    jm, variables, pm = _models(name, use_noise, seed=1)
    xg, xc = _inputs(name, 2)
    want, stats, noise = _jax_forward(jm, variables, xg, xc, train)
    assert bool(noise) == use_noise
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    with torch.no_grad():
        got = pm(torch.from_numpy(xg), torch.from_numpy(xc), train=train, noise=as_tensors(noise))
    assert got.shape == want.shape == {"idis": (B, 4, 4), "vdis": (B, 4, 2, 2), "gdis": (B, 3, 2, 2)}[name]
    within(got.numpy(), want, ATOL_F32)
    after = pm.state_dict()
    _, want_stats = FROM_TORCH[name]({k: v.numpy() for k, v in after.items()})
    for bn, s in want_stats.items():
        if train:  # moved towards the batch's mean and biased variance
            within(s["mean"], np.asarray(stats[bn]["mean"]), ATOL_F32)
            within(s["var"], np.asarray(stats[bn]["var"]), ATOL_F32)
    changed = [k for k in after if "running" in k and not torch.equal(after[k], before[k])]
    assert bool(changed) == train  # eval mode writes nothing
    if train:  # and update_stats=False writes nothing either
        with torch.no_grad():
            pm(torch.from_numpy(xg), torch.from_numpy(xc), train=True, update_stats=False,
               noise=as_tensors(noise))
        assert all(torch.equal(v, after[k]) for k, v in pm.state_dict().items())


@pytest.mark.parametrize("name", ["idis", "vdis", "gdis"])
def test_bf16_matches_jax_in_bf16(name):
    jm, variables, pm = _models(name, True, jnp.bfloat16, torch.bfloat16, seed=3)
    xg, xc = _inputs(name, 4)
    want, stats, noise = _jax_forward(jm, variables, xg, xc, True, jnp.bfloat16)
    with torch.no_grad():
        got = pm(torch.from_numpy(xg), torch.from_numpy(xc), train=True, noise=as_tensors(noise))
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in pm.parameters())  # f32 masters
    within(got.float().numpy(), want, BF16_ATOL)
    _, got_stats = FROM_TORCH[name]({k: v.numpy() for k, v in pm.state_dict().items()})
    for bn, s in got_stats.items():
        within(s["var"], np.asarray(stats[bn]["var"]), BF16_STATS_ATOL)


@pytest.mark.parametrize("name", ["idis", "vdis", "gdis"])
def test_gradients_match_jax_on_the_same_inputs(name):
    """Every parameter's gradient of a scalar loss, train mode with noise,
    within 2e-4 of the tensor's largest gradient."""
    jm, variables, pm = _models(name, True, seed=9)
    xg, xc = _inputs(name, 10)
    _, _, noise = _jax_forward(jm, variables, xg, xc, True)

    def loss(params):
        y, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                        jnp.asarray(xg), jnp.asarray(xc), True,
                        rngs={"noise": jax.random.key(5)}, mutable=["batch_stats"])
        return jnp.mean(jax.nn.softplus(-y))

    want = jax.grad(loss)(variables["params"])
    y = pm(torch.from_numpy(xg), torch.from_numpy(xc), train=True, update_stats=False,
           noise=as_tensors(noise))
    torch.nn.functional.softplus(-y.float()).mean().backward()
    sd = {k: v.clone() for k, v in pm.state_dict().items()}
    sd.update({k: p.grad for k, p in pm.named_parameters()})
    got, _ = FROM_TORCH[name]({k: v.numpy() for k, v in sd.items()})
    for layer, leaves in want.items():
        for leaf, g in leaves.items():
            g = np.asarray(g)
            within(got[layer][leaf], g, ATOL_F32 * float(np.abs(g).max()) + 1e-7)


def test_gdis_ignores_the_colour_input_and_idis_orders_colour_first():
    _, _, pm = _models("gdis", False, seed=5)
    xg, xc = _inputs("gdis", 6)
    with torch.no_grad():
        a = pm(torch.from_numpy(xg), torch.from_numpy(xc), train=False)
        b = pm(torch.from_numpy(xg), None, train=False)
    assert torch.equal(a, b)
    _, _, im = _models("idis", False, seed=5)
    xg, xc = _inputs("idis", 6)
    with torch.no_grad():
        y = im(torch.from_numpy(xg), torch.from_numpy(xc), train=False)
        # swapping the stems' weights is not the same function: the concat
        # order [colour | geometry] feeds conv_1 different channels
        hg = im._stem(im.conv_g, torch.from_numpy(xg), None, None)
        hc = im._stem(im.conv_c, torch.from_numpy(xc), None, None)
        y_cg = im._run_main(torch.cat([hc, hg], 1), False, True, None, None)
        y_gc = im._run_main(torch.cat([hg, hc], 1), False, True, None, None)
    assert torch.equal(y, y_cg) and not torch.allclose(y, y_gc)


@pytest.mark.parametrize("name", ["idis", "vdis", "gdis"])
def test_state_dict_round_trips_through_the_jax_importer(name):
    _, variables, pm = _models(name, True, seed=7)
    params, stats = FROM_TORCH[name]({k: v.numpy() for k, v in pm.state_dict().items()})
    for k, v in variables["params"].items():
        for leaf in v:
            np.testing.assert_array_equal(params[k][leaf], v[leaf])
    for k, v in variables["batch_stats"].items():
        for leaf in v:
            np.testing.assert_array_equal(stats[k][leaf], v[leaf])


def test_noise_is_drawn_from_the_generator_when_not_given():
    _, _, pm = _models("idis", True, seed=8)
    xg, xc = (torch.from_numpy(a) for a in _inputs("idis", 9))
    with torch.no_grad():
        a = pm(xg, xc, train=False, generator=torch.Generator().manual_seed(1))
        b = pm(xg, xc, train=False, generator=torch.Generator().manual_seed(1))
        c = pm(xg, xc, train=False, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)  # eval mode is noisy too
