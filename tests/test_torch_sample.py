"""The port's sampling slice end to end against the JAX package.

A weights npz is written from randomised flax trees with numpy alone and
loaded by ``DCVGAN.load_state``; the latents are drawn with numpy and
injected. The JAX side runs the GRU, ``ggen.decode`` and ``cgen.__call__``
on the same latents.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvgan_torch import prng
from dcvgan_torch.config import ExperimentConfig
from dcvgan_torch.eval.sampler import generate_samples
from dcvgan_torch.train.step import DCVGAN, Latents
from dcvgan_tpu.models import ColorVideoGenerator as JaxCGen
from dcvgan_tpu.models import GeometricVideoGenerator as JaxGGen
from torch_port_util import ATOL_F32, NGF, flatten_tree, randomize_tree, within
from torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

DZC, DZM, DZ_COLOR, B, T = 6, 4, 4, 2, 4
# bf16 end to end: the geometry differences of test_torch_ggen feed the
# colour generator, which adds its own (test_torch_cgen). Measured max |diff|
# over three seeds: 8.3e-3 (geometry), 1.8e-2 (colour) on outputs in
# [-1, 1]; held at 3e-2.
BF16_ATOL = 3e-2


def _config(precision):
    cfg = ExperimentConfig.from_dict({
        "video_length": T,
        "image_size": 64,
        "geometric_info": {"name": "depth", "channel": 1},
        "ggen": {"dim_z_content": DZC, "dim_z_motion": DZM, "ngf": NGF},
        "cgen": {"dim_z_color": DZ_COLOR, "ngf": NGF},
        "trainer": {"precision": precision},
    })
    cfg.validate()
    return cfg


def _jax_models(dtype):
    ggen = JaxGGen(dim_z_content=DZC, dim_z_motion=DZM, channel=1, ngf=NGF,
                   video_length=T, dtype=dtype)
    cgen = JaxCGen(in_ch=1, dim_z=DZ_COLOR, ngf=NGF, dtype=dtype)
    return ggen, cgen


def _weights(tmp_path, seed, with_ema=False):
    """Randomised flax trees of both generators and their npz."""
    ggen, cgen = _jax_models(jnp.float32)
    shapes = {
        "ggen": jax.eval_shape(lambda: ggen.init(
            {"params": jax.random.key(0), "latent": jax.random.key(0)}, 1, train=False)),
        "cgen": jax.eval_shape(lambda: cgen.init(
            jax.random.key(0), jnp.zeros((1, 64, 64, 1)), jnp.zeros((1, DZ_COLOR)), train=False)),
    }
    rng = np.random.default_rng(seed)
    trees = {}
    for name, v in shapes.items():
        trees[name] = {
            "params": randomize_tree(v["params"], rng),
            "batch_stats": randomize_tree(v["batch_stats"], rng),
        }
        if with_ema:
            trees[name]["ema"] = randomize_tree(v["params"], rng)
    path = tmp_path / "weights.npz"
    np.savez(path, **flatten_tree(trees))
    return trees, path


def _latents(seed):
    rng = np.random.default_rng(seed)
    return Latents(
        z_content=torch.from_numpy(rng.normal(size=(B, DZC)).astype(np.float32)),
        e=torch.from_numpy(rng.normal(size=(B, T, DZM)).astype(np.float32)),
        h0=torch.from_numpy(rng.normal(size=(B, DZM)).astype(np.float32)),
        z_color=torch.from_numpy(rng.normal(size=(B, DZ_COLOR)).astype(np.float32)),
    )


def _jax_sample(trees, lat: Latents, dtype, params_key="params"):
    ggen, cgen = _jax_models(dtype)
    gv = {"params": trees["ggen"][params_key], "batch_stats": trees["ggen"]["batch_stats"]}
    cv = {"params": trees["cgen"][params_key], "batch_stats": trees["cgen"]["batch_stats"]}

    @jax.jit
    def run(gv, cv, zc, e, h0, zcol):
        zm = ggen.apply(gv, e.astype(dtype), h0.astype(dtype),
                        method=lambda m, e, h0: m.recurrent(e, initial_carry=h0))
        z = jnp.concatenate([jnp.broadcast_to(zc.astype(dtype)[:, None], (B, T, DZC)), zm], -1)
        xg = ggen.apply(gv, z.reshape(B * T, -1), False, method=JaxGGen.decode)
        xc = cgen.apply(cv, xg, jnp.repeat(zcol, T, axis=0), train=False)
        return xg.reshape(B, T, 64, 64, 1), xc.reshape(B, T, 64, 64, 3)

    xg, xc = run(gv, cv, *(jnp.asarray(t.numpy()) for t in lat))
    return np.asarray(xg, np.float32), np.asarray(xc, np.float32)


@pytest.mark.parametrize(
    "precision,jdtype,atol",
    [("float32", jnp.float32, ATOL_F32), ("bfloat16", jnp.bfloat16, BF16_ATOL)],
)
def test_sample_videos_matches_jax(tmp_path, precision, jdtype, atol):
    trees, path = _weights(tmp_path, seed=0)
    gan = DCVGAN(_config(precision), device="cpu")
    state = gan.load_state(path)
    lat = _latents(1)
    xg, xc = gan.sample_videos(state, None, B, latents=lat)
    assert xg.shape == (B, T, 64, 64, 1) and xc.shape == (B, T, 64, 64, 3)
    assert xg.dtype == xc.dtype == gan.dtype
    want_g, want_c = _jax_sample(trees, lat, jdtype)
    within(xg.float().numpy(), want_g, atol)
    within(xc.float().numpy(), want_c, atol)


def test_ema_weights_are_served(tmp_path):
    trees, path = _weights(tmp_path, seed=2, with_ema=True)
    gan = DCVGAN(_config("float32"), device="cpu")
    state = gan.load_state(path)
    assert state.ema is not None
    lat = _latents(3)
    _, xc = gan.sample_videos(state.with_ema_params(), None, B, latents=lat)
    _, want = _jax_sample(trees, lat, jnp.float32, params_key="ema")
    within(xc.numpy(), want, ATOL_F32)
    _, live = gan.sample_videos(state, None, B, latents=lat)
    assert not np.allclose(live.numpy(), xc.numpy())  # the live weights differ


def test_seeded_sampling_replays_and_streams_differ():
    gan = DCVGAN(_config("float32"), device="cpu")
    state = gan.init_state(0)
    a = gan.sample_latents(prng.for_step(prng.base_key(5), 1), B)
    b = gan.sample_latents(prng.for_step(prng.base_key(5), 1), B)
    c = gan.sample_latents(prng.for_step(prng.base_key(5), 2), B)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.z_content, c.z_content)
    assert not torch.equal(a.z_content, a.h0[:, :1].expand_as(a.z_content))
    # named streams of one generator are independent of each other's draws
    g = prng.base_key(5)
    assert prng.named(g, "ggen_motion").initial_seed() != prng.named(g, "cgen_color").initial_seed()
    xg, xc = gan.sample_videos(state, prng.base_key(5), B)
    xg2, xc2 = gan.sample_videos(state, prng.base_key(5), B)
    assert torch.equal(xc, xc2) and torch.equal(xg, xg2)


def test_generate_samples_returns_uint8_videos():
    gan = DCVGAN(_config("float32"), device="cpu")
    state = gan.init_state(1)
    xg, xc = generate_samples(gan, state, prng.base_key(0), num=3, batchsize=2)
    assert xc.shape == (3, T, 64, 64, 3) and xc.dtype == np.uint8
    assert xg.shape == (3, T, 64, 64, 3) and xg.dtype == np.uint8
    none, xc_only = generate_samples(gan, state, prng.base_key(0), num=3, batchsize=2,
                                     with_geo=False)
    assert none is None
    np.testing.assert_array_equal(xc_only, xc)
