"""The port's geometric video generator against the JAX package's, eval mode.

Weights come from a randomised flax tree through ``from_jax``; latents, ``e``
and ``h0`` are drawn with numpy and injected on both sides.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvgan_torch.cli.serve import quantize
from dcvgan_torch.compat.from_jax import ggen_from_jax
from dcvgan_torch.models import ggen as ggen_mod
from dcvgan_torch.models import layers
from dcvgan_torch.models.ggen import GeometricVideoGenerator as PortGGen
from dcvgan_torch.models.ggen import codes_of
from dcvgan_torch.models.layers import cast_for_compute
from dcvgan_torch.ops import softmax_codes as sc
from dcvgan_tpu.models import GeometricVideoGenerator as JaxGGen
from torch_port_util import ATOL_F32, NGF, randomize_tree, within
from torch_port_util import one_intra_op_thread  # noqa: F401
from torch_port_util import tracing  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

DZC, DZM, B, T = 6, 4, 2, 4
# bf16 against JAX in bf16: the GRU cell and the BatchNorm+ReLU stages round
# at different points in the two frameworks (flax normalises in f32 and
# rounds once; torch's GRU cell rounds per op). Measured max |diff| over
# three seeds: 1.1e-2 (GRU states), 7.8e-3 (frames in [-1, 1]); held at 2e-2.
BF16_ATOL = 2e-2


def _models(geometric_info, channel, dtype_jax, dtype_torch, seed):
    jm = JaxGGen(
        dim_z_content=DZC, dim_z_motion=DZM, channel=channel,
        geometric_info=geometric_info, ngf=NGF, video_length=T, dtype=dtype_jax,
    )
    v = jax.eval_shape(
        lambda: jm.init({"params": jax.random.key(0), "latent": jax.random.key(1)}, 1, train=False)
    )
    rng = np.random.default_rng(seed)
    params = randomize_tree(v["params"], rng)
    stats = randomize_tree(v["batch_stats"], rng)
    pm = PortGGen(
        dim_z_content=DZC, dim_z_motion=DZM, channel=channel,
        geometric_info=geometric_info, ngf=NGF, video_length=T,
    )
    pm.load_state_dict(ggen_from_jax(params, stats))
    cast_for_compute(pm, torch.device("cpu"), dtype_torch).eval()
    return jm, {"params": params, "batch_stats": stats}, pm


def _latents(seed):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(B, T, DZM)).astype(np.float32)
    h0 = rng.normal(size=(B, DZM)).astype(np.float32)
    z = rng.normal(size=(B * T, DZC + DZM)).astype(np.float32)
    return e, h0, z


def _jax_gru(jm, variables, e, h0):
    run = jax.jit(lambda v, e, h0: jm.apply(
        v, e, h0, method=lambda m, e, h0: m.recurrent(e, initial_carry=h0)))
    return run(variables, jnp.asarray(e), jnp.asarray(h0))


def _jax_decode(jm, variables, z):
    return jax.jit(lambda v, z: jm.apply(v, z, False, method=JaxGGen.decode))(variables, jnp.asarray(z))


@pytest.mark.parametrize(
    "dtypes,atol",
    [((jnp.float32, torch.float32), ATOL_F32), ((jnp.bfloat16, torch.bfloat16), BF16_ATOL)],
    ids=["f32", "bf16"],
)
def test_gru_and_decoder_match_jax(dtypes, atol):
    jm, variables, pm = _models("depth", 1, *dtypes, seed=0)
    e, h0, z = _latents(1)
    with torch.no_grad():
        got_m = pm.motion(torch.from_numpy(e), torch.from_numpy(h0))
        got_x = pm.decode(torch.from_numpy(z))
    want_m = _jax_gru(jm, variables, e, h0)
    want_x = _jax_decode(jm, variables, z)
    within(got_m.float().numpy(), np.asarray(want_m, np.float32), atol)
    within(got_x.float().numpy(), np.asarray(want_x, np.float32), atol)
    assert got_x.shape == (B * T, 64, 64, 1)


def test_forward_is_content_repeated_plus_motion():
    jm, variables, pm = _models("depth", 1, jnp.float32, torch.float32, seed=2)
    e, h0, _ = _latents(3)
    zc = np.random.default_rng(4).normal(size=(B, DZC)).astype(np.float32)
    with torch.no_grad():
        got = pm(torch.from_numpy(zc), torch.from_numpy(e), torch.from_numpy(h0))
    zm = np.asarray(_jax_gru(jm, variables, e, h0))
    z = np.concatenate([np.repeat(zc[:, None], T, axis=1), zm], axis=-1)
    want = _jax_decode(jm, variables, z.reshape(B * T, -1))
    within(got.numpy(), np.asarray(want).reshape(B, T, 64, 64, 1), ATOL_F32)


def test_segmentation_softmax_head():
    jm, variables, pm = _models("segmentation", 25, jnp.float32, torch.float32, seed=5)
    _, _, z = _latents(6)
    with torch.no_grad():
        got = pm.decode(torch.from_numpy(z)).numpy()
    want = np.asarray(_jax_decode(jm, variables, z))
    within(got, want, ATOL_F32)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_train_mode_raises():
    # train mode runs on batch statistics, selected by the argument and not
    # by .training; what raises is an argument the decoder does not have
    pm = PortGGen(dim_z_content=DZC, dim_z_motion=DZM, ngf=NGF, video_length=T)
    z = torch.from_numpy(_latents(7)[2])
    with torch.no_grad():
        ev = pm.decode(z)
        pm.eval()
        assert torch.equal(pm.decode(z), ev)
        tr = pm.decode(z, train=True, update_stats=False)
    assert tr.shape == ev.shape and not torch.allclose(tr, ev)
    with pytest.raises(TypeError):
        pm.decode(z, training=True)


# ---- the softmax head on softmax_codes (the decoder taken as fused on the
# CPU, where the op runs its plain version)


@pytest.fixture
def head_on_cpu(monkeypatch):
    """ggen's choice with a CPU tensor taken as on CUDA while ``.on``;
    ``.calls`` the shapes ``softmax_codes`` was called on."""
    state = types.SimpleNamespace(on=True, calls=[])

    def decodes_fused(x, train, norm):
        return layers.decodes_fused(types.SimpleNamespace(dtype=x.dtype, is_cuda=state.on), train, norm)

    def counted(raw):
        state.calls.append(tuple(raw.shape))
        return sc.softmax_codes(raw)

    monkeypatch.setattr(ggen_mod, "decodes_fused", decodes_fused)
    monkeypatch.setattr(ggen_mod, "softmax_codes", counted)
    return state


def _eval_ggen(geometric_info, channel, dtype=torch.bfloat16):
    pm = PortGGen(dim_z_content=DZC, dim_z_motion=DZM, channel=channel, geometric_info=geometric_info,
                  ngf=NGF, video_length=T)
    pm.reset_parameters(torch.Generator().manual_seed(channel))
    return cast_for_compute(pm, torch.device("cpu"), dtype).eval()


def _forward(pm, seed):
    zc = torch.from_numpy(np.random.default_rng(seed).normal(size=(B, DZC)).astype(np.float32))
    e, h0, _ = _latents(seed)
    with torch.inference_mode():
        return pm(zc, torch.from_numpy(e), torch.from_numpy(h0))


@pytest.mark.parametrize("channel", [5, 25])
def test_fused_softmax_head_hands_on_its_codes(head_on_cpu, tracing, channel):
    pm = _eval_ggen("segmentation", channel)
    at = tracing.mark()
    videos = _forward(pm, seed=channel)
    assert head_on_cpu.calls == [(B * T, channel, 64, 64)]
    assert [r.name for r in tracing.records(at)] == ["ggen.softmax_codes"]
    codes = codes_of(videos)
    assert videos.shape == codes.u8.shape == (B, T, 64, 64, channel) and codes.u8.dtype == torch.uint8
    assert torch.equal(codes.u8, quantize(videos))
    assert int(codes.total) == int(codes.u8.sum(dtype=torch.int64))
    head_on_cpu.on = False
    assert torch.equal(_forward(pm, seed=channel), videos)  # the modules' softmax, the same bytes
    assert codes_of(videos[:1]) is None and codes_of(videos.clone()) is None


@pytest.mark.parametrize("case", ["depth", "optical-flow", "unfused", "float32"])
def test_no_codes_off_the_fused_softmax_head(head_on_cpu, case):
    geometric_info, channel = {"depth": ("depth", 1), "optical-flow": ("optical-flow", 2)}.get(
        case, ("segmentation", 5))
    head_on_cpu.on = case != "unfused"
    pm = _eval_ggen(geometric_info, channel, torch.float32 if case == "float32" else torch.bfloat16)
    before = sc.softmax_codes.launches
    videos = _forward(pm, seed=1)
    assert head_on_cpu.calls == [] and codes_of(videos) is None
    assert sc.softmax_codes.launches == before and videos.shape == (B, T, 64, 64, channel)
