"""The port's feature extractor and metrics against the JAX package's.

Inputs are drawn with numpy; flax parameters cross into the port through the
same kernel-layout mapping the port's npz loader uses. Tolerances: float32
convolutions summed in another order, features and probabilities within
1e-4 abs + 1e-4 rel; the metrics are the same numpy code on the same arrays,
so equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from dcvgan_torch.eval import features as port_features
from dcvgan_torch.eval import metrics as port_metrics
from dcvgan_tpu.eval import features as jax_features
from dcvgan_tpu.eval import metrics as jax_metrics
from dcvgan_tpu.utils.video_np import videos_to_uint8
from torch_port_util import within
from torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

REPO = Path(__file__).resolve().parents[1]
ASSET = REPO / "assets" / "extractor-synthetic.npz"
ATOL = RTOL = 1e-4


def _flax_params(module, x, rng):
    """Random parameters of the right shapes for ``module`` at input ``x``,
    drawn with numpy (kernels ~ N(0, 1/fan_in), biases N(0, 0.1))."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), x)["params"]
    out = {}
    for layer, leaves in shapes.items():
        k = leaves["kernel"].shape
        out[layer] = {
            "kernel": rng.normal(0, 1 / np.sqrt(np.prod(k[:-1])), k).astype(np.float32),
            "bias": rng.normal(0, 0.1, leaves["bias"].shape).astype(np.float32),
        }
    return out


@pytest.mark.parametrize("t,h,w", [(8, 32, 32), (6, 36, 20)], ids=["8x32x32", "odd-extents"])
def test_small_tower_matches_flax(t, h, w):
    # (6, 36, 20) reaches odd extents and a 1-frame stage, where flax's
    # "SAME" pooling pads
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, t, h, w, 3)).astype(np.float32)
    jm = jax_features.C3DFeatures(num_classes=10, width=8, feature_dim=16)
    params = _flax_params(jm, jnp.asarray(x), rng)
    jf, jlogits = jm.apply({"params": params}, jnp.asarray(x))
    pm = port_features.C3DFeatures(num_classes=10, width=8, feature_dim=16)
    pm.load_state_dict(port_features._state_dict_from_flax(params))
    with torch.no_grad():
        pf, plogits = pm(torch.from_numpy(x))
    assert float(np.abs(jf).max()) > 0.05  # not all ReLU-dead
    within(pf.numpy(), np.asarray(jf), ATOL, RTOL)
    within(torch.softmax(plogits, -1).numpy(), np.asarray(jax.nn.softmax(jlogits, -1)), ATOL, RTOL)


def test_max_pool_same_pads_odd_extents_at_the_end():
    x = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(1, 1, 2, 3, 5) - 100.0
    got = port_features._max_pool_same(x, (2, 2, 2))
    assert got.shape == (1, 1, 1, 2, 3)
    want = nn.max_pool(jnp.asarray(x.numpy().transpose(0, 2, 3, 4, 1)), (2, 2, 2),
                       strides=(2, 2, 2), padding="SAME")
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 4, 1), want)


def test_npz_extractor_matches_the_jax_one():
    videos = np.random.default_rng(1).integers(0, 256, (2, 16, 64, 64, 3), dtype=np.uint8)
    jx = jax_features.FeatureExtractor(weights_path=str(ASSET))
    px = port_features.FeatureExtractor(weights_path=ASSET, device="cpu")
    assert px.fingerprint == jx.fingerprint and px.fingerprint.startswith("small-npz/sha256=")
    jf, jp = jx(videos, batchsize=2)
    pf, pp = px(videos, batchsize=2)
    within(pf, jf, ATOL, RTOL)
    within(pp, jp, ATOL, RTOL)
    # device_embed of the float videos those bytes came from
    pm1 = (videos.astype(np.float32) + 0.25) / 127.5 - 1.0
    df, dp = px.device_embed(torch.from_numpy(pm1))
    jdf, jdp = jax.jit(jx.device_embed)(jx.variables, jnp.asarray(pm1))
    within(df.numpy(), np.asarray(jdf), ATOL, RTOL)
    within(dp.numpy(), np.asarray(jdp), ATOL, RTOL)


def test_seeded_extractor_has_its_own_fingerprint():
    a = port_features.FeatureExtractor(seed=3, width=8, device="cpu")
    b = port_features.FeatureExtractor(seed=3, width=8, device="cpu")
    assert a.fingerprint == "c3d-seeded-torch/seed=3,width=8"
    # the JAX package's seeded extractor (flax init) is "c3d-seeded/seed=3,width=8"
    assert not a.fingerprint.startswith("c3d-seeded/")
    for (k, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(p, q), k
    assert port_features.FeatureExtractor(seed=0, width=8, device="cpu").fingerprint.endswith("seed=0,width=8")


def test_c3d_resize_matches_jax_image_resize():
    x = np.random.default_rng(2).integers(0, 256, (3, 64, 64, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (3, 112, 112, 3), method="bilinear")
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(112, 112), mode="bilinear",
                        align_corners=False, antialias=False).permute(0, 2, 3, 1)
    within(got.numpy(), np.asarray(want), 1e-3, 1e-6)  # values up to 255: f32 rounding


def test_c3d_clip_matches_flax():
    # one whole clip through the canonical topology: the pool5 padding, the
    # (T, H, W, C) flatten into fc6 and the fc layers
    rng = np.random.default_rng(3)
    x = rng.uniform(-60, 60, (1, 16, 112, 112, 3)).astype(np.float32)
    jm = jax_features.C3D(num_classes=12)
    params = _flax_params(jm, jnp.asarray(x), rng)
    jf, jlogits = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    pm = port_features.C3D(num_classes=12)
    pm.load_state_dict(port_features._state_dict_from_flax(params))
    with torch.no_grad():
        pf, plogits = pm(torch.from_numpy(x))
    scale = float(np.abs(jf).max())
    assert scale > 0.1
    within(pf.numpy(), np.asarray(jf), ATOL * scale, RTOL)
    within(plogits.numpy(), np.asarray(jlogits), ATOL * float(np.abs(jlogits).max()), RTOL)


def test_c3d_extractor_resizes_and_subtracts_the_mean(tmp_path):
    # a c3d npz (written here from numpy) loads with its mean; the port's
    # whole embed of 64x64 uint8 clips equals the JAX package's
    rng = np.random.default_rng(4)
    jm = jax_features.C3D(num_classes=5)
    params = _flax_params(jm, jnp.zeros((1, 16, 112, 112, 3)), rng)
    flat = {f"{layer}/{leaf}": v for layer, leaves in params.items() for leaf, v in leaves.items()}
    path = tmp_path / "c3d.npz"
    np.savez(path, **flat, **{"__meta__/topology": np.array("c3d"),
                              "__meta__/mean": np.array([90.0, 98.0, 102.0], np.float32)})
    videos = rng.integers(0, 256, (1, 16, 64, 64, 3), dtype=np.uint8)
    jx = jax_features.FeatureExtractor(weights_path=str(path))
    px = port_features.FeatureExtractor(weights_path=path, device="cpu")
    assert px.is_c3d and px.fingerprint == jx.fingerprint
    jf, jp = jx(videos, batchsize=1)
    pf, pp = px(videos, batchsize=1)
    within(pf, jf, ATOL * float(np.abs(jf).max()), RTOL)
    within(pp, jp, ATOL, RTOL)


def test_quantisation_equals_videos_to_uint8_bit_for_bit():
    k = np.arange(256, dtype=np.float32)
    edges = 2.0 * k / 255.0 - 1.0  # where (v + 1) / 2 * 255 lands on an integer
    ulp = np.spacing(np.abs(edges).astype(np.float32))
    v = np.concatenate([
        edges, edges - ulp, edges + ulp, edges - 3 * ulp, edges + 3 * ulp,
        np.float32([-1.0, 1.0, -0.0, 0.0, -1.5, 1.5, 2.0, -7.0, np.nextafter(1, 0, dtype=np.float32)]),
        np.random.default_rng(5).uniform(-1.2, 1.2, 4096),
    ]).astype(np.float32)
    got = port_features.quantize(torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), videos_to_uint8(v).astype(np.float32))
    # and from bfloat16 generator output, as sample_videos gives it
    vb = torch.from_numpy(v).to(torch.bfloat16)
    np.testing.assert_array_equal(port_features.quantize(vb).numpy(),
                                  videos_to_uint8(vb.float().numpy()).astype(np.float32))


@pytest.fixture(scope="module")
def feature_sets():
    rng = np.random.default_rng(6)
    real = rng.normal(0, 1, (40, 12))
    fake = rng.normal(0.3, 1.2, (36, 12))
    logits = rng.normal(0, 2, (36, 7))
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return real, fake, probs


@pytest.mark.parametrize("metrics", [["is"], ["fid", "fvd"], ["prd"], ["is", "fid", "prd"]],
                         ids=["is", "fid", "prd", "all"])
def test_metrics_equal_the_jax_package(feature_sets, metrics):
    real, fake, probs = feature_sets
    got = port_metrics.score_features(metrics, fake, probs, lambda: real)
    want = jax_metrics.score_features(metrics, fake, probs, lambda: real)
    assert got == want and set(got) >= set(metrics)


def test_frechet_distance_runs_on_a_scipy_without_disp(feature_sets, monkeypatch):
    # SciPy 1.18 removed sqrtm's ``disp`` argument (the card's machine has
    # such a SciPy); the port's copy calls the form both versions take
    import scipy.linalg

    real, fake, _ = feature_sets
    want = jax_metrics.frechet_distance(fake, real)
    plain_sqrtm = scipy.linalg.sqrtm
    monkeypatch.setattr(scipy.linalg, "sqrtm", lambda a: plain_sqrtm(a))
    assert port_metrics.frechet_distance(fake, real) == want


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_features.FeatureExtractor(weights_path=ASSET)
