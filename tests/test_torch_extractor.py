"""The extractor trainer of the port (``dcvgan_torch.tools.extractor``)
against the repository's JAX tool (``tools/train_extractor.py``).

- ``synth_labeled_batch``: the same clips and labels bit for bit from one
  seed;
- ``save_npz``: ``assets/extractor-synthetic-v2.npz`` through the port's
  model and back gives the file's keys, in order, with equal arrays and
  dtypes; an npz the port's CLI writes carries the JAX tool's metadata and
  embeds 8 clips alike in both packages' ``FeatureExtractor`` (features and
  probabilities within 2e-4, the parity suite's f32 tolerance);
- the seeded init draws flax's default distribution in flax's shapes
  (each kernel's std within 10% of 1 / sqrt(fan_in), every kernel inside
  the truncation at two standard deviations, zero biases), the same from
  one seed and another from another;
- ``train``: from one flax init carried across, 3 steps at width 4, feature
  dim 8, batch 4, 8 x 32 x 32 agree with the same steps under flax + optax:
  each loss within 1e-5 relative, each parameter within 1e-4 relative L2.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcvgan_torch.eval.features import C3DFeatures, FeatureExtractor, _flax_from_state_dict, _state_dict_from_flax
from dcvgan_torch.eval.features import load_npz
from dcvgan_torch.tools import extractor
from dcvgan_tpu.eval.features import C3DFeatures as JaxC3DFeatures
from dcvgan_tpu.eval.features import FeatureExtractor as JaxFeatureExtractor
from torch_port_util import ATOL_F32, one_intra_op_thread, within  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import train_extractor as jax_tool  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")
V2 = REPO / "assets" / "extractor-synthetic-v2.npz"
LOSS_RTOL, PARAM_RTOL = 1e-5, 1e-4
STEPS, BATCH, WIDTH, FDIM, T, S, SEED = 3, 4, 4, 8, 8, 32, 0


@pytest.mark.parametrize("seed", [0, 42])
def test_synth_labeled_batch_equals_the_jax_tools(seed):
    got = extractor.synth_labeled_batch(np.random.default_rng(seed), 6, 16, 64)
    want = jax_tool.synth_labeled_batch(np.random.default_rng(seed), 6, 16, 64)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
    assert extractor.NUM_CLASSES == jax_tool.NUM_CLASSES == 24


def test_save_npz_writes_the_v2_file_back(tmp_path):
    params, _ = load_npz(V2)
    model = C3DFeatures(num_classes=24, width=32, feature_dim=128)
    model.load_state_dict(_state_dict_from_flax(params))
    with np.load(V2) as raw:
        want = {k: raw[k] for k in raw.files}
    meta = {k.split("/", 1)[1]: v for k, v in want.items() if k.startswith("__meta__/")}
    extractor.save_npz(tmp_path / "v2.npz", model, meta)
    with np.load(tmp_path / "v2.npz") as raw:
        got = {k: raw[k] for k in raw.files}
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape and np.array_equal(got[k], w), k


@pytest.fixture(scope="module")
def cli_npz(tmp_path_factory):
    """An npz the port's CLI writes: 2 steps at width 4 from the seeded init."""
    out = tmp_path_factory.mktemp("extractor") / "ex.npz"
    extractor.main([str(out), "--steps", "2", "--batch", "2", "--width", "4", "--feature-dim", "8",
                    "--image-size", "32", "--video-length", "8", "--holdout", "4", "--device", "cpu"])
    return out


def test_the_cli_writes_the_jax_tools_metadata(cli_npz):
    _, meta = load_npz(cli_npz)
    assert list(meta) == ["topology", "trained_on", "classes", "steps", "seed", "holdout_acc", "holdout_n"]
    assert (meta["topology"], meta["trained_on"], meta["classes"]) == (
        "small", "synthetic-moving-shapes", "8 directions x 3 sizes")
    assert (int(meta["steps"]), int(meta["seed"]), int(meta["holdout_n"])) == (2, 0, 4)
    assert 0.0 <= float(meta["holdout_acc"]) <= 1.0


def test_a_port_saved_npz_embeds_alike_in_both_packages(cli_npz):
    videos, _ = extractor.synth_labeled_batch(np.random.default_rng(5), 8, 8, 32)
    port = FeatureExtractor(weights_path=cli_npz, device="cpu")
    jax_ex = JaxFeatureExtractor(weights_path=str(cli_npz))
    assert port.fingerprint == jax_ex.fingerprint and port.fingerprint.startswith("small-npz/")
    (pf, pp), (jf, jp) = port(videos, 4), jax_ex(videos, 4)
    assert pf.shape == (8, FDIM) and pp.shape == (8, extractor.NUM_CLASSES)
    within(pf, jf, ATOL_F32)
    within(pp, jp, ATOL_F32)


def test_the_seeded_init_draws_flaxs_distribution():
    def tree(seed):
        model = C3DFeatures(num_classes=24, width=8, feature_dim=32)
        extractor.init_parameters(model, seed)
        return _flax_from_state_dict(model.state_dict())

    port = tree(3)
    flax_init = jax.eval_shape(JaxC3DFeatures(num_classes=24, width=8, feature_dim=32).init,
                               jax.random.key(3), jnp.zeros((1, 2, 8, 8, 3)))["params"]
    assert set(port) == set(flax_init)
    for layer, leaves in port.items():
        w = leaves["kernel"]
        assert w.shape == flax_init[layer]["kernel"].shape and leaves["bias"].shape == flax_init[layer]["bias"].shape
        # flax's lecun_normal: a unit normal truncated to [-2, 2], scaled to
        # variance 1 / fan_in
        fan_in = np.prod(w.shape[:-1])
        assert abs(w.std() * fan_in**0.5 - 1) < 0.1, layer
        assert np.abs(w).max() <= 2 * fan_in**-0.5 / 0.87962566103423978 * (1 + 1e-6), layer
        assert not leaves["bias"].any()
    assert all(np.array_equal(port[k]["kernel"], v["kernel"]) for k, v in tree(3).items())
    assert not np.array_equal(port["conv0"]["kernel"], tree(4)["conv0"]["kernel"])


def _flax_steps():
    """The JAX tool's loop for STEPS steps, losses and the params before and
    after."""
    model = JaxC3DFeatures(num_classes=jax_tool.NUM_CLASSES, width=WIDTH, feature_dim=FDIM)
    rng = np.random.default_rng(SEED)
    init_v, _ = jax_tool.synth_labeled_batch(rng, 1, T, S)
    params = model.init(jax.random.key(SEED), jnp.asarray(init_v, jnp.float32) / 255.0)["params"]
    init = jax.tree.map(np.asarray, params)
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, videos_u8, labels):
        def loss_fn(p):
            _, logits = model.apply({"params": p}, videos_u8.astype(jnp.float32) / 255.0)
            return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(STEPS):
        videos, labels = jax_tool.synth_labeled_batch(rng, BATCH, T, S)
        params, opt_state, loss = step(params, opt_state, jnp.asarray(videos), jnp.asarray(labels))
        losses.append(float(loss))
    return init, losses, jax.tree.map(np.asarray, params)


def test_three_training_steps_match_flax_and_optax():
    init, want_losses, want = _flax_steps()
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        model, _, holdout_acc, stats = extractor.train(steps=STEPS, batch=BATCH, width=WIDTH, feature_dim=FDIM,
                                                       t=T, s=S, seed=SEED, holdout=4, device="cpu",
                                                       init_params=init)
        assert torch.backends.cudnn.allow_tf32  # the caller's setting, restored
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert 0.0 <= holdout_acc <= 1.0 and stats["step_ms"] is None
    got_losses = np.array(stats["losses"])
    assert len(got_losses) == STEPS
    np.testing.assert_allclose(got_losses, want_losses, rtol=LOSS_RTOL)
    got = _flax_from_state_dict(model.state_dict())
    moved = 0.0
    for layer, leaves in want.items():
        for leaf, w in leaves.items():
            rel = np.linalg.norm(got[layer][leaf] - w) / np.linalg.norm(w)
            assert rel <= PARAM_RTOL, (layer, leaf, rel)
            moved = max(moved, np.abs(w - init[layer][leaf]).max())
    assert moved > 1e-4  # the steps moved the parameters
