"""The port's time sharding (``dcvgan_torch/parallel/temporal.py``, the
masked BatchNorm and the time-sharded critics) against the JAX package on
its virtual CPU devices, over 4 gloo ranks.

One launch of the ranks (``torch_time_util.temporal_ops``) computes every
case at ``time`` 2 (``data`` 2) and ``time`` 4 (``data`` 1); the JAX side
runs on a mesh of the same shape:

- the halo of a frame-numbered clip, bit for bit against
  ``halo_exchange`` under ``shard_map`` (halo 3 and 1);
- ``time_sharded_conv3d`` against JAX's (rtol 2e-5, atol 1e-5, the masked
  tail exactly 0), and its input and weight gradients, summed over a
  row's time ranks, against the unsharded conv's;
- ``MaskedSyncBatchNorm`` against flax's inside ``shard_map`` over
  (data, time): output, input and parameter gradients, running statistics;
- the video and gradient critics' time-sharded logits and statistics
  against JAX's ``_time_sharded_apply`` (no noise: JAX folds the key per
  shard) and against the port's unsharded forward, with noise on (every
  rank keeps its frames of the unsharded draw), f32, 2e-4;
- the halo-too-large and T-not-divisible errors, and the critics' halo
  error at ``time`` 8 of 16 frames.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dcvgan_torch.compat.from_jax import FROM_JAX
from dcvgan_torch.config import ExperimentConfig
from dcvgan_torch.models.layers import place_for_training
from dcvgan_torch.parallel import create_layout
from dcvgan_torch.parallel.temporal import conv3d_time_valid, time_sharded_conv3d
from dcvgan_torch.train.step import DCVGAN as PortGAN
from dcvgan_tpu.models.discriminators import GradientDiscriminator, VideoDiscriminator
from dcvgan_tpu.models.layers import MaskedSyncBatchNorm
from dcvgan_tpu.parallel.mesh import DATA_AXIS, TIME_AXIS, create_mesh
from dcvgan_tpu.parallel.temporal import halo_exchange, time_sharded_conv3d as jax_ts_conv3d
from dcvgan_tpu.train.step import DCVGAN as JaxGAN
from torch_dist_util import run_ranks
from torch_port_util import (
    as_tensors, flatten_tree, no_persistent_compile_cache, numpy_tree,  # noqa: F401
    port_stats, randomize_tree, record_jax_draws, step_raw, within,
)
from torch_port_util import one_intra_op_thread  # noqa: F401
from torch_time_util import ATOL, CONV_ATOL, CONV_RTOL, conv_grads, gather_frames

pytestmark = pytest.mark.usefixtures("no_persistent_compile_cache", "one_intra_op_thread")
WORLD, NTS = 4, (2, 4)
T, S, B = 16, 32, 2
BN_B, BN_C, BN_VALID = 4, 3, 13
CRITICS = ("vdis", "gdis")
JAX_CRITIC = {"vdis": VideoDiscriminator, "gdis": GradientDiscriminator}


def _mesh(nt, devices):
    return create_mesh(data=WORLD // nt, time=nt, devices=devices[:WORLD])


def _critic_raw(noise: bool) -> dict:
    crit = {"use_noise": noise, "noise_sigma": 0.1, "ndf": 8}
    return step_raw(image_size=S, vdis=crit, gdis=crit)


def _critic_set(noise: bool, seed: int) -> dict:
    """Randomised vdis and gdis (JAX variables and the port's state dicts),
    inputs, and with ``noise`` the unsharded forwards' draws read from a
    flax run."""
    rng = np.random.default_rng(seed)
    xg = rng.uniform(-1, 1, (B, T, S, S, 1)).astype(np.float32)
    xc = rng.uniform(-1, 1, (B, T, S, S, 3)).astype(np.float32)
    out = {"config": _critic_raw(noise), "xg": torch.from_numpy(xg), "xc": torch.from_numpy(xc),
           "state": {}, "variables": {}, "noise": {}}
    for name in CRITICS:
        jm = JAX_CRITIC[name](ch_g=1, ch_c=3, use_noise=noise, noise_sigma=0.1, ndf=8)
        v = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.key(0), "noise": jax.random.key(0)}, jnp.asarray(xg), jnp.asarray(xc)))
        variables = {"params": randomize_tree(v["params"], rng),
                     "batch_stats": randomize_tree(v["batch_stats"], rng)}
        out["variables"][name] = variables
        out["state"][name] = FROM_JAX[name](variables["params"], variables["batch_stats"])
        if noise:
            _, draws = record_jax_draws(lambda: jm.apply(
                variables, jnp.asarray(xg), jnp.asarray(xc), True,
                rngs={"noise": jax.random.key(seed)}, mutable=["batch_stats"]))
            out["noise"][name] = as_tensors(draws["noise"][0])
    return out


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, 8, 8, 2)).astype(np.float32)
    k = (rng.normal(size=(4, 3, 3, 2, 4)) * 0.1).astype(np.float32)  # JAX's THWIO
    bn_params = {"weight": rng.uniform(0.5, 1.5, BN_C), "bias": rng.normal(0, 0.1, BN_C),
                 "running_mean": rng.normal(0, 0.5, BN_C), "running_var": rng.uniform(0.5, 2, BN_C)}
    return {
        "nts": NTS,
        "halo_x": torch.arange(T, dtype=torch.float32).reshape(1, T, 1, 1, 1).expand(B, T, 4, 4, 1)
        .contiguous(),
        "x": torch.from_numpy(x),
        "k": k,
        "w": torch.from_numpy(np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2))),
        "ct": torch.from_numpy(rng.normal(size=(B, T, 4, 4, 4)).astype(np.float32)),
        "bn_x": torch.from_numpy(rng.normal(1.0, 2.0, (BN_B, T, 4, 4, BN_C)).astype(np.float32)),
        "bn_ct": torch.from_numpy(rng.normal(size=(BN_B, T, 4, 4, BN_C)).astype(np.float32)),
        "bn": {k: torch.tensor(v, dtype=torch.float32) for k, v in bn_params.items()},
        "bn_valid": BN_VALID,
        "critics": {"plain": _critic_set(False, 1), "noise": _critic_set(True, 2)},
    }


def payload_of(inputs, **over) -> dict:
    out = {k: v for k, v in inputs.items() if k != "critics"}
    out["critics"] = {kind: {k: v for k, v in c.items() if k != "variables"}
                      for kind, c in inputs["critics"].items()}
    return {**out, **over}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_ranks("torch_time_util.temporal_ops", WORLD, payload_of(inputs),
                     tmp_path_factory.mktemp("temporal"))


# -------------------------------------------------------------------- halo
@pytest.mark.parametrize("nt", NTS)
def test_halo_contents_are_bit_exact(devices, ranks, inputs, nt):
    mesh = _mesh(nt, devices)
    x = jnp.asarray(inputs["halo_x"].numpy())
    t_local = T // nt
    for halo in (1, 3):
        want = np.asarray(jax.shard_map(
            lambda xl: halo_exchange(xl, TIME_AXIS, halo), mesh=mesh,
            in_specs=P(None, TIME_AXIS), out_specs=P(None, TIME_AXIS))(x))
        for r in ranks:
            got = r[nt]["halo"][halo].numpy()
            ti = r[nt]["time_index"]
            block = want[:, ti * (t_local + halo): (ti + 1) * (t_local + halo)]
            np.testing.assert_array_equal(got, block)
            frames = got[0, :, 0, 0, 0]
            np.testing.assert_array_equal(frames[:t_local], np.arange(ti * t_local, (ti + 1) * t_local))
            tail = (ti + 1) * t_local + np.arange(halo) if ti < nt - 1 else np.zeros(halo)
            np.testing.assert_array_equal(frames[t_local:], tail)


# -------------------------------------------------------------------- conv
@pytest.mark.parametrize("nt", NTS)
def test_time_sharded_conv3d_matches_jax_and_its_gradient_the_unsharded_conv(devices, ranks, inputs, nt):
    want, valid = jax_ts_conv3d(jnp.asarray(inputs["x"].numpy()), jnp.asarray(inputs["k"]),
                                _mesh(nt, devices), spatial_stride=2)
    want = np.asarray(want)
    assert {r[nt]["conv"]["valid"] for r in ranks} == {valid} == {T - 3}
    got = gather_frames(ranks, nt, "conv", "y")
    # every data row convolves the whole batch here: row 0's frames
    got = got[:B].numpy()
    np.testing.assert_allclose(got[:, :valid], want[:, :valid], rtol=CONV_RTOL, atol=CONV_ATOL)
    np.testing.assert_array_equal(got[:, valid:], 0.0)
    np.testing.assert_array_equal(want[:, valid:], 0.0)

    x = inputs["x"].clone().requires_grad_(True)
    w = inputs["w"].clone().requires_grad_(True)
    y = conv3d_time_valid(x.movedim(-1, 1), w, 2).movedim(1, -1)
    (y * inputs["ct"][:, :valid]).sum().backward()
    dx, dw = conv_grads(ranks, nt)
    np.testing.assert_allclose(dx.numpy(), x.grad.numpy(), rtol=CONV_RTOL, atol=CONV_ATOL)
    np.testing.assert_allclose(dw.numpy(), w.grad.numpy(), rtol=CONV_RTOL, atol=CONV_ATOL)


def test_halo_larger_than_the_local_frames_and_uneven_time_raise(inputs):
    x, w = inputs["x"], inputs["w"]
    with pytest.raises(ValueError, match="halo 3 exceeds local time extent 2"):
        time_sharded_conv3d(x, w, create_layout(data=1, time=8, world=8, rank=0))
    with pytest.raises(ValueError, match="T=15 not divisible by time axis 2"):
        time_sharded_conv3d(x[:, :15], w, create_layout(data=1, time=2, world=2, rank=0))


def test_the_critics_raise_the_halo_error_at_time_8_of_16_frames():
    gan = PortGAN(ExperimentConfig.from_dict(_critic_raw(False)), device="cpu")
    layout = create_layout(data=1, time=8, world=8, rank=0)
    x = torch.zeros(B, T // 8, S, S, 3)
    for name in CRITICS:
        with pytest.raises(ValueError, match="local time extent 2 < halo 3"):
            gan._build(name)(x[..., :1], x, layout=layout)


# --------------------------------------------------------- masked BatchNorm
def _jax_masked_bn(inputs, mesh):
    """flax's MaskedSyncBatchNorm over (time, data) inside shard_map: output,
    the input and parameter gradients of sum(output * cotangent) taken
    outside it, new statistics."""
    p = {k: jnp.asarray(v.numpy()) for k, v in inputs["bn"].items()}
    params = {"scale": p["weight"], "bias": p["bias"]}
    stats = {"mean": p["running_mean"], "var": p["running_var"]}
    bn = MaskedSyncBatchNorm((TIME_AXIS, DATA_AXIS), torch_default_init=True)

    def local(params, x):
        t_local = x.shape[1]
        mask = jax.lax.axis_index(TIME_AXIS) * t_local + jnp.arange(t_local) < BN_VALID
        y, mut = bn.apply({"params": params, "batch_stats": stats}, x, mask, True,
                          mutable=["batch_stats"])
        return y, mut["batch_stats"]

    spec = P(DATA_AXIS, TIME_AXIS)
    sharded = jax.shard_map(local, mesh=mesh, in_specs=(P(), spec), out_specs=(spec, P()))
    ct = jnp.asarray(inputs["bn_ct"].numpy())

    def loss(params, x):
        y, new = sharded(params, x)
        return jnp.sum(y * ct), (y, new)

    grad = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, (y, new)), (dp, dx) = grad(params, jnp.asarray(inputs["bn_x"].numpy()))
    return y, dx, dp, new


@pytest.mark.parametrize("nt", NTS)
def test_masked_sync_batch_norm_matches_flax_inside_shard_map(devices, ranks, inputs, nt):
    y, dx, dp, new = _jax_masked_bn(inputs, _mesh(nt, devices))
    within(gather_frames(ranks, nt, "bn", "y").numpy(), np.asarray(y), ATOL)
    within(gather_frames(ranks, nt, "bn", "dx").numpy(), np.asarray(dx), ATOL)
    # each rank's parameter gradient is its own frames' share
    for key, k in (("dweight", "scale"), ("dbias", "bias")):
        within(sum(r[nt]["bn"][key] for r in ranks).numpy(), np.asarray(dp[k]), ATOL, ATOL)
    for r in ranks:
        bn = r[nt]["bn"]
        within(bn["mean"].numpy(), np.asarray(new["mean"]), ATOL)
        within(bn["var"].numpy(), np.asarray(new["var"]), ATOL)
    # the frames past the valid ones were in no statistic: the sharded mean
    # is that of the first 13 frames of the whole batch
    x = inputs["bn_x"].numpy()[:, :BN_VALID].astype(np.float64)
    m = 0.9 * inputs["bn"]["running_mean"].numpy() + 0.1 * x.mean(axis=(0, 1, 2, 3))
    within(ranks[0][nt]["bn"]["mean"].numpy(), m, 1e-5)


# ---------------------------------------------------------------- critics
def _port_unsharded(crit, name):
    """The port's unsharded train-mode forward on the whole batch: logits
    and the state dict after it."""
    gan = PortGAN(ExperimentConfig.from_dict(copy.deepcopy(crit["config"])), device="cpu")
    module = place_for_training(gan._build(name), torch.device("cpu"), torch.float32)
    module.load_state_dict(crit["state"][name])
    with torch.no_grad():
        y = module(crit["xg"], crit["xc"], train=True, noise=crit["noise"].get(name))
    return y, module


def _port_stats_of(name, crit, stats):
    gan = PortGAN(ExperimentConfig.from_dict(copy.deepcopy(crit["config"])), device="cpu")
    module = gan._build(name)
    module.load_state_dict({**crit["state"][name], **stats})
    return port_stats(name, module)


def _logits(ranks, nt, kind, name):
    """The ranks' logits: every time rank of a row holds the row's whole
    logits (equal there); the rows in batch order."""
    by_row = {}
    for r in ranks:
        y = r[nt]["critics"][kind][name]["logits"]
        prev = by_row.setdefault(r[nt]["row"], y)
        assert torch.equal(prev, y)
    return torch.cat([by_row[d] for d in sorted(by_row)])


@pytest.mark.parametrize("nt", NTS)
@pytest.mark.parametrize("name", CRITICS)
def test_time_sharded_critics_match_jax_and_the_unsharded_forward(devices, ranks, inputs, name, nt):
    crit = inputs["critics"]["plain"]
    variables = crit["variables"][name]
    jm = JAX_CRITIC[name](ch_g=1, ch_c=3, use_noise=False, noise_sigma=0.1, ndf=8,
                          time_axis=TIME_AXIS, bn_sync_axes=(DATA_AXIS,))
    apply = JaxGAN._time_sharded_apply(None, jm, _mesh(nt, devices))
    want, want_stats = jax.jit(apply)(variables["params"], variables["batch_stats"],
                                      jnp.asarray(crit["xg"].numpy()), jnp.asarray(crit["xc"].numpy()),
                                      jax.random.key(0))
    got = _logits(ranks, nt, "plain", name)
    assert got.shape == want.shape == (B, {"vdis": 4, "gdis": 3}[name], 2, 2)
    within(got.numpy(), np.asarray(want), ATOL)
    plain, module = _port_unsharded(crit, name)
    within(got.numpy(), plain.numpy(), ATOL)
    want_stats = flatten_tree(numpy_tree(want_stats))
    unsharded = port_stats(name, module)
    for r in ranks:
        stats = _port_stats_of(name, crit, r[nt]["critics"]["plain"][name]["stats"])
        assert stats.keys() == want_stats.keys()
        for k, v in want_stats.items():
            within(stats[k], v, ATOL)
            within(stats[k], unsharded[k], ATOL)


@pytest.mark.parametrize("nt", NTS)
@pytest.mark.parametrize("name", CRITICS)
def test_time_sharded_critics_with_noise_take_their_frames_of_the_draw(ranks, inputs, name, nt):
    crit = inputs["critics"]["noise"]
    assert crit["noise"][name]
    plain, module = _port_unsharded(crit, name)
    within(_logits(ranks, nt, "noise", name).numpy(), plain.numpy(), ATOL)
    unsharded = port_stats(name, module)
    for r in ranks:
        stats = _port_stats_of(name, crit, r[nt]["critics"]["noise"][name]["stats"])
        for k, v in unsharded.items():
            within(stats[k], v, ATOL)
