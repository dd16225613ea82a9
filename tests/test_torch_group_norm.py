"""``trainer.norm: group`` in the port against the JAX package.

``ChannelGroupNorm`` alone on 4D and 5D inputs, in f32 and bf16; each of
the five models built with ``norm="group"`` in train and eval mode, from a
flax tree carried over by ``compat/from_jax.py`` (the JAX package's
``*_from_torch`` reads BatchNorm statistics a GroupNorm lacks, so weights
cross from JAX to the port only); the colour generator's eval-mode down
path, which a GroupNorm keeps off the fused kernel; one whole train step
shaped like ``configs/headtohead-tpu-seed0-10k-stable-gn.yml``; the
channels-last strides of every conv weight after either placement; and a
GroupNorm run trained for a step, restored and served on the CPU.

**Tolerances.** The layer: f32 measured max |diff| 3.1e-5 on outputs up to
5.4 (a group of one channel whose mean is large against its spread: the
packages sum the variance in another order), held at 5e-5; bf16 outputs
are each rounded once from f32 values that close, so they may land one
bf16 ulp apart (2^-7 of the value; measured 2.4e-4 at 5.3): held at 2^-7
relative + 1e-6. The models in f32 at ``ATOL_F32``. The step: the
train-step suite's tolerances (``tests/test_torch_train_step.py``), per
model at its own learning rate, not tightened (see
``tests/test_torch_levers.py`` for a state that comes within 1% of them).
Measured over two states (seeds 11, 13): losses 2.4e-7; gradients per
tensor up to 1.7e-2 of the tensor's largest (cgen) and 3.3e-3 in L2, the
critics up to 5.5e-6.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvgan_torch.compat import from_jax
from dcvgan_torch.compat.from_jax import load_gan_state_
from dcvgan_torch.models import cgen as port_cgen
from dcvgan_torch.models import discriminators as port_dis
from dcvgan_torch.models.ggen import GeometricVideoGenerator as PortGGen
from dcvgan_torch.models.layers import (
    ChannelGroupNorm, Norm, cast_for_compute, init_weights_, norm_layer, place_for_training,
)
from dcvgan_torch.train.step import DCVGAN as PortGAN
from dcvgan_tpu.models import (
    ColorVideoGenerator, GeometricVideoGenerator, GradientDiscriminator, ImageDiscriminator,
    VideoDiscriminator,
)
from dcvgan_tpu.models.layers import ChannelGroupNorm as JaxGroupNorm
from dcvgan_tpu.train.step import DCVGAN as JaxGAN
from torch_port_util import (
    ATOL_F32, LOSSES, MODEL_NAMES, as_tensors, flatten_tree, gradients_close, jax_state,
    jax_trees, numpy_tree, one_intra_op_thread, port_tree, randomize_tree, record_jax_draws,
    run_pair, step_batch, step_configs, within,
)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
# channels -> groups: the largest divisor of C that is at most 32
GROUPS = {4: 4, 8: 8, 24: 24, 48: 24, 96: 32}
GN_ATOL_F32, GN_RTOL_BF16 = 5e-5, 2.0**-7


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ndim", [4, 5], ids=["4d", "5d"])
@pytest.mark.parametrize("c", sorted(GROUPS))
def test_channel_group_norm_matches_jax(c, ndim, dtype):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    rng = np.random.default_rng(c * 10 + ndim)
    shape = (3, 5, 6, c) if ndim == 4 else (2, 3, 4, 5, c)
    x = (rng.normal(size=shape) * rng.uniform(0.5, 3.0, c) + 2 * rng.normal(size=c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0.0, 0.5, c).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    want = JaxGroupNorm(dtype=jdt).apply({"params": {"scale": scale, "bias": bias}}, jx)

    gn = ChannelGroupNorm(c)
    assert gn.num_groups == GROUPS[c]
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
        tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt).movedim(-1, 1)
        got = gn(tx, True, True)
        assert got.dtype == tdt and got.shape == tx.shape
        fmt = torch.channels_last if ndim == 4 else torch.channels_last_3d
        assert got.is_contiguous(memory_format=fmt)  # the conv after keeps its layout
        got_np, want_np = got.movedim(1, -1).float().numpy(), np.asarray(want, np.float32)
        if dtype == "bf16":
            within(got_np, want_np, 1e-6, GN_RTOL_BF16)
        else:
            within(got_np, want_np, GN_ATOL_F32)
        # no state: eval mode computes the same thing
        assert torch.equal(gn(tx, False, False), got)
    assert not list(gn.buffers())


def test_norm_layer_takes_each_batch_norms_init():
    g = torch.Generator().manual_seed(0)
    m = torch.nn.Sequential(norm_layer("group", 64), norm_layer("group", 64, ndim=3))
    init_weights_(m, g)
    assert 0 < (m[0].weight - 1).abs().max() < 0.2 and m[0].weight.std() > 0.01  # N(1, 0.02)
    assert torch.equal(m[1].weight, torch.ones(64))  # the video critics' torch default
    assert torch.equal(m[0].bias, torch.zeros(64)) and torch.equal(m[1].bias, torch.zeros(64))
    assert isinstance(norm_layer("batch", 8), Norm) and isinstance(norm_layer("batch", 8, 3), Norm)
    with pytest.raises(ValueError, match="layer"):
        norm_layer("layer", 8)


# ------------------------------------------------------------ the five models
DZC, DZM, DZ_COLOR, B, T = 6, 4, 4, 2, 4
NDF, S2, S3 = 8, 64, 32  # the critics' width and frame sizes (2D, 3D)


def _jax_model(name, jdt=jnp.float32):
    if name == "ggen":
        return GeometricVideoGenerator(dim_z_content=DZC, dim_z_motion=DZM, channel=1, ngf=8,
                                       video_length=T, dtype=jdt, norm="group")
    if name == "cgen":
        return ColorVideoGenerator(in_ch=1, dim_z=DZ_COLOR, ngf=8, video_length=T, dtype=jdt,
                                   norm="group")
    critic = {"idis": ImageDiscriminator, "vdis": VideoDiscriminator, "gdis": GradientDiscriminator}
    return critic[name](ch_g=1, ch_c=3, use_noise=True, noise_sigma=0.1, ndf=NDF, dtype=jdt,
                        norm="group")


def _port_model(name, norm="group"):
    if name == "ggen":
        return PortGGen(dim_z_content=DZC, dim_z_motion=DZM, channel=1, ngf=8, video_length=T,
                        norm=norm)
    if name == "cgen":
        return port_cgen.ColorVideoGenerator(in_ch=1, dim_z=DZ_COLOR, ngf=8, video_length=T,
                                             norm=norm)
    critic = {"idis": port_dis.ImageDiscriminator, "vdis": port_dis.VideoDiscriminator,
              "gdis": port_dis.GradientDiscriminator}
    return critic[name](ch_g=1, ch_c=3, use_noise=True, noise_sigma=0.1, ndf=NDF, norm=norm)


def _critic_inputs(name, seed):
    rng = np.random.default_rng(seed)
    lead = (B, S2, S2) if name == "idis" else (B, 16, S3, S3)
    return (rng.uniform(-1, 1, lead + (1,)).astype(np.float32),
            rng.uniform(-1, 1, lead + (3,)).astype(np.float32))


def _init_args(name):
    if name == "ggen":
        return ({"params": jax.random.key(0), "latent": jax.random.key(0)}, 1), {"train": False}
    if name == "cgen":
        return ((jax.random.key(0), jnp.zeros((1, 64, 64, 1)), jnp.zeros((1, DZ_COLOR))),
                {"train": False})
    xg, xc = _critic_inputs(name, 0)
    return ({"params": jax.random.key(0), "noise": jax.random.key(0)}, xg, xc), {}


def _group_models(name, seed):
    """(flax module, its variables, the port module in f32) with the same
    randomised weights. A GroupNorm model has no ``batch_stats``."""
    jm = _jax_model(name)
    args, kw = _init_args(name)
    shapes = jax.eval_shape(lambda: jm.init(*args, **kw))
    assert "batch_stats" not in shapes
    params = randomize_tree(shapes["params"], np.random.default_rng(seed))
    pm = _port_model(name)
    pm.load_state_dict(from_jax.FROM_JAX[name](params, {}))  # strict
    return jm, {"params": params}, place_for_training(pm, CPU, torch.float32)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", MODEL_NAMES)
def test_models_under_group_norm_match_jax(name, train):
    jm, variables, pm = _group_models(name, seed=MODEL_NAMES.index(name))
    with torch.no_grad():
        if name == "ggen":
            want, d = record_jax_draws(lambda: jm.apply(
                variables, B, train=train, rngs={"latent": jax.random.key(3)}))
            z = d["z"][0].reshape(B, T, -1)
            got = pm(torch.from_numpy(z[:, 0, :DZC]), torch.from_numpy(d["e"][0]),
                     torch.from_numpy(d["h0"][0]), train=train)
        elif name == "cgen":
            xs = np.random.default_rng(2).uniform(-1, 1, (B, T, 64, 64, 1)).astype(np.float32)
            want, d = record_jax_draws(lambda: jm.apply(
                variables, jnp.asarray(xs), train=train,
                rngs={"latent": jax.random.key(4), "dropout": jax.random.key(5)},
                method=ColorVideoGenerator.forward_videos))
            masks = [torch.from_numpy(m) for m in d["dropout"]]
            assert len(masks) == (2 if train else 0)
            z = torch.from_numpy(d["z_color"][0].reshape(B, T, -1)[:, 0])
            got = pm.forward_videos(torch.from_numpy(xs), z, train=train,
                                    dropout_masks=masks or None)
        else:
            xg, xc = _critic_inputs(name, 2)
            want, d = record_jax_draws(lambda: jm.apply(
                variables, jnp.asarray(xg), jnp.asarray(xc), train,
                rngs={"noise": jax.random.key(5)}))
            got = pm(torch.from_numpy(xg), torch.from_numpy(xc), train=train,
                     noise=as_tensors(d["noise"][0]))
    assert got.shape == want.shape
    within(got.numpy(), np.asarray(want), ATOL_F32)
    assert not [k for k, _ in pm.named_buffers()]  # no running statistics


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_a_group_norm_state_crosses_from_jax(name):
    """``from_jax`` of a GroupNorm tree: the reference layout's keys without
    the running statistics, each norm's ``scale/bias`` as ``weight/bias``."""
    jm = _jax_model(name)
    args, kw = _init_args(name)
    params = randomize_tree(jax.eval_shape(lambda: jm.init(*args, **kw))["params"],
                            np.random.default_rng(7))
    sd = from_jax.FROM_JAX[name](params, {})
    bn_keys = set(_port_model(name, "batch").state_dict())
    stat_keys = {k for k in bn_keys if k.rsplit(".", 1)[1] in
                 ("running_mean", "running_var", "num_batches_tracked")}
    assert stat_keys and set(sd) == bn_keys - stat_keys
    pm = _port_model(name)
    pm.load_state_dict(sd)  # strict
    norms = [k for k, m in pm.named_modules() if isinstance(m, ChannelGroupNorm)]
    assert norms
    flat = flatten_tree(params)
    want = {k.rsplit("/", 1)[0]: v for k, v in flat.items() if k.endswith("/scale")}
    got = sorted(pm.get_submodule(k).weight.detach().numpy().tobytes() for k in norms)
    assert got == sorted(v.tobytes() for v in want.values())


def test_whole_group_norm_state_crosses_with_adam_moments_and_ema():
    jcfg, pcfg = step_configs(trainer={"norm": "group", "ema_decay": 0.5})
    jgan, pgan = JaxGAN(jcfg), PortGAN(pcfg, device="cpu")
    trees = jax_trees(jax_state(jgan, seed=8, step=5))
    rng = np.random.default_rng(9)
    for name in MODEL_NAMES:
        assert trees[name]["batch_stats"] == {}
        trees[name]["opt"] = {"count": 5, "mu": randomize_tree(trees[name]["params"], rng),
                              "nu": randomize_tree(trees[name]["params"], rng)}
    pstate = pgan.init_state(0)
    load_gan_state_(pstate, trees)
    assert pstate.step == 5
    for name in MODEL_NAMES:
        module = getattr(pstate, name)
        got = flatten_tree(port_tree(name, module, dict(module.named_parameters())))
        for k, v in flatten_tree(trees[name]["params"]).items():
            np.testing.assert_array_equal(got[k], v)
        by_param = {k: pstate.opt[name].state[p] for k, p in module.named_parameters()}
        nu = flatten_tree(port_tree(name, module, {k: s["exp_avg_sq"] for k, s in by_param.items()}))
        for k, v in flatten_tree(trees[name]["opt"]["nu"]).items():
            np.testing.assert_array_equal(nu[k], v)
    for name in ("ggen", "cgen"):
        got = flatten_tree(port_tree(name, getattr(pstate, name), pstate.ema[name]))
        for k, v in flatten_tree(trees["ema"][name]).items():
            np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("norm,launches", [("batch", 5), ("group", 0)])
def test_eval_mode_cgen_runs_the_fused_op_under_batch_norm_only(monkeypatch, norm, launches):
    calls = []
    fused = port_cgen.fused_norm_act_conv

    def counted(*args, **kwargs):
        calls.append(None)
        return fused(*args, **kwargs)

    monkeypatch.setattr(port_cgen, "fused_norm_act_conv", counted)
    pm = _port_model("cgen", norm)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    pm = cast_for_compute(pm, CPU, torch.float32)
    xs = torch.rand(B, T, 64, 64, 1) * 2 - 1
    with torch.no_grad():
        out = pm.forward_videos(xs, torch.randn(B, DZ_COLOR))
        masks = pm.dropout_masks(B * T, torch.Generator().manual_seed(1), CPU)
        train = pm.forward_videos(xs, torch.randn(B, DZ_COLOR), train=True, update_stats=False,
                                  dropout_masks=masks)
    assert len(calls) == launches  # the train-mode forward runs unfused either way
    assert out.shape == train.shape == (B, T, 64, 64, 3) and torch.isfinite(out).all()


# ---------------------------------------------------- channels-last weights
def _placed(name, norm, placement):
    pm = _port_model(name, norm)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    if placement == "cast_bf16":
        return cast_for_compute(pm, CPU, torch.bfloat16)
    return place_for_training(pm, CPU, torch.float32)


# the one-input-channel weights, where NCHW and channels-last strides differ
# while both layouts pass is_contiguous
ONE_INPUT_CHANNEL = {
    "ggen": "main.12.weight",  # the last transposed conv, (ngf, 1, 4, 4)
    "cgen": "inconv.main.0.weight",  # (ngf, 1, 3, 3)
    "idis": "conv_g.1.weight",  # the depth stem, (ndf/2, 1, 4, 4)
    "vdis": "conv_g.0.weight",  # (ndf/2, 1, 4, 4, 4)
    "gdis": "main.1.weight",  # (ndf, 1, 4, 4, 4)
}


@pytest.mark.parametrize("placement", ["cast_bf16", "place_f32"])
@pytest.mark.parametrize("norm", ["batch", "group"])
@pytest.mark.parametrize("name", MODEL_NAMES)
def test_conv_weights_carry_channels_last_strides(name, norm, placement):
    """After ``cast_for_compute`` (bf16) and ``place_for_training`` (f32),
    every 4D and 5D weight has the strides a channels-last tensor of its
    shape has. ``Tensor.contiguous(memory_format=...)`` would leave a
    ``(., 1, ., .)`` weight's NCHW strides, which cuDNN reads as NCHW."""
    pm = _placed(name, norm, placement)
    seen = set()
    for k, p in pm.named_parameters():
        if p.dim() in (4, 5):
            fmt = torch.channels_last if p.dim() == 4 else torch.channels_last_3d
            want = torch.empty(p.shape, memory_format=fmt).stride()
            assert p.stride() == want, (k, p.shape, p.stride(), want)
            seen.add(k)
        elif p.dim() == 1 and isinstance(pm.get_submodule(k.rsplit(".", 1)[0]), Norm):
            assert p.dtype == torch.float32, k  # norm parameters stay f32
    one = ONE_INPUT_CHANNEL[name]
    assert one in seen and dict(pm.named_parameters())[one].shape[1] == 1
    conv_dtype = torch.bfloat16 if placement == "cast_bf16" else torch.float32
    assert dict(pm.named_parameters())[one].dtype == conv_dtype


# ------------------------------------------------------ one GroupNorm step
# configs/headtohead-tpu-seed0-10k-stable-gn.yml at ngf/ndf 8: adversarial
# loss, EMA 0.99, noise 0.2 on every critic, the critics at lr 5e-5, all
# with weight decay 1e-5
GN_LR = {"ggen": 2e-4, "cgen": 2e-4, "idis": 5e-5, "vdis": 5e-5, "gdis": 5e-5}


@pytest.fixture(scope="module")
def gn_step():
    over = {name: {"optimizer": {"lr": lr, "decay": 1e-5}} for name, lr in GN_LR.items()}
    for name in ("idis", "vdis", "gdis"):
        over[name].update(use_noise=True, noise_sigma=0.2)
    jcfg, pcfg = step_configs(loss="adversarial-loss",
                              trainer={"norm": "group", "ema_decay": 0.99}, **over)
    return run_pair(jcfg, pcfg, seed=11, batch=step_batch(12, np.uint8))


def test_group_norm_step_losses_match_jax(gn_step):
    _, jbefore, jafter, jm, _, pstate, pm = gn_step
    assert all(not ms.batch_stats for ms in jbefore.models.values())
    assert pstate.step == int(jafter.step) == 1
    for k in LOSSES:
        within(pm[k].numpy(), np.asarray(jm[k]), ATOL_F32, ATOL_F32)
    for name, module in pstate.models.items():
        assert not list(module.buffers()), name


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_group_norm_step_gradients_match_jax(gn_step, name):
    """cgen's innermost norm sees one value per group (1x1 pixels, 32
    channels in 32 groups at ngf 8): it outputs its bias, so neither its
    scale nor the conv before it gets a gradient in JAX. torch's kernel
    normalises as ``x * rstd - mean * rstd`` with rstd = eps^-1/2, which
    leaves a rounding residue: measured up to 1.5e-7 (scale) and 1.4e-6
    (conv) against a largest cgen gradient of 0.14-0.19 (three seeds), at
    most 9e-6 of it."""
    jgan, jbefore, jafter, _, _, pstate, _ = gn_step
    zero = ("down5_bn/scale", "down5_conv/kernel") if name == "cgen" else ()
    gradients_close(jgan, jbefore, jafter, pstate, name, zero=zero)


def test_group_norm_step_parameters_adam_state_and_ema_follow_jax(gn_step):
    """Adam took one step everywhere; every parameter within 2.5 of its
    model's lr of JAX's, and the EMA within (1 - decay) of that."""
    _, _, jafter, _, _, pstate, _ = gn_step
    for name in MODEL_NAMES:
        module = getattr(pstate, name)
        got = flatten_tree(port_tree(name, module, dict(module.named_parameters())))
        want = flatten_tree(numpy_tree(getattr(jafter, name).params))
        assert set(got) == set(want)
        for k in want:
            within(got[k], want[k], 2.5 * GN_LR[name])
        steps = {float(s["step"]) for s in pstate.opt[name].state.values()}
        assert steps == {1.0} and int(getattr(jafter, name).opt_state[1].count) == 1
        by_param = {k: pstate.opt[name].state[p] for k, p in module.named_parameters()}
        nu = flatten_tree(port_tree(name, module, {k: s["exp_avg_sq"] for k, s in by_param.items()}))
        for k, v in flatten_tree(numpy_tree(getattr(jafter, name).opt_state[1].nu)).items():
            # (1 - b2) g^2: the squared gradients' agreement
            within(nu[k], v, 0.2 * float(np.abs(v).max()) + 1e-12)
    for name in ("ggen", "cgen"):
        got = flatten_tree(port_tree(name, getattr(pstate, name), pstate.ema[name]))
        want = flatten_tree(numpy_tree(jafter.ema[name]))
        for k in want:
            within(got[k], want[k], 0.025 * GN_LR[name] + 1e-6)


# ------------------------------------------------ a GroupNorm run, end to end
def test_a_group_norm_run_trains_restores_and_serves(tmp_path, monkeypatch):
    """``configs/debug-mock-depth.yml`` with ``trainer.norm: group`` and an
    EMA: one ``cli.train`` step on the CPU, then ``load_run`` rebuilds the
    run from its config and checkpoint (equal tensors, no running
    statistics) and ``GenerationServer`` serves it: a seed replays its
    bytes, and the colour generator never reaches the fused op."""
    import yaml

    from dcvgan_torch.cli import train as cli_train
    from dcvgan_torch.cli.infer import load_run
    from dcvgan_torch.cli.serve import GenerationServer

    raw = yaml.safe_load((REPO / "configs" / "debug-mock-depth.yml").read_text())
    raw.update(log_dir=str(tmp_path / "result"), tensorboard_dir=str(tmp_path / "runs"))
    raw["dataset"].update(path=str(tmp_path / "raw"), processed_root=str(tmp_path / "processed"))
    raw["trainer"] = {**raw.get("trainer", {}), "norm": "group", "ema_decay": 0.5}
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(raw))
    trainer = cli_train.main(["--config", str(tmp_path / "cfg.yml"), "--device", "cpu"])
    trainer.loader.close()
    state, run_dir = trainer.state, trainer.run_dir

    cfg, gan, restored = load_run(run_dir, -1, device="cpu")
    assert cfg.trainer.norm == "group" and restored.step == state.step >= 1
    for name, module in restored.models.items():
        assert not list(module.buffers()), name
        assert any(isinstance(m, ChannelGroupNorm) for m in module.modules()), name
        for (k, a), b in zip(state.models[name].state_dict().items(),
                             module.state_dict().values()):
            assert torch.equal(a, b), (name, k)
    for name in ("ggen", "cgen"):
        for k, v in state.ema[name].items():
            assert torch.equal(v, restored.ema[name][k]), (name, k)

    calls = []
    monkeypatch.setattr(port_cgen, "fused_norm_act_conv", lambda *a, **k: calls.append(None))
    server = GenerationServer(gan, restored.generators().with_ema_params(), batchsize=2,
                              iters_per_chunk=1, geo_name="depth")
    _, a = server.generate(3, seed=7)
    _, b = server.generate(3, seed=7)
    _, c = server.generate(3, seed=8)
    server.close()
    assert a.shape == (3, 16, 64, 64, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c) and not calls
