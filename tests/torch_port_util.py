"""Shared helpers of the PyTorch port's tests (``test_torch_*.py``).

Inputs are drawn with numpy and handed to both packages; flax trees cross
into the port through ``dcvgan_torch.compat.from_jax``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

NGF = 8
ATOL_F32 = 2e-4  # the JAX parity suite's tolerance (tests/test_torch_parity.py)


def randomize_tree(tree, rng: np.random.Generator):
    """A flax params/batch_stats tree (of arrays or shape structs, e.g. from
    ``jax.eval_shape`` of an init) with every leaf drawn at a scale that keeps
    activations O(1): conv kernels ~ N(0, 1/fan_in), BN scale U(0.5, 1.5),
    biases N(0, 0.1), running mean N(0, 0.5), var U(0.5, 2)."""
    out = {}
    for k, v in tree.items():
        if not hasattr(v, "shape"):
            out[k] = randomize_tree(v, rng)
            continue
        shape = tuple(v.shape)
        if k == "kernel":
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 2 else shape[0]
            leaf = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        elif k == "scale":
            leaf = rng.uniform(0.5, 1.5, shape)
        elif k == "bias":
            leaf = rng.normal(0.0, 0.1, shape)
        elif k == "mean":
            leaf = rng.normal(0.0, 0.5, shape)
        elif k == "var":
            leaf = rng.uniform(0.5, 2.0, shape)
        else:
            raise KeyError(k)
        out[k] = leaf.astype(np.float32)
    return out


def flatten_tree(tree, prefix: str = ""):
    """{"a": {"b": x}} -> {"a/b": x}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> (N, C, H, W) torch view in channels-last memory."""
    return torch.from_numpy(np.array(x, order="C")).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    """(N, C, H, W) torch -> NHWC float32 numpy."""
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def hwio_to_torch(w: np.ndarray) -> torch.Tensor:
    """HWIO (4, 4, C, Cout) -> torch (Cout, C, 4, 4) in channels-last memory."""
    return torch.from_numpy(np.array(w.transpose(3, 0, 1, 2), order="C")).permute(0, 3, 1, 2)


def within(got: np.ndarray, want: np.ndarray, atol: float, rtol: float = 0.0) -> float:
    """Assert |got - want| <= atol + rtol*|want| everywhere; return max |diff|."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got - want)
    bad = d > atol + rtol * np.abs(want)
    assert not bad.any(), f"{int(bad.sum())} of {d.size} off, max |diff| {d.max():.3e}"
    return float(d.max())


def record_jax_draws(fn):
    """Run ``fn()`` (flax ``apply`` calls, outside ``jit``) and return
    ``(fn's result, draws)``, where ``draws`` holds every random number the
    flax modules drew on the way, as numpy:

    - ``noise``: ``{Noise layer name: unit-normal draw}`` per critic call, in
      call order (a list of dicts);
    - ``dropout``: the keep masks ``(N, C)`` of the colour generator's
      Dropout layers, in call order;
    - ``z_color``: the latents handed to ``ColorVideoGenerator.__call__``;
    - ``e``, ``h0``, ``z``: the GRU's inputs and ``decode``'s latents.

    The JAX package is not touched: ``nn.intercept_methods`` replaces the
    Noise and Dropout calls by the same arithmetic with the draw written
    down. A replaced call asks ``make_rng`` once, as the original does, so
    the numbers are the ones an unobserved (or jitted) run draws.
    """
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from dcvgan_tpu.models import ColorVideoGenerator, GeometricVideoGenerator
    from dcvgan_tpu.models.layers import Noise

    draws = {"noise": [], "dropout": [], "z_color": [], "e": [], "h0": [], "z": []}

    def interceptor(next_fun, args, kwargs, context):
        mod, name = context.module, context.method_name
        if isinstance(mod, Noise) and name == "__call__":
            x = args[0]
            if not mod.use_noise:
                return x
            noise = jax.random.normal(mod.make_rng("noise"), x.shape, mod.dtype)
            draws["noise"][-1][mod.name] = np.array(noise, np.float32)
            return x + jnp.asarray(mod.sigma, mod.dtype) * noise
        if isinstance(mod, nn.Dropout) and name == "__call__":
            x = args[0]
            if mod.deterministic:
                return x
            shape = list(x.shape)
            for dim in mod.broadcast_dims:
                shape[dim] = 1
            mask = jax.random.bernoulli(mod.make_rng(mod.rng_collection), 1.0 - mod.rate, shape)
            draws["dropout"].append(np.array(mask).reshape(x.shape[0], x.shape[-1]))
            return jax.lax.select(
                jnp.broadcast_to(mask, x.shape), x / (1.0 - mod.rate), jnp.zeros_like(x))
        if isinstance(mod, ColorVideoGenerator) and name == "__call__":
            draws["z_color"].append(np.array(args[1], np.float32))
        if isinstance(mod, GeometricVideoGenerator) and name == "decode":
            draws["z"].append(np.array(args[0], np.float32))
        if isinstance(mod, nn.RNN) and name == "__call__":
            draws["e"].append(np.array(args[0], np.float32))
            draws["h0"].append(np.array(kwargs["initial_carry"], np.float32))
        if name == "__call__" and type(mod).__name__.endswith("Discriminator"):
            draws["noise"].append({})
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(interceptor):
        out = fn()
    return out, draws


def as_tensors(tree):
    """A dict (or list) of numpy arrays as torch tensors."""
    if isinstance(tree, dict):
        return {k: as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [as_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def numpy_tree(tree):
    """A flax tree of jax arrays as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


# ------------------------------------------------ one train step of both packages
# The shapes of every train-step test: ngf/ndf 8, B=2, T=16, 64x64. The JAX
# step draws inside itself from named keys; ``step_draws`` rebuilds each key
# with the public ``dcvgan_tpu.prng`` functions and runs the flax modules once
# outside ``jit`` (``record_jax_draws``) to read the draws the step will make,
# and the port's step takes them as ``StepDraws``.
B, T, S = 2, 16, 64
LOSSES = ("loss_idis", "loss_vdis", "loss_gdis", "loss_gen")
LR = 2e-4
MODEL_NAMES = ("ggen", "cgen", "idis", "vdis", "gdis")
# whole-step gradients: see tests/test_torch_train_step.py's docstring
GRAD_RTOL, GRAD_L2 = 8e-2, 3e-2


def from_torch(name):
    """``dcvgan_tpu.compat.<name>_from_torch``."""
    from dcvgan_tpu import compat

    return getattr(compat, f"{name}_from_torch")


def step_raw(**over):
    """The raw config of the train-step tests; a dict entry of ``over``
    updates that section, any other value replaces it."""
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


def step_configs(**over):
    """(JAX config, port config) of ``step_raw(**over)``."""
    import copy

    from dcvgan_torch.config import ExperimentConfig as PortConfig
    from dcvgan_tpu.config import ExperimentConfig as JaxConfig

    raw = step_raw(**over)
    jcfg, pcfg = JaxConfig.from_dict(copy.deepcopy(raw)), PortConfig.from_dict(copy.deepcopy(raw))
    jcfg.trainer.donate_state = False
    jcfg.validate()
    pcfg.validate()
    return jcfg, pcfg


def step_batch(seed, dtype, batch: int = B, size: int = S):
    """A loader batch of uint8 (or the same dequantised to float32) colour
    and depth videos."""
    rng = np.random.default_rng(seed)
    u8 = {"color": rng.integers(0, 256, (batch, T, size, size, 3), dtype=np.uint8),
          "depth": rng.integers(0, 256, (batch, T, size, size, 1), dtype=np.uint8)}
    if dtype == np.uint8:
        return u8
    return {k: v.astype(np.float32) / np.float32(127.5) - np.float32(1.0) for k, v in u8.items()}


def jax_state(gan, seed: int, step: int = 0):
    """A JAX state whose parameters and statistics are drawn at a scale that
    keeps activations O(1), with fresh Adam states."""
    import jax
    import jax.numpy as jnp

    from dcvgan_tpu import prng as jax_prng
    from dcvgan_tpu.train.state import GANState, ModelState

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
    return GANState(step=jnp.asarray(step, jnp.int32), ema=ema, **models)


def jax_trees(state) -> dict:
    """A JAX ``GANState`` as the numpy trees ``load_gan_state_`` reads."""
    trees = {"step": int(state.step), "ema": None if state.ema is None else numpy_tree(state.ema)}
    for name, ms in state.models.items():
        adam = ms.opt_state[1]
        trees[name] = {
            "params": numpy_tree(ms.params), "batch_stats": numpy_tree(ms.batch_stats),
            "opt": {"count": int(adam.count), "mu": numpy_tree(adam.mu), "nu": numpy_tree(adam.nu)},
        }
    return trees


def port_state(pgan, jstate):
    """The port's ``GANState`` equal to ``jstate``."""
    from dcvgan_torch.compat.from_jax import load_gan_state_

    state = pgan.init_state(0)
    load_gan_state_(state, jax_trees(jstate))
    return state


def step_draws(gan, state, key, step: int, batch: int = B, replica=None, size: int = S):
    """The draws ``gan.train_step`` makes at 1-based ``step`` under ``key``
    for a batch of ``batch`` of ``size``-pixel frames, as the port's
    ``StepDraws``: under
    ``shared_fakes`` no ``d_fake`` latents, under ``critic_joint_batch`` the
    critics' D-phase noise of the ``joint`` stream for the 2B batch. With
    ``replica`` r, those of replica r of ``sharded_train_step``: its streams
    fold r into the step's key, ``t_rand`` stays the step's."""
    import jax
    import jax.numpy as jnp

    from dcvgan_torch.train.step import Latents, StepDraws
    from dcvgan_tpu import prng as jax_prng
    from dcvgan_tpu.models import ColorVideoGenerator as JaxCGen

    cfg = gan.config
    B = batch
    kstep = jax_prng.for_step(key, step)
    t_rand = int(jax.random.randint(jax_prng.named(kstep, "t_rand"), (), 0, cfg.video_length))
    if replica is not None:
        kstep = jax.random.fold_in(kstep, replica)
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

    def noise(name, k, batch=B):
        lead = (batch, size, size) if name == "idis" else (batch, T, size, size)
        ms = getattr(state, name)
        _, d = record_jax_draws(lambda: gan.modules[name].apply(
            {"params": ms.params, "batch_stats": ms.batch_stats},
            jnp.zeros(lead + (1,), gan.dtype), jnp.zeros(lead + (3,), gan.dtype), True,
            rngs={"noise": k}, mutable=["batch_stats"]))
        return as_tensors(d["noise"][0])

    kd, kg = jax_prng.named(kstep, "d_fake"), jax_prng.named(kstep, "g_fake")
    d_lat = d_drop = None
    if not cfg.trainer.shared_fakes:
        d_lat, d_drop = fakes(kd)
    g_lat, g_drop = fakes(kg)
    d_noise, g_noise = {}, {}
    for name in ("idis", "vdis", "gdis"):
        nkey = jax_prng.named(kstep, f"{name}_noise")
        if cfg.trainer.critic_joint_batch:
            d_noise[name] = {"joint": noise(name, jax_prng.named(nkey, "joint"), 2 * B)}
        else:
            d_noise[name] = {"real": noise(name, jax_prng.named(nkey, "d_fake")),
                             "fake": noise(name, jax_prng.named(nkey, "g_fake"))}
        g_noise[name] = noise(name, jax_prng.named(kg, f"{name}_noise"))
    return StepDraws(t_rand, d_lat, g_lat, d_drop, g_drop, d_noise, g_noise)


def port_tree(name, module, values):
    """Per-parameter tensors of ``module`` (gradients, say) as a flax tree.
    The JAX package's ``*_from_torch`` reads every norm's running
    statistics; a GroupNorm, which has none, is handed placeholders."""
    from dcvgan_torch.models.layers import ChannelGroupNorm

    sd = {k: v.detach().clone() for k, v in module.state_dict().items()}
    for k, m in module.named_modules():
        if isinstance(m, ChannelGroupNorm):
            sd[f"{k}.running_mean"] = torch.zeros_like(m.weight)
            sd[f"{k}.running_var"] = torch.ones_like(m.weight)
    for k, v in values.items():
        if k == "recurrent.bias_hn":
            sd["recurrent.bias_hh"] = torch.cat([torch.zeros(2 * v.numel()), v.detach()])
        else:
            sd[k] = v.detach()
    return from_torch(name)({k: v.numpy() for k, v in sd.items()})[0]


def port_stats(name, module):
    """The running statistics of ``module`` as a flat flax tree."""
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    return flatten_tree(from_torch(name)(sd)[1])


def jax_grads(before, after, name: str, cfg, n_steps: int = 1):
    """The gradient the JAX step fed Adam, from its first moment. From zero
    moments, ``n_steps`` steps on one gradient ``g`` give
    ``mu = (1 - b1**n) * g + decay * (...)``; the weight decay term is taken
    at the parameters before the step, which for two steps is off by
    ``decay * lr`` (1e-9 at the tests' settings)."""
    opt = getattr(cfg, name).optimizer
    mu = flatten_tree(numpy_tree(getattr(after, name).opt_state[1].mu))
    p = flatten_tree(numpy_tree(getattr(before, name).params))
    return {k: mu[k] / np.float32(1.0 - opt.b1 ** n_steps) - np.float32(opt.decay) * p[k]
            for k in mu}


def gradient_gaps(jgan, jbefore, jafter, pstate, name):
    """How far the port's gradients of ``name`` lie from the JAX step's:
    the largest per-tensor ``max |diff| / max |want|`` and the whole
    model's relative L2 distance."""
    want = jax_grads(jbefore, jafter, name, jgan.config)
    module = getattr(pstate, name)
    got = flatten_tree(port_tree(name, module, {k: p.grad for k, p in module.named_parameters()}))
    per_tensor = max(float(np.abs(got[k] - g).max() / np.abs(g).max()) for k, g in want.items())
    a = np.concatenate([got[k].ravel() for k in want])
    b = np.concatenate([want[k].ravel() for k in want])
    return per_tensor, float(np.linalg.norm(a - b) / np.linalg.norm(b))


def gradients_close(jgan, jbefore, jafter, pstate, name, n_steps: int = 1, zero=(), scale=1.0):
    """The port's gradients of ``name`` against the JAX step's times
    ``scale``, per tensor and in L2 (``GRAD_RTOL``, ``GRAD_L2``; the image
    critic at ``ATOL_F32``). Every tensor's gradient is nonzero, except
    those named in ``zero``: 0 in JAX (up to the rounding of its weight
    decay term) and rounding residue in the port, at most 5e-5 of the
    model's largest gradient."""
    want = {k: g * np.float32(scale)
            for k, g in jax_grads(jbefore, jafter, name, jgan.config, n_steps).items()}
    module = getattr(pstate, name)
    got = flatten_tree(port_tree(name, module, {k: p.grad for k, p in module.named_parameters()}))
    assert set(got) == set(want) and len(got) > 3
    rtol = ATOL_F32 if name == "idis" else GRAD_RTOL
    top = max(float(np.abs(g).max()) for g in want.values())
    for k, g in want.items():
        if k in zero:
            assert np.abs(g).max() <= 1e-9 and np.abs(got[k]).max() <= 5e-5 * top, k
            continue
        scale = float(np.abs(g).max())
        assert scale > 0, k
        within(got[k], g, rtol * scale + 1e-6)
    a = np.concatenate([got[k].ravel() for k in want])
    b = np.concatenate([want[k].ravel() for k in want])
    assert np.linalg.norm(a - b) <= GRAD_L2 * np.linalg.norm(b)


def run_pair(jcfg, pcfg, seed, batch, step0=0, jgan=None):
    """One step of each package from the same state (drawn from ``seed``
    at ``step0``) and the same draws; returns
    ``(jgan, jstate, jafter, jmetrics, pgan, pstate, pmetrics)``, with the
    draws kept as ``pgan.last_draws``. ``jgan``, an earlier pair's JAX
    model of the same config, reuses its compiled step."""
    import jax.numpy as jnp

    from dcvgan_torch import prng as port_prng
    from dcvgan_torch.train.step import DCVGAN as PortGAN
    from dcvgan_tpu import prng as jax_prng
    from dcvgan_tpu.train.step import DCVGAN as JaxGAN

    jgan, pgan = jgan or JaxGAN(jcfg), PortGAN(pcfg, device="cpu")
    jstate = jax_state(jgan, seed, step0)
    pstate = port_state(pgan, jstate)
    key = jax_prng.base_key(3)
    draws = step_draws(jgan, jstate, key, step0 + 1)
    jafter, jmetrics = jgan.jitted_train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    pstate, pmetrics = pgan.train_step(pstate, batch, port_prng.base_key(3), draws)
    pgan.last_draws = draws
    return jgan, jstate, jafter, jmetrics, pgan, pstate, pmetrics


@pytest.fixture(scope="session")
def jax_native_built():
    """The JAX package's host library (``dcvgan_tpu.native``) loaded before a
    module's tests reach it, one port test worker at a time. That package
    compiles ``libdcvgan_host.so`` with ``g++ -o`` straight onto its final
    path on first use, so a second process that loads it mid-build reads a
    partial file and falls back to numpy for good. An ``fcntl`` lock on a
    file in the port's build directory keeps port workers from building it
    at the same moment; the JAX package still does the writing. A module
    that reaches the library (directly or through the JAX dataset) opts in
    with ``pytestmark``."""
    import fcntl

    from dcvgan_torch.ops.build import BUILD_DIR
    from dcvgan_tpu import native

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "jax-native.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            return native.available()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


@pytest.fixture(scope="module")
def one_intra_op_thread():
    """One intra-op thread for torch while a module's tests run, restored
    after. The port's eager steps at these widths are small, and with
    several test workers on one machine each worker's full-width thread
    pool oversubscribes the cores: such a step took 20 s there against
    0.2 s alone. A module opts in with ``pytestmark``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------- data-parallel steps (gloo ranks)
# A global batch of 4 over 2 ranks (tests/torch_dist_util.py starts them);
# the JAX side on a data=2 mesh of its virtual CPU devices.
GLOBAL_B, WORLD = 4, 2


class DataParallelCase:
    """One state, batch and JAX model for the data-parallel tests: ``raw``
    is the port's config dict (``trainer`` entries over the f32 EMA step
    config), ``jstate`` / ``pstate`` the same state in both packages,
    ``mesh`` JAX's ``data=2`` mesh."""

    def __init__(self, **trainer):
        from dcvgan_torch.train.step import DCVGAN as PortGAN
        from dcvgan_tpu.parallel.mesh import create_mesh
        from dcvgan_tpu.train.step import DCVGAN as JaxGAN

        trainer = {"precision": "float32", "ema_decay": 0.9, **trainer}
        self.raw = step_raw(batchsize=GLOBAL_B, trainer=trainer)
        jcfg, self.pcfg = step_configs(batchsize=GLOBAL_B, trainer=trainer)
        self.jgan = JaxGAN(jcfg)
        self.jstate = jax_state(self.jgan, seed=11)
        self.pstate = port_state(PortGAN(self.pcfg, device="cpu"), self.jstate)
        self.mesh = create_mesh(data=WORLD, batchsize=GLOBAL_B)
        self.batch = step_batch(12, np.uint8, GLOBAL_B)

    @staticmethod
    def key():
        from dcvgan_tpu import prng

        return prng.base_key(3)

    def payload(self, steps, **over) -> dict:
        """A ``torch_dist_util.train_steps`` payload from this state."""
        from torch_dist_util import state_payload

        return {"config": self.raw, "state": state_payload(self.pstate), "steps": steps, **over}

    def jax_step(self, per_replica: bool):
        """JAX's step on the sharded batch: ``sharded_train_step`` (per-replica
        statistics) or ``jitted_train_step``; ``(after, metrics)``, computed
        before it returns (no rank starts while XLA's collectives run)."""
        import jax

        from dcvgan_tpu.parallel.mesh import replicate, shard_batch

        fn = self.jgan.sharded_train_step(self.mesh) if per_replica else self.jgan.jitted_train_step
        out = fn(replicate(self.jstate, self.mesh), shard_batch(self.batch, self.mesh), self.key())
        return jax.block_until_ready(out)

    def port_result(self, result):
        """A port ``GANState`` holding a rank's state and gradients after a step."""
        from dcvgan_torch.train.step import DCVGAN as PortGAN
        from torch_dist_util import load_state_payload

        state = PortGAN(self.pcfg, device="cpu").init_state(0)
        load_state_payload(state, result)
        for name, module in state.models.items():
            for k, p in module.named_parameters():
                p.grad = result["grads"][name][k]
        return state

    def match_jax(self, jafter, jm, results, grad_scale=1.0) -> None:
        """Rank 0's first step against JAX's: losses at ``ATOL_F32``,
        gradients (times ``grad_scale``) through ``gradients_close``,
        parameters within 2.5 lr, statistics at ``ATOL_F32``; every rank
        equal to rank 0."""
        replicas_equal(results)
        after = results[0][0]
        for k in LOSSES:
            within(after["metrics"][k], np.asarray(jm[k]), ATOL_F32, ATOL_F32)
        pstate = self.port_result(after)
        for name in MODEL_NAMES:
            gradients_close(self.jgan, self.jstate, jafter, pstate, name, scale=grad_scale)
            module = getattr(pstate, name)
            got = flatten_tree(port_tree(name, module, dict(module.named_parameters())))
            want = flatten_tree(numpy_tree(getattr(jafter, name).params))
            for k in want:
                within(got[k], want[k], 2.5 * LR)
            stats = port_stats(name, module)
            for k, v in flatten_tree(numpy_tree(getattr(jafter, name).batch_stats)).items():
                within(stats[k], v, ATOL_F32, ATOL_F32)


def replicas_equal(results) -> None:
    """Every rank ends each step with the same parameters, statistics, Adam
    moments, gradients and metrics, bit for bit."""
    for other in results[1:]:
        for a, b in zip(results[0], other):
            assert a["metrics"] == b["metrics"]
            for name in MODEL_NAMES:
                for k, v in a["models"][name].items():
                    assert torch.equal(v, b["models"][name][k]), (name, k)
                for k, g in a["grads"][name].items():
                    assert torch.equal(g, b["grads"][name][k]), (name, k)
                sa, sb = a["opt"][name]["state"], b["opt"][name]["state"]
                for i in sa:
                    assert torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"]), (name, i)


@pytest.fixture(scope="module")
def no_persistent_compile_cache():
    """JAX's persistent compilation cache off while a module runs: an
    executable of ``sharded_train_step`` loaded back from it aborts the
    process in XLA:CPU's all-reduce rendezvous ("Unexpected number of
    participants"), or crashes it, under jax 0.9; compiled afresh it runs.
    JAX decides once per process whether it uses the cache, so the decision
    is reset on the way in and out. A module opts in with ``pytestmark``."""
    import jax
    from jax._src import compilation_cache

    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


# ------------------------------------------------------------ span recorder
@pytest.fixture
def tracing():
    """``dcvgan_torch.utils.trace`` recording into an empty ring while the
    test runs, off again after."""
    from dcvgan_torch.utils import trace

    trace.enable()
    yield trace
    trace.disable()
