"""Shared helpers of the PyTorch port's tests (``test_torch_*.py``).

Inputs are drawn with numpy and handed to both packages; flax trees cross
into the port through ``dcvgan_torch.compat.from_jax``.
"""

from __future__ import annotations

import numpy as np
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
