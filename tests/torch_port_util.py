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
