"""GAN evaluation metrics: Inception Score, Fréchet distance, PRD.

The port's own copy of ``dcvgan_tpu/eval/metrics.py`` (numpy and scipy;
importing that module would import the JAX package's ``eval`` package, and
with it jax). Same functions, same arithmetic, same results on the same
arrays.

- IS: Salimans et al. 2016, exp(E_x KL(p(y|x) || p(y))).
- FID: Heusel et al. 2017, ||mu1-mu2||^2 + Tr(S1 + S2 - 2 (S1 S2)^{1/2}).
- PRD: Sajjadi et al. 2018 ("Assessing Generative Models via Precision and
  Recall"): k-means over the joint feature set, precision/recall curve over
  an angle sweep, summarised by the (F8, F1/8) pair as in the paper.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.linalg


def inception_score(probs: np.ndarray, splits: int = 1, eps: float = 1e-16) -> float:
    """IS from class probabilities ``(N, K)``."""
    probs = np.asarray(probs, np.float64)
    n = probs.shape[0]
    scores = []
    for part in np.array_split(np.arange(n), splits):
        p = probs[part]
        py = p.mean(axis=0, keepdims=True)
        kl = p * (np.log(p + eps) - np.log(py + eps))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores))


def frechet_distance(
    feats1: np.ndarray, feats2: np.ndarray, eps: float = 1e-6
) -> float:
    """FID between two feature sets ``(N, D)``."""
    f1 = np.asarray(feats1, np.float64)
    f2 = np.asarray(feats2, np.float64)
    mu1, mu2 = f1.mean(0), f2.mean(0)
    s1 = np.cov(f1, rowvar=False)
    s2 = np.cov(f2, rowvar=False)

    diff = mu1 - mu2
    # sqrtm's ``disp`` argument is gone from SciPy 1.18 (the JAX package's
    # ``disp=False`` raises there); the default form returns the same array
    covmean = scipy.linalg.sqrtm(s1 @ s2)
    if not np.isfinite(covmean).all():
        offset = np.eye(s1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((s1 + offset) @ (s2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean))


def _kmeans(data: np.ndarray, k: int, iters: int = 50, seed: int = 0) -> np.ndarray:
    """Plain-numpy k-means (k-means++ init); returns cluster assignments."""
    rng = np.random.default_rng(seed)
    n = data.shape[0]
    k = min(k, n)
    # k-means++ seeding (uniform fallback when remaining distances vanish,
    # e.g. fewer distinct points than clusters)
    centers = [data[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(
            ((data[:, None, :] - np.stack(centers)[None]) ** 2).sum(-1), axis=1
        )
        total = d2.sum()
        if total <= 0 or not np.isfinite(total):
            centers.append(data[rng.integers(n)])
        else:
            centers.append(data[rng.choice(n, p=d2 / total)])
    centers = np.stack(centers)
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d2 = ((data[:, None, :] - centers[None]) ** 2).sum(-1)
        new_assign = d2.argmin(1)
        if np.all(new_assign == assign):
            break
        assign = new_assign
        for j in range(k):
            mask = assign == j
            if mask.any():
                centers[j] = data[mask].mean(0)
    return assign


def prd_curve(
    real_feats: np.ndarray,
    fake_feats: np.ndarray,
    num_clusters: int = 20,
    num_angles: int = 1001,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """PRD precision/recall curve between feature sets.

    Returns (precision, recall) arrays of length ``num_angles``.
    """
    real = np.asarray(real_feats, np.float64)
    fake = np.asarray(fake_feats, np.float64)
    joint = np.concatenate([real, fake])
    assign = _kmeans(joint, num_clusters, seed=seed)
    p = np.histogram(assign[: len(real)], bins=num_clusters, range=(0, num_clusters))[0]
    q = np.histogram(assign[len(real):], bins=num_clusters, range=(0, num_clusters))[0]
    p = p / max(p.sum(), 1)
    q = q / max(q.sum(), 1)

    angles = np.linspace(1e-10, np.pi / 2 - 1e-10, num_angles)
    slopes = np.tan(angles)
    precision = np.minimum(slopes[:, None] * p[None], q[None]).sum(axis=1)
    recall = precision / slopes
    return np.clip(precision, 0, 1), np.clip(recall, 0, 1)


def prd_f_beta(
    precision: np.ndarray, recall: np.ndarray, beta: float = 8.0
) -> Tuple[float, float]:
    """(F_beta, F_{1/beta}) summary of a PRD curve (paper convention)."""

    def fmax(b: float) -> float:
        b2 = b * b
        with np.errstate(divide="ignore", invalid="ignore"):
            f = (1 + b2) * precision * recall / (b2 * precision + recall)
        return float(np.nanmax(np.where(np.isfinite(f), f, 0.0)))

    return fmax(beta), fmax(1.0 / beta)


def score_features(
    metrics,
    feats: np.ndarray,
    probs: np.ndarray,
    real_features=None,
) -> dict:
    """The single metric-dispatch point: ``is`` / ``fid`` (a Fréchet
    distance over whole-clip features, i.e. an FVD — "fid" is the
    reference's config name for it) / ``prd`` from generated
    ``(features, probs)`` against real features.

    ``real_features`` may be an array or a zero-arg callable (invoked at
    most once, and only when a metric actually needs the real side — so
    IS-only scoring never pays the reference embedding).
    """
    cache = {}

    def real() -> np.ndarray:
        if "r" not in cache:
            r = real_features() if callable(real_features) else real_features
            if r is None:
                raise ValueError("fid/prd need reference features")
            cache["r"] = r
        return cache["r"]

    scores: dict = {}
    for m in metrics:
        if m == "is":
            scores["is"] = float(inception_score(probs))
        elif m in ("fid", "fvd"):
            scores[m] = float(frechet_distance(feats, real()))
        elif m == "prd":
            prec, rec = prd_curve(real(), feats)
            f8, f1_8 = prd_f_beta(prec, rec)
            scores["prd"], scores["prd_f1_8"] = float(f8), float(f1_8)
        else:
            raise KeyError(f"unknown metric {m!r}")
    return scores
