"""Train the evaluation's feature extractor on synthetic moving-shapes clips.

    python -m dcvgan_torch.tools.extractor out.npz [--steps 600] [--batch 16] \
        [--width 16] [--feature-dim 128] [--image-size 64] [--video-length 16] \
        [--seed 0] [--holdout 64] [--device cpu]

The port's counterpart of the repository's ``tools/train_extractor.py``,
with its functions, arguments, task and file format: the small C3D tower
(``eval.features.C3DFeatures``) learns a 24-way motion + shape classifier (8
direction octants x 3 size buckets) on clips rendered on the host through
the synthetic dataset's own helpers, then is written as an extractor
``.npz`` in the flax layout that both packages' ``FeatureExtractor`` load.
The v2 extractor's recipe (``assets/MODELCARD-extractor-v2.md``) is
``--steps 2000 --batch 32 --width 32 --feature-dim 128 --seed 42 --holdout
512``.

- **Data**: one ``np.random.Generator`` seeded ``--seed`` draws the clips in
  the JAX tool's order (one clip for its init first, then a batch a step),
  so a seed gives the same uint8 clips and labels bit for bit; the holdout
  is drawn from the stream seeded ``seed + 10**6``.
- **Init**: flax's defaults, redrawn with torch: each kernel from a normal
  truncated at two standard deviations, scaled to variance 1 / fan_in
  (``lecun_normal``), each bias zero, drawn on the CPU from a
  ``torch.Generator`` seeded ``--seed`` (flax's threefry draws cannot be
  replayed in torch).
- **Step**: inputs ``x / 255`` in float32, softmax cross-entropy over the
  integer labels, Adam at 1e-3 (optax's defaults: 0.9, 0.999, 1e-8),
  accuracy from the argmax. Precision: full float32, cuDNN's and matmul's
  TF32 off while it trains (the caller's settings restored after), as the
  evaluator embeds.
- **Overlap**: the loop fetches no value from the card between log lines, so
  the host renders the next batch while the card runs the step.

Runs on ``cuda`` unless ``--device cpu`` is given. Imports nothing of the
JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dcvgan_torch.data.preprocess.synthetic import (
    bouncing_rect_trajectory,
    gradient_background,
    render_color_frame,
)
from dcvgan_torch.eval.features import C3DFeatures, _flax_from_state_dict, _state_dict_from_flax
from dcvgan_torch.utils.device import resolve_device

N_DIRECTIONS = 8
N_SIZES = 3
NUM_CLASSES = N_DIRECTIONS * N_SIZES
LR = 1e-3
PREDICT_CHUNK = 64


def synth_labeled_batch(rng: np.random.Generator, batch: int, t: int, s: int):
    """(videos uint8 ``(B, T, s, s, 3)``, labels int32 ``(B,)``): moving-shape
    clips of the ``synthetic`` dataset's family. The label encodes the
    initial motion-direction octant and the shape-size bucket."""
    videos = np.empty((batch, t, s, s, 3), np.uint8)
    labels = np.empty((batch,), np.int32)
    size_edges = np.linspace(s // 8, s // 3, N_SIZES + 1)
    for b in range(batch):
        color = rng.integers(64, 256, 3)
        size_bucket = int(rng.integers(N_SIZES))
        size = int(rng.uniform(size_edges[size_bucket], size_edges[size_bucket + 1]))
        size = max(2, size)
        x, y = rng.uniform(0, s - size, 2)
        direction = int(rng.integers(N_DIRECTIONS))
        angle = (direction + rng.uniform(0.1, 0.9)) * (2 * np.pi / N_DIRECTIONS)
        speed = rng.uniform(1.5, 3.0) * s / 64.0
        vx, vy = speed * np.cos(angle), speed * np.sin(angle)
        bg = gradient_background(s, rng.uniform(0, 2 * np.pi))
        traj = bouncing_rect_trajectory(s, t, x, y, vx, vy, size)
        for j, (xi, yi) in enumerate(traj):
            videos[b, j] = render_color_frame(bg, color, size, xi, yi)
        labels[b] = direction * N_SIZES + size_bucket
    return videos, labels


def save_npz(path: Path, model: C3DFeatures, meta: dict) -> None:
    """``model``'s weights in the extractor npz layout (``<layer>/kernel``,
    ``<layer>/bias`` in flax shapes, then ``__meta__/<key>``)."""
    flat = {f"{layer}/{leaf}": v for layer, leaves in _flax_from_state_dict(model.state_dict()).items()
            for leaf, v in leaves.items()}
    for k, v in meta.items():
        flat[f"__meta__/{k}"] = np.asarray(v)
    np.savez(path, **flat)


def metadata(steps: int, seed: int, holdout_acc: float, holdout_n: int) -> dict:
    """The ``__meta__`` entries of a trained extractor, the JAX tool's keys."""
    return {
        "topology": "small",
        "trained_on": "synthetic-moving-shapes",
        "classes": "8 directions x 3 sizes",
        "steps": steps,
        "seed": seed,
        "holdout_acc": holdout_acc,
        "holdout_n": holdout_n,
    }


def init_parameters(model: nn.Module, seed: int) -> None:
    """flax's default init redrawn with torch (module docstring)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv3d, nn.Linear)):
                std = m.weight[0].numel() ** -0.5 / 0.87962566103423978  # a truncated unit normal's std
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)
                m.weight.copy_(w)
                m.bias.zero_()


@contextlib.contextmanager
def _full_f32():
    """cuDNN and matmul in full float32 inside; the caller's settings after."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def train_step(model: nn.Module, opt: torch.optim.Optimizer, videos_u8: torch.Tensor, labels: torch.Tensor):
    """One Adam step on a uint8 batch; (loss, accuracy) as tensors on the
    model's device."""
    _, logits = model(videos_u8.float() / 255.0)
    loss = F.cross_entropy(logits, labels)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach(), (logits.detach().argmax(-1) == labels).float().mean()


def _on(device: torch.device, videos: np.ndarray, labels: np.ndarray):
    x, y = torch.from_numpy(videos), torch.from_numpy(labels.astype(np.int64))
    if device.type == "cuda":
        x, y = x.pin_memory(), y.pin_memory()
    return x.to(device, non_blocking=True), y.to(device, non_blocking=True)


def train(
    steps: int = 600,
    batch: int = 16,
    width: int = 16,
    feature_dim: int = 128,
    t: int = 16,
    s: int = 64,
    seed: int = 0,
    log_every: int = 50,
    holdout: int = 64,
    device=None,
    init_params: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
):
    """Train the classifier; returns (model, final train accuracy, holdout
    accuracy, stats). ``init_params``: a flax tree (``{layer: {"kernel",
    "bias"}}``) to start from instead of the seeded init. ``stats``: the
    loop's wall seconds and steps/s, the median host ms to render a batch,
    the median ms a step takes on the card's stream (CUDA events; None on
    the CPU), the peak device memory in GB (None on the CPU), the holdout's
    seconds and every step's loss."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    model = C3DFeatures(num_classes=NUM_CLASSES, width=width, feature_dim=feature_dim)
    rng = np.random.default_rng(seed)
    synth_labeled_batch(rng, 1, t, s)  # the JAX tool's init clip, kept for the stream
    if init_params is None:
        init_parameters(model, seed)
    else:
        model.load_state_dict(_state_dict_from_flax(init_params))
    model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    losses, render_s, events = [], [], []
    with _full_f32():
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            r0 = time.perf_counter()
            videos, labels = synth_labeled_batch(rng, batch, t, s)
            render_s.append(time.perf_counter() - r0)
            x, y = _on(dev, videos, labels)
            if on_card:
                events.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
            loss, acc = train_step(model, opt, x, y)
            if on_card:
                events[-1][1].record()
            losses.append(loss)
            if i % log_every == 0 or i == steps:
                print(f"step {i:5d}  loss {float(loss):.4f}  acc {float(acc):.3f}"
                      f"  ({time.perf_counter() - t0:.0f}s)", flush=True)
        if on_card:
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0

        # held-out accuracy on a fresh stream, predicted in chunks
        h0 = time.perf_counter()
        videos, labels = synth_labeled_batch(np.random.default_rng(seed + 10**6), holdout, t, s)
        preds = []
        with torch.no_grad():
            for i in range(0, holdout, PREDICT_CHUNK):
                x, _ = _on(dev, videos[i: i + PREDICT_CHUNK], labels[i: i + PREDICT_CHUNK])
                preds.append(model(x.float() / 255.0)[1].argmax(-1).cpu().numpy())
        holdout_acc = float((np.concatenate(preds) == labels).mean())
    stats = {
        "seconds": seconds,
        "steps_per_s": steps / seconds,
        "render_ms": 1e3 * statistics.median(render_s),
        "step_ms": statistics.median(a.elapsed_time(b) for a, b in events) if on_card else None,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None,
        "holdout_seconds": time.perf_counter() - h0,
        "losses": torch.stack(losses).tolist() if losses else [],
    }
    return model, float(acc), holdout_acc, stats


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("out", type=Path)
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--width", type=int, default=16)
    parser.add_argument("--feature-dim", type=int, default=128)
    parser.add_argument("--image-size", type=int, default=64)
    parser.add_argument("--video-length", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--holdout", type=int, default=64, help="held-out clips for the accuracy estimate")
    parser.add_argument("--device", default=None, help="torch device (default cuda; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)

    from dcvgan_torch.tools.headtohead import card

    model, train_acc, holdout_acc, stats = train(
        steps=args.steps, batch=args.batch, width=args.width, feature_dim=args.feature_dim,
        t=args.video_length, s=args.image_size, seed=args.seed, holdout=args.holdout, device=args.device,
    )
    print(f"holdout accuracy: {holdout_acc:.3f} (chance {1 / NUM_CLASSES:.3f})")
    save_npz(args.out, model, metadata(args.steps, args.seed, holdout_acc, args.holdout))
    print(f"wrote {args.out}")
    summary = {"card": card(), "train_acc": train_acc, "holdout_acc": holdout_acc,
               **{k: v for k, v in stats.items() if k != "losses"}, "last_loss": stats["losses"][-1]}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
