"""Synthetic moving-shapes dataset covering every geometry modality.

A generated dataset (no raw download needed) for demos, benchmarks, and
training-dynamics validation: each video shows a colored rectangle
bouncing over a gradient background, with

- a consistent **depth** map (shape near, background far),
- ground-truth **optical flow** (the shape's per-frame displacement,
  analytic — no Farnebäck estimation noise),
- a **segmentation** map (background 0, shape = a per-video part id),

so all three ``geometric_info`` branches of the dataset and the trainer are
trainable without raw downloads. The port's own copy of
``dcvgan_tpu/data/preprocess/synthetic.py``: the same seed stream writes the
same files. Structure matches the processed-dataset contract (color
frames + depth frames + ``optical-flow.npy`` + ``segm.npy`` + list.txt).

Registered as dataset name ``synthetic`` (64 videos) and
``synthetic-large`` (256 videos, enough for a batch of 100); the
``dataset.path`` config value is unused (nothing raw to read).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from dcvgan_torch.data.preprocess import register
from dcvgan_torch.io.image import write_img

N_VIDEOS = 64
N_FRAMES = 24


def gradient_background(s: int, angle: float) -> np.ndarray:
    """(s, s) uint8 luminance gradient at ``angle``."""
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    return (
        (np.cos(angle) * xx + np.sin(angle) * yy) / s * 80 + 60
    ).astype(np.uint8)


def bouncing_rect_trajectory(
    s: int, n: int, x: float, y: float, vx: float, vy: float, size: int
):
    """``n`` integer top-left positions of an elastically bouncing rect."""
    traj = []
    for _ in range(n):
        traj.append((int(round(x)), int(round(y))))
        x, y = x + vx, y + vy
        if x < 0 or x > s - size:
            vx, x = -vx, float(np.clip(x, 0, s - size))
        if y < 0 or y > s - size:
            vy, y = -vy, float(np.clip(y, 0, s - size))
    return traj


def render_color_frame(
    bg: np.ndarray, color, size: int, xi: int, yi: int
) -> np.ndarray:
    """Paint the rect onto a 3-channel copy of the gradient background."""
    frame = np.stack([bg] * 3, axis=-1).astype(np.uint8)
    frame[yi : yi + size, xi : xi + size] = color
    return frame


@register("synthetic")
def preprocess_synthetic_dataset(
    dataset_path: Path,
    save_path: Path,
    mode: str,
    length: int,
    img_size: int,
    n_jobs: int,
    n_videos: int = N_VIDEOS,
) -> None:
    del dataset_path, mode, n_jobs
    save_path = Path(save_path)
    save_path.mkdir(parents=True, exist_ok=True)
    s = img_size
    rng = np.random.default_rng(0)
    lines = []

    for n in range(1, n_videos + 1):
        vdir = save_path / str(n)
        (vdir / "color").mkdir(parents=True, exist_ok=True)
        (vdir / "depth").mkdir(parents=True, exist_ok=True)

        # per-video appearance + motion
        color = rng.integers(64, 256, 3)
        size = int(rng.integers(s // 8, s // 3))
        x, y = rng.uniform(0, s - size, 2)
        vx, vy = rng.uniform(-3, 3, 2) * s / 64.0
        bg = gradient_background(s, rng.uniform(0, 2 * np.pi))

        part_id = int(rng.integers(1, 25))  # SURREAL-style part label
        # N_FRAMES positions + one beyond for the last frame's flow target
        traj = bouncing_rect_trajectory(s, N_FRAMES + 1, x, y, vx, vy, size)
        flow = np.zeros((N_FRAMES, s, s, 2), np.float32)
        segm = np.zeros((N_FRAMES, s, s), np.uint8)
        for j in range(N_FRAMES):
            xi, yi = traj[j]
            frame = render_color_frame(bg, color, size, xi, yi)
            depth = np.full((s, s), 220, np.uint8)  # far background
            depth[yi : yi + size, xi : xi + size] = 60  # near shape
            segm[j, yi : yi + size, xi : xi + size] = part_id
            write_img(frame, vdir / "color" / f"{j:03d}.jpg")
            write_img(depth, vdir / "depth" / f"{j:03d}.jpg", grayscale=True)
            # analytic flow at frame j: displacement to frame j+1, inside
            # the shape region only (background is static)
            xn, yn = traj[j + 1]
            flow[j, yi : yi + size, xi : xi + size, 0] = float(xn - xi)
            flow[j, yi : yi + size, xi : xi + size, 1] = float(yn - yi)
        np.save(vdir / "optical-flow.npy", flow)
        np.save(vdir / "segm.npy", segm)
        lines.append(f"{n} {N_FRAMES}")

    (save_path / "list.txt").write_text("\n".join(lines) + "\n")


@register("synthetic-large")
def preprocess_synthetic_large_dataset(
    dataset_path: Path,
    save_path: Path,
    mode: str,
    length: int,
    img_size: int,
    n_jobs: int,
) -> None:
    """256-video variant: same generator and seed stream, so its first 64
    videos are bit-identical to ``synthetic``'s. Sized for batch-100
    training (a 64-video dataset yields zero full batches)."""
    preprocess_synthetic_dataset(
        dataset_path, save_path, mode, length, img_size, n_jobs, n_videos=256
    )
