"""Synthetic mock dataset fixture.

The port's own copy of ``dcvgan_tpu/data/mock.py``: a pixel-exact decode
oracle of three 17-frame videos of solid colors (color frames cycle pure
R/G/B, depth frames cycle gray {0, 127, 255}), with flow and segmentation
labels so that all four modalities are testable.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from dcvgan_torch.io.image import write_img

N_VIDEOS = 3
N_FRAMES = 17
COLOR_CYCLE = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)
DEPTH_CYCLE = np.array([0, 127, 255], np.uint8)


def generate_mock_dataset(root: Path, image_size: int = 64) -> Path:
    """Write the mock fixture tree under ``root`` (= .../mock/<mode>).

    Layout per video directory ``root/<n>/``:
      - ``color/NNN.png``: solid COLOR_CYCLE[(n-1+j) % 3] frames
      - ``depth/NNN.png``: solid DEPTH_CYCLE[(n-1+j) % 3] frames
      - ``optical-flow.npy``: float32 (N_FRAMES, H, W, 2), |values| <= 11
      - ``segm.npy``: uint8 (N_FRAMES, H, W) class ids in [0, 25)
    plus ``root/list.txt`` with "<n> <n_frames>" lines.
    """
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    s = image_size
    lines = []
    for n in range(1, N_VIDEOS + 1):
        vdir = root / str(n)
        (vdir / "color").mkdir(parents=True, exist_ok=True)
        (vdir / "depth").mkdir(parents=True, exist_ok=True)
        for j in range(N_FRAMES):
            color = np.broadcast_to(
                COLOR_CYCLE[(n - 1 + j) % 3], (s, s, 3)
            ).astype(np.uint8)
            write_img(color, vdir / "color" / f"{j:03d}.png")
            depth = np.full((s, s), DEPTH_CYCLE[(n - 1 + j) % 3], np.uint8)
            write_img(depth, vdir / "depth" / f"{j:03d}.png", grayscale=True)
        # Deterministic flow field: frame j is constant (u, v) = (j - 8, n),
        # well inside [-image_size, image_size] so /image_size lands in [-1, 1].
        flow = np.zeros((N_FRAMES, s, s, 2), np.float32)
        for j in range(N_FRAMES):
            flow[j, ..., 0] = float(j - 8)
            flow[j, ..., 1] = float(n)
        np.save(vdir / "optical-flow.npy", flow)
        # Deterministic segmentation: frame j is a horizontal class gradient
        # offset by (n + j), classes in [0, 25).
        rows = (np.arange(s) // max(1, s // 25))[:, None]
        segm = np.stack(
            [((rows + n + j) % 25).astype(np.uint8).repeat(s, axis=1)
             for j in range(N_FRAMES)]
        )
        np.save(vdir / "segm.npy", segm)
        lines.append(f"{n} {N_FRAMES}")
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    return root
