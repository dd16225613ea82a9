"""The benchmark's dataset: a processed tree of moving-shape clips with
colour, depth, optical flow and segmentation, written once per checkout.

The clip generator is a frozen copy of the port's synthetic preprocessor
(``dcvgan_torch/data/preprocess/synthetic.py``, seed 0): the same seed
stream, so its first 256 clips are that generator's ``synthetic-large``
clips. Each clip draws its parameters in turn from one stream; the clips
are then rendered and written in parallel. The tree goes to a fixed
directory under the checkout (``portbench/_work/data``), built under a
temporary name and renamed, so a run finds a whole tree or none.
"""

from __future__ import annotations

import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parent / "_work" / "data"
NAME = "portbench-synthetic"
N_FRAMES = 24


def tree(root: Path = ROOT, n_videos: int = 1024, image_size: int = 64) -> dict:
    """Write the tree under ``root/NAME/train`` unless it is there; returns
    ``{"path", "seconds", "bytes", "written"}``."""
    out = Path(root) / NAME / "train"
    if (out / "list.txt").exists():
        return {"path": str(out), "seconds": 0.0, "bytes": None, "written": False}
    t0 = time.perf_counter()
    tmp = Path(root) / f".{NAME}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    rng = np.random.default_rng(0)
    s = image_size
    clips = []
    for n in range(1, n_videos + 1):
        color = rng.integers(64, 256, 3)
        size = int(rng.integers(s // 8, s // 3))
        x, y = rng.uniform(0, s - size, 2)
        vx, vy = rng.uniform(-3, 3, 2) * s / 64.0
        angle = rng.uniform(0, 2 * np.pi)
        part_id = int(rng.integers(1, 25))
        clips.append((n, color, size, x, y, vx, vy, angle, part_id))
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda c: _write_clip(tmp, s, *c), clips))
    (tmp / "list.txt").write_text("".join(f"{c[0]} {N_FRAMES}\n" for c in clips))
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp.rename(out)
    return {"path": str(out), "seconds": time.perf_counter() - t0, "bytes": _bytes(out),
            "written": True}


def _bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def _trajectory(s, n, x, y, vx, vy, size):
    traj = []
    for _ in range(n):
        traj.append((int(round(x)), int(round(y))))
        x, y = x + vx, y + vy
        if x < 0 or x > s - size:
            vx, x = -vx, float(np.clip(x, 0, s - size))
        if y < 0 or y > s - size:
            vy, y = -vy, float(np.clip(y, 0, s - size))
    return traj


def _write_clip(root: Path, s: int, n, color, size, x, y, vx, vy, angle, part_id) -> None:
    vdir = root / str(n)
    (vdir / "color").mkdir(parents=True)
    (vdir / "depth").mkdir()
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    bg = ((np.cos(angle) * xx + np.sin(angle) * yy) / s * 80 + 60).astype(np.uint8)
    traj = _trajectory(s, N_FRAMES + 1, x, y, vx, vy, size)
    flow = np.zeros((N_FRAMES, s, s, 2), np.float32)
    segm = np.zeros((N_FRAMES, s, s), np.uint8)
    for j in range(N_FRAMES):
        xi, yi = traj[j]
        frame = np.stack([bg] * 3, axis=-1).astype(np.uint8)
        frame[yi: yi + size, xi: xi + size] = color
        depth = np.full((s, s), 220, np.uint8)
        depth[yi: yi + size, xi: xi + size] = 60
        segm[j, yi: yi + size, xi: xi + size] = part_id
        cv2.imwrite(str(vdir / "color" / f"{j:03d}.jpg"), cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(vdir / "depth" / f"{j:03d}.jpg"), depth)
        xn, yn = traj[j + 1]
        flow[j, yi: yi + size, xi: xi + size, 0] = float(xn - xi)
        flow[j, yi: yi + size, xi: xi + size, 1] = float(yn - yi)
    np.save(vdir / "optical-flow.npy", flow)
    np.save(vdir / "segm.npy", segm)
