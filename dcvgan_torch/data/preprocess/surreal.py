"""SURREAL dataset preprocessing: the port's counterpart of
``dcvgan_tpu/data/preprocess/surreal.py``, writing the same tree.

Walk ``<root>/<mode>/run*/<seq>/`` for (mp4, ``_depth.mat``, ``_segm.mat``,
``_info.mat``) quadruples, centre-crop each video to a square, crop a random
square around the human's box from the 2D joints (seeded per video by the
CRC32 of its name, so runs repeat), reject humans on the frame's edge,
resize (colour linear, depth and segmentation nearest), and write per video
``color/NNN.jpg``, ``depth.npy``, ``segm.npy``, three preview mp4s, and a
``list.txt`` in the order the videos were collected. The depth preview's
"hot" colormap is computed in numpy.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import traceback
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from dcvgan_torch.data.preprocess import parallel_map, register
from dcvgan_torch.io.image import resize_video, save_video_as_images
from dcvgan_torch.io.video import read_video, write_video
from dcvgan_torch.utils.video_np import segm_color

HUMAN_HEAD_HEIGHT = 22  # px margin above the topmost joint
NUM_SEGM_PARTS = 25
BACKGROUND_DEPTH = 1e10


class SquareBox:
    """Axis-aligned box as (x, y, w, h) with a cover test."""

    def __init__(self, x: int, y: int, w: int, h: int):
        self.x, self.y, self.w, self.h = int(x), int(y), int(w), int(h)

    @classmethod
    def from_corners(cls, x0: int, y0: int, x1: int, y1: int) -> "SquareBox":
        return cls(x0, y0, x1 - x0, y1 - y0)

    @property
    def top_left(self) -> np.ndarray:
        return np.array([self.x, self.y])

    @property
    def bottom_right(self) -> np.ndarray:
        return np.array([self.x + self.w, self.y + self.h])

    def covers(self, other: "SquareBox") -> bool:
        return bool(
            np.all(self.top_left <= other.top_left)
            and np.all(self.bottom_right >= other.bottom_right)
        )


def random_square_crop(
    human: SquareBox, image: SquareBox, rng: np.random.Generator
) -> SquareBox:
    """A random square that holds ``human`` and lies inside ``image``."""
    assert image.covers(human), "image box must cover the human box"
    slack = int((human.top_left - image.top_left).min())
    start = image.top_left + int(rng.integers(0, slack + 1))
    lo = int(human.bottom_right.max() - start.max())
    hi = int(image.bottom_right.max() - start.max())
    side = int(rng.integers(lo, hi + 1))
    return SquareBox(start[0], start[1], side, side)


def _read_mat_series(path: Path, prefix: str) -> np.ndarray:
    """Stack the ``<prefix>_1, <prefix>_2, ...`` arrays of a .mat file."""
    import scipy.io

    data = scipy.io.loadmat(str(path))
    frames: List[np.ndarray] = []
    i = 1
    while f"{prefix}_{i}" in data:
        frames.append(data[f"{prefix}_{i}"])
        i += 1
    if not frames:
        raise ValueError(f"no {prefix}_* arrays in {path}")
    return np.stack(frames)


def _read_joints2d(path: Path) -> np.ndarray:
    """(T, n_joints, 2) joint coordinates of an ``_info.mat`` file."""
    import scipy.io

    data = scipy.io.loadmat(str(path))
    return data["joints2D"].transpose(2, 1, 0)


def _hot_colormap(v: np.ndarray) -> np.ndarray:
    """matplotlib's "hot" colormap: black -> red -> yellow -> white."""
    v = np.clip(v, 0.0, 1.0)
    r = np.clip(v / 0.365079, 0, 1)
    g = np.clip((v - 0.365079) / (0.746032 - 0.365079), 0, 1)
    b = np.clip((v - 0.746032) / (1.0 - 0.746032), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def _depth_preview(depth: np.ndarray) -> np.ndarray:
    """(T, H, W) depth -> (T, H, W, 3) uint8: the human min-max normalised
    through the hot colormap on a grey background."""
    background_color = 130
    mask = depth < BACKGROUND_DEPTH
    t, h, w = depth.shape
    out = np.full((t, h, w, 3), background_color, np.uint8)
    human = depth[mask]
    if human.size == 0:
        return out
    ma, mi = human.max(), human.min()
    if ma - mi > 0:
        human = (human - mi) / (ma - mi)
    out[mask] = _hot_colormap(human)
    return out


def _preprocess_one(
    name: str,
    files: Dict[str, Path],
    save_path: Path,
    length: int,
    img_size: int,
) -> Optional[Tuple[str, int]]:
    """Write one video's directory and previews; ``(name, frames)``, or None
    (with the reason on stderr) for a rejected or failed video."""
    try:
        color = read_video(files["color"])  # (T, H, W, 3)
        depth = _read_mat_series(files["depth"], "depth")  # (T, H, W)
        segm = _read_mat_series(files["segm"], "segm")  # (T, H, W)
        joints = _read_joints2d(files["info"]).astype(np.float64)  # (T, N, 2)

        # centre-crop to a square
        t, h, w, _ = color.shape
        offset = (w - h) // 2
        color = color[:, :, offset : offset + h]
        depth = depth[:, :, offset : offset + h]
        segm = segm[:, :, offset : offset + h]
        joints[..., 0] -= offset
        joints = np.clip(joints, 0, h - 1)
        t, h, w = color.shape[:3]

        if len(color) < max(16, length if length > 0 else 16):
            print(f"too short, skipped: {name}", file=sys.stderr)
            return None
        if not (len(color) == len(depth) == len(segm) == len(joints)):
            print(f"stream lengths mismatch, skipped: {name}", file=sys.stderr)
            return None

        out_path = save_path / name
        if out_path.exists():
            return name, len(depth)

        rng = np.random.default_rng(zlib.crc32(name.encode()))

        x_min_mean = int(joints[..., 0].min(axis=1).mean())
        x_max_mean = int(joints[..., 0].max(axis=1).mean())
        y_min = max(int(joints[..., 1].min()) - HUMAN_HEAD_HEIGHT, 0)
        y_max = int(joints[..., 1].max())

        cx = (x_max_mean + x_min_mean) // 2
        if cx < w // 8 or cx > 7 * w // 8:
            print(f"human on frame edge, excluded: {name}", file=sys.stderr)
            return None

        human_box = SquareBox.from_corners(x_min_mean, y_min, x_max_mean, y_max)
        image_box = SquareBox(0, 0, w, h - 1)
        if not image_box.covers(human_box):
            print(f"human bbox out of frame, excluded: {name}", file=sys.stderr)
            return None

        crop = random_square_crop(human_box, image_box, rng)
        ry = slice(crop.top_left[1], crop.bottom_right[1])
        rx = slice(crop.top_left[0], crop.bottom_right[0])
        color = color[:, ry, rx]
        depth = depth[:, ry, rx]
        segm = segm[:, ry, rx]

        resize_to = (img_size, img_size)
        color = resize_video(color, resize_to, "linear")
        depth = resize_video(depth[..., None], resize_to, "nearest")[..., 0]
        segm = resize_video(segm[..., None], resize_to, "nearest")[..., 0]
        t = color.shape[0]

        # the video's directory appears whole or not at all: written under a
        # temporary name beside it, then renamed
        temp_path = Path(tempfile.mkdtemp(prefix=".tmp-", dir=save_path))
        try:
            save_video_as_images(color, temp_path / "color")
            np.save(str(temp_path / "depth"), depth)
            np.save(str(temp_path / "segm"), segm)

            write_video(color, (save_path / "color" / name).with_suffix(".mp4"), fps=20)
            write_video(
                _depth_preview(depth),
                (save_path / "depth" / name).with_suffix(".mp4"),
                fps=20,
            )
            palette = np.stack(
                [(segm_color(i) * 255).astype(np.uint8) for i in range(NUM_SEGM_PARTS)]
            )
            write_video(
                palette[np.clip(segm, 0, NUM_SEGM_PARTS - 1).astype(np.int64)],
                (save_path / "segm" / name).with_suffix(".mp4"),
                fps=20,
            )
            os.replace(temp_path, out_path)
        finally:
            shutil.rmtree(temp_path, ignore_errors=True)
        return name, t
    except Exception:  # one bad video must not stop the others; reported
        traceback.print_exc()
        print(f"unexpected error, skipped: {name}", file=sys.stderr)
        return None


@register("surreal")
def preprocess_surreal_dataset(
    dataset_path: Path,
    save_path: Path,
    mode: str,
    length: int,
    img_size: int,
    n_jobs: int = -1,
) -> None:
    """Preprocess every complete video quadruple of the SURREAL tree at
    ``dataset_path`` into ``save_path`` on ``n_jobs`` threads (-1: all CPUs)."""
    dataset_path, save_path = Path(dataset_path), Path(save_path)
    videos: Dict[str, Dict[str, Path]] = {}
    for run_dir in sorted((dataset_path / mode).glob("run*")):
        for seq_path in sorted(run_dir.iterdir()):
            if not seq_path.is_dir() or "ung_" in seq_path.name:
                continue
            for color_video in sorted(seq_path.glob("*.mp4")):
                seq_id = color_video.stem
                name = f"{run_dir.name}-{seq_id}"
                files = {
                    "color": color_video,
                    "depth": seq_path / f"{seq_id}_depth.mat",
                    "segm": seq_path / f"{seq_id}_segm.mat",
                    "info": seq_path / f"{seq_id}_info.mat",
                }
                missing = [k for k, v in files.items() if not v.exists()]
                if missing:
                    print(f"skipped {name}: missing {missing[0]}", file=sys.stderr)
                    continue
                videos[name] = files
    print(f"collected {len(videos)} videos.")

    save_path.mkdir(parents=True, exist_ok=True)
    for sub in ("color", "depth", "segm"):
        (save_path / sub).mkdir(exist_ok=True)

    infos = parallel_map(
        _preprocess_one,
        [(name, files, save_path, length, img_size) for name, files in videos.items()],
        n_jobs,
    )

    count = 0
    with open(save_path / "list.txt", "w") as f:
        for info in infos:
            if info is None:
                continue
            count += 1
            f.write("{} {}\n".format(*info))
    print(f"generated {count} processed videos.")
