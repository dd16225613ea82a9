"""ChaLearn LAP IsoGD dataset preprocessing: the port's counterpart of
``dcvgan_tpu/data/preprocess/isogd.py``, writing the same tree.

Read ``<root>/<mode>_list.txt`` of (colour mp4, depth mp4, label) rows,
compute Farneback optical flow on the full frames, crop a square centred on
the detected face (on the frame's centre without ``face_recognition`` or a
face), resize (colour linear, depth and flow nearest), and write per video
``color/NNN.jpg``, ``depth/NNN.jpg`` and ``optical-flow.npy``, three preview
mp4s, and a ``list.txt`` in the list's order.
"""

from __future__ import annotations

import sys
import traceback
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from dcvgan_torch.data.preprocess import parallel_map, register
from dcvgan_torch.io.image import resize_video, save_video_as_images
from dcvgan_torch.io.video import read_video, write_video
from dcvgan_torch.utils.video_np import calc_optical_flow, visualize_optical_flow


def detect_face(video: np.ndarray, num_frames_to_use: int = 6):
    """The mean face location over ``num_frames_to_use`` evenly spaced
    frames as (top, right, bottom, left), as ``face_recognition`` gives it;
    None without ``face_recognition`` or without a face."""
    try:
        import face_recognition
    except ImportError:
        return None

    frames = np.linspace(0, len(video), num_frames_to_use, endpoint=False).astype(int)
    locs = []
    for t in frames:
        locations = face_recognition.face_locations(video[t])
        if locations:
            locs.append(np.asarray(locations[0]))
    if not locs:
        return None
    return np.stack(locs).mean(axis=0).astype(int)


def _preprocess_one(
    color_path: Path,
    depth_path: Path,
    label: str,
    save_path: Path,
    length: int,
    img_size: int,
) -> Optional[Tuple[str, int]]:
    """Write one video's directory and previews; ``(name, frames)``, or None
    for a missing, too short or failed video."""
    try:
        if not (color_path.exists() and depth_path.exists()):
            print(f"sample not found, skipped: {color_path.parent}", file=sys.stderr)
            return None

        color = read_video(color_path)
        depth = read_video(depth_path)
        t, h, w, _ = color.shape
        if t < length + 1:
            return None

        face = detect_face(color)
        if face is not None:
            top, right, bottom, left = face
            center_x = (top - left) // 2 + left  # the reference's arithmetic, kept
        else:
            center_x = w // 2
        left_x = max(center_x - h // 2, 0)

        flow = calc_optical_flow(color)  # (T-1, H, W, 2), on the full frames

        color = color[:, :, left_x : left_x + h]
        depth = depth[:, :, left_x : left_x + h]
        flow = flow[:, :, left_x : left_x + h]

        resize_to = (img_size, img_size)
        color = resize_video(color, resize_to, "linear")
        depth = resize_video(depth, resize_to, "nearest")
        flow = resize_video(flow, resize_to, "nearest")

        name = f"{color_path.parent.name}_{color_path.name[2:7]}_{label}"
        save_video_as_images(color, save_path / name / "color")
        save_video_as_images(depth, save_path / name / "depth")
        np.save(str(save_path / name / "optical-flow"), flow)

        for sub in ("color", "depth", "optical-flow"):
            (save_path / sub).mkdir(parents=True, exist_ok=True)
        write_video(color, save_path / "color" / (name + ".mp4"))
        write_video(depth, save_path / "depth" / (name + ".mp4"))
        write_video(
            visualize_optical_flow(flow), save_path / "optical-flow" / (name + ".mp4")
        )
        return name, t
    except Exception:  # one bad video must not stop the others; reported
        traceback.print_exc()
        print(f"unexpected error, skipped: {color_path}", file=sys.stderr)
        return None


@register("isogd")
def preprocess_isogd_dataset(
    dataset_path: Path,
    save_path: Path,
    mode: str,
    length: int,
    img_size: int,
    n_jobs: int = -1,
) -> None:
    """Preprocess every row of ``<dataset_path>/<mode>_list.txt`` into
    ``save_path`` on ``n_jobs`` threads (-1: all CPUs)."""
    dataset_path, save_path = Path(dataset_path), Path(save_path)
    with open(dataset_path / f"{mode}_list.txt") as f:
        rows = f.readlines()

    jobs = []
    for row in rows:
        color, depth, label = row.strip().split(" ")
        jobs.append((dataset_path / color, dataset_path / depth, label, save_path, length, img_size))

    save_path.mkdir(parents=True, exist_ok=True)
    infos = parallel_map(_preprocess_one, jobs, n_jobs)

    with open(save_path / "list.txt", "w") as f:
        for info in infos:
            if info is None:
                continue
            f.write("{} {}\n".format(*info))
