"""Video container I/O: mp4 read and write through OpenCV.

Counterpart of ``dcvgan_tpu/io/video.py`` with the same conventions: uint8
RGB ``(T, H, W, C)`` arrays, ``mp4v`` files. The parallel forms use a
thread pool from the standard library (OpenCV releases the GIL while it
encodes and decodes), not ``joblib``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Sequence, Union

import cv2
import numpy as np

PathLike = Union[str, Path]


def read_video(path: PathLike) -> np.ndarray:
    """Read a video as uint8 RGB ``(T, H, W, 3)``."""
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise FileNotFoundError(f"could not open video: {path}")
    frames: List[np.ndarray] = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)


def write_video(video: np.ndarray, path: PathLike, fps: int = 16) -> None:
    """Write a uint8 RGB ``(T, H, W, C)`` video as mp4; one-channel frames
    are written as grey (broadcast to 3 channels). Raises when OpenCV cannot
    open a writer for ``path``."""
    t, h, w = video.shape[:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"could not open video writer for {path}")
    for frame in video:
        if frame.ndim == 2 or frame.shape[-1] == 1:
            frame = np.broadcast_to(frame.reshape(h, w, 1), (h, w, 3)).astype(np.uint8)
        writer.write(cv2.cvtColor(np.ascontiguousarray(frame), cv2.COLOR_RGB2BGR))
    writer.release()


def read_videos_parallel(paths: Sequence[PathLike], n_jobs: int = 8) -> List[np.ndarray]:
    """:func:`read_video` over ``paths`` on ``n_jobs`` threads, in order."""
    with ThreadPoolExecutor(max_workers=n_jobs) as pool:
        return list(pool.map(read_video, paths))


def write_videos_parallel(
    videos: Sequence[np.ndarray], paths: Sequence[PathLike], fps: int = 16, n_jobs: int = 8
) -> np.ndarray:
    """:func:`write_video` of each video to its path on ``n_jobs`` threads;
    returns ``np.stack(videos)``, as the JAX package's form does. The first
    failure is raised."""
    if len(videos) != len(paths):
        raise ValueError(f"{len(videos)} videos for {len(paths)} paths")
    with ThreadPoolExecutor(max_workers=n_jobs) as pool:
        for _ in pool.map(lambda vp: write_video(vp[0], vp[1], fps), zip(videos, paths)):
            pass
    return np.stack(videos)
