"""Image I/O and resizing: the port's own copy of ``dcvgan_tpu/io/image.py``.
RGB channel order, uint8 (H, W, C) and (T, H, W, C) numpy arrays.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Tuple, Union

import cv2
import numpy as np

_CV_MODES = {
    "nearest": cv2.INTER_NEAREST,
    "linear": cv2.INTER_LINEAR,
    "area": cv2.INTER_AREA,
    "cubic": cv2.INTER_CUBIC,
    "lanczos4": cv2.INTER_LANCZOS4,
}


def read_img(path: Union[str, Path], grayscale: bool = False) -> np.ndarray:
    """Read an image as uint8 RGB (H, W, C); grayscale gives (H, W, 1)."""
    img = cv2.imread(str(path))
    if img is None:
        raise FileNotFoundError(f"could not read image: {path}")
    if grayscale:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        img = np.expand_dims(img, -1)
    else:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


def write_img(
    img: np.ndarray, path: Union[str, Path], grayscale: bool = False
) -> None:
    """Write a uint8 RGB (H, W, C) image."""
    if grayscale:
        cv2.imwrite(str(path), img)
    else:
        cv2.imwrite(str(path), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def resize_img(
    img: np.ndarray, size: Tuple[int, int], mode: str = "linear"
) -> np.ndarray:
    """Resize an (H, W, C) image to ``size`` = (W, H), cv2's order, with one
    of the five modes of ``_CV_MODES``. A one-channel image stays (H, W, 1)
    (cv2 drops the channel axis)."""
    out = cv2.resize(img, size, interpolation=_CV_MODES[mode])
    if img.ndim == 3 and out.ndim == 2:
        out = np.expand_dims(out, -1)
    return out


def resize_video(video: np.ndarray, *args: Any) -> np.ndarray:
    """:func:`resize_img` of each frame of a (T, H, W, C) video."""
    return np.stack([resize_img(frame, *args) for frame in video])


def save_video_as_images(
    video: np.ndarray, path: Path, grayscale: bool = False, ext: str = "jpg"
) -> None:
    """Write (T, H, W, C) uint8 frames as ``path/NNN.<ext>``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    placeholder = str(path / ("{:03d}." + ext))
    for i, frame in enumerate(video):
        write_img(frame, placeholder.format(i), grayscale)
