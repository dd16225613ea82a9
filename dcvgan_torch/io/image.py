"""Image I/O: the port's own copy of ``read_img`` / ``write_img`` of
``dcvgan_tpu/io/image.py``. RGB channel order, uint8 (H, W, C) numpy arrays.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import cv2
import numpy as np


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
