"""Batch-assembly helpers on the host, in numpy.

The plain forms of ``dcvgan_torch.native``'s three functions (all return
float32 arrays, equal bit for bit to the library's). The dataset and the
trainer call the library; the tests and ``chip_smoke.py`` hold it against
these.
"""

from __future__ import annotations

import numpy as np


def normalize_u8(x: np.ndarray, divisor: float, shift: float) -> np.ndarray:
    """float32(x) / divisor + shift (a division, not a reciprocal)."""
    x = np.ascontiguousarray(x, dtype=np.uint8)
    return x.astype(np.float32) / np.float32(divisor) + np.float32(shift)


def one_hot(labels: np.ndarray, n_classes: int) -> np.ndarray:
    """uint8 labels (...,) -> float32 one-hot (..., n_classes); a label
    outside the range gives an all-zero row."""
    labels = np.ascontiguousarray(labels, dtype=np.uint8)
    eye = np.concatenate(
        [np.eye(n_classes, dtype=np.float32),
         np.zeros((max(0, 256 - n_classes), n_classes), np.float32)]
    )
    return eye[labels]


def scale_f32(x: np.ndarray, scale: float) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float32) * np.float32(scale)
