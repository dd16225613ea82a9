"""Numpy video utilities for the sampler, the trainer's sample logging and
the raw-dataset preprocessors: the port's own copy of the helpers of
``dcvgan_tpu/utils/video_np.py``.

Videos are channels-last ``(B, T, H, W, C)``.
"""

from __future__ import annotations

import numpy as np


def videos_to_uint8(videos: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> [0, 255] uint8 with clipping; uint8 passes through."""
    videos = np.asarray(videos)
    if videos.dtype == np.uint8:
        return videos
    videos = np.clip(videos.astype(np.float32), -1, 1)
    return ((videos + 1) / 2 * 255).astype(np.uint8)


def ensure_float_video(videos: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1]; float passes through."""
    videos = np.asarray(videos)
    if videos.dtype == np.uint8:
        return videos.astype(np.float32) / 127.5 - 1.0
    return videos.astype(np.float32)


def make_video_grid(videos: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """(N, T, H, W, C) -> (1, T, rows*H, cols*W, C) tiled grid."""
    n, t, h, w, c = videos.shape
    assert n == rows * cols, (n, rows, cols)
    v = videos.reshape(rows, cols, t, h, w, c)
    v = v.transpose(2, 0, 3, 1, 4, 5)  # (T, rows, H, cols, W, C)
    v = v.reshape(t, rows * h, cols * w, c)
    return v[None]


def calc_optical_flow(video: np.ndarray) -> np.ndarray:
    """Farneback optical flow between consecutive frames: (T, H, W, 3) uint8
    RGB -> (T-1, H, W, 2) float32."""
    import cv2  # only the flow helpers need OpenCV

    flows = []
    for i in range(len(video) - 1):
        f1 = cv2.cvtColor(video[i], cv2.COLOR_RGB2GRAY)
        f2 = cv2.cvtColor(video[i + 1], cv2.COLOR_RGB2GRAY)
        flows.append(cv2.calcOpticalFlowFarneback(f1, f2, None, 0.5, 3, 15, 3, 5, 1.2, 0))
    return np.stack(flows)


def visualize_optical_flow(flow_video: np.ndarray) -> np.ndarray:
    """(T, H, W, 2) flow -> (T, H, W, 3) uint8 RGB via the HSV wheel."""
    import cv2  # only the flow helpers need OpenCV

    frames = []
    h, w = flow_video.shape[1:3]
    for flow in flow_video:
        mag, ang = cv2.cartToPolar(
            flow[..., 0].astype(np.float32), flow[..., 1].astype(np.float32)
        )
        hsv = np.zeros((h, w, 3), dtype=np.uint8)
        hsv[..., 0] = ang * 180 / np.pi / 2
        hsv[..., 1] = 255
        hsv[..., 2] = cv2.normalize(mag, None, 0, 255, cv2.NORM_MINMAX)
        frames.append(cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    return np.stack(frames)


# SURREAL 25-body-part colormap (+background), as in the surreal demo's
# segmColorMap.m
_SEGM_PART_COLORS = np.array(
    [
        [0.4500, 0.5470, 0.6410],
        [0.8500, 0.3250, 0.0980],
        [0.9290, 0.6940, 0.1250],
        [0.4940, 0.1840, 0.3560],
        [0.4660, 0.6740, 0.1880],
        [0.3010, 0.7450, 0.9330],
        [0.5142, 0.7695, 0.7258],
        [0.9300, 0.8644, 0.4048],
        [0.6929, 0.6784, 0.7951],
        [0.6154, 0.7668, 0.4158],
        [0.4668, 0.6455, 0.7695],
        [0.9227, 0.6565, 0.3574],
        [0.6528, 0.8096, 0.3829],
        [0.6856, 0.4668, 0.6893],
        [0.7914, 0.7914, 0.7914],
        [0.7440, 0.8571, 0.7185],
        [0.9191, 0.7476, 0.8352],
        [0.9300, 0.9300, 0.6528],
        [0.3686, 0.3098, 0.6353],
        [0.6196, 0.0039, 0.2588],
        [0.9539, 0.8295, 0.6562],
        [0.9955, 0.8227, 0.4828],
        [0.1974, 0.5129, 0.7403],
        [0.5978, 0.8408, 0.6445],
        [0.8877, 0.6154, 0.5391],
        [0.6206, 0.2239, 0.3094],
    ],
    dtype=np.float64,
)


def segm_color(i: int) -> np.ndarray:
    """RGB colour (floats in [0, 1]) of segmentation part ``i``."""
    return _SEGM_PART_COLORS[i]


def geometric_info_in_color_format(xg: np.ndarray, geometric_info: str) -> np.ndarray:
    """Render geometry videos ``(B, T, H, W, C)`` float as ``(B, T, H, W, 3)``
    uint8: depth tiles to 3 channels, flow goes through the HSV wheel after
    undoing the /image_size normalisation, segmentation maps argmax through
    the SURREAL palette."""
    if geometric_info == "depth":
        out = np.repeat(xg, 3, axis=-1)
        return ((out + 1) / 2 * 255).astype(np.uint8)

    if geometric_info == "optical-flow":
        h = xg.shape[2]
        flows = xg * h
        return np.stack([visualize_optical_flow(f) for f in flows]).astype(np.uint8)

    if geometric_info == "segmentation":
        labels = np.argmax(xg, axis=-1)
        palette = (_SEGM_PART_COLORS[: labels.max() + 1] * 255).astype(np.uint8)
        return palette[labels]

    raise NotImplementedError(geometric_info)
