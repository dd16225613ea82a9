"""Batched eval-mode sampling to host uint8 videos.

Counterpart of ``dcvgan_tpu/eval/sampler.py``: ceil(num / batchsize)
sampling rounds, colour videos to uint8 and geometry rendered in colour on
the host, concatenated and trimmed to ``num``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dcvgan_torch import prng
from dcvgan_torch.train.state import GeneratorState
from dcvgan_torch.utils.video_np import (
    geometric_info_in_color_format,
    videos_to_uint8,
)


def generate_samples(
    gan,
    state: GeneratorState,
    gen: torch.Generator,
    num: int,
    batchsize: int = 20,
    with_geo: bool = True,
) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Generate ``num`` (geometry, colour) videos as uint8 numpy.

    Round i draws from ``prng.for_step(gen, i)``. Returns ``(xg, xc)``: xg is
    (num, T, H, W, 3) rendered geometry (None when ``with_geo=False``), xc is
    (num, T, H, W, 3) RGB.
    """
    xg_batches, xc_batches = [], []
    for i in range((num + batchsize - 1) // batchsize):
        xg, xc = gan.sample_videos(state, prng.for_step(gen, i), batchsize)
        if with_geo:
            xg_batches.append(xg.float().clamp(-1, 1).cpu().numpy())
        xc_batches.append(videos_to_uint8(xc.float().cpu().numpy()))

    xc_all = np.concatenate(xc_batches)[:num]
    if not with_geo:
        return None, xc_all
    xg_all = np.concatenate(xg_batches)[:num]
    return geometric_info_in_color_format(xg_all, gan.geometric_info), xc_all
