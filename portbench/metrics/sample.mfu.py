"""sample.mfu: model FLOPs a video (the reference's eval-mode ggen + cgen,
``yardstick.sample_flops``) times the videos delivered in the window's
untraced part, over its seconds, as a share of the card's bf16 dense peak."""

import torch

from portbench.yardstick import PEAK_FLOPS


def read(r):
    c = r.counters
    if not c.get("rest_videos") or not c.get("rest_s"):
        return None
    return 100.0 * c["flops_per_video"] * c["rest_videos"] / c["rest_s"] / PEAK_FLOPS[torch.bfloat16]
