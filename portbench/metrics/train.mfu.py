"""train.mfu: model FLOPs of the steps completed in the window's untraced
part, over its seconds, as a share of the card's bf16 dense peak. The FLOPs are
the reference's (``yardstick.train_step_flops``)."""

import torch

from portbench.yardstick import PEAK_FLOPS


def read(r):
    c = r.counters
    if not c.get("rest_steps") or not c.get("rest_s"):
        return None
    return 100.0 * c["flops_per_step"] * c["rest_steps"] / c["rest_s"] / PEAK_FLOPS[torch.bfloat16]
