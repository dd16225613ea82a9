"""The comparisons that decide ``correct``: the program's outputs against
the reference's, as numbers held to the limits in each cell's workload file.
"""

from __future__ import annotations

import statistics

import numpy as np

from portbench.reference import models


def train_gaps(prog_losses, prog_grads1, prog_params, ref, w0) -> dict:
    """The training check's numbers, program against reference:

    - ``loss_gap``: the largest relative gap of a loss over steps 1-3;
    - ``grad_gap``: over the leaves, the largest gap between the norms of
      the step-1 gradients Adam took, against the reference's norm of that
      leaf or of its model's median leaf, whichever is larger;
    - ``grad_gap.critics``: the same over the critics' leaves alone, whose
      step-1 gradients come from the D phase before any optimizer step (the
      generators' come after the critics' first Adam step, which moves every
      parameter by the learning rate in the sign its gradient has, so
      rounding at near-zero gradient elements turns into whole moves);
    - ``change_gap``: the same as ``grad_gap`` of each leaf's change over
      the three steps, leaving out leaves whose reference gradient is under
      a thousandth of its model's median leaf's (their change is round-off
      under Adam). A state left unchanged reads 1.

    The workload file's limits name the numbers compared; the others are
    reported beside them.
    """
    loss_gap = max(abs(pl[k] - rl[k]) / abs(rl[k])
                   for pl, rl in zip(prog_losses, ref["losses"]) for k in rl)
    grad = {m: 0.0 for m in models.MODELS}
    change_gap = 0.0
    for m in models.MODELS:
        rg = {k: float(v.norm()) for k, v in ref["grads1"][m].items()}
        med_g = statistics.median(rg.values())
        rc = {k: float((ref["params"][m][k] - w0[m][k]).norm()) for k in rg}
        moving = [k for k in rg if rg[k] >= 1e-3 * med_g]
        med_c = statistics.median(rc[k] for k in moving)
        for k in rg:
            pg = float(prog_grads1[m][k].norm())
            grad[m] = max(grad[m], abs(pg - rg[k]) / max(rg[k], med_g))
        for k in moving:
            pc = float((prog_params[m][k] - w0[m][k].cpu()).norm())
            change_gap = max(change_gap, abs(pc - rc[k]) / max(rc[k], med_c))
    return {"loss_gap": loss_gap, "grad_gap": max(grad.values()),
            "grad_gap.critics": max(grad[m] for m in models.CRITICS), "change_gap": change_gap}


def compared(numbers: dict, limits: dict) -> list:
    """``[(name, value, limit)]`` of the numbers the limits name."""
    return [(name, numbers[name], limit) for name, limit in limits.items()]


def video_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The largest mean |difference| in uint8 levels of one video, over the
    videos of a round (``(B, T, H, W, 3)`` each)."""
    if got.shape != want.shape:
        return float("inf")
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return float(d.reshape(d.shape[0], -1).mean(1).max())


def train_gap_detail(prog_losses, prog_grads1, prog_params, ref, w0) -> dict:
    """The same gaps taken apart, for the look behind a limit: each step's
    largest loss gap, step 1's critic losses and generator loss, and per
    model the worst and the median leaf's gradient and change gaps."""
    out = {}
    for s, (pl, rl) in enumerate(zip(prog_losses, ref["losses"]), start=1):
        gaps = {k: abs(pl[k] - rl[k]) / abs(rl[k]) for k in rl}
        out[f"loss_step{s}"] = max(gaps.values())
        if s == 1:
            out["loss_step1_critics"] = max(v for k, v in gaps.items() if k != "loss_gen")
            out["loss_step1_gen"] = gaps["loss_gen"]
    for m in models.MODELS:
        rg = {k: float(v.norm()) for k, v in ref["grads1"][m].items()}
        med_g = statistics.median(rg.values())
        g = [abs(float(prog_grads1[m][k].norm()) - rg[k]) / max(rg[k], med_g) for k in rg]
        rc = {k: float((ref["params"][m][k] - w0[m][k]).norm()) for k in rg}
        moving = [k for k in rg if rg[k] >= 1e-3 * med_g]
        med_c = statistics.median(rc[k] for k in moving)
        c = [abs(float((prog_params[m][k] - w0[m][k].cpu()).norm()) - rc[k]) / max(rc[k], med_c)
             for k in moving]
        out[f"grad_{m}_max"], out[f"grad_{m}_median"] = max(g), statistics.median(g)
        out[f"change_{m}_max"], out[f"change_{m}_median"] = max(c), statistics.median(c)
    return out
