"""Traffic ``sample_cgen``: ``sample``'s bulk sampling (``traffic/sample.py``'s
``measure``, run unchanged) with two more profiler ranges around names the
program calls, so that the colour generator's time reads apart from the
geometry generator's:

- ``portbench.cgen`` around ``ColorVideoGenerator.forward`` (cgen's eval
  forward: inconv, down path, up path, tanh), the calls in ``cgen_calls``;
- ``portbench.cgen_fused_up`` around ``fused_norm_act_up_conv`` as
  ``models/cgen.py`` calls it (cgen's up1-5 and outconv; the geometry
  generator's calls, through its own name, are not ranged), each traced
  call's bound (:func:`up_bound`) summed in the counter
  ``cgen_fused_up_bound_s`` and the calls in ``cgen_fused_up_calls``.

``sample.py`` keeps its phase to itself, so these ranges open only inside
the traced span, between ``portbench.trace.Span.measure`` and
``Span.close``, which this module wraps while ``measure`` runs: the calls of
the traced chunks, one forward and six up convs a sampling round. A name
the program lacks is left alone, and its reader then finds nothing to read.

Parameters and limit: ``sample``'s.
"""

from __future__ import annotations

import functools

import torch

from portbench import trace as trace_mod
from portbench.harness import ROOT, Outcome, load_module
from portbench.yardstick import PEAK_BYTES_PER_S, PEAK_FLOPS


def up_bound(n: int, h: int, c1: int, c2: int, cout: int, route: str):
    """(bound_s, flops, bytes) of one bf16 ``fused_norm_act_up_conv`` call on
    an ``(n, c1, h, h)`` input and an ``(n, c2, h, h)`` skip to ``cout``
    channels, ``route`` ``k4s2`` (k4 s2 p1) or ``k3s1`` (k3 s1 p1): x, the
    skip and the weight read once, the output written once, over the
    memory's rate; or the products of the taps that touch the image, on the
    live channels, over the bf16 peak, if that is longer."""
    s, k = (2, 4) if route == "k4s2" else (1, 3)
    live = (4 * h - 2) ** 2 if s == 2 else (3 * h - 2) ** 2  # non-padding taps summed over the outputs
    flops = 2 * n * (c1 + c2) * cout * live
    nbytes = 2 * (n * h * h * (c1 + c2) + (c1 + c2) * cout * k * k + n * (s * h) ** 2 * cout) + 8 * c1
    return max(flops / PEAK_FLOPS[torch.bfloat16], nbytes / PEAK_BYTES_PER_S), flops, nbytes


def measure(ctx) -> Outcome:
    import dcvgan_torch.models.cgen as cgen_mod

    sample = load_module(ROOT / "traffic" / "sample.py")
    st = {"traced": False, "cgen_calls": 0, "cgen_fused_up_calls": 0, "cgen_fused_up_bound_s": 0.0}

    class TracedSpan(trace_mod.Span):
        def measure(self) -> None:
            super().measure()
            st["traced"] = True

        def close(self) -> None:
            st["traced"] = False
            super().close()

    patches = [(trace_mod, "Span", TracedSpan)]
    cls = getattr(cgen_mod, "ColorVideoGenerator", None)
    forward = getattr(cls, "forward", None)
    if forward is not None:
        @functools.wraps(forward)
        def ranged_forward(self, *a, **k):
            if not st["traced"]:
                return forward(self, *a, **k)
            with torch.profiler.record_function("portbench.cgen"):
                out = forward(self, *a, **k)
            st["cgen_calls"] += 1
            return out

        patches.append((cls, "forward", ranged_forward))
    up = getattr(cgen_mod, "fused_norm_act_up_conv", None)
    if up is not None:
        @functools.wraps(up)
        def ranged_up(x, scale, shift, w, skip=None, stride=2, padding=1):
            if not st["traced"]:
                return up(x, scale, shift, w, skip, stride, padding)
            with torch.profiler.record_function("portbench.cgen_fused_up"):
                out = up(x, scale, shift, w, skip, stride, padding)
            n, c1, h, _ = x.shape
            c2 = 0 if skip is None else skip.shape[1]
            st["cgen_fused_up_calls"] += 1
            st["cgen_fused_up_bound_s"] += up_bound(n, h, c1, c2, w.shape[1],
                                                    "k4s2" if stride == 2 else "k3s1")[0]
            return out

        patches.append((cgen_mod, "fused_norm_act_up_conv", ranged_up))

    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    for owner, name, new in patches:
        setattr(owner, name, new)
    try:
        out = sample.measure(ctx)
    finally:
        for owner, name, old in saved:
            setattr(owner, name, old)
    out.readings.counters.update({k: v for k, v in st.items() if k != "traced"})
    return out
