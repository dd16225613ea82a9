"""Traffic ``sample_segm``: ``sample``'s bulk sampling (``traffic/sample.py``'s
``measure``, run unchanged) for a configuration whose geometry is a
segmentation, with two more profiler ranges around names the program calls:

- ``portbench.onehot_conv`` around ``onehot_conv3x3`` as ``models/cgen.py``
  calls it (cgen's argmax, one-hot, inconv and LeakyReLU in one launch),
  each traced call's bound (:func:`onehot_bound`) summed in the counter
  ``onehot_bound_s`` and the calls in ``onehot_calls``;
- ``portbench.ggen_decode`` around ``GeometricVideoGenerator._decode_fused``
  (ggen's eval decoder: its first conv, the fused up stages and the softmax
  head), the calls in ``ggen_decode_calls``.

``sample.py`` keeps its phase to itself, so these ranges open only inside
the traced span, between ``portbench.trace.Span.measure`` and
``Span.close``, which this module wraps while ``measure`` runs: the calls of
the traced chunks, one of each a sampling round. A name the program lacks is
left alone, and its reader then finds nothing to read.

The output check adds ``cgen_gap`` to ``sample``'s ``video_gap``. In
bfloat16 ggen's softmax ties classes that float32 keeps apart, so argmax
flips and ``video_gap`` reads rounding of ggen's scores as much as faults
of cgen's segmentation input. ``cgen_gap`` (:func:`cgen_gap`) feeds the
served colour generator and the reference's the same scores, the
reference's float32 ggen output of the first round rounded to bfloat16, so
both take the same labels and ties: what is left is cgen's own arithmetic
and its one-hot input path (labels, tie rule, border taps).

Parameters: ``sample``'s; limits: ``video_gap`` and ``cgen_gap``.
"""

from __future__ import annotations

import functools

import torch

from portbench import judge
from portbench import trace as trace_mod
from portbench.harness import ROOT, Outcome, load_module
from portbench.reference import models, steps, streams
from portbench.yardstick import PEAK_BYTES_PER_S, PEAK_FLOPS


def onehot_bound(n: int, c: int, h: int, w: int, cout: int, dtype: torch.dtype = torch.bfloat16):
    """(bound_s, flops, bytes) of one ``onehot_conv3x3`` call on ``(n, c, h,
    w)`` scores to ``cout`` channels: each score read once, each output
    written once and the f32 table of 9 x C x Cout read once, over the
    memory's rate; or the 9 f32 additions of each output over the f32 peak,
    if that is longer."""
    es = torch.finfo(dtype).bits // 8
    nbytes = n * h * w * (c + cout) * es + 9 * c * cout * 4
    flops = 9 * n * h * w * cout
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]), flops, nbytes


def cgen_gap(cfg, w, running, cgen, seed: int, batchsize: int, device, arith=None) -> float:
    """``judge.video_gap`` of one round's colour videos from the same
    geometry scores: the reference's float32 ggen output of round 0 of chunk
    0, rounded to bfloat16 as the program's ggen gives it, coloured by
    ``cgen`` (the program's served colour generator; or, with ``arith``, the
    reference computed in that arithmetic) against the reference's cgen in
    float32."""
    import dcvgan_torch.cli.serve as serve_mod

    k = streams.fold_in(streams.fold_in(streams.base_key(seed, device), 0), 0)
    z_content, e, h0, z_color = steps.latents(cfg, k, batchsize)
    with torch.no_grad(), steps.full_f32():
        xg = models.ggen(w["ggen"], z_content, e, h0, models.Stats("eval", running["ggen"]), cfg)
        xg = xg.to(torch.bfloat16)
        stats = models.Stats("eval", running["cgen"])
        want = steps.quantize(models.cgen(w["cgen"], xg.float(), z_color, stats, cfg))
        if arith is not None:
            got = steps.quantize(models.cgen(w["cgen"], xg.float(), z_color, stats, cfg, None, arith))
    if arith is None:
        with torch.inference_mode():
            got = serve_mod.quantize(cgen.forward_videos(xg, z_color))
    return judge.video_gap(got.cpu().numpy(), want.cpu().numpy())


def measure(ctx) -> Outcome:
    import dcvgan_torch.cli.serve as serve_mod
    import dcvgan_torch.models.cgen as cgen_mod
    from dcvgan_torch.models.ggen import GeometricVideoGenerator

    sample = load_module(ROOT / "traffic" / "sample.py")
    st = {"traced": False, "onehot_calls": 0, "onehot_bound_s": 0.0, "ggen_decode_calls": 0}

    class TracedSpan(trace_mod.Span):
        def measure(self) -> None:
            super().measure()
            st["traced"] = True

        def close(self) -> None:
            st["traced"] = False
            super().close()

    calibrate, serve = steps.calibrate, serve_mod.serve

    def kept_calibrate(cfg, w, *a, **k):
        st["ref"] = (w, calibrate(cfg, w, *a, **k))
        return st["ref"][1]

    def kept_serve(gan, served, *a, **k):
        st["cgen"] = served.cgen
        return serve(gan, served, *a, **k)

    patches = [(trace_mod, "Span", TracedSpan), (steps, "calibrate", kept_calibrate),
               (serve_mod, "serve", kept_serve)]
    onehot = getattr(cgen_mod, "onehot_conv3x3", None)
    if onehot is not None:
        @functools.wraps(onehot)
        def ranged_onehot(p, w, slope=0.01):
            if not st["traced"]:
                return onehot(p, w, slope)
            with torch.profiler.record_function("portbench.onehot_conv"):
                out = onehot(p, w, slope)
            n, c, h, wd = p.shape
            st["onehot_calls"] += 1
            st["onehot_bound_s"] += onehot_bound(n, c, h, wd, w.shape[0], p.dtype)[0]
            return out

        patches.append((cgen_mod, "onehot_conv3x3", ranged_onehot))
    decode = getattr(GeometricVideoGenerator, "_decode_fused", None)
    if decode is not None:
        @functools.wraps(decode)
        def ranged_decode(self, x):
            if not st["traced"]:
                return decode(self, x)
            with torch.profiler.record_function("portbench.ggen_decode"):
                out = decode(self, x)
            st["ggen_decode_calls"] += 1
            return out

        patches.append((GeometricVideoGenerator, "_decode_fused", ranged_decode))

    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    for owner, name, new in patches:
        setattr(owner, name, new)
    try:
        out = sample.measure(ctx)
    finally:
        for owner, name, old in saved:
            setattr(owner, name, old)
    out.readings.counters.update(onehot_calls=st["onehot_calls"], onehot_bound_s=st["onehot_bound_s"],
                                 ggen_decode_calls=st["ggen_decode_calls"])
    video_check = out.check

    def check():
        (w, running), cgen = st.pop("ref"), st.pop("cgen")
        gap = cgen_gap(ctx.config, w, running, cgen, ctx.seed, ctx.params["batchsize"], ctx.device)
        del w, running, cgen
        return video_check() + [("cgen_gap", gap, ctx.params["limits"]["cgen_gap"])]

    out.check = check
    return out
