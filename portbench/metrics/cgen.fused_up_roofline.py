"""cgen.fused_up_roofline: the summed bounds of the traced chunks' calls of
``fused_norm_act_up_conv`` as ``models/cgen.py`` calls it (cgen's up1-5 and
outconv; ``traffic/sample_cgen.py``'s ``up_bound``: x, skip and weight read
once, the output written once, the live taps' products on live channels;
the larger of operations at 989 TFLOP/s and bytes at 3.35 TB/s) over the
device time of the kernels under the harness's range around each call
(``ops/fused_up.py`` + ``csrc/fused_up.cu`` at cgen's sites)."""


def read(r):
    t = r.trace or {}
    dev_s = t.get("ranges", {}).get("cgen_fused_up", (0.0, 0))[0]
    bound = r.counters.get("cgen_fused_up_bound_s")
    if not dev_s or not bound:
        return None
    return 100.0 * bound / dev_s
