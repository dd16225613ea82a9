"""fused_block_roofline: the summed bounds of the traced chunks'
``fused_norm_act_conv`` calls (``yardstick.fused_site_bound``: the larger of
flops over the bf16 peak and bytes over 3.35 TB/s, per call from its shapes)
over the device time of the kernels under the harness's range around each
call (``ops/fused_block.py`` + ``csrc/fused_block.cu``)."""


def read(r):
    t = r.trace or {}
    dev_s = t.get("ranges", {}).get("fused_block", (0.0, 0))[0]
    bound = r.counters.get("fused_bound_s")
    if not dev_s or not bound:
        return None
    return 100.0 * bound / dev_s
