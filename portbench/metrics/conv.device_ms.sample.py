"""conv.device_ms.sample: device ms a chunk spends in kernels under the aten
convolution ops, in the traced chunks."""


def read(r):
    t, n = r.trace, r.counters.get("traced_chunks")
    if not t or not n or not t.get("conv_s"):
        return None
    return 1e3 * t["conv_s"] / n
