"""conv.device_ms.train: device ms a train step spends in kernels under the
aten convolution ops (forward and backward), in the traced steps."""


def read(r):
    t, n = r.trace, r.counters.get("traced_steps")
    if not t or not n or not t.get("conv_s"):
        return None
    return 1e3 * t["conv_s"] / n
