"""cgen.device_ms.sample: device ms a chunk spends in the kernels under the
harness's range around ``ColorVideoGenerator.forward`` (cgen's eval forward:
inconv, down path, up path, tanh), in the traced chunks."""


def read(r):
    t, n = r.trace or {}, r.counters.get("traced_chunks")
    dev_s = t.get("ranges", {}).get("cgen", (0.0, 0))[0]
    if not dev_s or not n:
        return None
    return 1e3 * dev_s / n
