"""ggen.decode_ms.sample: device ms a chunk spends in the kernels under the
harness's range around ``GeometricVideoGenerator._decode_fused`` (ggen's
eval decoder: its first conv, the fused up stages and the softmax head), in
the traced chunks."""


def read(r):
    t, n = r.trace or {}, r.counters.get("traced_chunks")
    dev_s = t.get("ranges", {}).get("ggen_decode", (0.0, 0))[0]
    if not dev_s or not n:
        return None
    return 1e3 * dev_s / n
