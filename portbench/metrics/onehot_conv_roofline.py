"""onehot_conv_roofline: the summed bounds of the traced chunks'
``onehot_conv3x3`` calls (``traffic/sample_segm.py``'s ``onehot_bound``:
each score read once, each output written once, over 3.35 TB/s) over the
device time of the kernels under the harness's range around each call
(``ops/onehot_conv.py`` + ``csrc/onehot_conv.cu``)."""


def read(r):
    t = r.trace or {}
    dev_s = t.get("ranges", {}).get("onehot_conv", (0.0, 0))[0]
    bound = r.counters.get("onehot_bound_s")
    if not dev_s or not bound:
        return None
    return 100.0 * bound / dev_s
