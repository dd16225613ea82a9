"""dequant_roofline: the bound of the traced steps' ingest (each input byte
read once, each output written once in the compute dtype, at 3.35 TB/s) over
the device time of the kernels under the harness's range around
``DCVGAN.ingest`` (``ops/dequant.py`` + ``csrc/dequant.cu``)."""


def read(r):
    t = r.trace or {}
    dev_s = t.get("ranges", {}).get("ingest", (0.0, 0))[0]
    bound = r.counters.get("ingest_bound_s")
    if not dev_s or not bound:
        return None
    return 100.0 * bound / dev_s
