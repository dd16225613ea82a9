"""loader.wait_ms: host ms a train step waits for the epoch iterator's next
batch (``data/loader.py`` + ``data/dataset.py``), the mean over the window's
untraced steps."""


def read(r):
    waits = r.spans.get("loader_wait")
    return 1e3 * sum(waits) / len(waits) if waits else None
