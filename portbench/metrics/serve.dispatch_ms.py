"""serve.dispatch_ms: host ms to enqueue one ``chunk_fn`` call of ``serve()``'s
chunk loop (``cli/serve.py``), the mean over the window's untraced chunks."""


def read(r):
    host = r.spans.get("dispatch")
    return 1e3 * sum(host) / len(host) if host else None
