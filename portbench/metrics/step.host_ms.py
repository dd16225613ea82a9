"""step.host_ms: host ms a ``DCVGAN.train_step`` call takes until it returns,
the eager step's enqueue cost, the mean over the window's untraced steps."""


def read(r):
    host = r.spans.get("step_host")
    return 1e3 * sum(host) / len(host) if host else None
