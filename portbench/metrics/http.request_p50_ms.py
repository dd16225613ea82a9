"""http.request_p50_ms: the median latency, send to last byte at the client,
of the requests completed in the window's untraced part; it stands beside the
tail."""

from portbench.yardstick import percentile


def read(r):
    lat = r.spans.get("request")
    return 1e3 * percentile(lat, 50) if lat else None
