"""http.delivered_share: videos served over the videos the chunks generated
(``/stats``: ``videos_served`` / (``batched_chunks`` x chunk)), in the
window's untraced part (``MicroBatcher``)."""


def read(r):
    share = r.counters.get("delivered_share")
    return share or None
