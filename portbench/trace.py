"""The traced span of a ``--trace 1`` run, read from ``torch.profiler``.

The harness opens the profiler from outside the program, lets it run one
warm-up part that is discarded, then traces the measured part. The profiler
loses kernels launched just after its measured part starts, so that part
opens with a marker kernel (a short spin, left out of every sum), a
synchronise and a pause. From the trace:

- ``busy_s``: the union of the device's kernel intervals in the window;
  ``window_s``: from the first kernel after the marker to the last one;
- device seconds under each ``record_function`` range the harness opened
  (``portbench.<name>``): the kernels that lie inside the range's interval
  on the device's timeline (the profiler's device-side copy of the range);
  and device seconds under the aten convolution ops;
- the device's longest idle gaps, each named by the host's innermost event
  at the gap's start, and the device operations that took most time.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from portbench.yardstick import union_seconds

MARKER = "spin_kernel"
CONV_OPS = ("aten::convolution", "aten::convolution_backward")
RANGE_PREFIX = "portbench."


class Span:
    """A profiler over one span: :meth:`open` (warm-up part starts),
    :meth:`measure` (measured part starts), :meth:`close` (it ends)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self.summary: Optional[Dict] = None

    def open(self) -> None:
        self.prof.start()

    def measure(self) -> None:
        torch.cuda.synchronize()
        self.prof.step()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.005)

    def close(self) -> None:
        torch.cuda.synchronize()
        self.prof.step()
        self.prof.stop()

    def summarize(self) -> Dict:
        """The closed span's summary (read after the window: it takes a
        while)."""
        if self.summary is None:
            self.summary = summarize(self.prof)
        return self.summary


def _device_time(e) -> float:
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)


def summarize(prof) -> Dict:
    events = prof.events()
    kernels, host, marked = [], [], []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith(RANGE_PREFIX):
                marked.append(e)
            elif not getattr(e, "is_user_annotation", False):
                kernels.append(e)
        else:
            host.append(e)
    marks = [k for k in kernels if MARKER in k.name]
    start = max((k.time_range.end for k in marks), default=-float("inf"))
    kernels = [k for k in kernels if MARKER not in k.name and k.time_range.start >= start]
    if not kernels:
        return {"busy_s": 0.0, "window_s": 0.0, "ranges": {}, "conv_s": 0.0,
                "device_ops": [], "idle_gaps": []}
    iv = [(k.time_range.start, k.time_range.end) for k in kernels]
    t0, t1 = min(s for s, _ in iv), max(e for _, e in iv)

    ranges: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for m in marked:
        inside = [k for k in kernels
                  if m.time_range.start <= k.time_range.start and k.time_range.end <= m.time_range.end]
        r = ranges[m.name[len(RANGE_PREFIX):]]
        r[0] += sum(k.time_range.end - k.time_range.start for k in inside) / 1e6
        r[1] += 1
    conv = sum(_device_time(e) for e in prof.key_averages() if e.key in CONV_OPS) / 1e6
    by_name: Dict[str, float] = defaultdict(float)
    for k in kernels:
        by_name[k.name] += (k.time_range.end - k.time_range.start) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": union_seconds(iv) / 1e6, "window_s": (t1 - t0) / 1e6,
            "ranges": dict(ranges), "conv_s": conv, "device_ops": [[n, s] for n, s in top],
            "idle_gaps": _gaps(iv, [h for h in host if h.time_range.end >= t0])}


def _gaps(iv, host, n: int = 10) -> List[list]:
    """The ``n`` longest gaps between the union of ``iv``, each named by the
    host event that started last among those open at the gap's start."""
    merged = []
    for s, e in sorted(iv):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])), reverse=True)[:n]
    out = []
    for length, at in gaps:
        open_ = [h for h in host if h.time_range.start <= at < h.time_range.end]
        name = max(open_, key=lambda h: h.time_range.start).name if open_ else "host (no op)"
        out.append([name, length / 1e6])
    return out


def idle_percent(readings) -> Optional[float]:
    """100 * (1 - busy / window) of the traced span, or None untraced."""
    t = readings.trace
    if not t or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
