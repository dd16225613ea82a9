"""The span recorder (``dcvgan_torch/utils/trace.py``): off it records and
times nothing; on it keeps name, times, parent, thread and id in a ring of
fixed capacity, and opens a profiler range only under a profiler."""

import threading

import pytest
import torch

from dcvgan_torch.utils import trace
from torch_port_util import tracing  # noqa: F401


def _refuse(*args, **kwargs):
    raise AssertionError("called while it should not be")


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    trace.disable()
    monkeypatch.setattr(trace.time, "perf_counter_ns", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    at = trace.mark()
    first = trace.span("a", 1)
    assert first is trace.span("b") and not trace.enabled()
    with first:
        pass
    assert trace.begin("c", 2) is None
    trace.end(None)
    assert trace.records(since=at) == [] and trace.mark() == at


def test_on_records_name_times_parent_thread_and_id(tracing):
    assert tracing.enabled()
    with tracing.span("outer", 7):
        with tracing.span("inner"):
            pass
    inner, outer = tracing.records()
    assert (inner.name, inner.parent, inner.id) == ("inner", "outer", None)
    assert (outer.name, outer.parent, outer.id) == ("outer", None, 7)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert inner.thread == outer.thread == threading.get_ident()


def test_a_span_closes_on_an_exception(tracing):
    with pytest.raises(KeyError):
        with tracing.span("fails", 3):
            raise KeyError("x")
    with tracing.span("after"):
        pass
    failed, after = tracing.records()
    assert failed.name == "fails" and failed.id == 3 and failed.start_ns <= failed.end_ns
    assert after.parent is None  # the failed span left the thread's stack


def test_begin_and_end_in_two_threads(tracing):
    with tracing.span("submit"):
        token = tracing.begin("queue", 5)
    t = threading.Thread(target=tracing.end, args=(token,))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    submit, queue = tracing.records()
    assert (queue.name, queue.id, queue.parent) == ("queue", 5, "submit")
    assert queue.thread == threading.get_ident() != t.ident
    assert submit.start_ns <= queue.start_ns <= queue.end_ns


def test_the_ring_keeps_its_capacity_and_counts_drops(tracing):
    for i in range(tracing.CAPACITY + 10):
        with tracing.span("s", i):
            pass
    kept = tracing.records()
    assert len(kept) == tracing.CAPACITY
    assert kept[0].id == 10 and kept[-1].id == tracing.CAPACITY + 9
    assert tracing.dropped() == 10 and tracing.dropped(since=4) == 6
    at = tracing.mark()
    assert tracing.dropped(since=at) == 0
    with tracing.span("t"):
        pass
    assert [r.name for r in tracing.records(since=at)] == ["t"]
    tracing.enable()  # a fresh ring
    assert tracing.records() == [] and tracing.dropped() == 0


def test_a_profiler_range_only_under_a_profiler(tracing, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("phase", 1):
            torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert names.count("dcvgan.phase") == 1
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    with tracing.span("unprofiled"):
        pass
    assert [r.name for r in tracing.records()] == ["phase", "unprofiled"]


def test_threads_lose_no_record(tracing):
    """More recording threads than cores, switching as often as the
    interpreter allows: every span lands in its own slot of the ring."""
    import os
    import sys

    n_threads, per_thread = 2 * (os.cpu_count() or 4), 500
    start = threading.Barrier(n_threads)

    def record(t):
        start.wait(timeout=30)
        for i in range(per_thread):
            with tracing.span("s", t * per_thread + i):
                pass
            tracing.end(tracing.begin("q", -(t * per_thread + i) - 1))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=record, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    ids = sorted(r.id for r in tracing.records())
    total = n_threads * per_thread
    assert tracing.mark() == 2 * total and ids == list(range(-total, total))
