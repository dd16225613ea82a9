"""Host spans of the program's phases, kept in memory for a reader in the
same process.

Off by default: :func:`span` then costs one module-level flag check and
returns a shared no-op, and reads no clock. On (:func:`enable`), each span
appends a :class:`Record` ``(name, start_ns, end_ns, parent, thread, id)``
to a ring of :data:`CAPACITY` records: times from ``time.perf_counter_ns``,
``parent`` the name of the span open in the same thread when it began,
``thread`` the thread's ident, ``id`` the request or round it belongs to.
A full ring overwrites its oldest records; :func:`dropped` counts them.

While a ``torch.profiler`` records the calling thread, a span also opens
``record_function("dcvgan." + name)``, which puts it on the trace's host
timeline. Without one it does not: an unheard ``record_function`` still
costs microseconds. The profiler records only the thread that started it;
a span of another thread is in the ring alone, and the profiler's clock is
``time.time_ns``, not ``perf_counter_ns``.

:func:`begin` and :func:`end` bracket a span that starts in one thread and
ends in another (no profiler range). :func:`mark` and ``records(since=...)``
take the spans of a window. Nothing is exported: the reader is in-process.
"""

from __future__ import annotations

import threading
import time
from typing import List, NamedTuple, Optional

import torch

CAPACITY = 65536
PREFIX = "dcvgan."


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    thread: int
    id: Optional[int]


class _Ring:
    def __init__(self):
        self.slots: List[Optional[tuple]] = [None] * CAPACITY  # Record's fields
        self.n = 0  # records ever appended; record s sits in slot s % CAPACITY
        self.lock = threading.Lock()

    def append(self, rec: tuple) -> None:
        with self.lock:
            self.slots[self.n % CAPACITY] = rec
            self.n += 1


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()
_on = False
_ring = _Ring()
_local = threading.local()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "id", "start", "parent", "range")

    def __init__(self, name: str, id: Optional[int]):
        self.name, self.id = name, id

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.autograd.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack().pop()
        _ring.append((self.name, self.start, end, self.parent, threading.get_ident(), self.id))
        return False


def span(name: str, id: Optional[int] = None):
    """A context manager timing its block as ``name`` (of request or round
    ``id``); it closes on an exception too."""
    if not _on:
        return _NOOP
    return _Span(name, id)


def begin(name: str, id: Optional[int] = None) -> Optional[tuple]:
    """Start a span that :func:`end` closes, from any thread; None when
    off. Its parent and thread are those of the caller."""
    if not _on:
        return None
    stack = _stack()
    parent = stack[-1].name if stack else None
    return name, time.perf_counter_ns(), parent, threading.get_ident(), id


def end(token: Optional[tuple]) -> None:
    """Close :func:`begin`'s span (nothing for None)."""
    if token is not None:
        name, start, parent, thread, id = token
        _ring.append((name, start, time.perf_counter_ns(), parent, thread, id))


def enable() -> None:
    """Start recording into an empty ring."""
    global _on, _ring
    _ring = _Ring()
    _on = True


def disable() -> None:
    """Stop recording; the records stay readable."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def mark() -> int:
    """The position of the next record, for ``records(since=...)``."""
    return _ring.n


def records(since: int = 0) -> List[Record]:
    """The records appended at or after ``since`` that the ring still holds,
    oldest first (in the order the spans ended)."""
    ring = _ring
    with ring.lock:
        return [Record._make(ring.slots[s % CAPACITY])
                for s in range(max(since, ring.n - CAPACITY), ring.n)]


def dropped(since: int = 0) -> int:
    """Records appended at or after ``since`` that a full ring overwrote."""
    return max(0, _ring.n - CAPACITY - since)
