"""Named spans at the port's layer boundaries, kept in memory.

    from caliscope_tpu_torch import tracing

    tracing.enable()
    ...  # track, play or calibrate as usual
    for s in tracing.spans():
        print(s.name, (s.end_ns - s.start_ns) / 1e6, "ms", s.attrs)
    tracing.disable()

Tracing is off by default. Off, `span(name, **attrs)` is one check of a
module flag and hands back a shared no-op context: no clock read, no lock,
no record. On, each span records a `Span` (its name, its id, its parent's
id, its request's id, the thread, its start and end on
`time.perf_counter_ns()`, and its attributes) in a bounded store; while a
torch.profiler runs, it also opens a `torch.profiler.record_function` range
of the same name, so that the span stands in the profiler's trace (and in a
Perfetto view of it) on the profiler's own clock, on the threads the
profiler records.

The parent of a span is the innermost span open on the same thread. A span
with no parent starts a request, and the spans under it carry its id: a
`get_points_batch` call, a streamer frame or a `calibrate_extrinsics` job.
Counts (frames, bytes, passes) are attributes of the span where the work
happens. No span reads the device or waits for it: spans around the port's
own device-to-host reads time those reads and add none.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import NamedTuple

import torch.autograd.profiler as torch_profiler
from torch.profiler import record_function

CAPACITY = 1 << 18  # spans kept; the oldest go first, and are counted

_on = False
_NOOP = nullcontext()
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_store: deque = deque(maxlen=CAPACITY)
_dropped = 0


class Span(NamedTuple):
    name: str
    span_id: int
    parent_id: int | None
    request_id: int
    thread_id: int
    start_ns: int
    end_ns: int
    attrs: dict


class Spans(list):
    """The spans recorded, oldest first; `dropped` counts those the bounded
    store let go."""

    dropped: int = 0


class _Open:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "request_id", "start_ns", "_range")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self.span_id = next(_ids)
        parent = stack[-1] if stack else None
        self.parent_id = parent.span_id if parent else None
        self.request_id = parent.request_id if parent else self.span_id
        stack.append(self)
        # the span's times take in its range, whose calls may wait for the
        # interpreter lock; a range records nothing with no profiler running,
        # so it opens only under one
        self.start_ns = time.perf_counter_ns()
        self._range = record_function(self.name) if getattr(torch_profiler, "_is_profiler_enabled", True) else None
        if self._range is not None:
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        global _dropped
        if self._range is not None:
            self._range.__exit__(*exc)
        end = time.perf_counter_ns()
        _local.stack.pop()
        record = Span(self.name, self.span_id, self.parent_id, self.request_id, threading.get_ident(),
                      self.start_ns, end, self.attrs)
        with _lock:
            if len(_store) == _store.maxlen:
                _dropped += 1
            _store.append(record)
        return False


def span(name: str, **attrs):
    """A context manager over one piece of work named `name`, recorded with
    `attrs` while tracing is on; the shared no-op context while it is off."""
    if not _on:
        return _NOOP
    return _Open(name, attrs)


def enable() -> None:
    """Turn tracing on."""
    global _on
    _on = True


def disable() -> None:
    """Turn tracing off; spans open now are still recorded as they close."""
    global _on
    _on = False


def spans() -> Spans:
    """The recorded spans, oldest first, with the count of dropped ones."""
    with _lock:
        out = Spans(_store)
        out.dropped = _dropped
    return out


def clear() -> None:
    """Forget every recorded span and the count of dropped ones."""
    global _dropped
    with _lock:
        _store.clear()
        _dropped = 0
