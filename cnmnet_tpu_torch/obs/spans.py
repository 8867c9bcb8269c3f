"""The port's span recorder: named intervals of host time with attributes,
kept in memory, off by default.

    from cnmnet_tpu_torch.obs import spans

    spans.enable()
    with spans.span("serve.session.stage", bucket=4):
        ...
    spans.record("serve.batcher.queue", start_ns, end_ns, span_id=request_id)
    taken = spans.take()  # Taken(spans=[Span, ...], offset_ns=...)
    spans.disable()

Each ``Span`` holds its name, its own id, the id of its parent (the
innermost span open on the same thread when it began; None at the top),
the thread (``threading.get_ident()``), start and end in
``time.perf_counter_ns()`` and its attributes. ``record`` writes a span
that began on one thread and ended on another, with no parent; a request's
spans share the id that ``new_id()`` gave it.

``enable()`` takes one anchor, ``time.time_ns()`` beside
``time.perf_counter_ns()``; ``take().offset_ns`` added to a stamp puts it
on unix time in nanoseconds, the timeline of ``torch.profiler``'s events.

Off, ``span()`` reads one flag and returns a shared no-op context: it
allocates nothing, takes no lock and calls no torch function (keyword
attributes are still gathered by the call itself). Nothing here uses
``torch.profiler``: turning the recorder on or off adds nothing of the
profiler to the threads it records.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple, Optional

_on = False
_spans: List["Span"] = []
_offset_ns = 0
_ids = itertools.count(1)
_local = threading.local()


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    attrs: dict


class Taken(NamedTuple):
    spans: List[Span]
    offset_ns: int  # unix ns - perf_counter ns, at enable()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "attrs", "id", "parent", "start")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter_ns()
        _stack().pop()
        _spans.append(Span(self.name, self.id, self.parent, threading.get_ident(), self.start, end,
                           self.attrs))
        return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def enabled() -> bool:
    return _on


def span(name: str, **attrs):
    """A context manager that records ``name`` around its block when the
    recorder is on."""
    if not _on:
        return _NO_SPAN
    return _OpenSpan(name, attrs)


def new_id() -> int:
    """A fresh id, unique among every span's."""
    return next(_ids)


def record(name: str, start_ns: int, end_ns: int, span_id: Optional[int] = None, **attrs) -> None:
    """Record a finished span with no parent, under ``span_id`` if given."""
    if _on:
        _spans.append(Span(name, next(_ids) if span_id is None else span_id, None,
                           threading.get_ident(), start_ns, end_ns, attrs))


def _anchor() -> int:
    """``time.time_ns() - time.perf_counter_ns()`` from the closest of a few
    back-to-back pairs of reads."""
    best = None
    for _ in range(5):
        p0 = time.perf_counter_ns()
        unix = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, unix - (p0 + p1) // 2)
    return best[1]


def enable() -> None:
    """Start recording (dropping what was recorded before) and anchor the
    clock."""
    global _on, _offset_ns
    _spans.clear()
    _offset_ns = _anchor()
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> Taken:
    """The spans recorded so far (finished ones only), which the recorder
    then forgets, and the offset onto unix time."""
    global _spans
    taken, _spans = _spans, []
    return Taken(taken, _offset_ns)
