"""Spans and counters inside the program, on the device trace's clock.

    with tracing.span("span.extract.forward"):
        ...
    tracing.count("extract.batches")

A span records its name, its start and end (``time.time_ns()``, the
Unix-epoch nanoseconds on which kineto stamps host and device events, so
the spans of any thread lie on the device timeline of a ``torch.profiler``
trace), its thread, the span that encloses it on that thread, and the unit
of work it belongs to: stage 4's batch, stage 5's step, stage 6's
iteration. A span takes its unit from ``unit=``, else from the enclosing
span on its thread (the feed thread's per-batch span hands batch n's unit
to its decoding, as the main thread's does to its forward). The counters
count work where it happens (batches, bytes written, host reads, kernel
launches, non-local blocks run). Each non-local block of SLOWFAST_NLN_8x8_R50
is a span ``span.extract.nonlocal`` (its enqueue, on the thread that runs
the model) and counts in ``nonlocal.blocks`` on any path; the non-local
core's kernel counts its launches in ``nln_bf16.launches``, stage 6's fused
greedy step its in ``batch_mi.launches``.

Tracing is on while a ``torch.profiler`` profile records in this process
and inside ``with enabled():``. When it turns on, the spans and counters
are emptied (by ``enabled()`` on entry; under a profiler by the first span
or count that finds it on), so a reader after a window finds only what the
window did. Off, ``span`` returns a shared context that does nothing and
``count`` returns: a flag test a call, nothing allocated. While a profiler
records, a span also enters ``torch.profiler.record_function`` under its
own name, so the main thread's spans appear in the exported trace; the
profiler does not record one opened on a plain Python thread, while
``spans()`` holds those of every thread.

Nothing here imports torch: the decode workers import this module through
``data.tar_dataset`` and must start without it.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from typing import Dict, List, NamedTuple, Optional


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[int]  # the enclosing span's id, on the same thread
    unit: Optional[int]
    attrs: Dict


_spans: List[Span] = []
_counters: Dict[str, int] = {}
_count_lock = threading.Lock()
_ids = itertools.count()
_local = threading.local()  # .stack: the thread's open spans
_forced = 0  # depth of enabled() contexts
_was_on = False
_profiler = None  # torch.autograd.profiler, once torch is imported


def _profiling() -> bool:
    global _profiler
    if _profiler is None:
        _profiler = sys.modules.get("torch.autograd.profiler")
        if _profiler is None:
            return False
    return _profiler._is_profiler_enabled


def _reset() -> None:
    _spans.clear()
    with _count_lock:
        _counters.clear()


def on() -> bool:
    """Whether spans and counts are recorded now."""
    global _was_on
    now = _forced > 0 or _profiling()
    if now != _was_on:
        _was_on = now
        if now:
            _reset()
    return now


class enabled:
    """``with enabled():`` records spans and counts inside the block, with
    or without a profiler; entering it when tracing is off empties both."""

    def __enter__(self):
        global _forced
        on()  # a profile that ended unseen must not leave the state on
        _forced += 1
        on()

    def __exit__(self, *exc):
        global _forced
        _forced -= 1
        on()
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "unit", "attrs", "id", "parent", "start", "stack", "label")

    def __init__(self, name: str, unit: Optional[int], attrs: Dict):
        self.name, self.unit, self.attrs = name, unit, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        if parent is not None:
            self.parent = parent.id
            if self.unit is None:
                self.unit = parent.unit
        else:
            self.parent = None
        self.id = next(_ids)
        self.stack = stack
        stack.append(self)
        self.start = time.time_ns()
        self.label = None
        if _profiling():  # the span encloses its profiler event
            self.label = _profiler.record_function(self.name)
            self.label.__enter__()
        return self

    def __exit__(self, *exc):
        if self.label is not None:
            self.label.__exit__(*exc)
        end = time.time_ns()
        self.stack.pop()
        _spans.append(Span(self.id, self.name, self.start, end, threading.get_ident(),
                           self.parent, self.unit, self.attrs))
        return False


def span(name: str, unit: Optional[int] = None, **attrs):
    """A context that records the stretch it encloses as ``name`` (with
    ``unit`` and ``attrs``) when tracing is on."""
    if not on():
        return _OFF
    return _Open(name, unit, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` when tracing is on."""
    if not on():
        return
    with _count_lock:
        _counters[name] = _counters.get(name, 0) + n


def spans() -> List[Span]:
    """The spans recorded since tracing last turned on, in the order they
    ended."""
    return list(_spans)


def counters() -> Dict[str, int]:
    """The counts since tracing last turned on."""
    with _count_lock:
        return dict(_counters)


def total_ns(name: str, records: Optional[List[Span]] = None) -> int:
    """The summed duration of the spans named ``name``."""
    records = spans() if records is None else records
    return sum(s.end_ns - s.start_ns for s in records if s.name == name)


def self_ns(name: str, records: Optional[List[Span]] = None) -> int:
    """The time of the spans named ``name`` less the time their child spans
    cover (children nest in their parent on its thread, one after another)."""
    records = spans() if records is None else records
    ids = {s.id for s in records if s.name == name}
    children = sum(s.end_ns - s.start_ns for s in records if s.parent in ids)
    return total_ns(name, records) - children
