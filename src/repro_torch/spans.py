"""Spans of the WSI tile path and of the region-template runtime and stores,
recorded only while a torch profiler records.

An operator who profiles the program (``torch.profiler.profile``) reads the
program's own spans afterwards with :func:`records`: which step of a tile
took the host's time, how often the host waited for the card, and the
card's time between a span's two CUDA events. With no profiler running,
:func:`span` and :func:`sync` return one shared no-op context after a single
check of the profiler's process-wide flag, and no CUDA event is made.

A record holds the span's name, its start and end in nanoseconds on the
profiler's clock, its parent (the innermost span open on the thread when it
opened) and its root (the outermost one; every span of one tile shares the
root of ``wsi.analyze_tile``). Work handed to another thread nests under
the span open where it was handed over: :func:`current` takes that span and
:func:`within` opens the other thread's spans under it, as the runtime's
WRM threads do for the tasks of a stage. :func:`record` keeps a span whose
start was taken elsewhere, such as a stage's wait from the moment it became
ready, on one thread, to the moment another thread started it.

The profiler's clock is the epoch clock (``time.time_ns()``): an event of
``prof.events()`` starts at
``prof.profiler.kineto_results.trace_start_ns() + 1000 * e.time_range.start``
nanoseconds, on torch 2.13 (CPU) and on 2.11 with CUDA 12.8 (H100), so the
program's spans and the profiler's events lie on one time line. A span
given a CUDA device also records a pair of timing events on that device's
current stream, at its opening and its closing; :func:`records` resolves
them into ``device_ms``, waiting for the second event of each.

The spans stay in memory: a span is never a ``record_function`` range,
which the profiler would draw again on the device's timeline as if it were
work there. Records are kept in a bounded buffer (the oldest go first
beyond ``CAPACITY``) until :func:`reset`. While the profiler records CUDA
activity, a span costs about 3 us of host time, and about 60 us with its
CUDA events (H100, torch 2.11).

The switch is ``torch.autograd.profiler._is_profiler_enabled``, which torch
sets while any profiler of the process runs. ``torch.autograd._profiler_enabled()``
reads the profiler's state of the calling thread only, and reads False on
the region-template runtime's worker threads even under
``profile_all_threads``.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 18  # records kept: 17 spans a 4096^2 tile on the card, so some 15,000 tiles


class Span(NamedTuple):
    id: int
    parent: int | None
    root: int
    name: str
    start_ns: int
    end_ns: int
    device_ms: float | None  # between the span's two CUDA events; None without a device


_OFF = contextlib.nullcontext()
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_closed: collections.deque = collections.deque(maxlen=CAPACITY)


class _Open:
    """One span while it is open; its record once closed."""

    __slots__ = ("name", "device", "id", "parent", "root", "start_ns", "end_ns", "events")

    def __init__(self, name: str, device: torch.device | None) -> None:
        self.name, self.device, self.events = name, device, None

    def __enter__(self) -> _Open:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer else None
        self.root = outer.root if outer else self.id
        self.start_ns = time.time_ns()
        if self.device is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
            self.events = (start, None)
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        if self.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            self.events = (self.events[0], end)
        self.end_ns = time.time_ns()
        _local.stack.pop()
        with _lock:
            _closed.append(self)


def enabled() -> bool:
    """Whether spans record now: a profiler of the process runs."""
    return _profiler._is_profiler_enabled


def span(name: str, device: torch.device | None = None):
    """A context that records the span ``name`` while a profiler records;
    with CUDA timing events on ``device``'s current stream where ``device``
    is a CUDA device."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, device if device is not None and device.type == "cuda" else None)


def sync(site: str, device: torch.device):
    """The span ``sync.<site>`` around a step where the host waits for the
    card: recorded only where ``device`` is a CUDA device and a profiler
    records."""
    if not _profiler._is_profiler_enabled or device.type != "cuda":
        return _OFF
    return _Open("sync." + site, None)


def record(name: str, start_ns: int, end_ns: int) -> None:
    """Keep the closed span ``name`` from ``start_ns`` to ``end_ns`` (epoch
    nanoseconds, from ``time.time_ns()`` on any thread), under the innermost
    span open on the calling thread; only while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    rec = _Open(name, None)
    stack = getattr(_local, "stack", None)
    outer = stack[-1] if stack else None
    rec.id = next(_ids)
    rec.parent = outer.id if outer else None
    rec.root = outer.root if outer else rec.id
    rec.start_ns, rec.end_ns = int(start_ns), int(end_ns)
    with _lock:
        _closed.append(rec)


def current():
    """The innermost span open on the calling thread, for :func:`within` on
    another thread; None with none open or no profiler recording."""
    if not _profiler._is_profiler_enabled:
        return None
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


class _Within:
    """Spans opened on this thread while it is entered nest under ``outer``."""

    __slots__ = ("outer",)

    def __init__(self, outer: _Open) -> None:
        self.outer = outer

    def __enter__(self) -> None:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self.outer)

    def __exit__(self, *exc) -> None:
        _local.stack.pop()


def within(outer):
    """A context in which the calling thread's spans nest under ``outer``, a
    span that :func:`current` took on another thread (a no-op for None)."""
    if outer is None:
        return _OFF
    return _Within(outer)


def _device_ms(events) -> float | None:
    if events is None:
        return None
    start, end = events
    end.synchronize()
    return start.elapsed_time(end)


def records() -> list[Span]:
    """The closed spans, oldest first (a span closes after its children)."""
    with _lock:
        closed = list(_closed)
    return [Span(s.id, s.parent, s.root, s.name, s.start_ns, s.end_ns, _device_ms(s.events))
            for s in closed]


def reset() -> None:
    """Forget every closed span."""
    with _lock:
        _closed.clear()
