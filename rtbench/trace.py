"""The benchmark's own spans and the reduction of a profiler trace.

Spans are installed only in a ``--trace 1`` run, as wrappers around module
functions and store methods of the program, which is never edited. Each
span is timed on the host clock and, while the profiler runs, also opens a
``record_function`` range, which the trace draws again on the device's
timeline around the work the span launched.
"""
from __future__ import annotations

import bisect
import functools
import heapq
import importlib.util
import re
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch

PREFIX = "rtbench."
OP_PREFIX = PREFIX + "op."
COUNTS_DIR = Path(__file__).resolve().parent / "counts"


def _count_modules() -> dict:
    out = {}
    for path in sorted(COUNTS_DIR.glob("*.py")):
        if path.stem.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(f"rtbench_counts_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def load_counts() -> dict:
    """{op name: count(args, kwargs) -> (operations, bytes)}, one file an op."""
    return {op: mod.count for op, mod in _count_modules().items()}


def op_kernels() -> dict:
    """{op name: the names of the program's own kernels that the op launches}."""
    return {op: tuple(mod.KERNELS) for op, mod in _count_modules().items()}


class Tracer:
    """Host spans and counters of one traced run."""

    def __init__(self, peaks: dict, sync=None) -> None:
        self.peaks = peaks
        self.sync = sync or (lambda: None)
        self.spans: dict[str, list[float]] = defaultdict(list)  # name -> seconds each
        self.counters: dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._undo: list = []

    def bound_s(self, ops: float, nbytes: float) -> float:
        """The least time the card takes: the larger of the two roofs."""
        return max(ops / self.peaks["float32_ops_per_s"], nbytes / self.peaks["hbm_bytes_per_s"])

    def add(self, name: str, value: float) -> None:
        with self._lock:
            self.counters[name] += value

    def _record(self, name: str, seconds: float) -> None:
        with self._lock:
            self.spans[name].append(seconds)

    def wrap(self, owner, attr: str, name: str, *, sync: bool = False, count=None) -> None:
        """Replace ``owner.attr`` by a timed span named ``name`` until
        :meth:`remove`. ``sync`` closes the span on a device synchronise (and
        opens it on one); ``count(args, kwargs)`` adds the call's
        (operations, bytes) bound to ``bound_s.<name>`` when the span is the
        outermost counted one on its thread."""
        fn = getattr(owner, attr)
        tracer = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            depth = getattr(tracer._local, "depth", 0)
            outer = count is not None and depth == 0
            if outer:
                ops, nbytes = count(args, kwargs)
                tracer.add(f"bound_s.{name}", tracer.bound_s(ops, nbytes))
                tracer.add(f"calls.{name}", 1)
                tracer._local.depth = 1
            try:
                if sync:
                    tracer.sync()
                t0 = time.perf_counter()
                with torch.autograd.profiler.record_function(PREFIX + name):
                    out = fn(*args, **kwargs)
                    if sync:
                        tracer.sync()
                tracer._record(name, time.perf_counter() - t0)
                return out
            finally:
                if outer:
                    tracer._local.depth = 0

        had = attr in getattr(owner, "__dict__", {})
        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, fn, had))

    def wrap_ops(self, ops_module) -> None:
        """Spans around the kernel wrappers that ``counts/`` holds a count for."""
        for op, count in load_counts().items():
            if hasattr(ops_module, op):
                self.wrap(ops_module, op, "op." + op, count=count)

    def remove(self) -> None:
        for owner, attr, fn, had in reversed(self._undo):
            if had:
                setattr(owner, attr, fn)
            else:
                delattr(owner, attr)  # the class's method shows again
        self._undo.clear()


# ---------------------------------------------------------------------------
# Profiler trace -> summary
# ---------------------------------------------------------------------------
def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clipped(intervals: list[tuple[float, float]], starts: list[float], a: float,
             b: float) -> float:
    """Length of the merged ``intervals`` that lies inside [a, b]."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    while i < len(intervals) and intervals[i][0] < b:
        total += max(0.0, min(b, intervals[i][1]) - max(a, intervals[i][0]))
        i += 1
    return total


def _inside(intervals: list[tuple[float, float]], starts: list[float], t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= intervals[i][1]


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def summarize(events, kernels_of: dict | None = None) -> dict:
    """Reduce ``prof.events()`` to what the readers take.

    Returns busy_s (union of device kernels, copies and sets), device_s by
    name, copy_s by direction ("HtoD", "DtoH", "DtoD"), op_device_s, the
    traced window's length and the idle gaps by the innermost host span
    around them.

    An op's device time is the time of the kernels that the op launched,
    merged: the kernels that lie inside the device-side range of one of its
    ``op.*`` spans (the profiler draws a span that launched device work again
    on the device's timeline) and were launched from inside one of its host
    spans, by the launch call that the trace links to the kernel, or, for a
    kernel linked to no launch, bear the name of one of the op's own kernels
    (``kernels_of``, from ``counts/``). Copies and sets never count to an op,
    nor does a kernel launched outside the op's host spans. A kernel that
    another host thread launches while the op's span is open would count, so
    a metric that reads ``op_device_s`` lists only cells whose ops run on one
    host thread.
    """
    from torch.autograd import DeviceType

    kernels_of = op_kernels() if kernels_of is None else kernels_of
    device = []
    annotations: dict[str, list] = defaultdict(list)
    named_spans: list[tuple[float, float, str]] = []
    launches: dict[int, float] = {}  # correlation id -> host time of the launch call
    for e in events:
        name = e.name
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if name.startswith(OP_PREFIX):
                annotations[name[len(OP_PREFIX):]].append((start, end))
            elif not name.startswith(PREFIX):
                device.append((start, end, name, e.id))
        elif e.device_type == DeviceType.CPU:
            if name.startswith(PREFIX):
                named_spans.append((start, end, name[len(PREFIX):]))
            elif name.startswith("cu") and "Launch" in name:  # cudaLaunchKernel, cuLaunchKernel...
                launches[e.id] = start
    intervals = _merge([(a, b) for a, b, _, _ in device])
    starts = [a for a, _ in intervals]
    window_us = next(((a, b) for a, b, span in named_spans if span == "window"), None)
    if window_us is None and intervals:
        window_us = (intervals[0][0], intervals[-1][1])
    busy_us = _clipped(intervals, starts, *window_us) if window_us else 0.0
    device_s: dict[str, float] = defaultdict(float)
    copy_s: dict[str, float] = defaultdict(float)
    for a, b, name, _ in device:
        device_s[name] += (b - a) * 1e-6
        if name.startswith("Memcpy"):
            copy_s[name.split()[1]] += (b - a) * 1e-6
    op_device_s, attributed = _op_device_s(device, annotations, named_spans, launches,
                                           kernels_of)
    gaps: dict[str, float] = defaultdict(float)
    if window_us is not None:
        edges = [window_us[0]] + [x for ab in intervals for x in ab] + [window_us[1]]
        # op spans launch the device's work; the gaps are what the host did around them
        spans = sorted(s for s in named_spans if not s[2].startswith("op."))
        active: list = []  # heap of (end, start, name) of spans open at the sweep
        nxt = 0
        for k in range(0, len(edges), 2):
            a, b = edges[k], edges[k + 1]
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            while nxt < len(spans) and spans[nxt][0] <= mid:
                heapq.heappush(active, (spans[nxt][1], spans[nxt][0], spans[nxt][2]))
                nxt += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            what = min(active, key=lambda s: s[0] - s[1])[2] if active else "no span"
            gaps[what] += (b - a) * 1e-6
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (window_us[1] - window_us[0]) * 1e-6 if window_us else 0.0,
        "device_s": dict(device_s),
        "copy_s": dict(copy_s),
        "op_device_s": dict(op_device_s),
        "idle_gaps": dict(gaps),
        "stats": {"device_events": len(device),
                  "op_ranges": sum(len(v) for v in annotations.values()), **attributed},
    }


def _op_device_s(device, annotations, named_spans, launches, kernels_of):
    """({op: seconds of its kernels, merged}, counts of the kernels inside op
    ranges by how they were placed: by their launch, by their name, or left
    out)."""
    kernels = sorted((a, b, name, cid) for a, b, name, cid in device if _is_kernel(name))
    kstarts = [k[0] for k in kernels]
    host: dict[str, list] = defaultdict(list)
    for a, b, span in named_spans:
        if span.startswith("op."):
            host[span[3:]].append((a, b))
    tally = {"op_kernels_by_launch": 0, "op_kernels_by_name": 0, "op_kernels_left_out": 0}
    out = {}
    for op, ranges in annotations.items():
        spans = _merge(host.get(op, []))
        span_starts = [a for a, _ in spans]
        names = kernels_of.get(op, ())
        mine = []
        for lo, hi in _merge(ranges):
            i = bisect.bisect_left(kstarts, lo)
            while i < len(kernels) and kernels[i][0] < hi:
                a, b, name, cid = kernels[i]
                i += 1
                t = launches.get(cid)
                if t is not None:
                    ok, how = _inside(spans, span_starts, t), "op_kernels_by_launch"
                else:
                    ok = any(re.search(rf"\b{k}\b", name) for k in names)
                    how = "op_kernels_by_name"
                tally[how if ok else "op_kernels_left_out"] += 1
                if ok:
                    mine.append((a, b))
        out[op] = sum(b - a for a, b in _merge(mine)) * 1e-6
    return out, tally


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def roofline_share(run, ops) -> float | None:
    """The summed work bound of ``ops`` over the device time of the kernels
    they launched, in %; None where the run traced none of them."""
    if run.trace is None:
        return None
    bound = sum(run.tracer_counters.get(f"bound_s.op.{op}", 0.0) for op in ops)
    busy = sum(run.trace["op_device_s"].get(op, 0.0) for op in ops)
    if bound <= 0 or busy <= 0:
        return None
    return 100.0 * bound / busy


def idle_share(run) -> float | None:
    """The share of the traced window with no kernel, copy or set on the
    card, in %."""
    t = run.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
