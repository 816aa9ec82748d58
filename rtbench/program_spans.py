"""The program's own spans of a traced run (``repro_torch.spans``), for the
readers of ``metrics/``.

The program records spans only while the profiler runs, which in a run is
the traced window. The first read of a run takes the program's records and
clears them, so records of two runs in one process never mix. A program
without the span recorder, an untraced run and a run that recorded nothing
read as no records, and each reader then returns None.
"""
from __future__ import annotations

KEY = "program_spans"


def records(run) -> list:
    """The program's span records of ``run``, taken on its first read."""
    if KEY not in vars(run):
        try:
            from repro_torch import spans
        except ImportError:  # a program older than its span recorder
            vars(run)[KEY] = []
        else:
            vars(run)[KEY] = spans.records()
            spans.reset()
    return vars(run)[KEY]


def is_sync(name: str) -> bool:
    """A span around a step where the host waits for the card."""
    return name == "wsi.upload" or name.startswith("sync.")


def per_unit(run, values) -> float | None:
    """The sum of ``values`` over the run's completed units; None where the
    program recorded nothing or no unit completed."""
    if not records(run) or not run.tally.completed:
        return None
    return sum(values) / run.tally.completed


def host_ms(run, keep) -> list[float]:
    """Host milliseconds of each span whose name ``keep`` takes."""
    return [1e-6 * (r.end_ns - r.start_ns) for r in records(run) if keep(r.name)]


def device_ms_a_call(run, name: str) -> float | None:
    """Mean device ms between the CUDA events of the spans ``name``; None
    where none has events (no card, or nothing recorded)."""
    ms = [r.device_ms for r in records(run) if r.name == name and r.device_ms is not None]
    return sum(ms) / len(ms) if ms else None
