"""The WSI tile path's spans on the card (``repro_torch.spans``): the
profiler's clock, and each host-device synchronisation of a tile, span by
span, against the ones ``torch.cuda.set_sync_debug_mode("warn")`` reports
and the pinned uploads of ``repro_torch.staging``, whose waits on
CUDA events the debug mode does not report.

    PYTHONPATH=src python scripts/probe_tile_spans.py [--size 4096] [--tiles 4]

Tiles come from the benchmark's generator (``rtbench/tiles.py``) and reach
``analyze_tile`` as host arrays, as a user's do. The first tile builds the
kernels and warms every shape. Then, for each later tile: its spans by name,
with the host ms of each kind, the device ms of ``wsi.segment_tile`` and
``wsi.extract_object_rois``, the synchronisations that torch reported by
source line, the staged uploads, and whether the counts agree. The clock
line holds the offsets between a ``record_function`` range around a tile and the tile's
root span, in microseconds. The cost line holds what the spans cost while
the profiler records: microseconds a span (with and without CUDA events)
over many empty spans, a few hundred open at a time as in a traced window,
and the median host ms of a tile whose RGB is already on the card (so that
the upload's spread leaves the comparison) with the spans on and
switched off, in turns, under one profiler. Prints one JSON line a tile,
a clock line, a cost line and a last line ``{"ok": ...}``; exits 1 where a
count or the clock disagrees.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import linecache
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

from repro_torch import spans, staging  # noqa: E402
from repro_torch.configs.wsi import WSIConfig  # noqa: E402
from repro_torch.pipeline import analyze_tile  # noqa: E402
from rtbench import tiles  # noqa: E402
from rtbench.program_spans import is_sync  # noqa: E402


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


SYNC_WARNING = "called a synchronizing CUDA operation"
ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def one_tile(rgb, cfg) -> dict:
    """One tile under the profiler and the sync debug mode."""
    spans.reset()
    staging.reset_stats()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                analyze_tile(rgb, cfg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    recs = spans.records()
    kinds: dict[str, dict] = {}
    for r in recs:
        k = kinds.setdefault(r.name, {"n": 0, "host_ms": 0.0})
        k["n"] += 1
        k["host_ms"] += 1e-6 * (r.end_ns - r.start_ns)
        if r.device_ms is not None:
            k["device_ms"] = k.get("device_ms", 0.0) + r.device_ms
    lines: dict[str, dict] = {}
    for w in caught:
        if SYNC_WARNING not in str(w.message):
            continue
        where = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
        entry = lines.setdefault(where, {"n": 0, "code": linecache.getline(w.filename,
                                                                            w.lineno).strip()})
        entry["n"] += 1
    syncs = sum(k["n"] for name, k in kinds.items() if is_sync(name))
    reported = sum(v["n"] for v in lines.values())
    staged = staging.stats()["staged_uploads"]
    return {"spans": kinds, "host_syncs": syncs, "reported": reported,
            "reported_by_line": lines, "staged_uploads": staged,
            "agree": syncs == reported + staged}


def clock(rgb, cfg) -> dict:
    """The root span of a tile against a profiler range around it."""
    spans.reset()
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        with torch.autograd.profiler.record_function("probe.warm"):
            pass
        with torch.autograd.profiler.record_function("probe.tile"):
            analyze_tile(rgb, cfg)
        torch.cuda.synchronize()
    (root,) = [r for r in spans.records() if r.name == "wsi.analyze_tile"]
    probe = next(e for e in prof.events() if e.name == "probe.tile"
                 and e.device_type == torch.autograd.DeviceType.CPU)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    named = {r.name for r in spans.records()}
    return {"start_us": (root.start_ns - (t0 + 1000 * probe.time_range.start)) / 1e3,
            "end_us": (t0 + 1000 * probe.time_range.end - root.end_ns) / 1e3,
            "program_spans_in_trace": sorted({e.name for e in prof.events()
                                              if e.name in named})}


def cost(pool, cfg, dev, tiles: int, reps: int = 10_000, live: int = 500) -> dict:
    """The spans' cost while the profiler records."""
    on = (spans.span, spans.sync)
    times: dict[str, list[float]] = {"on": [], "off": []}
    on_card = [torch.as_tensor(rgb, device=dev) for rgb in pool]
    with torch.profiler.profile(activities=ACTIVITIES):
        per_span = {}
        for kind, make in (("events_us", lambda: spans.span("probe.events", dev)),
                           ("host_us", lambda: spans.sync("probe", dev))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k in range(reps):
                with make():
                    pass
                if k % live == live - 1:
                    spans.reset()
            per_span[kind] = 1e6 * (time.perf_counter() - t0) / reps
        spans.reset()
        try:
            for i in range(tiles):
                for mode in ("on", "off") if i % 2 == 0 else ("off", "on"):
                    if mode == "on":
                        spans.span, spans.sync = on
                    else:
                        spans.span = spans.sync = lambda *a, **k: contextlib.nullcontext()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    analyze_tile(on_card[i % len(on_card)], cfg)
                    torch.cuda.synchronize()
                    times[mode].append(1e3 * (time.perf_counter() - t0))
        finally:
            spans.span, spans.sync = on
    spans.reset()
    med = {k: statistics.median(v) for k, v in times.items()}
    return {**per_span, "tile_ms_on": med["on"], "tile_ms_off": med["off"],
            "tiles_each": tiles, "on_minus_off_ms": med["on"] - med["off"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--tiles", type=int, default=4)
    ap.add_argument("--seed", type=int, default=2**31 + 5)
    ap.add_argument("--cost-tiles", type=int, default=100)
    args = ap.parse_args()
    dev = torch.device("cuda")
    cfg = WSIConfig(tile=args.size)
    pool = [tiles.make_tile(tiles.tile_seed(args.seed, i), args.size, dev).cpu().numpy()
            for i in range(args.tiles)]
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda, "card": card(),
                      "flag": hasattr(torch.autograd.profiler, "_is_profiler_enabled")}),
          flush=True)
    analyze_tile(pool[0], cfg)  # builds the kernels, warms the shapes
    torch.cuda.synchronize()
    ok = True
    for i, rgb in enumerate(pool[1:], 1):
        got = one_tile(rgb, cfg)
        ok &= got["agree"]
        print(json.dumps({"tile": i, **got}), flush=True)
    c = clock(pool[-1], cfg)
    ok &= abs(c["start_us"]) < 1000 and abs(c["end_us"]) < 1000
    ok &= not c["program_spans_in_trace"]
    print(json.dumps({"clock": c}), flush=True)
    print(json.dumps({"cost": cost(pool, cfg, dev, args.cost_tiles)}), flush=True)
    print(json.dumps({"ok": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
