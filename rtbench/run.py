"""Run one cell of the benchmark once and print its result line.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It exits with code 2, printing no result, where
CUDA is not available or the card count is below the cell's; with code 3 if
a module of JAX or of the JAX package is loaded once the window has closed.
Each number that decides ``correct`` is printed beside its limit, as the
last lines of standard error and as the last key of the result line.
"""
from __future__ import annotations

import os
import sys
import time

T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (from /proc; 0 where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE0 = _process_age()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)  # this folder's modules would shadow the standard library's
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
# every build and kernel cache of the program inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from rtbench import harness

    chips = harness.find(harness.load_manifest(), "workloads", args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rtbench: the cell needs {chips} CUDA card(s); "
              f"this process sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  setup_clock=lambda: AGE0 + time.perf_counter() - T0)
    except SystemExit as stop:
        print(stop, file=sys.stderr)
        return 3
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in result["setup_phases"].items()),
          file=sys.stderr)
    for err in result["errors"]:
        print(f"rtbench: a unit failed: {err}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
