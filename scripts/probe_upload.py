"""Which side of a pinned upload (``repro_torch.staging``) sets its pace,
on the card, for the 201 MB float32 RGB of a 4096^2 tile.

    PYTHONPATH=src python scripts/probe_upload.py [--reps 20]

Prints one JSON line with the card and its power limit, then one a
measurement, each a median over ``--reps`` runs after one warm-up:

  * ``pageable_ms``: ``torch.as_tensor(x, device="cuda")``, the CUDA driver's
    pageable path;
  * ``staged_ms``: ``staging.upload(x, "cuda")``, pinned memory first;
  * ``memcpy_GBps``: the host's copy of the array into pinned memory
    (``Tensor.pin_memory``, a block from torch's caching host allocator), at
    ``torch.get_num_threads()`` threads and at one;
  * ``dma_GBps``: the pinned array to the card, asynchronous, timed with
    CUDA events.

The staged time is about the memcpy's plus the DMA's. The source is
resident, as the benchmark's tile pool is.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import staging  # noqa: E402


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def host_ms(fn, reps: int) -> float:
    """Median host ms of ``fn()`` with the card idle before and done after."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def sources(dev, count: int) -> dict[str, list[np.ndarray]]:
    """``count`` distinct 201 MB float32 arrays of each kind: drawn by NumPy
    on the host (``rng``), and made on the card and copied back with
    ``.cpu().numpy()`` (``from_card``), as the benchmark's tile pool is."""
    g = np.random.default_rng(2**31 + 28)
    shape = (3, 4096, 4096)
    return {"rng": [g.random(shape, np.float32) for _ in range(count)],
            "from_card": [torch.rand(shape, device=dev).cpu().numpy() for _ in range(count)]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--pool", type=int, default=8)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    pools = sources(dev, args.pool)
    nbytes = pools["rng"][0].nbytes
    gb = nbytes / 1e9
    print(json.dumps({"card": card(), "torch": torch.__version__, "cuda": torch.version.cuda,
                      "threads": torch.get_num_threads(), "bytes": nbytes, "pool": args.pool}),
          flush=True)
    threads = torch.get_num_threads()
    same = True
    for name, pool in pools.items():
        turn = itertools.cycle(pool)
        pageable = host_ms(lambda: torch.as_tensor(next(turn), device=dev), args.reps)
        staged = host_ms(lambda: staging.upload(next(turn), dev), args.reps)
        x = pool[0]
        got = staging.upload(x, dev)
        same &= bool(torch.equal(got.view(torch.int32),
                                 torch.as_tensor(x, device=dev).view(torch.int32)))
        print(json.dumps({"source": name, "pageable_ms": pageable,
                          "pageable_GBps": gb / pageable * 1e3, "staged_ms": staged,
                          "staged_GBps": gb / staged * 1e3, "equal": same}), flush=True)

        def fill() -> None:
            torch.from_numpy(next(turn)).pin_memory()

        for n in (threads, 1):
            torch.set_num_threads(n)
            ms = host_ms(fill, args.reps)
            print(json.dumps({"source": name, "memcpy_GBps": gb / ms * 1e3, "threads": n,
                              "ms": ms}), flush=True)
        torch.set_num_threads(threads)

    pinned = torch.from_numpy(pools["rng"][0]).pin_memory()
    dst = torch.empty_like(pinned, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def dma() -> float:
        start.record()
        dst.copy_(pinned, non_blocking=True)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    dma()
    ms = statistics.median(dma() for _ in range(args.reps))
    print(json.dumps({"dma_GBps": gb / ms * 1e3, "ms": ms}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
