#!/usr/bin/env python3
"""Where the port's LM path spends its time on the CUDA card.

    PYTHONPATH=src python scripts/profile_lm_torch.py [--batch 2] [--prompt-len 2048]
                                                      [--decode-steps 8] [--seed 0]

Builds hymba-1.5b at full width and depth in bf16 (random weights from the
seed), warms it up with one prefill and two decode steps, then traces one
prefill and ``--decode-steps`` greedy decode steps with ``torch.profiler``.
For each phase it prints, as one JSON line: the host wall time around work
that ends in a device synchronisation, the summed duration of the device's
kernels and copies, the share of the wall time with none of them running
(one stream: device events do not overlap), the number of device events,
the device time by kernel group (the SSD scan's three phases, attention,
the library's matrix products, the rest) and the kernels taking the most
device time. Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


# Kernel groups by a substring of the kernel's name, first match wins.
GROUPS = (
    ("ssd_chunk_state", ("ssd_chunk_state",)),
    ("ssd_state_passing", ("ssd_state_passing",)),
    ("ssd_chunk_scan", ("ssd_chunk_scan",)),
    ("flash_attention", ("flash_attention",)),
    ("matmul_library", ("nvjet", "gemm", "cutlass", "cublas")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def device_summary(prof, wall_s: float, top: int = 8) -> dict:
    """Device events of a trace: busy time, idle share, time by kernel group,
    top kernels by time."""
    from torch.autograd import DeviceType

    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        rec = by_name[evt.name]
        rec[0] += evt.time_range.elapsed_us() / 1e3
        rec[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    by_group: dict[str, float] = defaultdict(float)
    for name, (ms, _) in by_name.items():
        by_group[group_of(name)] += ms
    return {
        "wall_ms": wall_s * 1e3,
        "device_busy_ms": busy_ms if by_name else None,
        "device_idle_share": (1.0 - busy_ms / (wall_s * 1e3)) if by_name else None,
        "device_events": sum(n for _, n in by_name.values()),
        "group_ms": {g: by_group.get(g, 0.0) for g in (*(g for g, _ in GROUPS), "other")},
        "top_kernels": [{"name": name[:90], "ms": ms, "count": n}
                        for name, (ms, n) in ranked],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import HybridLM
    from repro_torch.serve import make_cache, make_decode_step, make_prefill_step

    if not torch.cuda.is_available():
        sys.exit("profile_lm_torch: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    cfg = get_config("hymba-1.5b")
    dev = torch.device("cuda")
    model = HybridLM(cfg, device=dev, seed=args.seed)
    b, s = args.batch, args.prompt_len
    prompt = torch.as_tensor(np.random.default_rng(args.seed).integers(0, cfg.vocab, (b, s)),
                             dtype=torch.int32, device=dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    max_len = s + args.decode_steps + 3

    def run_prefill():
        return prefill(model, {"tokens": prompt}, make_cache(cfg, b, max_len, device=dev))

    def run_decode(cache, first, steps):
        tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        for i in range(steps):
            logits, cache = decode(model, tok, cache, first + i)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        return cache

    with torch.no_grad():
        _, cache = run_prefill()  # warm-up: library handles, first launches
        run_decode(cache, s, 2)
        for phase in ("prefill", "decode"):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if phase == "prefill":
                    _, cache = run_prefill()
                else:
                    run_decode(cache, s, args.decode_steps)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            out = {"phase": phase, "batch": b, "prompt_len": s,
                   "steps": 1 if phase == "prefill" else args.decode_steps,
                   **device_summary(prof, wall)}
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
