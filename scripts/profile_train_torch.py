#!/usr/bin/env python3
"""Where the port's training step spends its time on the CUDA card, and how
its loss moves at a few learning rates.

    PYTHONPATH=src python scripts/profile_train_torch.py [--arch qwen3-0.6b] [--batch 2]
        [--seq 2048] [--steps 20] [--lrs 3e-3,1e-3,3e-4,1e-4] [--profile-steps 2] [--seed 0]

Builds ``--arch`` at full width and depth in bf16 (random weights from the
seed), as ``launch.train`` does: the plain attention (``attn_impl="torch"``),
``cfg.remat``, AdamW with the cosine schedule (10 warmup steps) over
``--steps``, synthetic tokens. For each learning rate of ``--lrs`` it trains
``--steps`` steps from the same weights and prints one JSON line with the
losses and step times (host clock around a step that ends in reading its
loss). Then, at the last learning rate, it warms up two steps and traces
``--profile-steps`` steps with ``torch.profiler``: one JSON line with the
wall time, the device's busy time and idle share, the device time by kernel
group and the kernels taking the most device time. Needs one CUDA card;
imports nothing of JAX.
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
    ("matmul_library", ("nvjet", "gemm", "cutlass", "cublas", "sm90_xmma")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce_kernel",)),
    ("index_scatter_gather", ("index", "scatter", "gather")),
    ("elementwise", ("elementwise", "vectorized")),
    ("copy", ("copy", "cat", "Memcpy", "Memset")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def device_summary(prof, wall_s: float, top: int = 12) -> dict:
    from torch.autograd import DeviceType

    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        rec = by_name[evt.name]
        rec[0] += evt.time_range.elapsed_us() / 1e3
        rec[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    by_group: dict[str, float] = defaultdict(float)
    for name, (ms, _) in by_name.items():
        by_group[group_of(name)] += ms
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "wall_ms": wall_s * 1e3,
        "device_busy_ms": busy_ms if by_name else None,
        "device_idle_share": (1.0 - busy_ms / (wall_s * 1e3)) if by_name else None,
        "device_events": sum(n for _, n in by_name.values()),
        "group_ms": {g: by_group.get(g, 0.0) for g in (*(g for g, _ in GROUPS), "other")},
        "top_kernels": [{"name": name[:90], "ms": ms, "count": n} for name, (ms, n) in ranked],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lrs", default="3e-3,1e-3,3e-4,1e-4")
    ap.add_argument("--profile-steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.train import AdamW, AdamWConfig, cosine_lr, init_state, make_train_step

    if not torch.cuda.is_available():
        sys.exit("profile_train_torch: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    cfg = get_config(args.arch).replace(attn_impl="torch")
    dev = torch.device("cuda")
    data = SyntheticTokens(cfg.vocab, args.seq, args.batch, seed=args.seed)

    def batch(i: int) -> dict:
        return {k: torch.as_tensor(v, device=dev) for k, v in data.batch_at(i).items()}

    def trainer(lr: float):
        optim = AdamW(AdamWConfig(lr=lr))
        sched = lambda s: cosine_lr(s, base=lr, warmup=10, total=args.steps)  # noqa: E731
        return init_state(cfg, optim, seed=args.seed, device=dev), make_train_step(
            cfg, optim, lr_schedule=sched)

    lrs = [float(x) for x in args.lrs.split(",")]
    for lr in lrs:
        state, step = trainer(lr)
        losses, ms = [], []
        for i in range(args.steps):
            t0 = time.perf_counter()
            state, metrics = step(state, batch(i))
            losses.append(float(metrics["loss"]))
            ms.append(1e3 * (time.perf_counter() - t0))
        print(json.dumps({"arch": cfg.name, "lr": lr, "tokens_per_step": args.batch * args.seq,
                          "losses": losses, "step_ms": ms}), flush=True)
        del state, step
        torch.cuda.empty_cache()

    state, step = trainer(lrs[-1])
    for i in range(2):  # warm-up
        state, metrics = step(state, batch(i))
    float(metrics["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.profile_steps):
            state, metrics = step(state, batch(2 + i))
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(json.dumps({"phase": "train_step", "arch": cfg.name, "remat": cfg.remat,
                      "batch": args.batch, "seq": args.seq, "steps": args.profile_steps,
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      **device_summary(prof, wall)}), flush=True)


if __name__ == "__main__":
    main()
