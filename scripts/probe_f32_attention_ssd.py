"""Times the float32 CUDA-core attention and the bf16 SSD scan at the served
paths' shapes, for comparing two trees of the port in one call.

Attention, float32, causal (rows 5d, 5i and the float32 D = 128 and D = 64
lines of ``PERF.md`` §6): the kernel, ``scaled_dot_product_attention`` on the
same inputs, the plain version's error and the bound. The SSD scan, bf16
(rows 6 and 6b): the call and the device time of each of its three phases
(``chip_smoke.device_ms``), the error against the plain recurrence at
mamba2-2.7b's shape. Prints the card's name and power limit, then one JSON
line a row, each tagged with ``--label``.

    python3 scripts/probe_f32_attention_ssd.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory of the tree to time (default this
tree's), so a parent unpacked under ``build/`` is timed by the same script.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (device_ms, lm_bound)

# (name, Hq, Hkv, D) at batch 2 x 2048 tokens, causal
ATTENTION = (("gemma", 8, 1, 256), ("mla", 16, 16, 192), ("qwen3", 16, 8, 128),
             ("hymba", 25, 5, 64))
# (name, H, P, G, N, chunk) at batch 2 x 2048 tokens
SSD = (("hymba", 50, 64, 1, 16, 128), ("mamba2", 80, 64, 1, 128, 128))
B, T = 2, 2048


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ssd_scan as ssd_mod

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    _build.lib()
    dev = torch.device("cuda")

    def time_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return float(np.median(times))

    gen = torch.Generator(device=dev).manual_seed(0)
    pairs = T * (T + 1) // 2
    for name, hq, hkv, d in ATTENTION:
        q = torch.randn((B, hq, T, d), generator=gen, device=dev)
        k, v = (torch.randn((B, hkv, T, d), generator=gen, device=dev) for _ in range(2))
        got = ops.attention(q, k, v, impl="cuda")
        err = (got - ops.attention(q, k, v, impl="torch")).abs().max().item()
        lib = partial(F.scaled_dot_product_attention, q, k, v, is_causal=True, enable_gqa=True)
        print(json.dumps({
            "label": args.label, "row": f"flash_attention:f32:{name}", "shape": [B, hq, hkv, T, d],
            "ms": time_ms(partial(ops.attention, q, k, v, impl="cuda"), args.reps),
            "library_ms": time_ms(lib, args.reps), "max_abs_err": err,
            "bound_ms": chip_smoke.lm_bound(4 * (2 * q.numel() + k.numel() + v.numel()),
                                            4 * d * pairs * B * hq, torch.float32)[0]}),
              flush=True)
        del q, k, v, got
    for name, h, p, g, n, chunk in SSD:
        x = torch.randn((B, T, h, p), generator=gen, device=dev).to(torch.bfloat16)
        dt = torch.rand((B, T, h), generator=gen, device=dev) * 0.1
        a = -torch.exp(torch.randn((h,), generator=gen, device=dev))
        bm, cm = (torch.randn((B, T, g, n), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        dsk = torch.randn((h,), generator=gen, device=dev)
        args_ = (x, dt, a, bm, cm, dsk)
        y, hf = ops.ssd_scan(*args_, impl="cuda", chunk=chunk)
        yr, hr = ops.ssd_scan(*args_, impl="torch")
        print(json.dumps({
            "label": args.label, "row": f"ssd_scan:bf16:{name}", "shape": [B, T, h, p, g, n],
            "instance": ssd_mod.instance(torch.bfloat16, n, p),
            "ms": time_ms(partial(ops.ssd_scan, *args_, impl="cuda", chunk=chunk), args.reps),
            "phase_ms": chip_smoke.device_ms(torch, lambda ev: ssd_mod.ssd_scan_cuda(
                *args_, chunk=chunk, events=ev), ssd_mod.PHASES, args.reps),
            "y_max_abs_err": (y.float() - yr.float()).abs().max().item(),
            "state_max_abs_err": (hf - hr).abs().max().item()}), flush=True)
        del x, dt, a, bm, cm, dsk, args_, y, hf, yr, hr
    return 0


if __name__ == "__main__":
    sys.exit(main())
