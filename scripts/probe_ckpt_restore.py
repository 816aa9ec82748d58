"""Time checkpoint restores through ``DiskStorage`` and count the page-locked
host memory they leave behind; one JSON line a measurement.

    python scripts/probe_ckpt_restore.py --write DIR           # once: the checkpoints
    PYTHONPATH=<tree>/src python scripts/probe_ckpt_restore.py --read DIR --label <name>

``--write`` saves qwen3-0.6b's training state at full width and depth (the
model and AdamW's moments, as ``launch.train`` checkpoints it) and two
checkpoints of sub-MiB leaves: 2000 leaves over 8 shapes that repeat, and
400 leaves each of its own size. ``--read`` runs in a fresh process on the
card (``--device cpu``: a process with no CUDA context; ``--smoke`` scales
the model down for a rehearsal), restores each twice
and reports the seconds, the read spares the store still keeps free and
torch's page-locked host allocator's bytes, then the microseconds of one
chunk read at 4 KiB, 64 KiB and 512 KiB. Run ``--read`` on two trees in turns
on one card, a fresh process each, to compare them.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import BoundingBox, ElementType, RegionKey
from repro_torch.storage import CheckpointManager, DiskStorage
from repro_torch.train import AdamW, AdamWConfig, init_state

REPEATING = [(16,), (128,), (1024,), (3072,), (64, 64), (256, 256), (128, 1024), (512, 511)]


def _small(distinct: bool) -> dict:
    rng = np.random.default_rng(7)
    if distinct:  # 1 KiB to 400 KiB, each size once
        return {f"l{i}": rng.random(256 * (i + 1), dtype=np.float32) for i in range(400)}
    return {f"l{i}": rng.random(REPEATING[i % len(REPEATING)], dtype=np.float32)
            for i in range(2000)}


def _state(device, smoke: bool = False):
    cfg = get_config("qwen3-0.6b").replace(attn_impl="torch")
    cfg = cfg.scaled_down() if smoke else cfg
    return init_state(cfg, AdamW(AdamWConfig(lr=1e-3)), seed=0, device=device)


def _store(root: str) -> DiskStorage:
    return DiskStorage(root, transport="aggregated", io_group_size=2, queue_threshold=8)


def _host_bytes() -> dict:
    if not torch.cuda.is_initialized():
        return {}
    s = torch.cuda.host_memory_stats()
    return {"host_allocated_bytes": s.get("allocated_bytes.current"),
            "host_active_bytes": s.get("active_bytes.current"),
            "num_host_alloc": s.get("num_host_alloc"),
            "host_alloc_ms": s.get("host_alloc_time.total", 0) / 1e3}


def _spare_bytes(store: DiskStorage) -> int | None:
    spares = getattr(store, "_spares", None)
    if spares is None:
        return None
    return sum(raw.nbytes for free in spares._free.values() for raw, _ in free)


def write(root: str, device, smoke: bool) -> None:
    for name, tree in (("lm", None), ("small", _small(False)), ("distinct", _small(True))):
        t0 = time.perf_counter()
        ckpt = CheckpointManager(_store(os.path.join(root, name)), keep=1)
        ckpt.save(1, _state(device, smoke) if tree is None else tree)
        print(json.dumps({"write": name, "s": time.perf_counter() - t0,
                          "bytes": ckpt.last_save["bytes"]}), flush=True)


def read(root: str, device, label: str, smoke: bool) -> None:
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for name in ("lm", "small", "distinct"):
        store = _store(os.path.join(root, name))
        ckpt = CheckpointManager(store, keep=1)
        held = []
        drop = getattr(store, "drop_spares", None)
        if drop is not None:  # what the restore lets go of as it ends
            store.drop_spares = lambda: (held.append(_spare_bytes(store)), drop())
        target = _state(device, smoke) if name == "lm" else _small(name == "distinct")
        sync()
        for rep in (1, 2):
            before = _host_bytes()
            t0 = time.perf_counter()
            ckpt.restore(target)
            sync()
            s = time.perf_counter() - t0
            print(json.dumps({"label": label, "restore": name, "rep": rep, "s": s,
                              "spare_bytes_at_end": held[-1] if held else None,
                              "spare_bytes_after": _spare_bytes(store),
                              "before": before, "after": _host_bytes()}), flush=True)
    store = _store(os.path.join(root, "reads"))
    for nbytes in (4096, 65536, 524288):
        key = RegionKey("p", f"r{nbytes}", ElementType.UINT8, 0, 0)
        box = BoundingBox((0,), (nbytes,))
        store.put(key, box, np.arange(nbytes, dtype=np.uint8))
        store.flush()
        for _ in range(20):
            store.get(key, box)
        times = []
        for _ in range(500):
            t0 = time.perf_counter()
            store.get(key, box)
            times.append(time.perf_counter() - t0)
        print(json.dumps({"label": label, "read_bytes": nbytes,
                          "us_median": 1e6 * float(np.median(times)),
                          "us_p90": 1e6 * float(np.percentile(times, 90))}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--write")
    ap.add_argument("--read")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="qwen3-0.6b scaled down")
    a = ap.parse_args()
    device = torch.device(a.device)
    if device.type == "cuda":
        torch.cuda.init()
    if a.write:
        write(a.write, device, a.smoke)
    if a.read:
        read(a.read, device, a.label, a.smoke)


if __name__ == "__main__":
    main()
