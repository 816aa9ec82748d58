"""I/O configuration auto-tuning (paper §5.3 future work).

"We intend to examine ... methods for automating the choice of the I/O
configuration through the integration with parameter auto-tuning
systems" — this module does exactly that over the DISK engine's
configuration space (transport x placement x group size x queue depth)
using the virtual-time cost model as the objective, with a simple
successive-halving search (cheap configs are measured on small workload
slices first; survivors graduate to the full workload).
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
from typing import Iterable

import numpy as np

from repro_torch.core.bbox import BoundingBox
from repro_torch.core.regions import ElementType, RegionKey
from repro_torch.storage.disk import DiskCostModel, DiskStorage


@dataclasses.dataclass(frozen=True)
class IOConfig:
    transport: str
    io_mode: str
    io_group_size: int
    queue_threshold: int
    num_io_workers: int = 0

    def build(self, root: str, cost_model: DiskCostModel | None = None) -> DiskStorage:
        return DiskStorage(
            root,
            transport=self.transport,
            io_mode=self.io_mode,
            io_group_size=self.io_group_size,
            num_io_workers=self.num_io_workers,
            queue_threshold=self.queue_threshold,
        )


def default_space(num_writers: int) -> list[IOConfig]:
    out = []
    for transport in ("posix", "aggregated"):
        groups = [1] if transport == "posix" else sorted({1, 4, num_writers})
        for g in groups:
            for q in ([1] if transport == "posix" else [2, 8]):
                out.append(IOConfig(transport, "colocated", g, q))
                out.append(IOConfig(transport, "separated", g, q,
                                    num_io_workers=max(2, num_writers // 2)))
    return out


@dataclasses.dataclass
class TuneResult:
    best: IOConfig
    virtual_s: float
    trials: list[tuple[IOConfig, float]]


def _drive(store: DiskStorage, n_chunks: int, chunk: int = 32) -> float:
    arr = np.ones((chunk, chunk), np.float32)
    for i in range(n_chunks):
        key = RegionKey("tune", f"c{i % 8}", ElementType.FLOAT32, timestamp=i)
        store.put(key, BoundingBox((0, 0), (chunk, chunk)), arr)
    store.flush()
    return store.stats.virtual_total_s


def autotune_io(
    *,
    num_writers: int = 16,
    workload_chunks: int = 64,
    space: Iterable[IOConfig] | None = None,
    survivors: int = 4,
) -> TuneResult:
    """Successive halving over the I/O config space (virtual time)."""
    space = list(space or default_space(num_writers))
    # round 1: 1/4 workload
    trials = []
    for cfg in space:
        tmp = tempfile.mkdtemp(prefix="iotune_")
        try:
            t = _drive(cfg.build(tmp), max(4, workload_chunks // 4))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        trials.append((cfg, t))
    trials.sort(key=lambda ct: ct[1])
    finalists = [c for c, _ in trials[: max(survivors, 1)]]
    # round 2: full workload
    final = []
    for cfg in finalists:
        tmp = tempfile.mkdtemp(prefix="iotune_")
        try:
            t = _drive(cfg.build(tmp), workload_chunks)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        final.append((cfg, t))
    final.sort(key=lambda ct: ct[1])
    best, best_t = final[0]
    return TuneResult(best=best, virtual_s=best_t, trials=trials + final)
