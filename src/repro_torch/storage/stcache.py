"""Spatio-temporal region cache with predictive prefetch.

The paper's §7 names this as the motivating extension for the cell-
tracking application: "smart spatial-temporal caching and data
prefetching strategies, which could anticipate the data reading process".

This module implements it:

  * an LRU cache over (key, ROI) reads fronting any StorageBackend;
  * overlap-aware hits: a request is served from cache when a cached
    entry's bounding box *contains* the requested ROI (cheap slicing);
  * a motion-model prefetcher: per (namespace, name) stream, the
    displacement between consecutive requested ROIs is tracked (EWMA),
    the next ROI is extrapolated (spatially, and temporally via the key
    timestamp), and fetched on a background thread before it is asked
    for — the paper's object-tracking access pattern.
"""
from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np

from repro_torch.core.bbox import BoundingBox
from repro_torch.core.regions import RegionKey, StorageBackend


@dataclasses.dataclass
class STCacheStats:
    hits: int = 0
    misses: int = 0
    prefetch_issued: int = 0
    prefetch_hits: int = 0
    evictions: int = 0
    bytes_cached: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class SpatioTemporalCache:
    """LRU + motion-predictive prefetch front for a StorageBackend.

    Implements the StorageBackend protocol itself, so it can be
    registered under the same name and dropped in front of DMS or DISK
    transparently (puts write through and update/invalidate the cache).
    """

    def __init__(
        self,
        backend: StorageBackend,
        *,
        name: str | None = None,
        capacity_bytes: int = 256 << 20,
        prefetch: bool = True,
        history: int = 4,
    ) -> None:
        self.backend = backend
        self.name = name or f"{backend.name}+STC"
        self.capacity_bytes = capacity_bytes
        self.prefetch_enabled = prefetch
        self.stats = STCacheStats()
        self._lock = threading.RLock()
        # ordered dict as LRU: (key, bb) -> ndarray
        self._cache: "collections.OrderedDict[tuple, np.ndarray]" = collections.OrderedDict()
        self._inflight: dict[tuple, threading.Event] = {}
        # per-stream request history for the motion model
        self._history: dict[tuple, collections.deque] = {}
        self._hist_len = history

    # -- cache mechanics ---------------------------------------------------------
    def _entry_for(self, key: RegionKey, roi: BoundingBox):
        """Find a cached entry whose box contains roi (containment hit)."""
        for (ck, cbb), arr in reversed(self._cache.items()):
            if ck == key and cbb.contains(roi):
                return (ck, cbb), arr
        return None, None

    def _insert(self, key: RegionKey, bb: BoundingBox, arr: np.ndarray) -> None:
        with self._lock:
            ck = (key, bb)
            if ck in self._cache:
                self._cache.move_to_end(ck)
                return
            self._cache[ck] = arr
            self.stats.bytes_cached += arr.nbytes
            while self.stats.bytes_cached > self.capacity_bytes and len(self._cache) > 1:
                _, old = self._cache.popitem(last=False)
                self.stats.bytes_cached -= old.nbytes
                self.stats.evictions += 1

    def invalidate(self, key: RegionKey) -> None:
        with self._lock:
            for ck in [ck for ck in self._cache if ck[0] == key]:
                self.stats.bytes_cached -= self._cache[ck].nbytes
                del self._cache[ck]

    # -- motion model ----------------------------------------------------------------
    def _stream_id(self, key: RegionKey) -> tuple:
        return (key.namespace, key.name)

    def _record_and_predict(
        self, key: RegionKey, roi: BoundingBox
    ) -> tuple[RegionKey, BoundingBox] | None:
        sid = self._stream_id(key)
        hist = self._history.setdefault(sid, collections.deque(maxlen=self._hist_len))
        hist.append((key, roi))
        if len(hist) < 2:
            return None
        (k0, r0), (k1, r1) = hist[-2], hist[-1]
        if r0.rank != r1.rank:
            return None
        # EWMA displacement over the full history
        deltas = []
        items = list(hist)
        for (ka, ra), (kb, rb) in zip(items[:-1], items[1:]):
            if ra.rank == rb.rank:
                deltas.append(tuple(lb - la for la, lb in zip(ra.lo, rb.lo)))
        if not deltas:
            return None
        w = 0.0
        acc = [0.0] * len(deltas[0])
        weight = 1.0
        for d in reversed(deltas):
            for i, v in enumerate(d):
                acc[i] += weight * v
            w += weight
            weight *= 0.5
        disp = tuple(int(round(a / w)) for a in acc)
        dt = k1.timestamp - k0.timestamp
        next_key = k1.at(k1.timestamp + dt) if dt else k1
        next_roi = r1.translate(disp)
        if next_roi == r1 and next_key == k1:
            return None
        return next_key, next_roi

    def _prefetch(self, key: RegionKey, roi: BoundingBox) -> None:
        ck = (key, roi)
        with self._lock:
            hit, _ = self._entry_for(key, roi)
            if hit is not None or ck in self._inflight:
                return
            evt = threading.Event()
            self._inflight[ck] = evt
            self.stats.prefetch_issued += 1

        def work():
            try:
                arr = self.backend.get(key, roi)
                self._insert(key, roi, np.asarray(arr))
            except KeyError:
                pass  # predicted region does not exist (yet) — harmless
            finally:
                with self._lock:
                    self._inflight.pop(ck, None)
                evt.set()

        threading.Thread(target=work, daemon=True, name="st-prefetch").start()

    # -- StorageBackend protocol ----------------------------------------------------
    def get(self, key: RegionKey, roi: BoundingBox) -> np.ndarray:
        with self._lock:
            ck, arr = self._entry_for(key, roi)
            inflight = self._inflight.get((key, roi))
        if inflight is not None:
            inflight.wait()
            with self._lock:
                ck, arr = self._entry_for(key, roi)
            if arr is not None:
                self.stats.prefetch_hits += 1
        if arr is not None:
            with self._lock:
                self.stats.hits += 1
                self._cache.move_to_end(ck)
            out = arr[roi.local_slices(ck[1])] if ck[1] != roi else arr
        else:
            with self._lock:
                self.stats.misses += 1
            out = np.asarray(self.backend.get(key, roi))
            self._insert(key, roi, out)
        if self.prefetch_enabled:
            pred = self._record_and_predict(key, roi)
            if pred is not None:
                self._prefetch(*pred)
        return out

    def put(self, key: RegionKey, bb: BoundingBox, array: np.ndarray) -> None:
        self.backend.put(key, bb, array)
        self.invalidate(key)  # write-through + invalidate overlaps
        self._insert(key, bb, np.asarray(array))

    def query(self, namespace: str, name: str):
        return self.backend.query(namespace, name)

    def delete(self, key: RegionKey) -> None:
        self.backend.delete(key)
        self.invalidate(key)

    def close(self) -> None:
        """Stop issuing prefetches and wait out in-flight prefetch
        threads (each signals its event when done, hit or miss)."""
        self.prefetch_enabled = False
        with self._lock:
            pending = list(self._inflight.values())
        for evt in pending:
            evt.wait(timeout=5.0)
