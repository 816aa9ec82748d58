"""Response caching for the serving tier: generation-validated payloads.

Three pieces, one invalidation discipline:

* :class:`ResponseCache` — a bytes-bounded LRU of served payloads keyed
  ``(region key, window)`` (the gateway's hot-window response cache) or
  ``(region key, chain digest, roi)`` (the compute engine's derived-
  product cache — :class:`~repro_torch.serve.compute.DerivedCache` is this
  class).  Every entry records the key's *write generation* captured
  BEFORE the payload was fetched, and a lookup revalidates against the
  current generation — a racing put can only cause a spurious miss,
  never a stale hit.
* :class:`GenerationTracker` — the single source of "current generation"
  for a gateway: the wrapped store's
  :meth:`~repro_torch.storage.tiers.TieredStore.generation` (catches writes
  that bypass the gateway), a local counter for stores without one, and
  — in fleet mode — the fleet-wide max gossiped through the ``gen``
  transport op, so a put through *any* gateway sharing the DMS fleet
  invalidates *every* gateway's caches.
* :class:`WindowPrefetcher` — speculative window prefetch driven by the
  coalescer's observed access pattern: consecutive fetch windows for a
  key yield a stride, the next window along that stride is fetched in
  the background through a
  :class:`~repro_torch.runtime.prefetch.DevicePipeline` (bounded in-flight
  depth), and lands in the response cache before the client asks.
  Prefetch is advisory: a mispredicted window is a wasted fetch, never a
  wrong answer — entries carry the same generation validation as demand
  fills.  Its pipeline runs on the gateway's device (``None``: the CUDA
  card), resolved and built at construction, so a missing card raises
  there and not, silently, inside the prefetch thread.
"""
from __future__ import annotations

import collections
import threading

import numpy as np

from repro_torch.core.bbox import BoundingBox
from repro_torch.core.regions import RegionKey
from repro_torch.runtime.prefetch import DevicePipeline


class ResponseCache:
    """Bytes-bounded LRU of served payloads, generation-validated.

    Cache keys are tuples whose first element is the
    :class:`~repro_torch.core.regions.RegionKey`; entries store the write
    generation they were fetched under, and :meth:`get` /
    :meth:`lookup_window` revalidate against the caller-supplied current
    generation — a stale entry is a miss (and is dropped).  All methods
    are thread-safe.
    """

    def __init__(self, capacity_bytes: int) -> None:
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[tuple, tuple[int, np.ndarray]]" = (
            collections.OrderedDict()
        )
        self._by_key: dict[RegionKey, set[tuple]] = {}
        self._prefetched: set[tuple] = set()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def _drop_locked(self, ck: tuple) -> None:
        gen_arr = self._entries.pop(ck, None)
        if gen_arr is None:
            return
        self._bytes -= gen_arr[1].nbytes
        self._prefetched.discard(ck)
        keyset = self._by_key.get(ck[0])
        if keyset is not None:
            keyset.discard(ck)
            if not keyset:
                self._by_key.pop(ck[0], None)

    def get(self, ck: tuple, current_gen: int) -> np.ndarray | None:
        with self._lock:
            entry = self._entries.get(ck)
            if entry is None:
                self.misses += 1
                return None
            gen, arr = entry
            if gen != current_gen:
                self._drop_locked(ck)  # stale: the region was rewritten
                self.misses += 1
                return None
            self._entries.move_to_end(ck)
            self.hits += 1
            return arr

    def lookup_window(
        self, key: RegionKey, roi: BoundingBox, current_gen: int
    ) -> "tuple[np.ndarray, bool] | None":
        """Serve ``roi`` from a cached window of ``key``: an exact
        ``(key, roi)`` hit, or a slice out of any valid cached window
        that contains it (the hot-read repeat costs a slice, not a tier
        fetch).  Returns ``(payload copy, came_from_prefetch)`` or None;
        stale windows encountered during the scan are dropped."""
        with self._lock:
            exact = self._entries.get((key, roi))
            candidates = [(key, roi)] if exact is not None else []
            candidates += [
                ck
                for ck in list(self._by_key.get(key, ()))
                if ck != (key, roi) and len(ck) == 2 and ck[1].contains(roi)
            ]
            for ck in candidates:
                entry = self._entries.get(ck)
                if entry is None:
                    continue
                gen, arr = entry
                if gen != current_gen:
                    self._drop_locked(ck)  # stale: the region was rewritten
                    continue
                self._entries.move_to_end(ck)
                self.hits += 1
                # copy: callers never alias the cached window (or each other)
                return arr[roi.local_slices(ck[1])].copy(), ck in self._prefetched
            self.misses += 1
            return None

    def put(
        self, ck: tuple, gen: int, arr: np.ndarray, *, prefetched: bool = False
    ) -> None:
        if arr.nbytes > self.capacity_bytes:
            return  # would evict everything for one entry
        with self._lock:
            self._drop_locked(ck)
            self._entries[ck] = (gen, arr)
            self._by_key.setdefault(ck[0], set()).add(ck)
            if prefetched:
                self._prefetched.add(ck)
            self._bytes += arr.nbytes
            while self._bytes > self.capacity_bytes and self._entries:
                victim = next(iter(self._entries))
                self._drop_locked(victim)
                self.evictions += 1

    def invalidate(self, key: RegionKey) -> int:
        """Drop every cached payload of ``key`` (gateway put/delete)."""
        with self._lock:
            cks = list(self._by_key.get(key, ()))
            for ck in cks:
                self._drop_locked(ck)
            self.invalidations += len(cks)
            return len(cks)

    def as_dict(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
            }


class GenerationTracker:
    """One gateway's source of per-key write generations.

    The generation is a SUM of two independent monotone lines:

    * the **base** line — the wrapped store's own ``generation()`` when
      it has one (so direct ``store.put`` calls that bypass the gateway
      still invalidate), a local counter otherwise;
    * the **fleet** line (``fleet=True`` only) — a per-key counter
      gossiped via the DMS ``gen`` transport op: every gateway write
      increments it on every ring member, and reads take the max over
      the members.  The two lines are summed, not merged: each
      gateway's base line starts wherever its own write history left it,
      so comparing absolute values across gateways would leave a sibling
      blind to remote writes until the fleet counter "caught up" — the
      sum instead moves on EVERY write, local (base +1, and fleet +1
      when pushed) or remote (fleet +1).

    The observed fleet value is floored per key (monotone), so a remote
    write permanently advances the local view even if the member holding
    the max is briefly unreachable afterwards — a pull regression can
    never resurrect a stale cache entry.
    """

    def __init__(self, store, *, fleet: bool = False) -> None:
        gen = getattr(store, "generation", None)
        self._store_gen = gen if callable(gen) else None
        self._lock = threading.Lock()
        self._local: collections.Counter = collections.Counter()
        self._floor: collections.Counter = collections.Counter()
        self._fleet: list = []
        if fleet:
            backends = [store] + [t.backend for t in getattr(store, "tiers", ())]
            self._fleet = [
                b for b in backends if callable(getattr(b, "pull_generation", None))
            ]

    @property
    def fleet_enabled(self) -> bool:
        return bool(self._fleet)

    def _base(self, key: RegionKey) -> int:
        if self._store_gen is not None:
            return int(self._store_gen(key))
        with self._lock:
            return self._local[key]

    def _fleet_component(self, key: RegionKey, observed: int) -> int:
        with self._lock:
            if self._floor[key] < observed:
                self._floor[key] = observed
            return self._floor[key]

    def current(self, key: RegionKey) -> int:
        """The generation cached payloads of ``key`` must match to be
        served.  In fleet mode this pays one small ``gen`` round-trip
        per ring member — metadata, not a tier fetch."""
        base = self._base(key)
        if not self._fleet:
            return base
        observed = 0
        for dms in self._fleet:
            observed = max(observed, int(dms.pull_generation(key)))
        return base + self._fleet_component(key, observed)

    def note_write(self, key: RegionKey) -> int:
        """Record a write through the gateway facade: bump the local
        counter (stores with their own ``generation()`` already bumped
        in their put path) and push the fleet counter so sibling
        gateways' caches see the key move."""
        if self._store_gen is None:
            with self._lock:
                self._local[key] += 1
        base = self._base(key)
        if not self._fleet:
            return base
        observed = 0
        for dms in self._fleet:
            observed = max(observed, int(dms.push_generation(key)))
        return base + self._fleet_component(key, observed)


def _identity(x):
    return x


class WindowPrefetcher:
    """Speculative next-window prefetch from the coalescer's pattern.

    :meth:`observe` records each fetched window; two consecutive windows
    for a key give a stride (the SFC-ordered scans the coalescer
    produces have a stable one), and the predicted next window is
    fetched on a background thread through a
    :class:`~repro_torch.runtime.prefetch.DevicePipeline` with ``depth``
    windows in flight (upload overlaps the next fetch), landing in the
    response cache with demand-fill generation validation.  Advisory by
    construction: failures and mispredictions are dropped silently.
    """

    def __init__(
        self, store, cache, gens, stats, *, depth: int = 2, name: str = "GW", device=None
    ) -> None:
        self.store = store
        self.cache = cache
        self.gens = gens
        self.stats = stats
        self.depth = max(1, int(depth))
        self._pipe = DevicePipeline(_identity, window=self.depth, device=device)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._last: dict[RegionKey, BoundingBox] = {}
        self._queue: "collections.deque[tuple[RegionKey, BoundingBox]]" = (
            collections.deque()
        )
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"{name}-prefetch"
        )
        self._thread.start()

    def observe(self, key: RegionKey, window: BoundingBox) -> None:
        """Feed one fetched window; maybe enqueue a prediction."""
        with self._lock:
            if self._closed:
                return
            prev = self._last.get(key)
            self._last[key] = window
            if prev is None or prev == window:
                return
            delta = tuple(a - b for a, b in zip(window.lo, prev.lo))
            if all(d == 0 for d in delta):
                return
            if len(self._queue) >= 4 * self.depth:
                return  # bounded backlog: drop predictions, never block
            self._queue.append((key, window.translate(delta)))
            self._cv.notify()

    def _pending(self):
        """Generator of fetched predicted windows (feeds the pipeline)."""
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                key, window = self._queue.popleft()
            gen = self.gens.current(key)  # BEFORE the fetch (race -> spurious miss)
            try:
                arr = self.store.get(key, window)
            except Exception:  # noqa: BLE001 — a mispredicted window
                # (coverage hole, out of domain) is a dropped prediction
                continue
            self.stats.add(prefetch_issued=1)
            yield key, window, gen, arr

    def _loop(self) -> None:
        pipe = self._pipe
        tagged = (
            ((key, window, gen), arr) for key, window, gen, arr in self._pending()
        )
        try:
            for (key, window, gen), out in pipe.map_tagged(tagged):
                self.cache.put((key, window), gen, np.asarray(out), prefetched=True)
        except Exception:  # noqa: BLE001 — prefetch is advisory; a dead
            # prefetcher degrades to demand fills, never a gateway crash
            pass

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=10.0)
