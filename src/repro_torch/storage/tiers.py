"""Tiered staging: policy-driven RAM -> DISK -> DMS storage hierarchy.

The paper's container "enables different data management strategies and
data I/O implementations, while providing a homogeneous, unified
interface" (§4, Fig. 8); the hierarchical-pipelines companion work
(arXiv:1209.3332) shows that staging data in the right memory layer
dominates end-to-end throughput.  :class:`TieredStore` composes the
existing siloed backends into one automatic hierarchy behind the same
``StorageBackend`` protocol, so any pipeline swaps it in through
``STORAGE.register(...)`` with zero call-site changes.

Mechanics
---------
* **Read-through + promotion** — a ``get`` is served from the fastest
  tier holding the key; repeated reads (``promote_after``) promote the
  region one tier up (towards RAM).
* **Capacity-triggered demotion** — when a bounded tier fills up, LRU
  victims are *spilled* to the next tier down (optionally re-blocked at
  ROI granularity via the placement policy), never dropped.
* **Write policies** — ``write_through`` copies every put to the bottom
  (durable) tier synchronously; ``write_back`` acknowledges after the
  target tier and lets a background flusher thread move the bytes down;
  ``lazy`` keeps data in its placed tier until eviction or ``drain()``
  pushes it down.  ``flush()``/``drain()`` provide checkpoint
  consistency for the deferred policies.
* **Placement hook** — a :class:`~repro.storage.placement.PlacementPolicy`
  pins namespaces to tiers, applies size/dtype thresholds, and sets the
  spill granularity.
* **Locality** — ``locality(key)`` names the fastest tier holding the
  key; the runtime scheduler uses it to refine DL transfer-cost
  estimates (memory-resident data is cheap, DMS-resident data charges
  the modeled network cost).
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from typing import Iterable, Sequence

import numpy as np

from repro_torch import spans, staging
from repro_torch.core.bbox import BoundingBox
from repro_torch.core.regions import RegionKey, StorageBackend
from repro_torch.storage import copies
from repro_torch.storage.placement import Placement, PlacementPolicy

# Per-tier staging bandwidth defaults (bytes/s) used by the runtime to
# turn a locality answer into a transfer-cost estimate.  Keys are the
# conventional tier names produced by :meth:`TieredStore.standard`.
TIER_BANDWIDTH: dict[str, float] = {
    "MEM": 2.0e10,  # host memcpy
    "DISK": 1.2e9,  # matches DiskCostModel.disk_bandwidth
    "DMS": 6.0e9,  # matches InProcTransport.link_bandwidth
}


def _assemble(
    pieces: Iterable[tuple[BoundingBox, np.ndarray]],
    roi: BoundingBox,
    *,
    share: bool = False,
) -> tuple[np.ndarray | None, int]:
    """Overlay (bb, array) pieces (each array spanning its bb) onto an
    ROI-shaped output.  Later pieces win on overlap.  Returns (out,
    covered): out is None when nothing intersects; covered counts the ROI
    cells that some piece holds, a boolean mask's count, so overlapping
    pieces are never double-counted.  A read is whole when covered equals
    ``roi.volume``.

    With ``share`` (pieces that are read-only and never written in place)
    a ROI that one piece contains, contiguously, is that piece's view,
    with no copy and no mask: it is covered by its box, so covered is
    ``roi.volume``.  Every copy counts in ``copies.stats()`` as a get,
    every view as a ``get_views``.
    """
    pieces = [(bb, arr) for bb, arr in pieces if not bb.intersect(roi).is_empty]
    if share and len(pieces) == 1 and pieces[0][0].contains(roi):
        bb, arr = pieces[0]
        view = arr[roi.local_slices(bb)]
        if view.flags.c_contiguous and not view.flags.writeable:
            copies.count_view()
            return view, roi.volume
    if not pieces:
        return None, 0
    bb, arr = pieces[0]
    out = np.zeros(roi.shape + arr.shape[bb.rank:], dtype=arr.dtype)
    covered = np.zeros(roi.shape, dtype=bool)
    for bb, arr in pieces:
        part = bb.intersect(roi)
        out[part.local_slices(roi)] = arr[part.local_slices(bb)]
        covered[part.local_slices(roi)] = True
    copies.count("get", out.nbytes)
    return out, int(np.count_nonzero(covered))


@dataclasses.dataclass
class TierStats:
    """Per-tier accounting (hits, promotions, demotions, bytes moved)."""

    hits: int = 0
    misses: int = 0
    puts: int = 0
    promotions: int = 0
    demotions: int = 0
    flushes: int = 0
    flush_failures: int = 0  # drain() could not materialize the key
    bytes_in: int = 0
    bytes_out: int = 0
    bytes_promoted: int = 0
    bytes_demoted: int = 0
    bytes_flushed: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class MemoryTier:
    """Capacity-friendly in-process tier (StorageBackend protocol).

    Chunks are kept read-only, apart from the caller's array: one already
    in a store's spare buffer (``copies.immutable``, such as the stages'
    downloads) as it is, any other as a copy into such a buffer
    (``copies.Spares``), counted in ``copies.stats()``. So an acknowledged
    write never changes with the caller's array, and a spare is never
    reused while a chunk lies in it. ``get`` assembles the requested ROI
    from every intersecting chunk (same contract as DISK/DMS); a ROI that
    one chunk covers is that chunk's read-only view. The
    :class:`TieredStore` drives eviction, so this class only tracks
    resident bytes: :attr:`pinned_bytes` of them page-locked.
    """

    def __init__(self, *, name: str = "MEM") -> None:
        self.name = name
        self._chunks: dict[RegionKey, list[tuple[BoundingBox, np.ndarray]]] = {}
        self._lock = threading.Lock()
        self._spares = copies.Spares()

    def put(self, key: RegionKey, bb: BoundingBox, array: np.ndarray) -> None:
        arr = np.asarray(array)
        if tuple(arr.shape)[: bb.rank] != bb.shape:
            raise ValueError(f"payload shape {arr.shape} != bb shape {bb.shape}")
        if not copies.immutable(arr):
            copies.count("put", arr.nbytes)
            arr = self._spares.copy(arr)
        with self._lock:
            chunks = self._chunks.setdefault(key, [])
            for i, (obb, _) in enumerate(chunks):
                if obb == bb:  # overwrite in place: no stale duplicates
                    chunks[i] = (bb, arr)
                    return
            chunks.append((bb, arr))

    def get(self, key: RegionKey, roi: BoundingBox) -> np.ndarray:
        with self._lock:
            chunks = list(self._chunks.get(key, []))
        if not chunks:
            raise KeyError(f"{self.name}: no data for {key}")
        out, covered = _assemble(chunks, roi, share=True)
        if out is None:
            raise KeyError(f"{self.name}: {key} has no chunks intersecting {roi}")
        if covered < roi.volume:
            raise KeyError(f"{self.name}: {key} covers only {covered}/{roi.volume} of {roi}")
        return out

    def query(self, namespace: str, name: str) -> list[tuple[RegionKey, BoundingBox]]:
        with self._lock:
            out: dict[RegionKey, BoundingBox] = {}
            for key, chunks in self._chunks.items():
                if key.namespace == namespace and key.name == name:
                    for bb, _ in chunks:
                        out[key] = bb if key not in out else out[key].union(bb)
            return sorted(out.items(), key=lambda kv: kv[0])

    def delete(self, key: RegionKey) -> None:
        with self._lock:
            self._chunks.pop(key, None)

    # -- TieredStore hooks -----------------------------------------------------
    def peek_chunks(self, key: RegionKey) -> list[tuple[BoundingBox, np.ndarray]]:
        """The key's chunks as written (lossless demotion source)."""
        with self._lock:
            return list(self._chunks.get(key, []))

    def key_bytes(self, key: RegionKey) -> int:
        with self._lock:
            return sum(a.nbytes for _, a in self._chunks.get(key, []))

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return sum(a.nbytes for cs in self._chunks.values() for _, a in cs)

    @property
    def pinned_bytes(self) -> int:
        """The resident bytes that lie in page-locked memory (the spares of a
        process that holds a CUDA context, and the stages' downloads from a
        card), which this tier keeps alive: part of :attr:`used_bytes`, so
        within the tier's capacity once the store has enforced it."""
        with self._lock:
            arrays = [a for cs in self._chunks.values() for _, a in cs]
        return sum(a.nbytes for a in arrays if staging.page_locked(a))


@dataclasses.dataclass
class Tier:
    """One level of the hierarchy: a backend + an optional byte budget.

    Capacity accounting is exact for :class:`MemoryTier` backends (they
    report resident bytes per key); for other backends it accumulates
    put sizes, which over-counts same-box overwrites — budget bounded
    tiers should therefore be memory tiers (the usual configuration).
    """

    name: str
    backend: StorageBackend
    capacity_bytes: int | None = None  # None = unbounded
    stats: TierStats = dataclasses.field(default_factory=TierStats)


_FLUSH_STOP = object()


class TieredStore:
    """Ordered tier stack behind the unified ``StorageBackend`` protocol."""

    def __init__(
        self,
        tiers: Sequence[Tier | StorageBackend | tuple],
        *,
        name: str = "TIERED",
        policy: PlacementPolicy | None = None,
        write_policy: str = "write_through",
        promote_after: int = 2,
    ) -> None:
        if write_policy not in ("write_through", "write_back", "lazy"):
            raise ValueError(f"unknown write_policy {write_policy!r}")
        self.name = name
        self.tiers: list[Tier] = []
        for t in tiers:
            if isinstance(t, Tier):
                self.tiers.append(t)
            elif isinstance(t, tuple):
                tname, backend, cap = (t + (None,))[:3] if len(t) == 2 else t
                self.tiers.append(Tier(tname, backend, cap))
            else:
                self.tiers.append(Tier(getattr(t, "name", "tier"), t))
        if not self.tiers:
            raise ValueError("TieredStore needs at least one tier")
        self.policy = policy or PlacementPolicy()
        self.write_policy = write_policy
        self.promote_after = max(1, int(promote_after))
        self._lock = threading.RLock()
        # metadata: which tiers hold each key, union bb, per-tier bytes
        self._resident: dict[RegionKey, set[int]] = {}
        self._bb: dict[RegionKey, BoundingBox] = {}
        self._tier_bytes: list[dict[RegionKey, int]] = [
            collections.defaultdict(int) for _ in self.tiers
        ]
        # per-key write generation, and the generation each tier's copy
        # reflects: a copy is stale iff its generation is behind the
        # key's.  Demotion may only *drop* a copy when a lower tier holds
        # a current-generation one; otherwise it must spill.
        self._gen: collections.Counter = collections.Counter()
        self._tier_gen: list[dict[RegionKey, int]] = [{} for _ in self.tiers]
        self._lru: list["collections.OrderedDict[RegionKey, None]"] = [
            collections.OrderedDict() for _ in self.tiers
        ]
        self._placement: dict[RegionKey, Placement] = {}
        self._hits: collections.Counter = collections.Counter()
        self._moving: set[RegionKey] = set()  # promotion/demotion in flight
        # write-back machinery
        self._pending_flush: collections.Counter = collections.Counter()
        self._tombstones: set[RegionKey] = set()
        self._flushq: "queue.Queue" = queue.Queue()
        self._flusher = threading.Thread(
            target=self._flush_loop, daemon=True, name=f"{name}-flusher"
        )
        self._flusher.start()

    # -- helpers ------------------------------------------------------------------
    def _tier_index(self, tier_name: str | None) -> int:
        if tier_name is None:
            return 0
        for i, t in enumerate(self.tiers):
            if t.name == tier_name:
                return i
        raise KeyError(f"{self.name}: no tier named {tier_name!r}")

    @property
    def _bottom(self) -> int:
        return len(self.tiers) - 1

    def _touch(self, ti: int, key: RegionKey) -> None:
        lru = self._lru[ti]
        if key in lru:
            lru.move_to_end(key)
        else:
            lru[key] = None

    def _admit(self, ti: int, key: RegionKey, bb: BoundingBox, nbytes: int) -> None:
        self._resident.setdefault(key, set()).add(ti)
        self._bb[key] = bb if key not in self._bb else self._bb[key].union(bb)
        backend = self.tiers[ti].backend
        if isinstance(backend, MemoryTier):
            # exact accounting: re-puts overwrite in place, so ask the tier
            self._tier_bytes[ti][key] = backend.key_bytes(key)
        else:
            self._tier_bytes[ti][key] += nbytes
        self._touch(ti, key)

    def _drop_from_tier(self, ti: int, key: RegionKey) -> None:
        self._tier_bytes[ti].pop(key, None)
        self._tier_gen[ti].pop(key, None)
        self._lru[ti].pop(key, None)
        tiers = self._resident.get(key)
        if tiers is not None:
            tiers.discard(ti)
            if not tiers:
                self._resident.pop(key, None)

    # -- StorageBackend protocol ----------------------------------------------------
    def put(self, key: RegionKey, bb: BoundingBox, array: np.ndarray) -> None:
        """Store the payload in its placed tier, then as its write policy
        says. While a profiler records, the put is the span ``tiers.put``
        (``repro_torch.spans``), with the tiers' own spans inside."""
        with spans.span("tiers.put"):
            self._put(key, bb, array)

    def _put(self, key: RegionKey, bb: BoundingBox, array: np.ndarray) -> None:
        arr = np.asarray(array)
        placement = self.policy.place(key, bb, arr.nbytes, arr.dtype)
        ti = self._tier_index(placement.tier)
        tier = self.tiers[ti]
        tier.backend.put(key, bb, arr)
        with self._lock:
            self._tombstones.discard(key)
            self._placement[key] = placement
            self._gen[key] += 1
            gen = self._gen[key]
            self._admit(ti, key, bb, arr.nbytes)
            self._tier_gen[ti][key] = gen
            tier.stats.puts += 1
            tier.stats.bytes_in += arr.nbytes
            wp = placement.write_policy or self.write_policy
        if ti != self._bottom:
            if wp == "write_through":
                bottom = self.tiers[self._bottom]
                bottom.backend.put(key, bb, arr)
                with self._lock:
                    self._admit(self._bottom, key, bb, arr.nbytes)
                    self._tier_gen[self._bottom][key] = gen
                    bottom.stats.puts += 1
                    bottom.stats.bytes_in += arr.nbytes
            elif wp == "write_back":
                with self._lock:
                    self._pending_flush[key] += 1
                self._flushq.put((key, bb, arr, gen))
            # "lazy": stays in the placed tier until eviction / drain()
        self._enforce_capacity(ti)

    def get(self, key: RegionKey, roi: BoundingBox) -> np.ndarray:
        """The ROI from the freshest tier that holds the key, the fastest on
        a tie. While a profiler records, the read is the span ``tiers.get``,
        with the tier's own spans inside."""
        with spans.span("tiers.get"):
            return self._get(key, roi)

    def _get(self, key: RegionKey, roi: BoundingBox) -> np.ndarray:
        arr = None
        ti = None
        # bounded retry: a concurrent demotion may move the payload down
        # between the metadata read and the backend read; the metadata
        # converges (destination is populated before the source is
        # dropped), so re-reading it resolves the race
        had_resident = False
        for _ in range(8):
            with self._lock:
                # freshest copy first (stale lower copies may linger after
                # a lazy/write-back overwrite), fastest tier as tiebreak
                resident = sorted(
                    self._resident.get(key, ()),
                    key=lambda t: (-self._tier_gen[t].get(key, 0), t),
                )
            if not resident:
                break
            had_resident = True
            ti = resident[0]
            try:
                arr = self.tiers[ti].backend.get(key, roi)
                break
            except KeyError:
                # either a concurrent demotion moved the payload (metadata
                # converges: retry) or the freshest tier lacks full ROI
                # coverage (falls through to cross-tier assembly)
                arr = None
                continue
        if arr is None and not had_resident:
            # data staged directly into a backend (not through this store):
            # probe top-down and adopt the key so future reads are tracked
            for i, tier in enumerate(self.tiers):
                try:
                    arr = tier.backend.get(key, roi)
                except KeyError:
                    continue
                ti = i
                found = tier.backend.query(key.namespace, key.name)
                bb = next((b for k, b in found if k == key), roi)
                with self._lock:
                    self._gen[key] = max(self._gen[key], 1)
                    self._admit(ti, key, bb, 0)
                    self._tier_gen[ti][key] = self._gen[key]
                break
        if arr is None:
            # the key's chunks may be split across tiers (placement
            # thresholds route chunks independently) — no single tier
            # covers the ROI, but the hierarchy jointly can
            arr, ti = self._assemble_across_tiers(key, roi)
            if arr is None:
                raise KeyError(f"{self.name}: no tier holds {key}")
        with self._lock:
            for i in range(ti):
                self.tiers[i].stats.misses += 1
            self.tiers[ti].stats.hits += 1
            self.tiers[ti].stats.bytes_out += arr.nbytes
            self._touch(ti, key)
            self._hits[key] += 1
            promote = (
                ti > 0
                and self._hits[key] >= self.promote_after
                and not self._placement.get(key, Placement()).pinned
            )
        if promote:
            self._promote(key, ti, roi, arr)
        return arr

    def _assemble_across_tiers(
        self, key: RegionKey, roi: BoundingBox
    ) -> tuple[np.ndarray | None, int | None]:
        """Assemble an ROI from chunks spread over several tiers.

        Slowest tier first so faster (and per-policy fresher) tiers
        overwrite on overlap.  Returns (None, None) if the hierarchy does
        not jointly cover the ROI.
        """
        with self._lock:
            # stalest first so fresher generations overwrite on overlap;
            # equal generations resolve to the fastest tier
            order = sorted(
                range(len(self.tiers)),
                key=lambda i: (self._tier_gen[i].get(key, 0), -i),
            )
        pieces: list[tuple[BoundingBox, np.ndarray]] = []
        fastest = None
        for i in order:
            tier = self.tiers[i]
            for k, bb in tier.backend.query(key.namespace, key.name):
                if k != key or not bb.intersects(roi):
                    continue
                part = bb.intersect(roi)
                try:
                    pieces.append((part, tier.backend.get(key, part)))
                except KeyError:
                    continue  # this tier's coverage of part is partial
                fastest = i if fastest is None else min(fastest, i)
        out, covered = _assemble(pieces, roi)
        if out is None or covered < roi.volume:
            return None, None
        return out, fastest

    def query(self, namespace: str, name: str) -> list[tuple[RegionKey, BoundingBox]]:
        out: dict[RegionKey, BoundingBox] = {}
        for tier in self.tiers:
            for key, bb in tier.backend.query(namespace, name):
                out[key] = bb if key not in out else out[key].union(bb)
        return sorted(out.items(), key=lambda kv: kv[0])

    def delete(self, key: RegionKey) -> None:
        with self._lock:
            if self._pending_flush.get(key):
                self._tombstones.add(key)
            for ti in range(len(self.tiers)):
                self._drop_from_tier(ti, key)
            self._hits.pop(key, None)
            self._placement.pop(key, None)
            self._bb.pop(key, None)
            # _gen is intentionally kept (and bumped: a delete is a write
            # for anyone caching derived products of this key): it must
            # stay monotonic across delete/re-put so late flushes of the
            # old incarnation can be recognized as stale
            self._gen[key] += 1
        for tier in self.tiers:
            tier.backend.delete(key)

    # -- promotion / demotion -----------------------------------------------------
    def _promote(
        self, key: RegionKey, src: int, roi: BoundingBox, served: np.ndarray
    ) -> None:
        """Copy a hot key straight to the top tier (read-through
        promotion).  The just-served payload is reused when it covers the
        region's full box, so promotion adds no extra backend read."""
        dst = 0
        with self._lock:
            bb = self._bb.get(key)
            # a stale top-tier leftover must not block re-promotion of a
            # fresher copy: compare generations, not mere residency
            dst_current = dst in self._resident.get(key, set()) and self._tier_gen[
                dst
            ].get(key, 0) >= self._tier_gen[src].get(key, 0)
            if bb is None or dst_current or key in self._moving:
                self._hits[key] = 0
                return
            self._moving.add(key)
        try:
            self._promote_locked(key, src, roi, served, bb, dst)
        finally:
            with self._lock:
                self._moving.discard(key)

    def _promote_locked(
        self,
        key: RegionKey,
        src: int,
        roi: BoundingBox,
        served: np.ndarray,
        bb: BoundingBox,
        dst: int,
    ) -> None:
        if roi.contains(bb) and bb.contains(roi):
            arr = served
        else:
            try:
                arr = self.tiers[src].backend.get(key, bb)
            except KeyError:
                return  # partial coverage: promotion needs the full box
        cap = self.tiers[dst].capacity_bytes
        if cap is not None and arr.nbytes > cap:
            with self._lock:
                self._hits[key] = 0  # would be evicted right back out
            return
        dst_backend = self.tiers[dst].backend
        with self._lock:
            src_gen = self._tier_gen[src].get(key, 0)
            # a newer put may have landed while we held the payload; stale
            # bytes must never clobber it
            stale = self._gen[key] != src_gen or (
                dst in self._resident.get(key, set())
                and self._tier_gen[dst].get(key, 0) >= src_gen
            )
            if stale:
                self._hits[key] = 0
                return
            if isinstance(dst_backend, MemoryTier):
                # cheap in-memory write: do it under the lock so the gen
                # check above cannot be invalidated mid-copy
                dst_backend.put(key, bb, arr)
                copied = True
            else:
                copied = False
        if not copied:
            dst_backend.put(key, bb, arr)
            with self._lock:
                if self._gen[key] != src_gen:
                    return  # raced: metadata never claims the stale copy
        with self._lock:
            self._admit(dst, key, bb, arr.nbytes)
            self._tier_gen[dst][key] = src_gen
            self.tiers[dst].stats.promotions += 1
            self.tiers[dst].stats.bytes_promoted += arr.nbytes
            self._hits[key] = 0
        self._enforce_capacity(dst)

    def _enforce_capacity(self, ti: int) -> None:
        tier = self.tiers[ti]
        if tier.capacity_bytes is None:
            return
        undemotable: set[RegionKey] = set()
        while True:
            with self._lock:
                used = sum(self._tier_bytes[ti].values())
                if used <= tier.capacity_bytes:
                    return
                victim = None
                for key in self._lru[ti]:  # oldest first
                    if key in undemotable:
                        continue
                    p = self._placement.get(key, Placement())
                    if p.pinned:
                        # a pin with tier=None pins to the top tier
                        try:
                            pin_ti = self._tier_index(p.tier)
                        except KeyError:
                            pin_ti = None
                        if pin_ti == ti:
                            continue
                    victim = key
                    break
                if victim is None:
                    # every candidate pinned or busy: over budget for now
                    return
            if not self._demote(victim, ti):
                # mid-relocation or un-materializable: try the next victim
                undemotable.add(victim)

    def _demote(self, key: RegionKey, src: int) -> bool:
        """Demote the key out of ``src``: the region never leaves the
        hierarchy.  If a lower tier already holds it (write-through copy,
        flushed write-back, promotion leftover) dropping the ``src`` copy
        suffices — locality simply moves down.  Otherwise the payload is
        spilled to the next tier (optionally re-blocked at ROI
        granularity)."""
        dst = src + 1
        if dst > self._bottom:
            return False  # bottom tier is never demoted
        with self._lock:
            if key in self._moving:
                return False  # another thread is already relocating it
            self._moving.add(key)
        try:
            return self._demote_locked(key, src, dst)
        finally:
            with self._lock:
                self._moving.discard(key)

    def _demote_locked(self, key: RegionKey, src: int, dst: int) -> bool:
        src_tier, dst_tier = self.tiers[src], self.tiers[dst]
        with self._lock:
            resident = set(self._resident.get(key, set()))
            if src not in resident:
                return False  # relocated meanwhile
            spill_block = self._placement.get(key, Placement()).spill_block
            moved = self._tier_bytes[src].get(key, 0)
            src_gen = self._tier_gen[src].get(key, 0)
            # drop only if a lower tier holds a copy at least as fresh as
            # ours — a stale lower copy (lazy/write-back overwrite) must
            # not shadow the only up-to-date data
            fresh_below = any(
                t > src and self._tier_gen[t].get(key, -1) >= src_gen
                for t in resident
            )
        if not fresh_below:
            # nothing fresh below: copy to the next tier FIRST so a
            # concurrent reader always finds the payload somewhere
            if isinstance(src_tier.backend, MemoryTier):
                chunks = src_tier.backend.peek_chunks(key)
            else:
                bb = self._bb.get(key)
                try:
                    chunks = [(bb, src_tier.backend.get(key, bb))] if bb else []
                except KeyError:
                    chunks = []
            if not chunks:
                # cannot materialize a copy and nothing durable below:
                # keep it where it is rather than losing data
                with self._lock:
                    self._touch(src, key)  # avoid re-picking it immediately
                return False
            for bb, arr in chunks:
                for part, payload in _spill_parts(bb, arr, spill_block):
                    dst_tier.backend.put(key, part, payload)
                    with self._lock:
                        self._admit(dst, key, part, payload.nbytes)
                        self._tier_gen[dst][key] = max(
                            self._tier_gen[dst].get(key, 0), src_gen
                        )
        # metadata drops before the source payload: readers that re-check
        # the metadata are routed below, never at a half-deleted tier
        with self._lock:
            self._drop_from_tier(src, key)
            src_tier.stats.demotions += 1
            src_tier.stats.bytes_demoted += moved
        src_tier.backend.delete(key)
        self._enforce_capacity(dst)
        return True

    # -- write-back flusher -------------------------------------------------------
    def _flush_loop(self) -> None:
        bottom = self._bottom
        while True:
            item = self._flushq.get()
            try:
                if item is _FLUSH_STOP:
                    return
                key, bb, arr, gen = item
                with self._lock:
                    # stale if deleted, or the bottom already holds a copy
                    # at least this fresh via another path (write-through
                    # override, newer flush, push-down)
                    skip = (
                        key in self._tombstones
                        or self._tier_gen[bottom].get(key, 0) >= gen
                    )
                wrote = False
                if not skip:
                    self.tiers[bottom].backend.put(key, bb, arr)
                    wrote = True
                resurrected = False
                with self._lock:
                    self._pending_flush[key] -= 1
                    if self._pending_flush[key] <= 0:
                        self._pending_flush.pop(key, None)
                    if wrote and key in self._tombstones:
                        # deleted while we were writing: undo, don't
                        # resurrect the key in the bottom tier
                        resurrected = True
                    elif wrote:
                        self._admit(bottom, key, bb, arr.nbytes)
                        self._tier_gen[bottom][key] = max(
                            self._tier_gen[bottom].get(key, 0), gen
                        )
                        self.tiers[bottom].stats.flushes += 1
                        self.tiers[bottom].stats.bytes_flushed += arr.nbytes
                    if key not in self._pending_flush:
                        self._tombstones.discard(key)
                if resurrected:
                    self.tiers[bottom].backend.delete(key)
            finally:
                self._flushq.task_done()

    def flush(self) -> None:
        """Block until every queued write-back has reached the bottom tier."""
        self._flushq.join()

    def drain(self) -> None:
        """Checkpoint consistency: flush write-backs, push lazily held
        regions down to the bottom tier, then sync the bottom backend's
        own buffers (e.g. DISK I/O groups)."""
        self.flush()
        self._push_down()
        bottom = self.tiers[self._bottom].backend
        if hasattr(bottom, "flush"):
            bottom.flush()

    def _push_down(self) -> None:
        """Copy every region not yet bottom-resident to the bottom tier."""
        bi = self._bottom
        bottom = self.tiers[bi]
        with self._lock:
            pending = []
            for key, tiers in self._resident.items():
                if not tiers:
                    continue
                # source = the freshest copy (fastest tier on ties)
                src = max(
                    tiers, key=lambda t, key=key: (self._tier_gen[t].get(key, 0), -t)
                )
                if src == bi:
                    continue
                if bi in tiers and self._tier_gen[bi].get(
                    key, 0
                ) >= self._tier_gen[src].get(key, 0):
                    continue  # bottom already current
                pending.append((key, src, self._bb.get(key)))
        for key, ti, bb in pending:
            if bb is None:
                continue
            try:
                arr = self.tiers[ti].backend.get(key, bb)
            except KeyError:
                # chunks split across tiers: assemble the full box
                arr, _ = self._assemble_across_tiers(key, bb)
                if arr is None:
                    with self._lock:
                        bottom.stats.flush_failures += 1
                    continue  # genuinely uncoverable; surfaced in stats
            bottom.backend.put(key, bb, arr)
            with self._lock:
                src_gen = self._tier_gen[ti].get(key, 0)
                self._admit(bi, key, bb, arr.nbytes)
                self._tier_gen[bi][key] = max(
                    self._tier_gen[bi].get(key, 0), src_gen
                )
                bottom.stats.flushes += 1
                bottom.stats.bytes_flushed += arr.nbytes

    def close(self) -> None:
        self.flush()
        self._flushq.put(_FLUSH_STOP)
        self._flusher.join(timeout=2.0)
        for tier in self.tiers:
            backend_close = getattr(tier.backend, "close", None)
            if callable(backend_close):
                backend_close()  # e.g. DMS socket transports

    # -- introspection -------------------------------------------------------------
    def locality(self, key: RegionKey, *, probe: bool = False) -> str | None:
        """Name of the fastest tier holding the key (None = not resident).

        The default answers from in-memory metadata only — O(1), safe on
        the scheduler hot path.  ``probe=True`` additionally scans the
        backends for data staged into them directly (linear in resident
        keys; such data is also adopted lazily on first ``get``).
        """
        with self._lock:
            resident = self._resident.get(key)
            if resident:
                # the tier that actually serves reads: freshest, then
                # fastest — a stale faster copy must not be reported
                best = min(
                    resident,
                    key=lambda t: (-self._tier_gen[t].get(key, 0), t),
                )
                return self.tiers[best].name
        if probe:
            for tier in self.tiers:
                if any(
                    k == key for k, _ in tier.backend.query(key.namespace, key.name)
                ):
                    return tier.name
        return None

    def dirty(self, key: RegionKey) -> bool:
        """True while the key has not yet reached the bottom tier."""
        with self._lock:
            if self._pending_flush.get(key, 0) > 0:
                return True
            tiers = self._resident.get(key)
            return bool(tiers) and self._bottom not in tiers

    def generation(self, key: RegionKey) -> int:
        """Monotonic per-key write generation (puts AND deletes bump it).

        Consumed by derived-product caches (the gateway's near-data
        compute tier): a cached result is valid iff the generation it was
        computed under still matches, so writes that bypass the cache
        owner — direct ``store.put`` while a gateway fronts the store —
        still invalidate.
        """
        with self._lock:
            return self._gen[key]

    def bump_generation(self, key: RegionKey, floor: int | None = None) -> int:
        """Raise ``key``'s write generation: by one (``floor=None``, an
        out-of-band mutation observed outside the put path — forces
        every generation-validated cache above this store to drop the
        key), or to at least ``floor`` (restoring a persisted generation
        watermark).  Never moves backwards; returns the current
        generation."""
        with self._lock:
            if floor is None:
                self._gen[key] += 1
            elif self._gen[key] < int(floor):
                self._gen[key] = int(floor)
            return self._gen[key]

    def tier_stats(self) -> dict[str, TierStats]:
        return {t.name: t.stats for t in self.tiers}

    def counters(self) -> dict[str, float]:
        """A snapshot of the store's counters, flat, to difference over a
        window: each tier's :class:`TierStats` (``<tier>.<field>``), the
        bytes a memory tier holds and the page-locked part of them
        (``<tier>.used_bytes``, ``<tier>.pinned_bytes``; exact for memory
        tiers alone), and the stats a backend keeps as a dataclass, such as
        DISK's bytes read and written (``<tier>.bytes_read``,
        ``<tier>.bytes_written``)."""
        out: dict[str, float] = {}
        with self._lock:
            for t in self.tiers:
                out.update({f"{t.name}.{k}": v for k, v in t.stats.as_dict().items()})
        for t in self.tiers:
            if isinstance(t.backend, MemoryTier):
                out[f"{t.name}.used_bytes"] = t.backend.used_bytes
                out[f"{t.name}.pinned_bytes"] = t.backend.pinned_bytes
            own = getattr(t.backend, "stats", None)
            if dataclasses.is_dataclass(own) and not isinstance(own, type):
                out.update({f"{t.name}.{k}": v for k, v in dataclasses.asdict(own).items()})
        return out

    def used_bytes(self, tier_name: str) -> int:
        ti = self._tier_index(tier_name)
        with self._lock:
            return sum(self._tier_bytes[ti].values())

    def __repr__(self) -> str:
        stack = " -> ".join(
            f"{t.name}"
            + (f"[{t.capacity_bytes >> 20}MiB]" if t.capacity_bytes else "")
            for t in self.tiers
        )
        return f"TieredStore({self.name}: {stack}, {self.write_policy})"

    # -- canonical stack ------------------------------------------------------------
    @staticmethod
    def standard(
        domain: BoundingBox,
        block_shape: Iterable[int],
        *,
        root: str,
        name: str = "TIERED",
        mem_capacity_bytes: int = 256 << 20,
        num_servers: int = 4,
        policy: PlacementPolicy | None = None,
        write_policy: str = "write_through",
        promote_after: int = 2,
        disk_kwargs: dict | None = None,
        dms_transport=None,
        replication: int = 1,
        repair_interval: float | None = None,
        wire_codec=None,
        membership=None,
    ) -> "TieredStore":
        """The paper-shaped stack: bounded RAM -> DISK (ADIOS-style) -> DMS.

        ``dms_transport`` swaps the DMS tier's server link: ``None`` keeps
        the in-process shards, a :class:`~repro.storage.net.
        SocketTransport` (or a pre-spawned ``ServerGroup().transport()``)
        makes the bottom tier span hosts — demotion, write-back flush and
        ``locality()`` are unchanged, only the bytes ride TCP.  The store
        owns the transport: ``close()`` closes it.

        ``replication`` is the DMS tier's R-way block replication: each
        demoted/flushed block lands on R servers along the SFC ring, so
        the bottom tier survives R-1 server deaths with zero failed
        reads — and zero failed writes (puts re-home blocks past dead
        replicas).  ``repair_interval`` (seconds) opts into the DMS
        tier's background anti-entropy sweep: a crashed server that
        rejoins empty is re-filled until every block has R live copies
        again; ``close()`` stops the sweep.

        ``wire_codec`` compresses the DMS tier's payloads on the wire:
        either one codec name (``repro.storage.codec.WIRE_CODECS``) for
        every block, or a per-key glob mapping such as ``{"labels/*":
        "zlib", "feat/*": "bf16"}`` routing each region key to its own
        codec (unmatched keys ride raw).  Negotiated per connection, old
        servers degrade the link to raw.  It requires a socket
        ``dms_transport`` — in-process shards move no wire bytes, so a
        codec there would only burn CPU — and must be set before the
        transport's first use (negotiation happens at dial time).

        ``membership`` seeds the DMS tier's elastic fleet view (a
        :class:`~repro.storage.membership.RingView`); leave ``None`` for
        the genesis ring over the transport's servers.  The DMS tier's
        ``add_server``/``remove_server``/``rebalance`` then grow and
        shrink the bottom tier live — reach it via
        ``store.tiers[-1].backend``.
        """
        from repro_torch.storage.codec import check_codec
        from repro_torch.storage.disk import DiskStorage
        from repro_torch.storage.dms import DistributedMemoryStorage

        if wire_codec is not None:
            if dms_transport is None:
                raise ValueError(
                    "wire_codec= needs a socket dms_transport (in-process "
                    "shards move no wire bytes); pass a SocketTransport or "
                    "ServerGroup().transport()"
                )
            dms_transport.wire_codec = check_codec(wire_codec)
        mem = MemoryTier(name="MEM")
        disk = DiskStorage(root, name=f"{name}-DISK", **(disk_kwargs or {}))
        dms = DistributedMemoryStorage(
            domain, block_shape,
            num_servers if dms_transport is None else None,
            name=f"{name}-DMS", transport=dms_transport,
            replication=replication, membership=membership,
        )
        if repair_interval is not None:
            dms.start_auto_repair(repair_interval)
        return TieredStore(
            [
                Tier("MEM", mem, mem_capacity_bytes),
                Tier("DISK", disk),
                Tier("DMS", dms),
            ],
            name=name,
            policy=policy,
            write_policy=write_policy,
            promote_after=promote_after,
        )


def _spill_parts(
    bb: BoundingBox, arr: np.ndarray, spill_block: tuple[int, ...] | None
):
    """Yield (bb, payload) demotion units, re-blocked at ROI granularity."""
    if spill_block is None or len(spill_block) != bb.rank:
        yield bb, arr
        return
    for tile in bb.tiles(spill_block):
        yield tile, np.ascontiguousarray(arr[tile.local_slices(bb)])
