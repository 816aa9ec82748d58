"""Near-data compute: server-side kernel chains over the region gateway.

The paper's hierarchical dataflow (§3) runs each computing stage next to
its data; this module is that claim for the serving path.  A client
submits a :class:`ComputeRequest` naming a registered kernel chain
(:mod:`repro_torch.kernels.chains`) and the gateway executes it *server-side*:

  client → gateway (admission) → coalesce compute ROIs → ONE window
  fetch per cluster → DevicePipeline (upload | kernels | download,
  paper §3.2.1) → derived-product cache → derived array / feature vector

Only the derived result crosses the wire back — a uint8 mask (4× smaller
than a float32 plane, 12× smaller than the RGB tiles it came from) or a
9-float feature vector (~10⁶× smaller) — which is the egress win the
astronomy case study's server-side quantitative queries demonstrate
(arXiv:1111.6661).

Correctness contract: a gateway ``compute()`` is bit-exact with fetching
the same ROI locally and running the same chain — coalescing merges the
*fetches*, never the kernel inputs (each member's chain runs on its own
ROI slice of the shared window), so non-local stages (percentile
normalization, CCL) see exactly the bytes a local run would.

The derived-product cache is keyed ``(region key, chain digest, roi)``
and validated by *put generation*: every entry records the key's write
generation at fetch time (captured BEFORE the fetch, so a racing put can
only cause a spurious miss, never a stale hit) and a lookup re-checks it
against the store's :meth:`~repro_torch.storage.tiers.TieredStore.generation`
— writes that bypass the gateway still invalidate.  Stores without
generation tracking fall back to a gateway-local counter bumped on every
``put``/``delete`` through the facade.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Mapping

import numpy as np

from repro_torch.core.bbox import BoundingBox
from repro_torch.core.regions import RegionKey
from repro_torch.device import resolve_device
from repro_torch.kernels.chains import Chain, resolve_chain
from repro_torch.runtime.prefetch import DevicePipeline
from repro_torch.serve.gateway import ReadTicket, _Cluster, _deliver, _deliver_error
from repro_torch.serve.rcache import GenerationTracker, ResponseCache
from repro_torch.storage.dms import TransportError


@dataclasses.dataclass(frozen=True)
class ComputeRequest:
    """One server-side chain execution over one ROI."""

    key: RegionKey
    roi: BoundingBox
    chain: str
    params: Mapping[str, Any] | None = None


class ComputeTicket(ReadTicket):
    """Future for a submitted compute; ``group`` keys worker batching so
    only same-key same-chain requests drain into one coalescing batch."""

    def __init__(self, request: ComputeRequest, chain: Chain) -> None:
        super().__init__(request.key, request.roi)
        self.request = request
        self.chain_obj = chain
        self.digest = chain.digest()
        self.group = ("compute", self.digest)


class DerivedCache(ResponseCache):
    """Bytes-bounded LRU of derived products, generation-validated.

    Key: ``(region key, chain digest, roi)``.  This IS the serving
    tier's :class:`~repro_torch.serve.rcache.ResponseCache` (re-exported under
    its derived-product name): entries store the write generation they
    were computed under, :meth:`get` revalidates against the caller-
    supplied current generation, and a stale entry is a miss (and is
    dropped) — never a stale hit.  All methods are thread-safe.
    """


class ChainStats:
    """Per-chain accounting (latency + egress bytes saved), lock-guarded."""

    _ZERO = {
        "requests": 0,
        "served": 0,
        "failed": 0,
        "cache_hits": 0,
        "raw_bytes": 0,      # bytes fetched from the store, server-side
        "derived_bytes": 0,  # bytes returned to clients
        "compute_ms": 0.0,
    }

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._chains: dict[str, dict] = {}

    def add(self, chain: str, **deltas) -> None:
        with self._lock:
            row = self._chains.setdefault(chain, dict(self._ZERO))
            for k, v in deltas.items():
                row[k] += v

    def as_dict(self) -> dict:
        with self._lock:
            return {c: dict(row) for c, row in self._chains.items()}


class ComputeEngine:
    """Executes compute batches for a gateway's worker pool.

    One engine per gateway; it owns the derived cache and the per-chain
    stats, and borrows the gateway's coalescer/stats for the fetch side.
    Its chains run on ``device`` (``None``: the CUDA card; raises at
    construction without one unless ``device="cpu"``).
    """

    def __init__(
        self, store, config, *, gens: GenerationTracker | None = None, device=None
    ) -> None:
        self.store = store
        self.config = config
        self.device = resolve_device(device)
        self.cache = DerivedCache(config.compute_cache_bytes)
        self.chain_stats = ChainStats()
        # generation source, shared with the owning gateway's response
        # cache when the gateway built us: a store with its own
        # write-generation tracking (TieredStore) catches puts that
        # bypass the gateway, a local counter covers plain backends, and
        # fleet mode folds in the gossiped fleet-wide max
        self._gens = gens if gens is not None else GenerationTracker(store)

    # -- generations ----------------------------------------------------------
    def generation(self, key: RegionKey) -> int:
        return self._gens.current(key)

    def note_write(self, key: RegionKey) -> None:
        """Record a facade write: standalone-engine users only — a
        gateway-owned engine shares the gateway's tracker, and the
        gateway's ``_note_write`` already bumped it."""
        self._gens.note_write(key)
        self.cache.invalidate(key)

    # -- cache fast path (called at submit time, before queueing) --------------
    def cached(self, ticket: ComputeTicket) -> np.ndarray | None:
        ck = (ticket.key, ticket.digest, ticket.roi)
        arr = self.cache.get(ck, self.generation(ticket.key))
        if arr is None:
            return None
        self.chain_stats.add(
            ticket.chain_obj.name, cache_hits=1, derived_bytes=arr.nbytes
        )
        return arr.copy()  # callers never alias the cached entry

    # -- batch execution (called from a gateway worker) -------------------------
    def serve_batch(self, batch: list[ComputeTicket], gateway) -> None:
        chain = batch[0].chain_obj
        cfg = gateway.config
        stats = gateway.stats
        if cfg.coalesce and len(batch) > 1:
            clusters = gateway._coalesce(batch)
        else:
            clusters = [_Cluster(t) for t in batch]
        # fetch phase: one store read per merged window, degraded to
        # per-member reads on coverage holes / transport failures —
        # exactly the read path's semantics
        items: list[tuple[ComputeTicket, np.ndarray, int]] = []
        raw_bytes = 0
        for c in clusters:
            live = [m for m in c.members if not m.done()]
            if not live:
                continue
            stats.add(
                compute_windows=1,
                compute_coalesced=len(c.members) if len(c.members) > 1 else 0,
            )
            gen = self.generation(c.members[0].key)  # BEFORE the fetch
            window_arr = None
            if len(live) == 1:
                c = _Cluster(live[0])  # no sharing: fetch the exact ROI
            try:
                window_arr = gateway.store.get(live[0].key, c.window)
            except TransportError:
                stats.add(compute_window_failures=1)
            except Exception:  # noqa: BLE001 — coverage hole etc.
                if len(c.members) > 1:
                    stats.add(compute_window_fallbacks=1)
            if window_arr is not None:
                raw_bytes += window_arr.nbytes
                for m in live:
                    items.append((m, window_arr[m.roi.local_slices(c.window)], gen))
                continue
            # degraded path: per-member fetches (each may still succeed
            # from an upper tier, or surface its own error)
            for m in live:
                gen = self.generation(m.key)
                try:
                    arr = gateway.store.get(m.key, m.roi)
                except BaseException as e:  # noqa: BLE001
                    stats.add(compute_failed=1)
                    self.chain_stats.add(chain.name, failed=1)
                    if not _deliver_error(m, e):
                        stats.add(compute_failed=-1)
                        self.chain_stats.add(chain.name, failed=-1)
                    continue
                raw_bytes += arr.nbytes
                items.append((m, arr, gen))
        # raw-fetch accounting lands BEFORE any ticket is fulfilled so a
        # client waking on .result() already sees its window's bytes
        if raw_bytes:
            self.chain_stats.add(chain.name, raw_bytes=raw_bytes)
            stats.add(raw_fetch_bytes=raw_bytes)
        if not items:
            return
        # compute phase: batched windows through the 3-phase device
        # pipeline (upload | kernel chain | download overlap, §3.2.1)
        pipe = DevicePipeline(
            chain.device_fn(cfg.compute_impl),
            window=cfg.compute_pipeline_window,
            host_fn=chain.host_fn(),
            device=self.device,
        )
        t0 = time.perf_counter()
        try:
            for (m, _, gen), out in zip(items, pipe.map(a for _, a, _ in items)):
                result = np.asarray(out)
                # the cache keeps a pageable copy and the client gets the
                # pipeline's own buffer, which on the card is pinned host
                # memory: cached entries then hold no pinned memory, and a
                # dropped reply returns its buffer to PyTorch's pinned cache
                # for the next download
                self.cache.put((m.key, m.digest, m.roi), gen, result.copy())
                # count before fulfilling (see gateway._deliver), rolling
                # back only on a lost race with a client-side cancel
                stats.add(compute_served=1, derived_reply_bytes=result.nbytes)
                self.chain_stats.add(
                    chain.name, served=1, derived_bytes=result.nbytes
                )
                if not _deliver(m, result):
                    stats.add(
                        compute_served=-1, derived_reply_bytes=-result.nbytes
                    )
                    self.chain_stats.add(
                        chain.name, served=-1, derived_bytes=-result.nbytes
                    )
        except BaseException as e:  # noqa: BLE001 — a kernel failure must
            # answer every still-pending member, not poison the batch
            for m, _, _ in items:
                if m.done():
                    continue
                stats.add(compute_failed=1)
                self.chain_stats.add(chain.name, failed=1)
                if not _deliver_error(m, e):
                    stats.add(compute_failed=-1)
                    self.chain_stats.add(chain.name, failed=-1)
        self.chain_stats.add(
            chain.name, compute_ms=(time.perf_counter() - t0) * 1e3
        )

    def as_dict(self) -> dict:
        return {"chains": self.chain_stats.as_dict(), "cache": self.cache.as_dict()}


def make_ticket(request: ComputeRequest) -> ComputeTicket:
    """Resolve + validate a request into a ticket; raises the typed
    :mod:`repro_torch.kernels.chains` errors *before* anything is queued."""
    chain = resolve_chain(request.chain, request.params)
    chain.check_input_rank(request.roi.rank)
    return ComputeTicket(request, chain)
