"""Region-serving gateway: many clients, one tiered region store.

The paper's runtime keeps many concurrent analysis stages reading from
one shared region store, and its hierarchical-pipelines companion work
(arXiv:1209.3332) shows throughput comes from batching fine-grain
requests onto shared resources.  :class:`RegionGateway` is that front
door, built as an explicit staged pipeline —

    admission -> fairness -> response cache -> coalesce -> store

* **bounded admission** — requests enter a bounded queue; when the
  queue is full a client waits at most ``admit_timeout`` seconds for a
  slot and then gets an explicit :class:`Overloaded` (never a deadlock,
  never an unbounded pile-up); RAM pressure (the top tier's fill
  fraction) shrinks the queue to ``shed_queue_factor`` of its size and
  turns the bounded wait into immediate shedding;
* **fairness** (:mod:`repro_torch.serve.fair`) — per-priority-class queues
  drained by weighted deficit round-robin, so a low-priority scan
  cannot monopolize the batch window, plus an optional per-client
  :class:`~repro_torch.core.pacing.TokenBucket` that makes a hog throttle
  itself before admission;
* **response cache** (:mod:`repro_torch.serve.rcache`) — served windows are
  kept in a bytes-bounded, generation-validated LRU; a repeated hot
  read costs a slice of a cached window, not a tier fetch.  Generations
  come from the store (writes that bypass the gateway still invalidate)
  and, in fleet mode, from the ``gen`` gossip op — N gateways sharing
  one DMS fleet see each other's writes, so any gateway's put
  invalidates every gateway's cache;
* **coalescing reads** — a worker drains every batchable queued request
  (same key, same class), merges overlapping/adjacent ROIs into minimal
  bounding windows, issues ONE tier fetch per window, and slices each
  caller's ROI out of the shared payload; fetched windows feed the
  response cache and a speculative :class:`~repro_torch.serve.rcache.
  WindowPrefetcher` that follows the observed scan stride;
* **coalescing writes** — with ``coalesce_puts`` enabled, puts queue as
  tickets too and a worker flushes a same-key batch with per-ROI
  last-writer-wins (N overwrites of one tile within a flush window cost
  one store put);
* **near-data compute** — :meth:`RegionGateway.compute` runs a named
  kernel chain server-side and returns only the derived array; its
  derived-product cache shares the response-cache implementation and
  the same generation validation (see :mod:`repro_torch.serve.compute`).

A merged window can cover cells none of the members asked for; if the
store cannot serve the window (a coverage hole raises ``KeyError``) the
gateway falls back to per-request fetches, so coalescing is a pure
optimization — results are always bit-exact with direct reads.  A
:class:`~repro_torch.storage.dms.TransportError` is distinguished in the
stats (``window_failures`` vs ``window_fallbacks``) but degrades the
same way.  The response cache preserves bit-exactness by construction:
entries record the write generation captured BEFORE their fetch, so a
racing put causes a spurious miss, never a stale hit.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
from typing import Callable, Iterable, Mapping

import numpy as np

from repro_torch.core.bbox import BoundingBox
from repro_torch.core.regions import RegionKey, StorageBackend
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import IMPLS
from repro_torch.serve.fair import DEFAULT_CLASSES, ClientPacer, FairScheduler
from repro_torch.serve.rcache import GenerationTracker, ResponseCache, WindowPrefetcher
from repro_torch.storage.dms import DMSStats, TransportError


class Overloaded(RuntimeError):
    """Admission control rejected the request; retry later or back off."""


class GatewayClosed(RuntimeError):
    """The gateway is shut down; no new requests are accepted."""


@dataclasses.dataclass
class GatewayConfig:
    """Staged-pipeline knobs (see class docstring for semantics)."""

    workers: int = 4
    max_queue: int = 128          # bounded admission queue (requests)
    batch_window: int = 32        # max requests drained into one batch
    admit_timeout: float = 10.0   # bounded wait for a queue slot (s)
    request_timeout: float | None = 120.0  # get() wait for the result (s)
    mem_highwater: float = 0.85   # RAM-tier fill fraction that sheds load
    shed_queue_factor: float = 0.25  # queue share admitted under pressure
    max_window_waste: float = 1.5  # window vol <= waste * sum(member vols)
    coalesce: bool = True
    # fairness stage: priority classes (name -> DRR weight), and an
    # optional per-client token bucket (requests/s; None = unthrottled)
    classes: "Mapping[str, int] | Iterable[tuple[str, int]]" = DEFAULT_CLASSES
    client_rate: float | None = None
    client_burst: float | None = None
    # response-cache stage: hot-window payload cache bound (0 disables),
    # speculative stride prefetch, and cross-gateway generation gossip
    # (fleet mode: validate/invalidate through the shared DMS fleet)
    response_cache_bytes: int = 32 << 20
    prefetch: bool = False
    prefetch_depth: int = 2
    fleet_generations: bool = False
    # write coalescing: puts queue as tickets and flush with per-ROI
    # last-writer-wins inside a same-key batch window
    coalesce_puts: bool = False
    # near-data compute (serve/compute.py): derived-product cache bound,
    # DevicePipeline in-flight window, and kernel impl dispatch ("auto" =
    # the CUDA kernels on the card, the plain versions on the CPU; "cuda";
    # "torch" = the plain versions anywhere)
    compute_cache_bytes: int = 64 << 20
    compute_pipeline_window: int = 2
    compute_impl: str = "auto"

    def __post_init__(self) -> None:
        if self.workers < 1:
            raise ValueError("gateway needs at least one worker")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.batch_window < 1:
            raise ValueError("batch_window must be >= 1")
        if self.compute_cache_bytes < 0:
            raise ValueError("compute_cache_bytes must be >= 0")
        if self.response_cache_bytes < 0:
            raise ValueError("response_cache_bytes must be >= 0")
        if self.prefetch_depth < 1:
            raise ValueError("prefetch_depth must be >= 1")
        if self.client_rate is not None and self.client_rate <= 0:
            raise ValueError("client_rate must be positive (or None)")
        if self.compute_impl not in IMPLS:
            raise ValueError(f"compute_impl must be one of {IMPLS}, got {self.compute_impl!r}")


class GatewayStats:
    """Request accounting: monotonic counters behind ONE internal lock.

    Writers use :meth:`add` (an atomic multi-counter bump: related
    counters like ``served``+``failed`` from one batch move together),
    :meth:`class_add` (the per-priority-class admission/shed/hit rows)
    or :meth:`peak`; readers use :meth:`as_dict`, which snapshots every
    counter — including the class rows — under the same lock, so a
    concurrent-worker snapshot can never observe a half-applied update
    (torn read).  Plain attribute reads of a single counter remain
    lock-free (individual ints are consistent; only cross-counter
    invariants need the snapshot).
    """

    _FIELDS = (
        "requests",      # submitted reads (admitted + rejected + cache hits)
        "served",        # reads completed with a payload
        "failed",        # reads completed with a backend error
        "rejected",      # Overloaded at admission (reads + writes + computes)
        "abandoned",     # tickets cancelled after a get() timeout
        "throttled",     # submissions that waited on their client bucket
        "batches",       # worker drain cycles
        "windows",       # tier fetches issued (merged read windows)
        "coalesced",     # reads served from a window shared with others
        "window_fallbacks",  # read window had a hole -> per-request reads
        "window_failures",   # read window died on the wire -> degrade
        "queue_peak",
        # response-cache stage
        "response_cache_hits",   # reads served from a cached hot window
        "prefetch_issued",       # speculative windows fetched
        "prefetch_hits",         # cache hits served by a prefetched window
        # write-coalescing stage
        "writes",            # submitted puts (facade or submit_put)
        "writes_applied",    # store puts actually issued after dedup
        "write_coalesced",   # puts superseded by a later same-ROI put
        "write_batches",     # write flush cycles
        "write_failed",      # puts completed with a backend error
        # near-data compute path (disjoint from the read counters)
        "compute_requests",
        "compute_served",
        "compute_failed",
        "compute_cache_hits",
        "compute_windows",           # fetch windows issued for computes
        "compute_coalesced",         # computes sharing a fetched window
        "compute_window_fallbacks",  # compute window hole -> per-member
        "compute_window_failures",   # compute window wire death -> degrade
        "raw_fetch_bytes",       # bytes pulled from the store for computes
        "derived_reply_bytes",   # bytes actually returned to compute clients
    )

    _CLASS_FIELDS = ("requests", "admitted", "shed", "served", "cache_hits")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        for f in self._FIELDS:
            setattr(self, f, 0)
        self._classes: dict[str, dict[str, int]] = {}

    def add(self, **deltas: int) -> None:
        """Atomically bump several counters (one lock acquisition)."""
        with self._lock:
            for name, delta in deltas.items():
                if name not in self._FIELDS:
                    raise AttributeError(f"unknown gateway counter {name!r}")
                setattr(self, name, getattr(self, name) + delta)

    def class_add(self, cls: str, **deltas: int) -> None:
        """Atomically bump counters on one priority class's row."""
        with self._lock:
            row = self._classes.setdefault(
                cls, {f: 0 for f in self._CLASS_FIELDS}
            )
            for name, delta in deltas.items():
                if name not in self._CLASS_FIELDS:
                    raise AttributeError(f"unknown class counter {name!r}")
                row[name] += delta

    def peak(self, name: str, value: int) -> None:
        with self._lock:
            setattr(self, name, max(getattr(self, name), value))

    def as_dict(self) -> dict:
        """Consistent snapshot of every counter (taken under the lock)."""
        with self._lock:
            out = {f: getattr(self, f) for f in self._FIELDS}
            out["classes"] = {c: dict(row) for c, row in self._classes.items()}
            return out


class ReadTicket(concurrent.futures.Future):
    """Handle on one submitted ROI read (a Future carrying key + roi)."""

    # worker batching groups same-key same-group tickets; plain reads all
    # share the None group, compute tickets override with their chain
    # digest (and write tickets with a "put" marker) so reads, writes,
    # and unrelated chains never mix in one batch
    group = None
    # fairness class (normalized at submit) and client id (throttling)
    priority = "default"
    client = None

    def __init__(self, key: RegionKey, roi: BoundingBox) -> None:
        super().__init__()
        self.key = key
        self.roi = roi

    def result(self, timeout: float | None = None) -> np.ndarray:
        try:
            return super().result(timeout)
        except concurrent.futures.TimeoutError:
            # on 3.10 the futures TimeoutError is NOT the builtin; callers
            # should only ever need `except TimeoutError`
            raise TimeoutError(
                f"gateway read of {self.key} {self.roi} timed out"
            ) from None


class WriteTicket(ReadTicket):
    """Handle on one queued put.  All writes share one batching group,
    so a worker flushes every queued same-key put in one cycle with
    per-ROI last-writer-wins.  The caller must not mutate ``array``
    until the ticket resolves (the facade ``put()`` blocks, so only
    direct ``submit_put`` users can observe this)."""

    group = ("put",)

    def __init__(self, key: RegionKey, roi: BoundingBox, array: np.ndarray) -> None:
        super().__init__(key, roi)
        self.array = array


def _deliver(ticket: ReadTicket, value) -> bool:
    """set_result unless the client cancelled meanwhile; True = counted.

    Callers must bump their stats counters BEFORE calling this (rolling
    back with a negative delta on False): set_result wakes the client,
    and a client reading ``gateway.stats`` right after ``result()``
    returns must already see its own request counted.
    """
    try:
        ticket.set_result(value)
        return True
    except concurrent.futures.InvalidStateError:
        return False


def _deliver_error(ticket: ReadTicket, error: BaseException) -> bool:
    try:
        ticket.set_exception(error)
        return True
    except concurrent.futures.InvalidStateError:
        return False


class _Cluster:
    """One merged fetch window and the requests it serves.

    ``covered`` is a lower bound on the union volume of the member ROIs
    (each absorbed ROI contributes only its cells OUTSIDE the window so
    far, so duplicates and overlaps contribute nothing) — the waste
    check is against distinct requested cells, never an inflated sum.
    """

    __slots__ = ("window", "covered", "members")

    def __init__(self, first: ReadTicket) -> None:
        self.window = first.roi
        self.covered = first.roi.volume
        self.members = [first]

    def try_absorb(self, req: ReadTicket, max_waste: float) -> bool:
        # overlapping or adjacent (touching counts: the merged window is
        # still gap-free along the shared face)
        if not self.window.inflate(1).intersects(req.roi):
            return False
        merged = self.window.union(req.roi)
        gain = req.roi.volume - req.roi.intersect(self.window).volume
        if merged.volume > max_waste * (self.covered + gain):
            return False  # merging would fetch mostly unrequested cells
        self.window = merged
        self.covered += gain
        self.members.append(req)
        return True


class RegionGateway:
    """Staged request pipeline fronting one shared region store.

    Implements ``StorageBackend`` (``get`` blocks on a submitted ticket;
    ``put``/``query``/``delete`` pass through — or queue, with
    ``coalesce_puts``), so a gateway registers in a
    :class:`~repro_torch.core.regions.StorageRegistry` under the store's own
    name and stages never notice.  Unknown attributes (``drain``,
    ``tier_stats``, ``locality``, ...) delegate to the wrapped store.

    ``device`` is where the near-data chains and the prefetcher's pipeline
    run: ``None`` means the CUDA card (construction raises without one),
    ``"cpu"`` the plain versions on the CPU.

    Fleet mode: construct N gateways whose stores share one DMS fleet
    (one transport) with ``fleet_generations=True`` — they keep a
    consistent membership view through the epoch gossip, and the ``gen``
    gossip propagates write generations so any gateway's put invalidates
    every gateway's response cache.
    """

    def __init__(
        self,
        store: StorageBackend,
        *,
        name: str | None = None,
        config: GatewayConfig | None = None,
        pressure_fn: Callable[[], float] | None = None,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.store = store
        self.name = name or getattr(store, "name", "GATEWAY")
        self.config = config or GatewayConfig()
        self.stats = GatewayStats()
        self._pressure_fn = pressure_fn
        self._engine = None  # near-data ComputeEngine, created on first use
        self._engine_lock = threading.Lock()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._slot_free = threading.Condition(self._lock)
        self._paused = False
        self._closed = False
        # pipeline stages: fairness scheduler (guarded by _lock, like the
        # plain deque it replaced), per-client pacer, generation tracker,
        # response cache, speculative prefetcher
        self._sched = FairScheduler(self.config.classes)
        self._pacer = (
            ClientPacer(self.config.client_rate, self.config.client_burst)
            if self.config.client_rate is not None
            else None
        )
        self._gens = GenerationTracker(
            store, fleet=self.config.fleet_generations
        )
        self._rcache = (
            ResponseCache(self.config.response_cache_bytes)
            if self.config.response_cache_bytes > 0
            else None
        )
        self._prefetcher = (
            WindowPrefetcher(
                store,
                self._rcache,
                self._gens,
                self.stats,
                depth=self.config.prefetch_depth,
                name=self.name,
                device=self.device,
            )
            if self.config.prefetch and self._rcache is not None
            else None
        )
        self._workers = [
            threading.Thread(
                target=self._worker_loop, daemon=True, name=f"{self.name}-gw{i}"
            )
            for i in range(self.config.workers)
        ]
        for w in self._workers:
            w.start()

    # -- admission control --------------------------------------------------------
    def pressure(self) -> float:
        """RAM-tier fill fraction in [0, 1] (0 when unbounded/unknown).

        Reads the wrapped :class:`~repro_torch.storage.tiers.TieredStore`'s
        capacity accounting; a custom ``pressure_fn`` overrides (e.g. to
        fold in host RSS or downstream backpressure).
        """
        if self._pressure_fn is not None:
            return max(0.0, min(1.0, float(self._pressure_fn())))
        tiers = getattr(self.store, "tiers", None)
        used = getattr(self.store, "used_bytes", None)
        if tiers and callable(used):
            top = tiers[0]
            cap = getattr(top, "capacity_bytes", None)
            if cap:
                return min(1.0, used(top.name) / cap)
        return 0.0

    def _admit_limit(self, pressure: float) -> int:
        cfg = self.config
        if pressure >= cfg.mem_highwater:
            return max(1, int(cfg.max_queue * cfg.shed_queue_factor))
        return cfg.max_queue

    def submit(
        self,
        key: RegionKey,
        roi: BoundingBox,
        *,
        priority: str | None = None,
        client=None,
    ) -> ReadTicket:
        """Enqueue one ROI read; returns a ticket to wait on.

        ``priority`` names a fairness class (unknown names degrade to
        the default class), ``client`` is the per-client throttling id.
        Blocks at most ``admit_timeout`` for a queue slot; raises
        :class:`Overloaded` when the queue stays full (immediately when
        the RAM tier is past ``mem_highwater`` — shedding, not queueing,
        is the right response to memory pressure).  A response-cache hit
        resolves the ticket immediately: no queue, no tier fetch.
        """
        with self._lock:
            if self._closed:  # don't serve cache hits from a closed gateway
                raise GatewayClosed(f"gateway {self.name} is closed")
        ticket = ReadTicket(key, roi)
        ticket.priority = self._sched.resolve(priority)
        ticket.client = client
        self._throttle(ticket)
        self.stats.add(requests=1)
        self.stats.class_add(ticket.priority, requests=1)
        if self._rcache is not None:
            gen = self._gens.current(key)  # fleet mode validates here
            hit = self._rcache.lookup_window(key, roi, gen)
            if hit is not None:
                payload, prefetched = hit
                deltas = {"served": 1, "response_cache_hits": 1}
                if prefetched:
                    deltas["prefetch_hits"] = 1
                self.stats.add(**deltas)
                self.stats.class_add(ticket.priority, served=1, cache_hits=1)
                ticket.set_result(payload)
                return ticket
        self._admit(ticket)
        return ticket

    def submit_put(
        self,
        key: RegionKey,
        bb: BoundingBox,
        array: np.ndarray,
        *,
        priority: str | None = None,
        client=None,
    ) -> WriteTicket:
        """Enqueue one put for batched flushing (last-writer-wins per
        ROI within the flush window); resolves with None once applied.
        Do not mutate ``array`` until then."""
        with self._lock:
            if self._closed:  # don't sleep on the pacer for a closed gateway
                raise GatewayClosed(f"gateway {self.name} is closed")
        ticket = WriteTicket(key, bb, array)
        ticket.priority = self._sched.resolve(priority)
        ticket.client = client
        self._throttle(ticket)
        self.stats.add(writes=1)
        self.stats.class_add(ticket.priority, requests=1)
        self._admit(ticket)
        return ticket

    def _throttle(self, ticket: ReadTicket) -> None:
        """Per-client pacing, BEFORE admission and outside every lock:
        a client over its rate sleeps on its own bucket, shaping its
        arrival rate instead of occupying a queue slot while it waits."""
        if self._pacer is None:
            return
        if self._pacer.take(ticket.client) > 0:
            self.stats.add(throttled=1)

    def _admit(self, ticket: ReadTicket) -> None:
        """Shared bounded-admission path for read/write/compute tickets."""
        deadline = time.monotonic() + self.config.admit_timeout
        while True:
            # sample pressure OUTSIDE the gateway lock: the store takes
            # its own lock, and a custom pressure_fn may legitimately
            # consult this gateway (e.g. queue_depth)
            p = self.pressure()
            with self._lock:
                if self._closed:
                    raise GatewayClosed(f"gateway {self.name} is closed")
                limit = self._admit_limit(p)
                depth = len(self._sched)
                if depth < limit:
                    self._sched.push(ticket)
                    self.stats.peak("queue_peak", depth + 1)
                    self.stats.class_add(ticket.priority, admitted=1)
                    self._not_empty.notify()
                    return
                if p >= self.config.mem_highwater:
                    self.stats.add(rejected=1)
                    self.stats.class_add(ticket.priority, shed=1)
                    raise Overloaded(
                        f"{self.name}: queue {depth} >= {limit} with RAM tier at "
                        f"{p:.0%} of capacity; shedding load (retry with backoff)"
                    )
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.stats.add(rejected=1)
                    self.stats.class_add(ticket.priority, shed=1)
                    raise Overloaded(
                        f"{self.name}: queue full ({depth}/{limit}) for "
                        f"{self.config.admit_timeout:.1f}s; rejecting (bounded wait)"
                    )
                self._slot_free.wait(remaining)

    # -- near-data compute ---------------------------------------------------------
    @property
    def engine(self):
        """The lazily-built :class:`~repro_torch.serve.compute.ComputeEngine`."""
        # double-checked lazy init: _engine only ever transitions
        # None -> engine (under _engine_lock), so the lock-free fast
        # path can at worst take the slow path once more
        if self._engine is None:  # relint: allow(guarded-attribute) — see above
            with self._engine_lock:
                if self._engine is None:
                    from repro_torch.serve.compute import ComputeEngine

                    self._engine = ComputeEngine(
                        self.store, self.config, gens=self._gens, device=self.device
                    )
        return self._engine  # relint: allow(guarded-attribute) — monotonic once set

    def submit_compute(
        self,
        key: RegionKey | "object",
        roi: BoundingBox | None = None,
        chain: str | None = None,
        params=None,
    ) -> "ReadTicket":
        """Enqueue one server-side kernel-chain execution.

        Accepts either a :class:`~repro_torch.serve.compute.ComputeRequest` or
        the unpacked ``(key, roi, chain, params)``.  Chain resolution and
        parameter validation happen HERE, synchronously — unknown chains
        raise :class:`~repro_torch.kernels.chains.UnknownChainError` and bad
        params/ranks raise :class:`~repro_torch.kernels.chains.ChainParamError`
        before anything is queued.  A derived-cache hit resolves the
        ticket immediately (no queue, no fetch, no kernel).
        """
        from repro_torch.serve.compute import ComputeRequest, make_ticket

        if isinstance(key, ComputeRequest):
            request = key
        else:
            if roi is None or chain is None:
                raise TypeError("submit_compute needs (key, roi, chain) or a ComputeRequest")
            request = ComputeRequest(key, roi, chain, params)
        ticket = make_ticket(request)  # typed errors fail fast, pre-queue
        self.stats.add(compute_requests=1)
        self.engine.chain_stats.add(ticket.chain_obj.name, requests=1)
        cached = self.engine.cached(ticket)
        if cached is not None:
            self.stats.add(
                compute_cache_hits=1,
                compute_served=1,
                derived_reply_bytes=cached.nbytes,
            )
            ticket.set_result(cached)
            return ticket
        self._admit(ticket)
        return ticket

    def compute(
        self,
        key: RegionKey | "object",
        roi: BoundingBox | None = None,
        chain: str | None = None,
        params=None,
    ) -> np.ndarray:
        """Blocking server-side chain execution; returns the derived
        array/feature vector (bit-exact with a local fetch + chain run)."""
        ticket = self.submit_compute(key, roi, chain, params)
        try:
            return ticket.result(self.config.request_timeout)
        except TimeoutError:
            if ticket.cancel():
                self.stats.add(abandoned=1)
            raise

    # -- worker pool --------------------------------------------------------------
    def _worker_loop(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            try:
                self._serve_batch(batch)
            except BaseException as e:  # noqa: BLE001 — a worker must
                # survive anything (even MemoryError mid-batch): answer
                # every unresolved ticket and keep draining, or queued
                # clients would hang for their full request_timeout
                for m in batch:
                    if m.done():
                        continue
                    if isinstance(m, WriteTicket):
                        field = "write_failed"
                    elif m.group is None:
                        field = "failed"
                    else:
                        field = "compute_failed"
                    self.stats.add(**{field: 1})
                    if not _deliver_error(m, e):
                        self.stats.add(**{field: -1})

    def _next_batch(self) -> list[ReadTicket] | None:
        """Pop the scheduler's next request (weighted round-robin over
        the priority classes) plus every batchable queued request from
        the same class (same key, same group, up to ``batch_window``) —
        the coalescing unit.  None = closed + drained."""
        with self._lock:
            while True:
                if len(self._sched) and (not self._paused or self._closed):
                    break
                if self._closed and not len(self._sched):
                    return None
                self._not_empty.wait()
            head = self._sched.pop_head()
            batch = self._sched.drain_matching(
                head, self.config.batch_window, self.config.coalesce
            )
            self.stats.add(batches=1)
            self._slot_free.notify_all()
        return batch

    def _coalesce(self, batch: list[ReadTicket]) -> list[_Cluster]:
        """Greedy window merge: sorted-by-origin requests fold into the
        first cluster they overlap/touch without exceeding the waste
        bound.  Duplicated ROIs collapse into one fetch for free."""
        clusters: list[_Cluster] = []
        for req in sorted(batch, key=lambda r: (r.roi.lo, r.roi.hi)):
            for c in clusters:
                if c.try_absorb(req, self.config.max_window_waste):
                    break
            else:
                clusters.append(_Cluster(req))
        return clusters

    def _serve_batch(self, batch: list[ReadTicket]) -> None:
        if isinstance(batch[0], WriteTicket):
            self._serve_writes(batch)
            return
        if batch[0].group is not None:
            # compute batch (same key, same chain digest): the engine
            # coalesces the FETCHES like reads, then runs the chain on
            # each member's own ROI slice through the device pipeline
            self.engine.serve_batch(batch, self)
            return
        if self.config.coalesce and len(batch) > 1:
            clusters = self._coalesce(batch)
        else:
            clusters = [_Cluster(r) for r in batch]
        for c in clusters:
            self.stats.add(
                windows=1, coalesced=len(c.members) if len(c.members) > 1 else 0
            )
            if len(c.members) == 1:
                self._serve_one(c.members[0])
                continue
            key = c.members[0].key
            # generation BEFORE the fetch: a racing put makes the cached
            # window a spurious miss, never a stale hit
            gen = self._gens.current(key) if self._rcache is not None else 0
            try:
                window_arr = self.store.get(key, c.window)
            except TransportError:
                # infrastructure failure (replica failover exhausted), not
                # a coverage hole: counted separately so operators see it,
                # but still degraded to per-request reads — a member whose
                # ROI lives in an upper tier (RAM/DISK) is served even
                # while the DMS is down, and members that genuinely need
                # the dead servers fail with their own TransportError
                # (cheap: the transport's liveness cache fails fast)
                self.stats.add(window_failures=1)
                for m in c.members:
                    self._serve_one(m)
                continue
            except Exception:  # noqa: BLE001 — coverage hole (KeyError) or
                # another per-window tier error: degrade to per-request
                # reads, which either succeed or surface the member's own
                # error — coalescing stays a pure optimization
                self.stats.add(window_fallbacks=1)
                for m in c.members:
                    self._serve_one(m)
                continue
            if self._rcache is not None:
                self._rcache.put((key, c.window), gen, window_arr)
            if self._prefetcher is not None:
                self._prefetcher.observe(key, c.window)
            for m in c.members:
                if m.done():
                    continue  # cancelled while queued
                try:
                    # slice per caller; copy so clients never alias the
                    # shared window payload (or each other — duplicated
                    # ROIs would otherwise all receive the same view)
                    payload = window_arr[m.roi.local_slices(c.window)].copy()
                except BaseException as e:  # noqa: BLE001 — e.g. MemoryError
                    # on the copy: fail this member, keep serving the rest
                    self.stats.add(failed=1)
                    if not _deliver_error(m, e):
                        self.stats.add(failed=-1)
                    continue
                self.stats.add(served=1)
                self.stats.class_add(m.priority, served=1)
                if not _deliver(m, payload):
                    self.stats.add(served=-1)
                    self.stats.class_add(m.priority, served=-1)

    def _serve_one(self, req: ReadTicket) -> None:
        if req.done():
            return  # cancelled while queued: don't fetch, don't re-resolve
        gen = self._gens.current(req.key) if self._rcache is not None else 0
        try:
            value = self.store.get(req.key, req.roi)
        except BaseException as e:  # noqa: BLE001 — surfaced on the ticket
            self.stats.add(failed=1)
            if not _deliver_error(req, e):
                self.stats.add(failed=-1)
            return
        if self._rcache is not None:
            # the cache keeps the fetched array; the caller gets a copy
            # so a client mutating its result never corrupts future hits
            self._rcache.put((req.key, req.roi), gen, value)
            value = value.copy()
        if self._prefetcher is not None:
            self._prefetcher.observe(req.key, req.roi)
        self.stats.add(served=1)
        self.stats.class_add(req.priority, served=1)
        if not _deliver(req, value):
            self.stats.add(served=-1)
            self.stats.class_add(req.priority, served=-1)

    def _serve_writes(self, batch: list[WriteTicket]) -> None:
        """Flush one same-key write batch: last-writer-wins per ROI
        (submission order — later queued puts supersede earlier ones to
        the same ROI), one store put per surviving write."""
        live = [t for t in batch if not t.done()]
        survivors: dict[BoundingBox, WriteTicket] = {}
        order: list[BoundingBox] = []
        for t in live:
            if t.roi not in survivors:
                order.append(t.roi)
            survivors[t.roi] = t
        self.stats.add(
            write_batches=1, write_coalesced=len(live) - len(survivors)
        )
        errors: dict[BoundingBox, BaseException] = {}
        applied = 0
        for bb in order:
            t = survivors[bb]
            try:
                self.store.put(t.key, bb, t.array)
                applied += 1
            except BaseException as e:  # noqa: BLE001 — surfaced per ticket
                errors[bb] = e
        if applied:
            self.stats.add(writes_applied=applied)
            # one invalidation per flushed key: caches + fleet gossip see
            # the final batch state, not every superseded intermediate
            self._note_write(live[0].key)
        for t in live:
            err = errors.get(t.roi)
            if err is not None:
                self.stats.add(write_failed=1)
                if not _deliver_error(t, err):
                    self.stats.add(write_failed=-1)
            elif not _deliver(t, None):
                pass  # cancelled after flush: the write still happened

    # -- StorageBackend protocol ----------------------------------------------------
    def get(self, key: RegionKey, roi: BoundingBox) -> np.ndarray:
        ticket = self.submit(key, roi)
        try:
            return ticket.result(self.config.request_timeout)
        except TimeoutError:
            # cancel so a worker skips the ticket (workers already skip
            # done() members) instead of fetching a window for a caller
            # that gave up — and counting the orphan as served
            if ticket.cancel():
                self.stats.add(abandoned=1)
            raise

    def put(self, key: RegionKey, bb: BoundingBox, array: np.ndarray) -> None:
        if self.config.coalesce_puts:
            ticket = self.submit_put(key, bb, array)
            try:
                ticket.result(self.config.request_timeout)
            except TimeoutError:
                if ticket.cancel():
                    self.stats.add(abandoned=1)
                raise
            return
        self.store.put(key, bb, array)
        self.stats.add(writes=1, writes_applied=1)
        # a write through the facade invalidates the key's cached
        # responses/derived products and gossips the fleet generation
        # (stores with generation() also catch direct puts)
        self._note_write(key)

    def query(self, namespace: str, name: str) -> list[tuple[RegionKey, BoundingBox]]:
        return self.store.query(namespace, name)

    def delete(self, key: RegionKey) -> None:
        self.store.delete(key)
        self._note_write(key)

    def _note_write(self, key: RegionKey) -> None:
        """Post-write invalidation fan-out: generation tracker (local +
        fleet gossip), response cache, and the derived-product cache."""
        self._gens.note_write(key)
        if self._rcache is not None:
            self._rcache.invalidate(key)
        engine = self._engine  # relint: allow(guarded-attribute) — monotonic None->engine; a racing first build has no derived products to invalidate
        if engine is not None:
            engine.cache.invalidate(key)

    # -- lifecycle ------------------------------------------------------------------
    def pause(self) -> None:
        """Stop dispatching (admission continues up to the queue bound).
        Maintenance hook; also makes coalescing deterministic in tests."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False
            self._not_empty.notify_all()

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._sched)

    def storage_stats(self) -> dict:
        """One operator view of the whole serving path: the gateway's own
        request counters (including per-priority-class rows, the
        response-cache health, and — as the ``"compute"`` sub-namespace —
        the per-chain compute counters) plus whatever the wrapped store
        exposes — tier hit/miss accounting
        (:class:`~repro_torch.storage.tiers.TierStats`), the DMS availability
        counters (:class:`~repro_torch.storage.dms.DMSStats`), and the
        transport byte counters.  A dashboard polling the gateway sees
        replica failover and anti-entropy repair happening below it
        without reaching around the facade.

        The top-level ``"compute"`` key is a deprecated alias of
        ``["gateway"]["compute"]``, kept for one release.
        """
        gw: dict = self.stats.as_dict()
        if self._rcache is not None:
            gw["response_cache"] = self._rcache.as_dict()
        engine = self._engine  # relint: allow(guarded-attribute) — monotonic None->engine; stats snapshots tolerate missing the engine being built right now
        if engine is not None:
            # per-chain latency + egress savings and derived-cache health
            gw["compute"] = engine.as_dict()
        out: dict = {"gateway": gw}
        if engine is not None:
            out["compute"] = gw["compute"]  # deprecated alias (one release)
        tier_stats = getattr(self.store, "tier_stats", None)
        if callable(tier_stats):
            out["tiers"] = {n: s.as_dict() for n, s in tier_stats().items()}
        backends = [self.store]
        backends += [t.backend for t in getattr(self.store, "tiers", ())]
        for backend in backends:
            stats = getattr(backend, "stats", None)
            if not isinstance(stats, DMSStats):
                continue
            entry = {"dms": stats.as_dict()}
            transport = getattr(backend, "transport", None)
            tstats = getattr(transport, "stats", None)
            if tstats is not None:
                # as_dict() snapshots every counter under the stats lock;
                # asdict() here was the PR-7 torn-read bug class
                entry["transport"] = tstats.as_dict()
            rebalance = getattr(backend, "rebalance_stats", None)
            if callable(rebalance):
                # elastic-fleet health: ring epoch/checksum, whether a
                # paced sweep is running, and the last sweep's report
                entry["rebalance"] = rebalance()
            out.setdefault("dms", {})[getattr(backend, "name", "DMS")] = entry
        return out

    def close(self, *, close_store: bool = True) -> None:
        """Clean shutdown: refuse new requests, drain + answer every
        queued/in-flight request, join the workers, then (by default)
        close the wrapped store."""
        with self._lock:
            already = self._closed
            self._closed = True
            self._paused = False  # a paused gateway still drains on close
            self._not_empty.notify_all()
            self._slot_free.notify_all()
        if not already:
            for w in self._workers:
                w.join(timeout=60.0)
            if self._prefetcher is not None:
                self._prefetcher.close()
        if close_store:
            store_close = getattr(self.store, "close", None)
            if callable(store_close):
                store_close()

    def __getattr__(self, attr: str):
        # transparency: drain/flush/tier_stats/locality/... reach the store
        store = self.__dict__.get("store")
        if store is None:
            raise AttributeError(attr)
        return getattr(store, attr)

    def __repr__(self) -> str:
        return (
            f"RegionGateway({self.name}: {self.config.workers} workers, "
            f"queue {self.queue_depth()}/{self.config.max_queue})"
        )
