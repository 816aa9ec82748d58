"""Distributed memory storage (DMS) — the DataSpaces-backed store of S4.1.

Faithful mechanics:
  * the application domain is gridded into fixed blocks;
  * each block's coordinates are mapped to a 1-D key by a Hilbert SFC
    (Morton for rank != 2);
  * the (possibly sparse) set of SFC keys is *compacted into a virtual
    domain* (rank among sorted keys) which is range-partitioned across the
    storage servers (paper Fig. 9);
  * a put stores payload blocks on their home servers and propagates only
    *metadata* to every server's directory (paper: "data stored on a single
    server, metadata propagated" — this is why inserts are cheap and reads
    may move data);
  * a get routes per-block requests to home servers and assembles the ROI.

Availability (beyond the paper's single-home placement):
  * ``replication=R`` writes every payload block to its home server AND
    the next ``R-1`` servers along the SFC virtual-domain ring, skipping
    servers co-located with an already-chosen replica (shards sharing a
    process share its fate); the directory entry records the full
    replica list (``homes``), with single-``home`` entries still
    decoding (backward compatible, and the R=1 wire format is
    byte-for-byte today's);
  * directory lookups rotate over the servers instead of pinning server 0
    (every directory is a replica, so any one answers);
  * a ``TransportError`` mid-read regroups the failed server's blocks onto
    surviving replicas — with R >= 2, one dead server causes zero failed
    reads; ``delete`` best-effort-drops on every replica;
  * a ``TransportError`` mid-WRITE re-homes the block onto the next live
    server along the ring (and a failed put rolls its partial blocks
    back), so one dead server causes zero failed puts too;
  * healthy reads rotate over live replicas (``read_balance``) so a hot
    key's fetch load spreads instead of pinning its primary;
  * ``repair()`` — the anti-entropy sweep — re-replicates under-covered
    blocks and re-fills the directory of a server that rejoined empty,
    so a crash + restart converges back to R live copies of everything.

Every server interaction goes through the message-based :class:`Transport`
protocol (``store``/``fetch``/``put_meta``/``lookup``/``keys``/``drop``/
``drop_block``),
so the same routing logic rides either

  * :class:`InProcTransport` — thread-safe in-process shards plus a
    virtual-time bandwidth model (reproduces the paper's throughput
    experiments without wall-clock sleeps), or
  * :class:`repro.storage.net.SocketTransport` — length-prefixed frames
    over TCP to :class:`repro.storage.net.ServerProcess` hosts, the real
    multi-host deployment.

Every byte moved is accounted (puts, gets, metadata) for the benchmark
suite in both cases.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import threading
from typing import Iterable, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch import spans
from repro_torch.core.bbox import BoundingBox
from repro_torch.core.hilbert import sfc_index, sfc_order_for
from repro_torch.core.regions import RegionKey
from repro_torch.storage import copies
from repro_torch.storage.membership import RingView, TokenBucket, adopt_newer


class TransportError(ConnectionError):
    """A wire-level failure (server down, connection reset, bad frame).

    Lives here (not :mod:`repro.storage.net`) because the routing layer
    catches it to fail over between replicas; ``net`` re-exports it.
    """


def encode_homes(homes: Iterable[int]):
    """Directory ``homes`` field: a bare int for a single home (today's
    wire format, byte-for-byte) or a list for R-way replica sets."""
    homes = [int(s) for s in homes]
    return homes[0] if len(homes) == 1 else homes


def decode_homes(home) -> tuple[int, ...]:
    """Backward-compatible decode: single-``home`` int entries and
    ``homes`` replica lists both come back as a tuple of server ids."""
    if isinstance(home, (int, np.integer)):
        return (int(home),)
    return tuple(int(s) for s in home)


class TransportStats:
    """Per-transport traffic accounting: counters behind ONE lock.

    ``bytes_put``/``bytes_get`` count WIRE bytes — what actually crossed
    the link (compressed payloads, or just the control frame for a
    shared-memory fetch).  ``bytes_put_raw``/``bytes_get_raw`` count the
    decoded array bytes the application moved.  On a plain transport the
    two are equal; the gap is the data-plane saving, surfaced by
    ``storage_stats()``.  ``shm_gets`` counts blocks served by shared-
    memory reference instead of a socket payload.

    Same discipline as ``GatewayStats``: writers bump related counters
    together through :meth:`add` (one atomic multi-counter step), and
    snapshot readers use :meth:`as_dict` so a concurrent bump can never
    produce a torn cross-counter view (e.g. ``puts`` without its
    ``bytes_put``).  Plain attribute reads of a single counter remain
    lock-free.
    """

    _FIELDS = (
        "puts",
        "gets",
        "meta_msgs",
        "bytes_put",
        "bytes_get",
        "bytes_meta",
        "bytes_put_raw",
        "bytes_get_raw",
        "shm_gets",
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()
        for f in self._FIELDS:
            setattr(self, f, 0)

    def add(self, **deltas: int) -> None:
        """Atomically bump several counters (one lock acquisition)."""
        with self._lock:
            for name, delta in deltas.items():
                if name not in self._FIELDS:
                    raise AttributeError(f"unknown transport counter {name!r}")
                setattr(self, name, getattr(self, name) + delta)

    def reset(self) -> None:
        with self._lock:
            for f in self._FIELDS:
                setattr(self, f, 0)

    def as_dict(self) -> dict:
        """Consistent snapshot of every counter (taken under the lock)."""
        with self._lock:
            return {f: getattr(self, f) for f in self._FIELDS}


@runtime_checkable
class Transport(Protocol):
    """Message API between a DMS client and its storage servers.

    One method per wire message; ``server`` is the global server id
    (0..num_servers).  Implementations route the message however they
    like (direct call, TCP frame, RDMA verb) but must preserve these
    semantics:

      * ``fetch``/``fetch_many``/``lookup`` raise ``KeyError`` when the
        server does not hold the requested data;
      * ``fetch_many`` is scatter-gather: N blocks move in ONE round-trip
        (``stats.gets`` counts round-trips, not blocks);
      * arrays round-trip bit-exact with dtype and shape preserved;
      * the ``home`` field of ``put_meta``/``lookup`` entries is either a
        bare server id (single home, the legacy format) or a sequence of
        replica ids — round-tripped as given, decoded via
        :func:`decode_homes`;
      * unreachable servers surface as :class:`TransportError` (never a
        hang longer than the transport's op timeout);
      * ``stats`` accounts every byte moved.
    """

    num_servers: int
    stats: TransportStats

    def store(
        self, server: int, key: RegionKey, block_coord: tuple, box: BoundingBox, payload: np.ndarray
    ) -> None: ...

    def fetch(self, server: int, key: RegionKey, block_coord: tuple) -> np.ndarray: ...

    def fetch_many(
        self, server: int, requests: list[tuple[RegionKey, tuple]]
    ) -> list[np.ndarray]: ...

    def put_meta(
        self,
        server: int,
        key: RegionKey,
        block_coord: tuple,
        box: BoundingBox,
        home: int | Sequence[int],
    ) -> None: ...

    def put_meta_batch(
        self,
        server: int,
        entries: list[tuple[RegionKey, tuple, BoundingBox, int | Sequence[int]]],
    ) -> "list[tuple] | None":
        """Returns the block coords that ALREADY had a directory entry
        on this server before the batch (the pre-image a failed put's
        rollback needs to avoid destroying an earlier incarnation), or
        None when the implementation cannot tell."""
        ...

    def lookup(
        self, server: int, key: RegionKey
    ) -> dict[tuple, tuple[BoundingBox, "int | Sequence[int]"]]: ...

    def keys(self, server: int) -> list[RegionKey]: ...

    def drop(self, server: int, key: RegionKey) -> None: ...

    def drop_block(self, server: int, key: RegionKey, block_coord: tuple) -> None: ...

    def payload_bytes(self, server: int) -> int: ...

    def join(self, server: int, sid: int, view: dict) -> "dict | None":
        """Announce to ``server`` that global shard ``sid`` joined the
        fleet under the given :class:`~repro.storage.membership.RingView`
        JSON; the server adopts the view when its epoch is newer and
        returns the view it now holds."""
        ...

    def leave(self, server: int, sid: int, view: dict, purge: bool = False) -> "dict | None":
        """Announce that ``sid`` left the fleet.  ``purge=True`` (sent
        after the rebalance sweep drained it) additionally drops the
        departed shard's remaining payload, directory, and arena slots
        when ``server`` hosts it."""
        ...

    def epoch(self, server: int) -> "dict | None":
        """The fleet view ``server`` currently holds (RingView JSON), or
        None when it has never been told one — lets a fresh client (or a
        rebalance resuming after a crash) rediscover the current epoch
        from any live server."""
        ...

    def gen(self, server: int, bump=None, want=None) -> dict:
        """Write-generation gossip (the response-cache invalidation
        signal, piggybacked on the membership plumbing): each opaque key
        token in ``bump`` increments ``server``'s per-key counter, each
        token in ``want`` reads it (missing -> 0).  Returns the touched
        tokens' current counts.  Gateways push a bump to every ring
        member on put/delete and pull the fleet max to validate cached
        responses, so any gateway's write invalidates every gateway's
        response cache."""
        ...

    def virtual_time(self) -> float: ...

    def close(self) -> None: ...


class _Server:
    """One storage server: payload blocks + a replicated metadata directory.

    Resident blocks are read-only ndarrays, or ``codec.Encoded`` blobs
    when the hosting process runs with at-rest compression.  When the
    socket server attaches a shared-memory ``arena``, ndarray blocks
    live inside it (copied in at store time, or promoted on first shm
    fetch) so co-located clients can read them without a socket payload.
    """

    def __init__(self, sid: int) -> None:
        self.sid = sid
        self._blocks: dict[tuple, object] = {}  # ndarray | codec.Encoded
        self._meta: dict[RegionKey, dict[tuple, tuple[BoundingBox, object]]] = {}
        self._lock = threading.Lock()
        self.arena = None  # optional shm.ShmArena, set by the socket server
        # blocks whose resident ndarray is an arena view: reads go through
        # _current_locked so a block the arena evicted under pressure is
        # re-homed onto the heap from the arena's saved copy (never lost,
        # never read through a recycled slot)
        self._in_arena: set[tuple] = set()
        # fleet-wide write-generation table (opaque key token -> count),
        # gossiped by the ``gen`` transport op: gateways bump it on every
        # put/delete and response caches validate against the fleet max,
        # so one gateway's write invalidates every gateway's cache.  It
        # survives clear() deliberately — a purged shard must not roll
        # a key's generation back below what clients already observed.
        self._gens: dict[str, int] = {}
        self._spares = copies.Spares()

    def gen(self, bump=None, want=None) -> dict[str, int]:
        """Bump-and-read the write-generation table: each token in
        ``bump`` increments, each in ``want`` reads (missing -> 0);
        returns the current count for every touched token."""
        with self._lock:
            out: dict[str, int] = {}
            for token in bump or ():
                self._gens[token] = self._gens.get(token, 0) + 1
                out[token] = self._gens[token]
            for token in want or ():
                out.setdefault(token, self._gens.get(token, 0))
            return out

    def store(
        self,
        key: RegionKey,
        block_coord: tuple,
        box: BoundingBox,
        payload,
        *,
        owned: bool = False,
    ) -> None:
        # copy on store: the caller may mutate (or have aliased) its
        # buffer after the put — resident blocks must never share memory
        # with client arrays.  ``owned=True`` skips the copy when the
        # caller hands over a private buffer (the socket server decodes
        # each frame into one; copying it again would double the memory
        # traffic of every replicated put).  Without an arena the copy
        # goes into a buffer an earlier block of its size let go of
        # (``copies.Spares``): never written in place while anything reads
        # it, so a read may hand the block out as it is; an array already
        # in such a buffer is kept as it is (``copies.immutable``).
        if isinstance(payload, np.ndarray):
            heap = self.arena is None
            if not owned and not (heap and copies.immutable(payload)):
                copies.count("put", payload.nbytes)
                payload = self._spares.copy(payload) if heap else np.array(payload, copy=True)
            payload.setflags(write=False)
        with self._lock:
            bk = (key, block_coord)
            if self.arena is not None:
                handle = (self.sid, key, block_coord)
                self.arena.release(handle)  # overwrite frees the old slot
                self._in_arena.discard(bk)
                if isinstance(payload, np.ndarray) and payload.nbytes:
                    adopted = self.arena.place(handle, payload)
                    if adopted is not None:
                        payload = adopted  # arena-resident read-only view
                        self._in_arena.add(bk)
            self._blocks[bk] = payload

    def _current_locked(self, bk: tuple):
        """The live resident object for ``bk``, reclaiming it from the
        arena's eviction ledger first: an LRU-evicted block's bytes were
        copied to the heap by the arena before its slot was recycled, and
        the first read after eviction adopts that copy (the stale arena
        view must never be served once the slot can be reused).  Touches
        the arena's fetch-recency clock otherwise."""
        block = self._blocks[bk]
        if self.arena is not None and bk in self._in_arena:
            raw = self.arena.claim_or_touch((self.sid, bk[0], bk[1]))
            if raw is not None:
                if isinstance(block, np.ndarray):
                    fresh = np.frombuffer(raw, dtype=block.dtype.base, count=block.size)
                    block = fresh.reshape(block.shape)
                self._blocks[bk] = block
                self._in_arena.discard(bk)
        return block

    def fetch(self, key: RegionKey, block_coord: tuple) -> np.ndarray:
        with self._lock:
            block = self._current_locked((key, block_coord))
        if not isinstance(block, np.ndarray):
            return block.decode()  # at-rest Encoded: read-only (frombuffer over bytes)
        # read-only view: in-process clients cannot mutate the store
        # through the returned array (its base is non-writable, so even
        # setflags cannot re-enable writes)
        return block.view()

    def fetch_resident(self, key: RegionKey, block_coord: tuple):
        """The resident object itself (ndarray or ``Encoded``) — lets the
        socket server pass an at-rest blob to a codec-capable client
        without a decode/re-encode round."""
        with self._lock:
            return self._current_locked((key, block_coord))

    def arena_ref(self, key: RegionKey, block_coord: tuple):
        """``(array header, offset, nbytes)`` of the block's arena slot,
        promoting a heap-resident ndarray into the arena on first shm
        fetch.  ``None`` when the block cannot be shm-served (no arena,
        arena full, empty block, or at-rest ``Encoded``) — the caller
        falls back to a socket payload.  Raises ``KeyError`` for a
        missing block, matching ``fetch``."""
        if self.arena is None:
            return None
        with self._lock:
            bk = (key, block_coord)
            block = self._current_locked(bk)
            if not isinstance(block, np.ndarray) or block.nbytes == 0:
                return None
            handle = (self.sid, key, block_coord)
            slot = self.arena.locate(handle)
            if slot is None:
                adopted = self.arena.place(handle, block)
                if adopted is None:
                    return None
                self._blocks[bk] = adopted
                self._in_arena.add(bk)
                slot = self.arena.locate(handle)
            meta = {"shape": list(block.shape), "dtype": str(block.dtype)}
            return meta, slot[0], slot[1]

    def put_meta(
        self, key: RegionKey, block_coord: tuple, box: BoundingBox, home: int | Sequence[int]
    ) -> None:
        with self._lock:
            self._meta.setdefault(key, {})[block_coord] = (box, home)

    def lookup(self, key: RegionKey) -> dict[tuple, tuple[BoundingBox, object]]:
        with self._lock:
            return dict(self._meta.get(key, {}))

    def keys(self) -> list[RegionKey]:
        with self._lock:
            return list(self._meta)

    def drop(self, key: RegionKey) -> None:
        with self._lock:
            self._meta.pop(key, None)
            for bk in [bk for bk in self._blocks if bk[0] == key]:
                self._blocks.pop(bk, None)
                self._in_arena.discard(bk)
                if self.arena is not None:
                    self.arena.release((self.sid, bk[0], bk[1]))

    def drop_block(self, key: RegionKey, block_coord: tuple) -> None:
        """Remove ONE block's payload and directory entry (put rollback:
        a failed put must not leave orphaned bytes or phantom entries)."""
        with self._lock:
            self._blocks.pop((key, block_coord), None)
            self._in_arena.discard((key, block_coord))
            if self.arena is not None:
                self.arena.release((self.sid, key, block_coord))
            meta = self._meta.get(key)
            if meta is not None:
                meta.pop(block_coord, None)
                if not meta:
                    self._meta.pop(key, None)

    def clear(self) -> None:
        """Purge everything this shard holds — the terminal step of a
        fleet ``leave`` after the rebalance sweep drained it (payload,
        directory, and arena slots all go; the shard object stays usable
        in case the same sid later rejoins)."""
        with self._lock:
            if self.arena is not None:
                for bk in self._blocks:
                    self.arena.release((self.sid, bk[0], bk[1]))
            self._blocks.clear()
            self._meta.clear()
            self._in_arena.clear()

    @property
    def payload_bytes(self) -> int:
        with self._lock:
            return sum(b.nbytes for b in self._blocks.values())


# Directory entries are small fixed-size records (key hash, coords, box,
# home id); both transports charge this nominal size per metadata message.
META_MSG_BYTES = 64


class InProcTransport:
    """In-process Transport: local ``_Server`` shards + byte accounting.

    The RDMA stand-in.  ``link_bandwidth`` (bytes/s) and ``latency`` (s)
    feed a *virtual time* model used by benchmarks (no sleeping): each
    message advances a per-endpoint clock, and aggregate throughput is
    bytes / max(clock).  A fetch returns a read-only view of the resident
    block, which is never written in place (``shares_blocks``): a read
    covered by one block may return that view without a copy.
    """

    shares_blocks = True

    def __init__(self, num_servers: int, link_bandwidth: float = 6.0e9, latency: float = 2e-6):
        self.num_servers = int(num_servers)
        self.stats = TransportStats()
        self.link_bandwidth = link_bandwidth
        self.latency = latency
        self.servers = [_Server(i) for i in range(self.num_servers)]
        self._clock = [0.0] * self.num_servers
        self._lock = threading.Lock()
        self._removed: set[int] = set()  # sids that left the fleet
        self._view: dict | None = None  # adopted RingView JSON (highest epoch)

    # -- elastic membership --------------------------------------------------------
    def _check_removed(self, server: int) -> None:
        with self._lock:
            gone = server in self._removed
        if gone:
            raise TransportError(f"server {server} has left the fleet")

    def add_endpoint(self, endpoint=None, *, sid: "int | None" = None) -> int:
        """Grow the fleet by one shard (``endpoint`` is ignored in-proc;
        it mirrors the socket transport's signature).  Reviving a
        previously-removed ``sid`` reuses its shard object."""
        with self._lock:
            if sid is not None and sid in self._removed:
                self._removed.discard(sid)
                return sid
            if sid is None:
                sid = len(self.servers)
            while len(self.servers) <= sid:
                self.servers.append(_Server(len(self.servers)))
                self._clock.append(0.0)
            self.num_servers = len(self.servers)
            self._removed.discard(sid)
            return sid

    def remove_endpoint(self, sid: int) -> None:
        """Mark ``sid`` unreachable (the in-proc stand-in for tearing
        down a connection): subsequent ops raise TransportError."""
        with self._lock:
            self._removed.add(sid)

    def reset_liveness(self, server: int) -> None:
        """Forget any cached unreachability for ``server`` (probe-on-
        epoch-bump: a rejoining sid must not be served stale answers)."""
        with self._lock:
            self._removed.discard(server)

    def known_servers(self) -> list[int]:
        """Every sid a message could still reach — ring members AND
        draining (departed-but-unpurged) shards."""
        with self._lock:
            return [i for i in range(len(self.servers)) if i not in self._removed]

    def alive(self, server: int) -> bool:
        with self._lock:
            return server not in self._removed

    def _adopt_view(self, view: "dict | None") -> "dict | None":
        with self._lock:
            if view is not None and (
                self._view is None or int(view["epoch"]) > int(self._view["epoch"])
            ):
                self._view = dict(view)
            return None if self._view is None else dict(self._view)

    def join(self, server: int, sid: int, view: dict) -> "dict | None":
        self._check_removed(server)
        self._account(server, META_MSG_BYTES, "meta")
        return self._adopt_view(view)

    def leave(self, server: int, sid: int, view: dict, purge: bool = False) -> "dict | None":
        self._check_removed(server)
        self._account(server, META_MSG_BYTES, "meta")
        out = self._adopt_view(view)
        if purge and 0 <= sid < len(self.servers):
            self.servers[sid].clear()
        return out

    def epoch(self, server: int) -> "dict | None":
        self._check_removed(server)
        return self._adopt_view(None)

    def gen(self, server: int, bump=None, want=None) -> dict:
        self._check_removed(server)
        self._account(server, META_MSG_BYTES, "meta")
        return self.servers[server].gen(bump, want)

    # -- accounting ---------------------------------------------------------------
    def _account(self, server: int, nbytes: int, op: str) -> None:
        # in-process moves are never compressed: wire bytes == raw bytes
        if op == "put":
            self.stats.add(puts=1, bytes_put=nbytes, bytes_put_raw=nbytes)
        elif op == "get":
            self.stats.add(gets=1, bytes_get=nbytes, bytes_get_raw=nbytes)
        else:
            self.stats.add(meta_msgs=1, bytes_meta=nbytes)
        with self._lock:  # _lock guards the virtual clock, stats guard themselves
            self._clock[server] += self.latency + nbytes / self.link_bandwidth

    # -- Transport message API -----------------------------------------------------
    def store(self, server, key, block_coord, box, payload) -> None:
        self._check_removed(server)
        self.servers[server].store(key, block_coord, box, payload)
        self._account(server, payload.nbytes, "put")

    def fetch(self, server, key, block_coord) -> np.ndarray:
        self._check_removed(server)
        block = self.servers[server].fetch(key, block_coord)
        self._account(server, block.nbytes, "get")
        return block

    def fetch_many(self, server, requests) -> list[np.ndarray]:
        self._check_removed(server)
        if not requests:
            return []
        shard = self.servers[server]
        blocks = [shard.fetch(key, coord) for key, coord in requests]
        # one message: one latency charge, one round-trip in the stats
        self._account(server, sum(b.nbytes for b in blocks), "get")
        return blocks

    def put_meta(self, server, key, block_coord, box, home) -> None:
        self.servers[server].put_meta(key, block_coord, box, home)
        if server not in decode_homes(home):
            # servers holding the payload learn the entry for free
            self._account(server, META_MSG_BYTES, "meta")

    def put_meta_batch(self, server, entries) -> list[tuple]:
        shard = self.servers[server]
        existing: dict[RegionKey, dict] = {}
        had: list[tuple] = []
        for key, block_coord, box, home in entries:
            if key not in existing:
                existing[key] = shard.lookup(key)
            if tuple(block_coord) in existing[key]:
                had.append(tuple(block_coord))
            self.put_meta(server, key, block_coord, box, home)
        return had

    def lookup(self, server, key) -> dict[tuple, tuple[BoundingBox, int]]:
        self._check_removed(server)
        return self.servers[server].lookup(key)

    def keys(self, server) -> list[RegionKey]:
        self._check_removed(server)
        return self.servers[server].keys()

    def drop(self, server, key) -> None:
        self.servers[server].drop(key)

    def drop_block(self, server, key, block_coord) -> None:
        self.servers[server].drop_block(key, block_coord)
        self._account(server, META_MSG_BYTES, "meta")

    def payload_bytes(self, server) -> int:
        return self.servers[server].payload_bytes

    # -- virtual time ---------------------------------------------------------------
    def virtual_time(self) -> float:
        with self._lock:
            return max(self._clock) if self._clock else 0.0

    def reset(self) -> None:
        with self._lock:
            self.stats.reset()
            self._clock = [0.0] * len(self._clock)

    def close(self) -> None:
        pass


class DMSStats:
    """Availability accounting for the replicated routing layer.

    Lock-guarded like :class:`TransportStats`/``GatewayStats``: gateway
    workers bump these concurrently, and ``storage_stats()`` snapshots
    them through :meth:`as_dict` under the same internal lock.
    """

    _FIELDS = (
        "failover_fetches",   # blocks served by a non-primary replica (fault-driven)
        "balanced_fetches",   # blocks served by a non-primary replica (load rotation)
        "failed_servers",     # TransportErrors that rerouted a fetch group / put replica
        "empty_reroutes",     # blocks rerouted past a reachable-but-dataless replica
        "directory_retries",  # directory lookups retried past a dead/empty server
        "directory_repairs",  # coverage holes healed by a cross-directory union
        "meta_broadcast_skips",  # put_meta broadcasts dropped (dead server, R > 1)
        "delete_skips",       # best-effort drops skipped on unreachable servers
        "put_failovers",      # blocks re-homed off their ideal replica ring on put
        "put_rollbacks",      # blocks dropped by a failed put's best-effort rollback
        "repaired_blocks",    # payload copies re-replicated by repair() sweeps
        "repair_meta_fixes",  # directories re-filled by repair() sweeps
        "lost_blocks",        # repair() found blocks with no surviving replica
        "rebalanced_blocks",  # blocks migrated onto their ideal epoch-N slot
        "rebalance_copies",   # payload copies added by rebalance() sweeps
        "rebalance_trims",    # stale off-slot copies dropped by rebalance()
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()
        for f in self._FIELDS:
            setattr(self, f, 0)

    def add(self, **deltas: int) -> None:
        """Atomically bump several counters (one lock acquisition)."""
        with self._lock:
            for name, delta in deltas.items():
                if name not in self._FIELDS:
                    raise AttributeError(f"unknown DMS counter {name!r}")
                setattr(self, name, getattr(self, name) + delta)

    def reset(self) -> None:
        with self._lock:
            for f in self._FIELDS:
                setattr(self, f, 0)

    def as_dict(self) -> dict:
        """Consistent snapshot of every counter (taken under the lock)."""
        with self._lock:
            return {f: getattr(self, f) for f in self._FIELDS}


class DistributedMemoryStorage:
    """The ``DMS`` global storage backend (StorageBackend protocol).

    ``replication=R`` (default 1) writes every payload block to its home
    server and the next ``R-1`` servers along the SFC virtual-domain
    ring; reads fail over between replicas on :class:`TransportError`, so
    any ``R-1`` simultaneous server deaths cause zero failed reads.
    Writes fail over too: a put skips unreachable replicas (the
    transport's liveness cache fails fast) and re-homes each block onto
    the next live servers along the ring, so every block still lands on
    R *distinct live* processes while any server is up — a put only
    raises when NO replica of some block can be written, and a failed
    put best-effort drops the blocks it already stored (no orphaned
    payload bytes, no phantom directory entries).  A degraded write
    (fewer than R live failure domains) is healed by :meth:`repair`, the
    anti-entropy sweep that re-replicates under-covered blocks and
    re-fills the directory of a server that rejoined empty —
    :meth:`start_auto_repair` runs it on a background interval.  Healthy
    reads rotate over live replicas (``read_balance``, on by default) so
    a hot key's fetch load spreads instead of pinning its primary.
    ``self.stats`` (:class:`DMSStats`) accounts all of it.
    """

    def __init__(
        self,
        domain: BoundingBox,
        block_shape: Iterable[int],
        num_servers: int | None = None,
        *,
        name: str = "DMS",
        transport: Transport | None = None,
        replication: int = 1,
        read_balance: bool = True,
        membership: RingView | None = None,
    ) -> None:
        self.name = name
        self.domain = domain
        self.block_shape = tuple(int(b) for b in block_shape)
        if len(self.block_shape) != domain.rank:
            raise ValueError("block_shape rank != domain rank")
        # num_servers defaults from the transport (or to 4 without one);
        # an *explicit* count must agree with the transport's fleet size
        self.transport: Transport = transport or InProcTransport(
            4 if num_servers is None else int(num_servers)
        )
        if (
            transport is not None
            and num_servers is not None
            and int(num_servers) != self.transport.num_servers
        ):
            raise ValueError(
                f"num_servers={num_servers} != transport.num_servers="
                f"{self.transport.num_servers}"
            )
        # the epoch'd ring is the single source of placement truth: the
        # genesis view reproduces the legacy frozen range partition
        # bit-exactly, so a never-resized fleet sees zero change.  The
        # reference is swapped whole on every membership change (readers
        # snapshot it once per operation; no lock needed).
        self._ring: RingView = membership or RingView.genesis(self.transport.num_servers)
        self.replication = int(replication)
        if not 1 <= self.replication <= len(self._ring.servers):
            raise ValueError(
                f"replication={replication} must be in [1, num_servers="
                f"{len(self._ring.servers)}]"
            )
        self.read_balance = bool(read_balance)
        self.stats = DMSStats()
        self._dir_rotor = itertools.count()  # rotating directory start
        self._read_rotor = itertools.count()  # per-block replica rotation
        self._repair_thread: threading.Thread | None = None
        self._repair_stop = threading.Event()
        self.rebalancing = False  # a paced sweep is in flight
        self._last_rebalance: dict | None = None
        # --- virtual-domain construction (paper Fig. 9) ---
        self._grid = tuple(
            -(-s // b) for s, b in zip(domain.shape, self.block_shape)
        )  # ceil-div block counts per dim
        order = sfc_order_for(max(self._grid))
        keys = sorted(
            sfc_index(order, coord) for coord in np.ndindex(*self._grid)
        )
        self._sfc_order = order
        # compaction: sfc key -> contiguous virtual rank
        self._virtual_rank = {k: i for i, k in enumerate(keys)}
        self._virtual_size = len(keys)

    @property
    def num_servers(self) -> int:
        """Live fleet size under the CURRENT epoch (elastic — grows on
        :meth:`add_server`, shrinks on :meth:`remove_server`)."""
        return len(self._ring.servers)

    @property
    def membership(self) -> RingView:
        """The current epoch'd ring view (immutable snapshot)."""
        return self._ring

    @property
    def epoch(self) -> int:
        return self._ring.epoch

    @property
    def _servers(self) -> list[_Server]:
        """Local shard objects — only meaningful for in-process transports
        (tests and white-box introspection; network transports have no
        local servers)."""
        servers = getattr(self.transport, "servers", None)
        if servers is None:
            raise AttributeError(
                f"{self.name}: transport {type(self.transport).__name__} has no local servers"
            )
        return servers

    # -- routing ------------------------------------------------------------------
    def _block_coord(self, point: tuple[int, ...]) -> tuple[int, ...]:
        return tuple(
            (p - l) // b for p, l, b in zip(point, self.domain.lo, self.block_shape)
        )

    def _rank_of(self, block_coord: tuple[int, ...]) -> int:
        return self._virtual_rank[sfc_index(self._sfc_order, block_coord)]

    def home_server(self, block_coord: tuple[int, ...]) -> int:
        """SFC key -> virtual rank -> owning arc of the current ring
        epoch (the genesis epoch is bit-identical to the legacy
        ``(rank * N) // V`` range partition)."""
        return self._ring.owner(self._rank_of(block_coord), self._virtual_size)

    def replica_servers(self, block_coord: tuple[int, ...]) -> tuple[int, ...]:
        """The block's home plus the next ``replication - 1`` servers
        along the SFC virtual-domain ring (primary first), skipping
        servers co-located with an already-chosen replica.

        Co-location is read off the transport's endpoint table when it
        has one (shards packed onto one process share its fate — R-way
        replication must survive R-1 HOST deaths, not merely R-1 shard
        ids); transports without endpoints treat every server as its own
        failure domain.  When there are fewer distinct domains than R,
        the remainder fills in plain ring order (better a co-located
        replica than none).
        """
        home = self.home_server(block_coord)
        if self.replication == 1:
            return (home,)
        return tuple(self._fill_ring(block_coord, [], lambda sid: True))

    def _fill_ring(self, block_coord: tuple, chosen: list[int], take) -> list[int]:
        """THE replica placement walk, shared by ideal placement
        (:meth:`replica_servers`), write failover and repair: extend
        ``chosen`` along the SFC ring from the block's home until
        ``replication`` members — servers in distinct failure domains
        first, co-located fill-ins second (better a co-located replica
        than none).  ``take(sid)`` attempts to claim a candidate (e.g.
        actually storing the payload there) and returns success."""
        used = {self._failure_domain(s) for s in chosen}
        for colocate_ok in (False, True):
            for sid in self._ring_order(block_coord):
                if len(chosen) >= self.replication:
                    return chosen
                if sid in chosen:
                    continue
                if not colocate_ok and self._failure_domain(sid) in used:
                    continue
                if take(sid):
                    chosen.append(sid)
                    used.add(self._failure_domain(sid))
        return chosen

    def _failure_domain(self, sid: int):
        """Servers sharing an endpoint (one process hosting several
        shards) share its fate; transports without an endpoint table
        treat every server as its own failure domain."""
        endpoints = getattr(self.transport, "endpoints", None)
        return sid if endpoints is None else endpoints[sid]

    def _ring_order(self, block_coord: tuple[int, ...]) -> list[int]:
        return self._ring.walk(self._rank_of(block_coord), self._virtual_size)

    def _scan_ids(self) -> list[int]:
        """Sids worth scanning in repair/rebalance sweeps: the current
        ring members PLUS any still-reachable departed shards (a leave
        is drained by rebalance before its endpoint is torn down, so
        departed servers keep serving their blocks until migrated)."""
        ids = list(self._ring.servers)
        known = getattr(self.transport, "known_servers", None)
        if known is not None:
            have = set(ids)
            ids.extend(s for s in known() if s not in have)
        return ids

    # -- availability helpers -------------------------------------------------------
    def _alive(self, server: int) -> bool:
        """Transport liveness-cache answer; optimistic without one."""
        alive = getattr(self.transport, "alive", None)
        return True if alive is None else bool(alive(server))

    def _directory_order(self) -> list[int]:
        """Every server id, start rotated per call (directory load
        spreads over the everywhere-replicated directories, and no single
        server — least of all server 0 — is a read SPOF), with
        liveness-cached-dead servers tried last (the cache may be stale,
        so they are never skipped outright)."""
        servers = self._ring.servers
        n = len(servers)
        start = next(self._dir_rotor) % n
        order = [servers[(start + i) % n] for i in range(n)]
        return sorted(order, key=lambda s: not self._alive(s))  # stable

    def _count(self, field: str, n: int = 1) -> None:
        self.stats.add(**{field: n})

    def _lookup_any(self, key: RegionKey) -> dict[tuple, tuple[BoundingBox, object]]:
        """First NON-EMPTY directory answer over the rotated order.

        An empty answer is only trusted once a SECOND reachable server
        confirms it: a crashed server restarted on the same port rejoins
        with an empty directory, and its answer must not shadow the full
        directories the healthy servers still hold.  (Two simultaneous
        empty rejoins exceed the single-fault model; truly-missing keys
        pay 2 lookups instead of 1 — the miss path, not the hot path.)
        At replication=1 a single empty answer suffices: the meta
        broadcast is all-or-fail there, so every directory is strictly
        consistent and the store was never asked for availability —
        misses keep their exact single-lookup cost.
        """
        want_empty = 2 if self.replication > 1 else 1
        last: TransportError | None = None
        empties = 0
        empty = None
        for sid in self._directory_order():
            try:
                found = self.transport.lookup(sid, key)
            except TransportError as e:
                self._count("directory_retries")
                last = e
                continue
            if found:
                return found
            empties += 1
            empty = found
            if empties >= want_empty:
                return empty
        if empty is not None:
            return empty  # every reachable directory agrees: truly empty
        raise TransportError(
            f"{self.name}: no directory server reachable for {key} "
            f"(all {self.num_servers} down)"
        ) from last

    def _union2(self, fn, merge, what: str) -> None:
        """Merge ``fn(sid)`` answers from TWO reachable directories.

        One stale (rejoined) server's partial answer can neither hide
        entries nor shrink extents, because the second (healthy)
        directory contributes the full set — the same single-fault model
        the replica failover defends.  At replication=1 a single answer
        suffices (today's cost: the store was never asked for
        availability, and every directory is strictly consistent because
        the meta broadcast is all-or-fail).  Raises
        :class:`TransportError` when no directory is reachable at all.
        """
        want = 2 if self.replication > 1 else 1
        last: TransportError | None = None
        reachable = 0
        for sid in self._directory_order():
            try:
                found = fn(sid)
            except TransportError as e:
                self._count("directory_retries")
                last = e
                continue
            merge(found)
            reachable += 1
            if reachable >= want:
                return
        if not reachable:
            raise TransportError(
                f"{self.name}: no directory server reachable{what} "
                f"(all {self.num_servers} down)"
            ) from last

    def _broadcast(self, fn, skip_stat: str, what: str) -> None:
        """Run ``fn(sid)`` on EVERY server (writes: meta broadcast,
        drops).  At replication=1 any failure propagates — today's
        semantics; with replication a dead server is skipped (counted in
        ``skip_stat``) as long as some server acknowledged."""
        acked = 0
        last: TransportError | None = None
        servers = self._ring.servers
        for sid in servers:
            try:
                fn(sid)
                acked += 1
            except TransportError as e:
                if self.replication == 1:
                    raise
                self._count(skip_stat)
                last = e
        if not acked:
            raise TransportError(
                f"{self.name}: {what} reached no server "
                f"(all {len(servers)} down)"
            ) from last

    def _keys_any(self) -> list[RegionKey]:
        seen: dict[RegionKey, None] = {}

        def merge(found: list[RegionKey]) -> None:
            for k in found:
                seen.setdefault(k, None)

        self._union2(lambda sid: self.transport.keys(sid), merge, "")
        return list(seen)

    def _lookup_union2(self, key: RegionKey) -> dict[tuple, tuple[BoundingBox, object]]:
        union: dict[tuple, tuple[BoundingBox, object]] = {}
        self._union2(
            lambda sid: self.transport.lookup(sid, key), union.update, f" for {key}"
        )
        return union

    def _blocks_overlapping(self, box: BoundingBox) -> list[tuple[tuple[int, ...], BoundingBox]]:
        box = box.intersect(self.domain)
        lo_blk = self._block_coord(tuple(box.lo))
        hi_blk = self._block_coord(tuple(c - 1 for c in box.hi)) if not box.is_empty else lo_blk
        out = []
        for coord in np.ndindex(*[h - l + 1 for l, h in zip(lo_blk, hi_blk)]):
            bc = tuple(l + c for l, c in zip(lo_blk, coord))
            blo = tuple(
                dl + c * b for dl, c, b in zip(self.domain.lo, bc, self.block_shape)
            )
            bhi = tuple(
                min(dl + (c + 1) * b, dh)
                for dl, dh, c, b in zip(self.domain.lo, self.domain.hi, bc, self.block_shape)
            )
            blk_box = BoundingBox(blo, bhi, box.t_lo, box.t_hi)
            if blk_box.intersects(box):
                out.append((bc, blk_box))
        return out

    # -- StorageBackend protocol -----------------------------------------------------
    def put(self, key: RegionKey, bb: BoundingBox, array: np.ndarray) -> None:
        """Store the payload with write-path failover.

        Each block is stored on its ideal replica ring when every member
        is live; unreachable replicas (liveness-cache fast path, or a
        :class:`TransportError` on the store itself) are skipped and the
        block is re-homed onto the next live servers along the SFC ring,
        so it still lands on ``R`` *distinct live* failure domains while
        the fleet has that many.  The directory ``homes`` entry records
        the ACTUAL placement.  The put raises only when some block can
        be written to no replica at all (or, at replication=1, when the
        strictly-consistent metadata broadcast fails) — and then it
        best-effort drops the blocks and directory entries it INTRODUCED
        (never an existing key's previous incarnation), so a failed put
        never leaks orphaned payload bytes.  While a profiler records, the
        put is the span ``dms.put`` (``repro_torch.spans``).
        """
        with spans.span("dms.put"):
            self._put(key, bb, array)

    def _put(self, key: RegionKey, bb: BoundingBox, array: np.ndarray) -> None:
        array = np.asarray(array)
        if tuple(array.shape)[: bb.rank] != bb.shape:
            raise ValueError(f"payload shape {array.shape} != bb shape {bb.shape}")
        meta: list[tuple[RegionKey, tuple, BoundingBox, object]] = []
        placed: list[tuple[int, tuple]] = []  # (server, coord) payload stored
        meta_acked: list[int] = []            # servers whose directory has the batch
        pre_image: list = []                  # coords that pre-existed (1st ack's answer)
        dead: set[int] = set()                # discovered unreachable this put
        try:
            for bc, blk_box in self._blocks_overlapping(bb):
                part = blk_box.intersect(bb)
                if part.is_empty:
                    continue
                view = array[part.local_slices(bb)]
                payload = np.ascontiguousarray(view)
                if payload is not view:
                    copies.count("put", payload.nbytes)
                homes = self._store_replicated(key, bc, part, payload, dead, placed)
                meta.append((key, bc, part, encode_homes(homes)))
            # metadata propagation to every server (cheap, paper S5.4) —
            # batched: one message per server per put, not per block, so a
            # socket transport pays N round-trips instead of blocks x N.
            # With replication the broadcast tolerates dead servers (their
            # directory copy dies with them; any surviving directory
            # answers reads) as long as at least one server acknowledged.
            if meta:
                self._broadcast_meta(key, meta, meta_acked, pre_image)
        except TransportError:
            self._rollback_put(key, placed, meta_acked, [m[1] for m in meta], pre_image)
            raise

    def _try_store(
        self,
        sid: int,
        key: RegionKey,
        bc: tuple,
        part: BoundingBox,
        payload: np.ndarray,
        dead: set[int],
        placed: list[tuple[int, tuple]],
    ) -> bool:
        try:
            self.transport.store(sid, key, bc, part, payload)
        except TransportError:
            dead.add(sid)
            self._count("failed_servers")
            return False
        placed.append((sid, bc))
        return True

    def _store_replicated(
        self,
        key: RegionKey,
        bc: tuple,
        part: BoundingBox,
        payload: np.ndarray,
        dead: set[int],
        placed: list[tuple[int, tuple]],
    ) -> tuple[int, ...]:
        """Store one block on ``replication`` live servers, re-homing
        along the SFC ring past unreachable replicas.  Returns the actual
        homes (ring order, primary first when the primary is live)."""
        ideal = self.replica_servers(bc)
        stored: list[int] = []
        cache_dead: set[int] = set()

        def take(sid: int) -> bool:
            if sid in dead:
                return False
            if not self._alive(sid):
                # liveness-cache fast path: a recently-failed server is
                # skipped without paying a probe or timeout
                cache_dead.add(sid)
                return False
            return self._try_store(sid, key, bc, part, payload, dead, placed)

        self._fill_ring(bc, stored, take)
        if not stored and cache_dead:
            # the cache may be stale for EVERY replica (one blip touched
            # all endpoints): before failing the put, try the cache-dead
            # servers for real — the mirror of the read path's `or live`
            self._fill_ring(
                bc,
                stored,
                lambda sid: sid in cache_dead
                and sid not in dead
                and self._try_store(sid, key, bc, part, payload, dead, placed),
            )
        if not stored:
            raise TransportError(
                f"{self.name}: block {bc} of {key} could not be written to "
                f"ANY server (all {self.num_servers} unreachable)"
            )
        ring_pos = {s: i for i, s in enumerate(self._ring_order(bc))}
        stored.sort(key=ring_pos.__getitem__)  # same order repair() emits
        if tuple(stored) != ideal:
            self._count("put_failovers")
        return tuple(stored)

    def _broadcast_meta(
        self,
        key: RegionKey,
        meta: list[tuple[RegionKey, tuple, BoundingBox, object]],
        acked: list[int],
        pre_image: list,
    ) -> None:
        """put_meta_batch to every server, recording who acked (the
        rollback set) and the FIRST ack's pre-image (which coords already
        had entries — every directory agrees pre-put, so one answer
        stands for all).  Same tolerance as :meth:`_broadcast`:
        all-or-fail at replication=1, best-effort past dead servers
        otherwise."""
        last: TransportError | None = None
        servers = self._ring.servers
        for sid in servers:
            try:
                had = self.transport.put_meta_batch(sid, meta)
            except TransportError as e:
                if self.replication == 1:
                    raise
                self._count("meta_broadcast_skips")
                last = e
                continue
            if not acked:
                pre_image.append(
                    None if had is None else {tuple(c) for c in had}
                )
            acked.append(sid)
        if not acked:
            raise TransportError(
                f"{self.name}: metadata broadcast for {key} reached no server "
                f"(all {len(servers)} down)"
            ) from last

    def _rollback_put(
        self,
        key: RegionKey,
        placed: list[tuple[int, tuple]],
        meta_acked: list[int],
        coords: list[tuple],
        pre_image: list,
    ) -> None:
        """Best-effort undo of a failed put — but ONLY of what this put
        introduced.  Coords the key already had before the put are left
        alone: their old payload may already be overwritten and their
        directory entries replaced on acked servers, so dropping them
        would destroy the previous incarnation — a torn-but-readable key
        beats a destroyed one.  Fresh coords (the common case, and every
        coord of a brand-new key) are dropped wherever this put wrote
        payload or directory entries, so the servers return to their
        pre-put byte counts: no orphaned payloads invisible to the
        directory, no phantom entries pointing at dropped blocks.  When
        the pre-put state is unknowable (transport without a
        ``put_meta_batch`` pre-image and directories already modified),
        nothing is dropped: leak, never destroy."""
        drop_block = getattr(self.transport, "drop_block", None)
        if drop_block is None:
            return  # third-party transport without per-block drop
        if meta_acked:
            # directories were modified: only the broadcast's own
            # pre-image can tell fresh coords from pre-existing ones
            pre = pre_image[0] if pre_image else None
            if pre is None:
                return
        else:
            try:
                pre = set(self._lookup_any(key))  # directories untouched
            except TransportError:
                return
        targets = {(sid, bc) for sid, bc in placed if bc not in pre}
        for sid in meta_acked:
            for bc in coords:
                if bc not in pre:
                    targets.add((sid, bc))
        dropped = 0
        for sid, bc in sorted(targets):
            try:
                drop_block(sid, key, bc)
                dropped += 1
            except (TransportError, KeyError):
                pass  # best-effort: an unreachable server's copy dies with it
        if dropped:
            self._count("put_rollbacks", dropped)

    def _fetch_blocks(
        self, key: RegionKey, blocks: list[tuple[tuple, BoundingBox, tuple[int, ...]]]
    ) -> list[tuple[BoundingBox, np.ndarray]]:
        """Fetch every (coord, box, homes) block with replica failover.

        Scatter-gather: every server's blocks move in one fetch_many
        round-trip instead of one fetch per block (single-block reads
        keep the plain fetch; third-party transports without fetch_many
        also fall back to it).  A TransportError regroups the failed
        server's blocks onto their surviving replicas and retries, so a
        server dying mid-read never fails the read while any replica of
        each block is still up.  A remote KeyError (the server is up but
        the block is gone — a crashed host restarted empty on the same
        port) reroutes per BLOCK, so blocks the server does hold still
        serve from it.

        With ``read_balance`` (the default) the target rotates over the
        LIVE replicas per block instead of pinning ``homes[0]``, so a hot
        key's read load spreads across its replica set; non-primary
        serves on a healthy replica count as ``balanced_fetches``,
        fault-driven ones as ``failover_fetches``.  ``read_balance=False``
        restores strict primary preference.
        """
        fetch_many = getattr(self.transport, "fetch_many", None)
        pieces: list[tuple[BoundingBox, np.ndarray]] = []
        pending = list(blocks)
        dead: set[int] = set()  # TransportError: host unreachable
        missing: set[tuple[int, tuple]] = set()  # (server, coord): data gone there
        while pending:
            groups: dict[int, list[tuple[tuple, BoundingBox, tuple[int, ...]]]] = {}
            for item in pending:
                bc, _, homes = item
                live = [
                    s for s in homes if s not in dead and (s, bc) not in missing
                ]
                if not live:
                    if any((s, bc) in missing for s in homes):
                        # some replica answered and lacked the block:
                        # the data is gone, not merely unreachable
                        raise KeyError(
                            f"{self.name}: block {bc} of {key} missing from "
                            f"every reachable replica {list(homes)} (a crashed "
                            f"server rejoined empty?)"
                        )
                    raise TransportError(
                        f"{self.name}: block {bc} of {key} unreachable — every "
                        f"replica {list(homes)} failed (replication="
                        f"{self.replication}; raise it to survive more faults)"
                    )
                # the transport's liveness cache routes around known-dead
                # hosts without paying a probe; among the cache-live
                # replicas the per-block rotor spreads hot-key load (or
                # sticks to the primary with read_balance=False)
                healthy = [s for s in live if self._alive(s)] or live
                if self.read_balance and len(healthy) > 1:
                    target = healthy[next(self._read_rotor) % len(healthy)]
                else:
                    target = healthy[0]
                groups.setdefault(target, []).append(item)
            pending = []
            for server in sorted(groups):
                items = groups[server]
                try:
                    fetched: list | None = None
                    if fetch_many is not None and len(items) > 1:
                        try:
                            fetched = list(
                                fetch_many(server, [(key, bc) for bc, _, _ in items])
                            )
                        except KeyError:
                            # one absent member poisons the whole gather:
                            # degrade to per-block fetches so only the
                            # genuinely missing blocks fail over
                            fetched = None
                    if fetched is None:
                        fetched = []
                        for bc, _, _ in items:
                            try:
                                fetched.append(self.transport.fetch(server, key, bc))
                            except KeyError:
                                fetched.append(None)
                                missing.add((server, bc))
                                self._count("empty_reroutes")
                except TransportError:
                    dead.add(server)
                    self._count("failed_servers")
                    pending.extend(items)  # pieces not yet appended: no dupes
                    continue
                for (bc, box, homes), blk in zip(items, fetched):
                    if blk is None:
                        pending.append((bc, box, homes))
                    else:
                        if server != homes[0]:
                            # non-primary serve: fault failover when the
                            # primary is dead/dataless, balance rotation
                            # when it was healthy and we spread anyway
                            if (
                                homes[0] in dead
                                or (homes[0], bc) in missing
                                or not self._alive(homes[0])
                            ):
                                self._count("failover_fetches")
                            else:
                                self._count("balanced_fetches")
                        pieces.append((box, blk))
        return pieces

    def get(self, key: RegionKey, roi: BoundingBox) -> np.ndarray:
        """The ROI ``roi`` of ``key``, assembled from its blocks.  Where one
        block of an in-process fleet covers the ROI, the answer is a
        read-only view of that block, which the store never writes in
        place; else a fresh array.  While a profiler records, the read is
        the span ``dms.get`` and its assembly ``dms.assemble``."""
        with spans.span("dms.get"):
            return self._get(key, roi)

    def _assemble(self, pieces, roi: BoundingBox):
        from repro_torch.storage.tiers import _assemble

        with spans.span("dms.assemble"):
            return _assemble(pieces, roi,
                             share=getattr(self.transport, "shares_blocks", False))

    def _get(self, key: RegionKey, roi: BoundingBox) -> np.ndarray:
        # any server's directory can answer the lookup: rotate + fail
        # over instead of pinning server 0 (the old single point of
        # failure for every read on a real fleet)
        directory = self._lookup_any(key)
        if not directory:
            raise KeyError(f"DMS: no data for {key}")
        blocks = [
            (bc, box, decode_homes(homes))
            for bc, (box, homes) in directory.items()
            if box.intersects(roi)
        ]
        pieces = self._fetch_blocks(key, blocks)
        out, covered = self._assemble(pieces, roi)
        if self.replication > 1 and (out is None or covered < roi.volume):
            # the answering directory may have been a rejoined server's
            # partial one (it received only post-rejoin broadcasts):
            # before failing, corroborate with a two-directory union —
            # under the single-fault model at most one directory is
            # stale, so two reachable answers recover the full entry set
            # — and fetch only what the fast lookup missed (the pieces
            # already in hand stay: no double transfer).  Gated on
            # replication > 1: at R=1 an under-covered read keeps
            # today's exact cost (the gateway's window-hole fallback and
            # TieredStore's cross-tier probes raise KeyError routinely
            # and must not pay extra round-trips for availability the
            # store was never asked for)
            union = self._lookup_union2(key)
            have = {bc for bc, _, _ in blocks}
            extra = [
                (bc, box, decode_homes(homes))
                for bc, (box, homes) in union.items()
                if bc not in have and box.intersects(roi)
            ]
            if extra:
                self._count("directory_repairs")
                pieces.extend(self._fetch_blocks(key, extra))
                out, covered = self._assemble(pieces, roi)
        if out is None:
            raise KeyError(f"DMS: {key} has no blocks intersecting {roi}")
        if covered < roi.volume:
            raise KeyError(f"DMS: {key} covers only {covered}/{roi.volume} cells of {roi}")
        return out

    def query(self, namespace: str, name: str) -> list[tuple[RegionKey, BoundingBox]]:
        # directories are everywhere-replicated: any reachable server
        # answers.  Both the key list and the per-key extents union two
        # directories, so a rejoined server's partial directory can
        # neither hide a key nor shrink its reported box (callers like
        # TieredStore._assemble_across_tiers size their reads off it)
        seen: dict[RegionKey, BoundingBox] = {}
        for key in self._keys_any():
            if key.namespace == namespace and key.name == name:
                for box, _ in self._lookup_union2(key).values():
                    seen[key] = box if key not in seen else seen[key].union(box)
        return sorted(seen.items(), key=lambda kv: kv[0])

    def delete(self, key: RegionKey) -> None:
        # with replication, best-effort on every server (an unreachable
        # server's copies usually die with it, and a restarted server
        # comes back empty) as long as SOME server acked; at R=1 a failed
        # drop propagates — today's behavior, and silently leaving the
        # only copy behind would resurrect the key once the server heals
        self._broadcast(
            lambda sid: self.transport.drop(sid, key),
            "delete_skips",
            f"delete of {key}",
        )

    # -- anti-entropy repair ---------------------------------------------------------
    def repair(self) -> dict:
        """One anti-entropy sweep: converge every block back to ``R``
        live copies and every reachable directory back to the full entry
        set.

        Walks the union directory over every reachable server.  A
        recorded replica "holds" a block iff its OWN directory still has
        the entry (payload and directory die together on a crash, and a
        server that rejoined empty on the same port has neither) — so an
        under-replicated block is fetched once from a surviving holder
        and re-stored onto the next live servers along the SFC ring
        (distinct failure domains first) until ``R`` copies exist again.
        Directories that lost entries (the rejoined server's) are
        re-filled with one ``put_meta_batch`` per key per server.  All
        best-effort: a concurrent put wins any race at the directory (at
        worst the next sweep re-converges), and a block with NO surviving
        holder is counted ``lost_blocks`` — replication is availability,
        not durability.

        Returns a report dict: ``scanned`` (block entries examined),
        ``repaired`` (payload copies added), ``meta_fixes`` (per-server
        directory entries re-sent), ``lost`` (blocks beyond healing),
        ``unreachable`` (servers skipped).
        """
        scan = self._scan_ids()
        members = set(self._ring.servers)
        reachable: list[int] = []
        dirs: dict[int, dict[RegionKey, dict]] = {}
        keys: set[RegionKey] = set()
        for sid in scan:
            try:
                ks = self.transport.keys(sid)
            except TransportError:
                continue
            reachable.append(sid)
            dirs[sid] = {}
            keys.update(ks)
        report = {
            "scanned": 0,
            "repaired": 0,
            "meta_fixes": 0,
            "lost": 0,
            "unreachable": len(scan) - len(reachable),
        }
        dead: set[int] = set()
        for key in sorted(keys):
            # union directory for this key over every reachable server
            entries: dict[tuple, tuple[BoundingBox, set[int]]] = {}
            for sid in reachable:
                try:
                    found = self.transport.lookup(sid, key)
                except TransportError:
                    dead.add(sid)
                    continue
                dirs[sid][key] = found
                for bc, (box, h) in found.items():
                    prev = entries.get(bc)
                    homes = prev[1] if prev else set()
                    homes.update(decode_homes(h))
                    entries[bc] = (box, homes)
            final: dict[tuple, tuple[BoundingBox, tuple[int, ...]]] = {}
            for bc, (box, candidates) in sorted(entries.items()):
                report["scanned"] += 1
                ring_pos = {s: i for i, s in enumerate(self._ring_order(bc))}
                # departed-but-draining holders sort after every ring
                # member (they are valid fetch sources, never targets)
                rank_of = lambda s: ring_pos.get(s, len(ring_pos) + s)  # noqa: E731
                holders = sorted(
                    (
                        s
                        for s in candidates
                        if s in dirs and s not in dead and bc in dirs[s].get(key, {})
                    ),
                    key=rank_of,
                )
                homes = list(holders)
                if len(holders) < self.replication and holders:
                    payload = None
                    for src in list(holders):
                        try:
                            payload = self.transport.fetch(src, key, bc)
                            break
                        except (TransportError, KeyError):
                            homes.remove(src)
                    if payload is not None:
                        homes = self._restore_copies(
                            key, bc, box, payload, homes, dead, report
                        )
                if not homes:
                    report["lost"] += 1
                    self._count("lost_blocks")
                    continue
                final[bc] = (box, tuple(sorted(homes, key=rank_of)))
            # directory convergence: re-send the full entry set to every
            # reachable ring member that is missing entries or has stale
            # homes (draining departed servers keep their old directory)
            for sid in reachable:
                if sid in dead or sid not in members:
                    continue
                have = dirs[sid].get(key, {})
                batch = [
                    (key, bc, box, encode_homes(homes))
                    for bc, (box, homes) in sorted(final.items())
                    if bc not in have or decode_homes(have[bc][1]) != homes
                ]
                if not batch:
                    continue
                try:
                    self.transport.put_meta_batch(sid, batch)
                except TransportError:
                    dead.add(sid)
                    continue
                report["meta_fixes"] += len(batch)
        if report["repaired"]:
            self._count("repaired_blocks", report["repaired"])
        if report["meta_fixes"]:
            self._count("repair_meta_fixes", report["meta_fixes"])
        return report

    def _restore_copies(
        self,
        key: RegionKey,
        bc: tuple,
        box: BoundingBox,
        payload: np.ndarray,
        homes: list[int],
        dead: set[int],
        report: dict,
    ) -> list[int]:
        """Store the fetched payload on live non-holders along the ring
        until ``replication`` copies exist (distinct domains first).  A
        liveness-cache-dead candidate is simply skipped — unlike the put
        path there is no try-anyway fallback, because the sweep is
        periodic: a stale cache costs one interval, not a failed op."""

        def take(sid: int) -> bool:
            if sid in dead or not self._alive(sid):
                return False
            try:
                self.transport.store(sid, key, bc, box, payload)
            except TransportError:
                dead.add(sid)
                return False
            report["repaired"] += 1
            return True

        return self._fill_ring(bc, homes, take)

    def start_auto_repair(self, interval: float) -> None:
        """Run :meth:`repair` every ``interval`` seconds on a daemon
        thread until :meth:`stop_auto_repair` / :meth:`close`.  A sweep
        that finds the whole fleet unreachable just waits for the next
        tick."""
        if interval <= 0:
            raise ValueError(f"repair interval must be positive, got {interval}")
        if self._repair_thread is not None:
            raise RuntimeError(f"{self.name}: auto-repair already running")
        self._repair_stop = threading.Event()

        def loop() -> None:
            while not self._repair_stop.wait(interval):
                try:
                    self.repair()
                except TransportError:
                    pass  # fleet-wide outage: retry on the next tick

        self._repair_thread = threading.Thread(
            target=loop, daemon=True, name=f"{self.name}-repair"
        )
        self._repair_thread.start()

    def stop_auto_repair(self) -> None:
        thread = self._repair_thread
        if thread is None:
            return
        self._repair_stop.set()
        thread.join(timeout=10.0)
        self._repair_thread = None

    def close(self) -> None:
        """Stop the repair thread and release transport resources
        (sockets); in-proc transports are a no-op."""
        self.stop_auto_repair()
        self.transport.close()

    # -- elastic membership & rebalancing ---------------------------------------
    def _announce(self, op: str, sid: int, view: dict) -> None:
        """Best-effort push of a new epoch to every ring member: a
        membership change must never block on a dead listener —
        stragglers catch up from any peer via ``epoch`` + adopt-newer."""
        for target in self._ring.servers:
            try:
                if op == "join":
                    self.transport.join(target, sid, view)
                else:
                    self.transport.leave(target, sid, view, False)
            except TransportError:
                continue

    def sync_membership(self) -> RingView:
        """Adopt the newest epoch any reachable ring member holds (a
        fresh client, or a rebalance resuming after a crash, rediscovers
        the fleet from any live server)."""
        best = self._ring
        for sid in list(best.servers):
            try:
                got = self.transport.epoch(sid)
            except TransportError:
                continue
            if got is not None:
                best = adopt_newer(best, RingView.from_json(got))
        self._ring = best
        return best

    @staticmethod
    def _gen_token(key: RegionKey) -> str:
        """Opaque wire token for a key's fleet generation counter."""
        return "\x1f".join(
            (
                key.namespace,
                key.name,
                getattr(key.elem_type, "name", str(key.elem_type)),
                str(key.timestamp),
                str(key.version),
            )
        )

    def push_generation(self, key: RegionKey) -> int:
        """Bump ``key``'s fleet write-generation on every reachable ring
        member (best-effort, like :meth:`_announce`: a write must never
        block on a dead listener) and return the highest count any
        member now holds.  Called by a gateway after a put/delete so
        every *other* gateway's response cache sees the key move."""
        token = self._gen_token(key)
        best = 0
        for sid in self._ring.servers:
            try:
                got = self.transport.gen(sid, bump=[token])
            except TransportError:
                continue
            best = max(best, int(got.get(token, 0)))
        return best

    def pull_generation(self, key: RegionKey) -> int:
        """The fleet-wide write generation of ``key``: the max over every
        reachable ring member (members can lag — a bump may have missed
        a then-dead server — but the member holding the max is also
        bumped by every push, so the max is monotone per write)."""
        token = self._gen_token(key)
        best = 0
        for sid in self._ring.servers:
            try:
                got = self.transport.gen(sid, want=[token])
            except TransportError:
                continue
            best = max(best, int(got.get(token, 0)))
        return best

    def add_server(self, endpoint=None, *, sid: "int | None" = None) -> int:
        """Grow the fleet live: register the endpoint with the
        transport, bump the ring epoch (every incumbent donates an equal
        arc slice to the newcomer — minimal remap), clear any stale-dead
        liveness answer for the sid (a leave/rejoin on the same port
        within the backoff window must be probed, not assumed dead), and
        announce the new view fleet-wide.  Blocks the newcomer now owns
        migrate on the next :meth:`rebalance`; reads keep following the
        directory's recorded homes meanwhile, so nothing fails in
        between.  Returns the new server id."""
        add_ep = getattr(self.transport, "add_endpoint", None)
        if add_ep is not None:
            sid = add_ep(endpoint, sid=sid)
        elif sid is None:
            raise ValueError(
                f"{self.name}: transport {type(self.transport).__name__} cannot "
                f"add endpoints; pass sid= explicitly"
            )
        ring = self._ring.join(sid)
        self._ring = ring  # atomic whole-object swap; readers snapshot per-op
        reset = getattr(self.transport, "reset_liveness", None)
        if reset is not None:
            reset(sid)
        self._announce("join", sid, ring.to_json())
        return int(sid)

    def remove_server(
        self,
        sid: int,
        *,
        rebalance: bool = True,
        pacer: "TokenBucket | None" = None,
        purge: bool = True,
    ) -> dict:
        """Shrink the fleet live.  The sid leaves the ring first (no new
        writes land on it), the new epoch is announced, and a rebalance
        sweep drains its blocks onto the survivors — the departed server
        keeps serving reads for blocks the directory still homes on it
        until each one has migrated, so a paced drain loses no ops.
        Its payload is purged and its endpoint torn down only after a
        CLEAN drain: the sweep completed without losing a block AND no
        reachable directory still homes anything on the sid.  A partial
        migration (an ideal target down mid-sweep) deliberately keeps
        the departed copy recorded so redundancy never shrinks — the
        purge then defers rather than destroy a copy the directory still
        points at; ``report["purged"]`` says which way it went, and
        calling :meth:`remove_server` again (idempotent once the sid has
        left the ring) finishes a deferred drain.  ``rebalance=False``
        defers the whole drain (run :meth:`rebalance` later; the purge
        is skipped too so the data survives).  Shrinking the ring below
        ``replication`` servers is refused — it would silently degrade
        every block below R copies.  Returns the rebalance report."""
        sid = int(sid)
        if sid in self._ring.servers:
            if len(self._ring.servers) - 1 < self.replication:
                raise ValueError(
                    f"{self.name}: removing server {sid} would leave "
                    f"{len(self._ring.servers) - 1} servers for "
                    f"replication={self.replication}; lower replication first"
                )
            ring = self._ring.leave(sid)
            self._ring = ring
            self._announce("leave", sid, ring.to_json())
        # else: the sid already left — a retry finishing a deferred purge
        report: dict = {}
        if rebalance:
            report = self.rebalance(pacer=pacer)
            drained = (
                bool(report["complete"])
                and report["lost"] == 0
                and not self._departed_still_homed(sid)
            )
            report["drained"] = drained
            report["purged"] = False
            if purge and drained:
                try:
                    self.transport.leave(sid, sid, self._ring.to_json(), True)
                except TransportError:
                    pass  # already dead: its bytes died with it
                rm = getattr(self.transport, "remove_endpoint", None)
                if rm is not None:
                    rm(sid)
                report["purged"] = True
        return report

    def _departed_still_homed(self, sid: int) -> bool:
        """True while any reachable directory (the departed shard's own
        included) still records ``sid`` as a home: some block's payload
        may live only there, so purging would destroy the last copy (at
        R=1) or silently drop redundancy below R.  The references clear
        on a later :meth:`rebalance` once the blocked targets return."""
        for src in dict.fromkeys([sid, *self._ring.servers]):
            try:
                for key in self.transport.keys(src):
                    for _bc, (_box, h) in self.transport.lookup(src, key).items():
                        if sid in decode_homes(h):
                            return True
            except TransportError:
                continue
        return False

    def rebalance(
        self,
        *,
        pacer: "TokenBucket | None" = None,
        max_blocks: "int | None" = None,
    ) -> dict:
        """One paced rebalance sweep: migrate every block whose ideal
        placement changed since it was written onto its ideal ring slot
        under the CURRENT epoch.

        Built on the repair() machinery: the union directory is walked,
        a recorded replica "holds" a block iff its own directory still
        has the entry, and per block the sweep (1) stores the payload on
        the ideal servers that lack it, (2) re-broadcasts the directory
        entry with ``homes`` = the ideal set to every ring member, and
        only then (3) trims the now-off-slot copies — so a read at ANY
        point mid-sweep finds directory homes whose servers still hold
        payload (zero failed ops during a drain).  SFC arc donation
        makes the migration minimal: only blocks whose owning arc
        changed hands move, ~K/N per membership change.

        ``pacer`` (a :class:`TokenBucket`) charges one token per
        migrated block, yielding to foreground traffic; ``max_blocks``
        bounds one call (``complete=False`` in the report — call again
        to resume; the sweep is idempotent, so a crash mid-sweep costs
        nothing but re-scanning).  Stale copies are trimmed only once
        the full ideal set holds the block; a partial migration keeps
        the old holders recorded and lets the next sweep finish.
        """
        ring = self._ring
        report = {
            "epoch": ring.epoch,
            "ring_checksum": ring.checksum(),
            "scanned": 0,
            "migrated": 0,
            "copies_added": 0,
            "trimmed": 0,
            "lost": 0,
            "unreachable": 0,
            "paced_wait_s": 0.0,
            "complete": True,
        }
        self.rebalancing = True
        try:
            scan = self._scan_ids()
            members = list(ring.servers)
            member_set = set(members)
            reachable: list[int] = []
            dirs: dict[int, dict[RegionKey, dict]] = {}
            keys: set[RegionKey] = set()
            for sid in scan:
                try:
                    ks = self.transport.keys(sid)
                except TransportError:
                    continue
                reachable.append(sid)
                dirs[sid] = {}
                keys.update(ks)
            report["unreachable"] = len(scan) - len(reachable)
            dead: set[int] = set()
            budget = None if max_blocks is None else int(max_blocks)
            for key in sorted(keys):
                entries: dict[tuple, tuple[BoundingBox, set[int]]] = {}
                for sid in reachable:
                    try:
                        found = self.transport.lookup(sid, key)
                    except TransportError:
                        dead.add(sid)
                        continue
                    dirs[sid][key] = found
                    for bc, (box, h) in found.items():
                        prev = entries.get(bc)
                        homes = prev[1] if prev else set()
                        homes.update(decode_homes(h))
                        entries[bc] = (box, homes)
                changed: list[tuple[tuple, BoundingBox, tuple[int, ...]]] = []
                trims: list[tuple[int, tuple, BoundingBox, tuple[int, ...]]] = []
                for bc, (box, candidates) in sorted(entries.items()):
                    report["scanned"] += 1
                    ideal = self.replica_servers(bc)
                    holders = [
                        s
                        for s in candidates
                        if s in dirs and s not in dead and bc in dirs[s].get(key, {})
                    ]
                    need = [s for s in ideal if s not in holders]
                    stale = [s for s in holders if s not in ideal]
                    if not need and not stale:
                        # payload already ideal; converge any member
                        # directory still recording pre-epoch homes
                        for sid in members:
                            have = dirs.get(sid, {}).get(key, {})
                            if sid in dead or sid not in dirs:
                                continue
                            if bc not in have or decode_homes(have[bc][1]) != ideal:
                                changed.append((bc, box, ideal))
                                break
                        continue
                    if budget is not None and report["migrated"] >= budget:
                        report["complete"] = False
                        continue
                    if not holders:
                        report["lost"] += 1
                        self._count("lost_blocks")
                        continue
                    if pacer is not None:
                        report["paced_wait_s"] += pacer.take(1.0)
                    payload = None
                    sources = [s for s in ideal if s in holders] + [
                        s for s in holders if s not in ideal
                    ]
                    for src in sources:
                        try:
                            payload = self.transport.fetch(src, key, bc)
                            break
                        except (TransportError, KeyError):
                            continue
                    if payload is None:
                        report["lost"] += 1
                        self._count("lost_blocks")
                        continue
                    placed = [s for s in ideal if s in holders]
                    added = 0
                    for dst in need:
                        if dst in dead:
                            continue
                        try:
                            self.transport.store(dst, key, bc, box, payload)
                            placed.append(dst)
                            added += 1
                        except TransportError:
                            dead.add(dst)
                    final = tuple(s for s in ideal if s in placed)
                    report["migrated"] += 1
                    report["copies_added"] += added
                    if len(final) == len(ideal):
                        changed.append((bc, box, final))
                        trims.extend((s, bc, box, final) for s in stale)
                    else:
                        # partial migration (some ideal target is down):
                        # keep every live holder recorded so redundancy
                        # never shrinks; the next sweep finishes the move
                        keep = tuple(dict.fromkeys(list(final) + stale))
                        changed.append((bc, box, keep or tuple(holders)))
                # (2) directory convergence BEFORE any trim: every member
                # must point at servers that hold payload at all times
                if changed:
                    batch = [
                        (key, bc, box, encode_homes(h)) for bc, box, h in changed
                    ]
                    for sid in members:
                        if sid in dead or sid not in dirs:
                            continue
                        try:
                            self.transport.put_meta_batch(sid, batch)
                        except TransportError:
                            dead.add(sid)
                # (3) trim the off-slot copies; drop_block also removes
                # that server's directory entry, so ring members get the
                # entry re-sent (directories stay complete everywhere)
                for s, bc, box, h in trims:
                    try:
                        self.transport.drop_block(s, key, bc)
                        report["trimmed"] += 1
                    except (TransportError, KeyError):
                        continue
                    if s in member_set:
                        try:
                            self.transport.put_meta(s, key, bc, box, encode_homes(h))
                        except TransportError:
                            dead.add(s)
            if report["migrated"] or report["trimmed"]:
                self.stats.add(
                    rebalanced_blocks=report["migrated"],
                    rebalance_copies=report["copies_added"],
                    rebalance_trims=report["trimmed"],
                )
            report["directory_checksums"] = self.directory_checksums()
            agreeing = {
                c for c in report["directory_checksums"].values() if c is not None
            }
            report["directories_agree"] = len(agreeing) <= 1
            self._last_rebalance = report
        finally:
            self.rebalancing = False
        return report

    def directory_checksums(self) -> dict:
        """Canonical digest of each ring member's directory (keys,
        block coords, extents, homes).  When every member answers the
        same checksum the directories agree byte-for-byte — the
        payload/directory-divergence tripwire the rebalance report and
        operator dashboards read."""
        out: dict[int, "str | None"] = {}
        for sid in self._ring.servers:
            try:
                entries = []
                for key in sorted(self.transport.keys(sid)):
                    found = self.transport.lookup(sid, key)
                    for bc, (box, h) in sorted(found.items()):
                        entries.append(
                            [
                                str(key),
                                [int(c) for c in bc],
                                [int(c) for c in box.lo],
                                [int(c) for c in box.hi],
                                list(decode_homes(h)),
                            ]
                        )
                blob = json.dumps(entries, separators=(",", ":"))
                out[sid] = hashlib.sha256(blob.encode()).hexdigest()[:12]
            except TransportError:
                out[sid] = None
        return out

    def rebalance_stats(self) -> dict:
        """Operator snapshot for ``storage_stats()["rebalance"]``: the
        current epoch + ring checksum, whether a sweep is in flight, and
        the last sweep's full report (incl. per-member directory
        checksums captured at its end)."""
        ring = self._ring
        return {
            "epoch": ring.epoch,
            "servers": list(ring.servers),
            "ring_checksum": ring.checksum(),
            "rebalancing": self.rebalancing,
            "last_sweep": self._last_rebalance,
        }

    # -- stats -----------------------------------------------------------------
    def server_load(self, *, by_role: bool = False) -> "list[int] | dict":
        """Payload bytes per server.

        The plain list is PHYSICAL bytes — at ``replication=R`` it
        includes every replica copy, so it measures capacity use (and the
        ~R× write amplification), not SFC partition balance.  With
        ``by_role=True`` the physical bytes are split by directory role:
        ``{"total", "primary", "replica"}`` lists, attributing each
        server's bytes proportionally to the block VOLUMES the union
        directory records it as primary (``homes[0]``) vs replica for —
        exact whenever a server's blocks share one element size (the
        usual case).  Balance checks for the SFC range partition must use
        the ``primary`` view at R > 1.
        """
        ring = self._ring
        cap = max(ring.servers) + 1  # lists stay sid-indexed (sparse after a leave)
        total = [0] * cap
        for s in ring.servers:
            try:
                total[s] = self.transport.payload_bytes(s)
            except TransportError:
                total[s] = 0
        if not by_role:
            return total
        prim_vol = [0] * cap
        repl_vol = [0] * cap
        for key in self._keys_any():
            for bc, (box, h) in self._lookup_union2(key).items():
                homes = decode_homes(h)
                if homes[0] < cap:
                    prim_vol[homes[0]] += box.volume
                for sid in homes[1:]:
                    if sid < cap:
                        repl_vol[sid] += box.volume
        primary = []
        for sid in range(cap):
            vol = prim_vol[sid] + repl_vol[sid]
            primary.append(total[sid] * prim_vol[sid] // vol if vol else 0)
        return {
            "total": total,
            "primary": primary,
            "replica": [t - p for t, p in zip(total, primary)],
        }

    def aggregate_throughput(self) -> float:
        """bytes moved / transport time (paper Fig. 14 reports GB/s).

        In-proc transports answer in virtual time (the paper's modeled
        links); socket transports answer in measured wall time.
        """
        t = self.transport.virtual_time()
        total = self.transport.stats.bytes_put + self.transport.stats.bytes_get
        return total / t if t > 0 else 0.0
