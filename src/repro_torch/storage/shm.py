"""Shared-memory block arena for same-host zero-copy fetches.

The paper's DataSpaces deployment keeps region payloads in RDMA-
registered server memory and ships *descriptors*, not bytes.  This is
the commodity-hardware equivalent: each storage server owns one
``multiprocessing.shared_memory`` segment (the **arena**) and keeps its
resident blocks inside it.  A co-located client maps the same segment
once (the **window**); a fetch reply then carries only ``(offset,
length)`` over the control socket (~50us round-trip) and the client
reads the payload straight out of the mapping — the block bytes never
cross the TCP stream, never get concatenated, and are copied at most
once (zero times with ``zero_copy=True``).

Same-host proof: the segment name alone is not evidence of co-location
(names are not globally unique across hosts).  The server writes a
random 16-byte token at arena offset 0 and sends it in the negotiation
reply; the client attaches, compares, and silently falls back to socket
payloads on any mismatch or attach failure — remote clients keep
working, they just pay the stream copy.

Lifetime rules (RDMA-window semantics):

  * a block's arena slot is valid until that block is dropped or
    overwritten; fetches default to copying out (safe), and
    ``zero_copy=True`` returns a read-only view whose base is the
    mapping — callers own the aliasing hazard;
  * freed slots sit in a short quarantine before reuse so an in-flight
    reader of a just-dropped block sees stale-but-consistent bytes
    rather than a torn rewrite;
  * the server unlinks the segment on clean shutdown; if it is
    SIGKILLed, Python's ``resource_tracker`` in the spawning process
    reclaims the segment (clients therefore *unregister* their attach —
    pre-3.13 ``SharedMemory`` has no ``track=False``).
"""
from __future__ import annotations

import secrets
import threading
import time
from multiprocessing import resource_tracker, shared_memory

import numpy as np

TOKEN_BYTES = 16
_ALIGN = 64  # cache-line align block slots
_QUARANTINE_S = 1.0

# mappings that could not be closed because zero-copy views still alias
# them: keep them referenced so SharedMemory.__del__ never re-raises the
# BufferError as an unraisable warning — the mapping lives until process
# exit, which is exactly what the outstanding views require anyway
_PINNED: list = []


def _close_quiet(shm: shared_memory.SharedMemory) -> None:
    try:
        shm.close()
    except BufferError:
        _PINNED.append(shm)


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class ShmArena:
    """Server-side shared-memory segment holding resident block payloads.

    First-fit free-list allocator over one segment; slots are keyed by
    an opaque hashable ``handle`` (the server uses ``(sid, key,
    coord)``).  All methods are thread-safe.  Under pressure ``place``
    evicts least-recently-fetched residents (their bytes move to a heap
    ledger the owning shard reclaims on its next read) and only returns
    ``None`` when the block doesn't fit even then — callers degrade to
    heap residency + socket payloads, never fail the store.
    """

    def __init__(self, capacity: int, name: str | None = None):
        capacity = max(int(capacity), _ALIGN)
        self._shm = shared_memory.SharedMemory(
            create=True, size=_ALIGN + capacity, name=name
        )
        token = secrets.token_bytes(TOKEN_BYTES)
        self._shm.buf[:TOKEN_BYTES] = token
        self.token = token.hex()
        self.name = self._shm.name
        self.capacity = capacity
        self._lock = threading.Lock()
        # free list: sorted [offset, size]; offsets relative to segment
        self._free: list[list[int]] = [[_ALIGN, capacity]]
        self._used: dict[object, tuple[int, int]] = {}  # handle -> (off, size)
        self._quarantine: list[tuple[float, int, int]] = []  # (free_at, off, size)
        self._closed = False
        # LRU eviction state: fetch-recency clock per resident handle,
        # and the heap ledger holding evicted blocks' bytes until their
        # owning shard reclaims them (lazily, on its next read) — an
        # eviction demotes a block to heap residency, never loses it
        self._recency: dict[object, int] = {}
        self._evicted: dict[object, bytes] = {}
        self._seq = 0
        self.evictions = 0

    # -- allocation ----------------------------------------------------

    def _reclaim_locked(self, now: float) -> None:
        keep = []
        for free_at, off, size in self._quarantine:
            if free_at <= now:
                self._insert_free_locked(off, size)
            else:
                keep.append((free_at, off, size))
        self._quarantine = keep

    def _reclaim_some_locked(self, nbytes: int) -> int | None:
        """Pressure fallback: free quarantined slots oldest-deadline
        first, retrying the allocation after each, so a forced early
        reuse recycles as few still-in-grace slots as possible (an
        in-flight shm reader of a just-freed slot gets the full grace
        window unless its bytes are the only way to satisfy the
        allocation)."""
        for entry in sorted(self._quarantine):
            self._quarantine.remove(entry)
            self._insert_free_locked(entry[1], entry[2])
            got = self._alloc_locked(nbytes)
            if got is not None:
                return got
        return None

    def _insert_free_locked(self, off: int, size: int) -> None:
        free = self._free
        lo, hi = 0, len(free)
        while lo < hi:
            mid = (lo + hi) // 2
            if free[mid][0] < off:
                lo = mid + 1
            else:
                hi = mid
        free.insert(lo, [off, size])
        # coalesce with neighbours
        if lo + 1 < len(free) and free[lo][0] + free[lo][1] == free[lo + 1][0]:
            free[lo][1] += free[lo + 1][1]
            del free[lo + 1]
        if lo > 0 and free[lo - 1][0] + free[lo - 1][1] == free[lo][0]:
            free[lo - 1][1] += free[lo][1]
            del free[lo]

    def _alloc_locked(self, nbytes: int) -> int | None:
        want = _align(nbytes)
        for i, (off, size) in enumerate(self._free):
            if size >= want:
                if size == want:
                    del self._free[i]
                else:
                    self._free[i] = [off + want, size - want]
                return off
        return None

    def place(self, handle, payload) -> np.ndarray | None:
        """Copy ``payload`` (any buffer/ndarray) into the arena under
        ``handle`` and return a read-only ndarray view over the slot, or
        ``None`` when it doesn't fit.  Replaces any existing slot for
        the handle (old slot goes to quarantine)."""
        arr = np.ascontiguousarray(payload)
        nbytes = arr.nbytes
        if nbytes == 0 or nbytes > self.capacity:
            return None
        with self._lock:
            if self._closed:  # checked under _lock: close() races with place()
                return None
            self._release_locked(handle)
            now = time.monotonic()
            self._reclaim_locked(now)
            off = self._alloc_locked(nbytes)
            if off is None:
                # pressure: reclaim quarantined slots (oldest first) and retry
                off = self._reclaim_some_locked(nbytes)
            if off is None:
                # still full: evict cold residents (LRU by fetch recency)
                off = self._evict_locked(nbytes, keep=handle, now=now)
            if off is None:
                return None
            self._used[handle] = (off, nbytes)
            self._seq += 1
            self._recency[handle] = self._seq
            self._evicted.pop(handle, None)  # a re-place supersedes any saved copy
        dst = np.frombuffer(self._shm.buf, dtype=np.uint8, count=nbytes, offset=off)
        try:
            dst[:] = arr.view(np.uint8).reshape(-1)
        except (TypeError, ValueError):
            # extended dtypes refuse the zero-copy uint8 view
            dst[:] = np.frombuffer(arr.tobytes(), dtype=np.uint8)
        view = np.frombuffer(self._shm.buf, dtype=arr.dtype.base, count=arr.size, offset=off)
        view = view.reshape(arr.shape)
        view.setflags(write=False)
        return view

    def _evict_locked(self, nbytes: int, keep, now: float) -> int | None:
        """Evict least-recently-fetched residents until ``nbytes`` fits.
        Each victim's bytes are saved to the heap ledger first (its
        owning shard re-homes them via :meth:`claim_or_touch` on the
        next read), then its slot takes the same quarantine grace as a
        released slot — an in-flight shm reader holding the victim's
        ``(off, nbytes)`` ref must not have the bytes recycled under it.
        The quarantine is drained early (oldest slots first) only as far
        as the allocation demands — the pressure fallback — so a victim
        is reused immediately only when its space is the sole way to
        satisfy the store; the block itself is demoted, never dropped."""
        order = sorted(self._used, key=lambda h: self._recency.get(h, 0))
        for victim in order:
            if victim == keep:
                continue
            off, size = self._used.pop(victim)
            self._evicted[victim] = bytes(self._shm.buf[off : off + size])
            self._recency.pop(victim, None)
            self.evictions += 1
            self._quarantine.append((now + _QUARANTINE_S, off, size))
            got = self._reclaim_some_locked(nbytes)
            if got is not None:
                return got
        return None

    def claim_or_touch(self, handle) -> bytes | None:
        """Either hand back an evicted block's saved bytes (consuming
        the ledger entry — the caller re-homes them on its heap) or, for
        a still-resident block, bump its fetch recency and return
        ``None``.  The shard calls this on every read of an
        arena-resident block, which is what makes the eviction order
        *fetch* recency rather than placement order."""
        with self._lock:
            raw = self._evicted.pop(handle, None)
            if raw is not None:
                return raw
            if handle in self._used:
                self._seq += 1
                self._recency[handle] = self._seq
            return None

    def locate(self, handle) -> tuple[int, int] | None:
        """(offset, nbytes) of a resident block, or ``None``."""
        with self._lock:
            return self._used.get(handle)

    def _release_locked(self, handle) -> None:
        slot = self._used.pop(handle, None)
        self._recency.pop(handle, None)
        self._evicted.pop(handle, None)
        if slot is not None:
            self._quarantine.append((time.monotonic() + _QUARANTINE_S, slot[0], slot[1]))

    def release(self, handle) -> None:
        with self._lock:
            self._release_locked(handle)

    # -- observability / lifecycle ------------------------------------

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return sum(size for _, size in self._used.values())

    def describe(self) -> dict:
        """Negotiation payload for the hello reply."""
        return {"name": self.name, "size": self._shm.size, "token": self.token}

    def close(self, *, unlink: bool = True) -> None:
        with self._lock:
            self._closed = True
            self._used.clear()
            self._recency.clear()
            self._evicted.clear()
        if unlink:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
        # live ndarray views over the mapping (server shutting down with
        # resident blocks) keep it pinned; the unlink above already freed
        # the name — the mapping itself dies with the process
        _close_quiet(self._shm)


class ShmWindow:
    """Client-side read-only mapping of a server's arena."""

    def __init__(self, shm: shared_memory.SharedMemory, token: str):
        self._shm = shm
        self.token = token
        self.name = shm.name

    @classmethod
    def attach(cls, desc: dict) -> "ShmWindow | None":
        """Attach to the arena described by a hello reply; ``None`` when
        the segment is unreachable or the token disproves co-location
        (callers fall back to socket payloads)."""
        try:
            try:
                shm = shared_memory.SharedMemory(name=desc["name"], track=False)
            except TypeError:  # pre-3.13: no track kwarg
                shm = shared_memory.SharedMemory(name=desc["name"])
                try:
                    # the attach registered the segment with OUR
                    # resource tracker, which would unlink the SERVER'S
                    # memory when this process exits — undo that.
                    resource_tracker.unregister(shm._name, "shared_memory")
                except Exception:
                    pass
        except (FileNotFoundError, OSError, ValueError):
            return None
        if bytes(shm.buf[:TOKEN_BYTES]).hex() != desc.get("token"):
            _close_quiet(shm)
            return None
        return cls(shm, desc["token"])

    def read(self, off: int, meta: dict, *, zero_copy: bool = False) -> np.ndarray:
        """Decode the block at ``off`` described by array header
        ``meta``.  Default copies out (safe after the slot is reused);
        ``zero_copy=True`` returns a read-only view into the mapping,
        valid until the block is dropped or overwritten server-side."""
        from repro_torch.storage.codec import _dtype_from_str

        dt = _dtype_from_str(meta["dtype"])
        shape = tuple(meta["shape"])
        n = 1
        for s in shape:
            n *= int(s)
        view = np.frombuffer(self._shm.buf, dtype=dt, count=n, offset=off).reshape(shape)
        if zero_copy:
            view.setflags(write=False)
            return view
        return view.copy()

    def close(self) -> None:
        # if the caller still holds zero-copy views the mapping is
        # pinned instead and persists until process exit
        _close_quiet(self._shm)
