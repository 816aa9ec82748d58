"""High-performance disk storage for data regions (paper S4.2).

An ADIOS-style chunked staging engine extended exactly the way the paper
extends ADIOS:

  (i)  *separated I/O cores*: writers can be dedicated I/O workers coupled
       to compute through queues, instead of every compute core writing
       (co-located);
  (ii) *configurable I/O group sizes*: the cores participating in I/O are
       partitioned into groups of size ``k``; a group enters a write
       session together (synchronizing only within the group) once its
       buffered chunk count reaches ``queue_threshold`` — no cross-group
       synchronization (the paper's 1.13x win over stock single-group
       ADIOS).

Transports:
  * ``posix``      — every chunk becomes its own file, written immediately,
                     no group synchronization (group size effectively 1);
  * ``aggregated`` — chunks buffer per group and flush as one combined file
                     per write session (models MPI_LUSTRE / MPI_AMR
                     staging: fewer, larger I/O requests).

Chunks are raw little-endian payloads with all metadata in a
``manifest.jsonl`` (append-only, crash-tolerant) so a fresh process can
reopen the store — this is what checkpoint restart builds on.

Every operation is accounted in both wall time and a *virtual-time* cost
model (disk bandwidth, per-file open cost, per-member sync cost) so the
benchmark suite can reproduce the paper's Titan experiment shapes on one
box.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import random
import threading
import time
import uuid

import numpy as np

from repro_torch import spans, staging
from repro_torch.core.bbox import BoundingBox
from repro_torch.core.regions import ElementType, RegionKey
from repro_torch.storage import copies


@dataclasses.dataclass
class DiskCostModel:
    """Virtual-time constants (defaults roughly Lustre-on-Titan flavored)."""

    disk_bandwidth: float = 1.2e9  # bytes/s per I/O stream
    file_open_cost: float = 4e-3  # s per file creation
    sync_cost: float = 5e-4  # s per member per group write session
    comm_bandwidth: float = 5.0e9  # bytes/s compute->I/O worker link
    comm_latency: float = 5e-6


@dataclasses.dataclass
class DiskStats:
    chunks_written: int = 0
    files_written: int = 0
    sessions: int = 0
    bytes_written: int = 0
    bytes_read: int = 0
    wall_write_s: float = 0.0
    virtual_io_s: float = 0.0
    virtual_sync_s: float = 0.0
    virtual_comm_s: float = 0.0
    # chunks read by ``get``, and of those the ones read into a spare that an
    # earlier read let go of
    chunk_reads: int = 0
    chunk_reads_reused: int = 0

    @property
    def virtual_total_s(self) -> float:
        return self.virtual_io_s + self.virtual_sync_s + self.virtual_comm_s


def _key_to_json(key: RegionKey) -> dict:
    return {
        "ns": key.namespace,
        "name": key.name,
        "et": int(key.elem_type),
        "ts": key.timestamp,
        "v": key.version,
    }


def _key_from_json(d: dict) -> RegionKey:
    return RegionKey(d["ns"], d["name"], ElementType(d["et"]), d["ts"], d["v"])


def _bb_to_json(bb: BoundingBox) -> dict:
    return {"lo": list(bb.lo), "hi": list(bb.hi), "tlo": bb.t_lo, "thi": bb.t_hi}


def _bb_from_json(d: dict) -> BoundingBox:
    return BoundingBox(tuple(d["lo"]), tuple(d["hi"]), d["tlo"], d["thi"])


@dataclasses.dataclass
class _Chunk:
    key: RegionKey
    bb: BoundingBox
    payload: np.ndarray


@dataclasses.dataclass
class _ManifestEntry:
    key: RegionKey
    bb: BoundingBox
    file: str
    offset: int
    nbytes: int
    shape: tuple[int, ...]
    dtype: str


def _dtype_name(c: _Chunk) -> str:
    """The dtype a chunk's manifest entry records. A ``BFLOAT16`` region is
    recorded as ``"bfloat16"`` whatever numpy type carries its 16-bit words
    (``ml_dtypes.bfloat16``, as the reference writes it, or raw ``uint16``
    words of a ``torch.bfloat16`` tensor), so the two packages' files agree."""
    if c.key.elem_type == ElementType.BFLOAT16:
        if c.payload.dtype.itemsize != 2:
            raise TypeError(f"DISK: a bfloat16 region {c.key} needs 16-bit words, "
                            f"got {c.payload.dtype}")
        return "bfloat16"
    return str(c.payload.dtype)


def _stored_dtype(name: str) -> np.dtype:
    """The numpy dtype a chunk reads back as: a ``"bfloat16"`` chunk as its
    raw 16-bit words (``uint16``; ``view(torch.bfloat16)`` of a tensor of
    them gives the values), so reading needs no ``ml_dtypes``."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _read_into(path: str, e: _ManifestEntry, buf: np.ndarray) -> None:
    """Fill ``buf`` with the chunk's bytes, unbuffered, a read at a time (a
    network file system may return fewer bytes than asked); raises where the
    file ends first, so no byte of an earlier chunk in ``buf`` is handed out."""
    view = memoryview(buf).cast("B")
    with open(path, "rb", buffering=0) as f:
        f.seek(e.offset)
        done = 0
        while done < e.nbytes:
            n = f.readinto(view[done:])
            if not n:
                raise EOFError(f"DISK: {path} ends {done} bytes into the {e.nbytes}-byte "
                               f"chunk at offset {e.offset}")
            done += n


class _IOGroup:
    """Writers sharing one write session (paper: ADIOS group)."""

    def __init__(self, gid: int, store: "DiskStorage") -> None:
        self.gid = gid
        self.store = store
        self.buffer: list[_Chunk] = []
        self.members = 0
        self.lock = threading.Lock()

    def submit(self, chunk: _Chunk) -> None:
        flush_now: list[_Chunk] | None = None
        with self.lock:
            self.buffer.append(chunk)
            if len(self.buffer) >= self.store.queue_threshold:
                flush_now, self.buffer = self.buffer, []
        if flush_now:
            self.store._write_session(self, flush_now)

    def drain(self) -> None:
        with self.lock:
            chunks, self.buffer = self.buffer, []
        if chunks:
            self.store._write_session(self, chunks)


class _IOWorker(threading.Thread):
    """Dedicated I/O core for the *separated* configuration."""

    def __init__(self, wid: int, group: _IOGroup) -> None:
        super().__init__(daemon=True, name=f"io-worker-{wid}")
        self.wid = wid
        self.group = group
        self.q: "queue.Queue[_Chunk | None]" = queue.Queue()

    def run(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                self.group.drain()
                return
            self.group.submit(item)


class DiskStorage:
    """The ``DISK`` global storage backend (StorageBackend protocol)."""

    def __init__(
        self,
        root: str,
        *,
        name: str = "DISK",
        transport: str = "posix",  # posix | aggregated
        io_mode: str = "colocated",  # colocated | separated
        io_group_size: int = 1,
        num_io_workers: int = 0,
        queue_threshold: int = 4,
        distribution: str = "round_robin",  # round_robin | random
        cost_model: DiskCostModel | None = None,
        seed: int = 0,
    ) -> None:
        if transport not in ("posix", "aggregated"):
            raise ValueError(f"unknown transport {transport!r}")
        if io_mode not in ("colocated", "separated"):
            raise ValueError(f"unknown io_mode {io_mode!r}")
        self.name = name
        self.root = root
        self.transport = transport
        self.io_mode = io_mode
        self.io_group_size = max(1, int(io_group_size))
        self.queue_threshold = max(1, int(queue_threshold)) if transport == "aggregated" else 1
        self.distribution = distribution
        self.cost = cost_model or DiskCostModel()
        self.stats = DiskStats()
        self._spares = copies.Spares(keep=4)  # an image of 4 tiles holds 4 RGB reads at once
        self._rng = random.Random(seed)
        self._rr = 0
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)
        self._manifest_path = os.path.join(root, "manifest.jsonl")
        self._manifest_lock = threading.Lock()
        self._index: dict[RegionKey, list[_ManifestEntry]] = self._read_manifest()

        self._workers: list[_IOWorker] = []
        self._groups: list[_IOGroup] = []
        if io_mode == "separated":
            n = max(1, int(num_io_workers))
            n_groups = max(1, n // self.io_group_size)
            self._groups = [_IOGroup(g, self) for g in range(n_groups)]
            for g in self._groups:
                g.members = 0
            for w in range(n):
                grp = self._groups[w % n_groups]
                grp.members += 1
                self._workers.append(_IOWorker(w, grp))
            for w in self._workers:
                w.start()
        else:
            # co-located: every caller is a writer; group per io_group_size slots
            self._colocated_groups: dict[int, _IOGroup] = {}

    # -- manifest ------------------------------------------------------------------
    def _read_manifest(self) -> dict[RegionKey, list[_ManifestEntry]]:
        index: dict[RegionKey, list[_ManifestEntry]] = {}
        if not os.path.exists(self._manifest_path):
            return index
        with open(self._manifest_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                entry = _ManifestEntry(
                    key=_key_from_json(d["key"]),
                    bb=_bb_from_json(d["bb"]),
                    file=d["file"],
                    offset=d["offset"],
                    nbytes=d["nbytes"],
                    shape=tuple(d["shape"]),
                    dtype=d["dtype"],
                )
                index.setdefault(entry.key, []).append(entry)
        return index

    def reload(self) -> None:
        """Re-read the manifest: the chunks that other processes have written
        under this root since it was last read."""
        index = self._read_manifest()
        with self._lock:
            self._index = index

    def _append_manifest(self, entries: list[_ManifestEntry]) -> None:
        with self._manifest_lock:
            with open(self._manifest_path, "a") as f:
                for e in entries:
                    f.write(
                        json.dumps(
                            {
                                "key": _key_to_json(e.key),
                                "bb": _bb_to_json(e.bb),
                                "file": e.file,
                                "offset": e.offset,
                                "nbytes": e.nbytes,
                                "shape": list(e.shape),
                                "dtype": e.dtype,
                            }
                        )
                        + "\n"
                    )
                f.flush()
                os.fsync(f.fileno())

    # -- write path -------------------------------------------------------------------
    def _group_for_caller(self) -> _IOGroup:
        """Co-located: map the calling thread onto an I/O group slot."""
        slot = threading.get_ident() % max(1, self.io_group_size)
        with self._lock:
            if slot not in self._colocated_groups:
                g = _IOGroup(slot, self)
                g.members = self.io_group_size
                self._colocated_groups[slot] = g
            return self._colocated_groups[slot]

    def _pick_worker(self) -> _IOWorker:
        if self.distribution == "random":
            return self._rng.choice(self._workers)
        with self._lock:
            w = self._workers[self._rr % len(self._workers)]
            self._rr += 1
            return w

    def put(self, key: RegionKey, bb: BoundingBox, array: np.ndarray) -> None:
        array = np.ascontiguousarray(array)
        chunk = _Chunk(key, bb, array)
        _dtype_name(chunk)  # refuse a bfloat16 region of other than 16-bit words now
        if self.io_mode == "separated":
            with self._lock:
                self.stats.virtual_comm_s += (
                    self.cost.comm_latency + array.nbytes / self.cost.comm_bandwidth
                )
            self._pick_worker().q.put(chunk)
        elif self.transport == "posix":
            self._write_session(None, [chunk])
        else:
            self._group_for_caller().submit(chunk)

    def _write_session(self, group: _IOGroup | None, chunks: list[_Chunk]) -> None:
        """One (possibly grouped) write session producing a single file."""
        t0 = time.perf_counter()
        fname = f"chunk-{uuid.uuid4().hex}.bin"
        path = os.path.join(self.root, fname)
        entries: list[_ManifestEntry] = []
        offset = 0
        with open(path, "wb") as f:
            for c in chunks:
                raw = c.payload.tobytes()
                f.write(raw)
                entries.append(
                    _ManifestEntry(
                        key=c.key,
                        bb=c.bb,
                        file=fname,
                        offset=offset,
                        nbytes=len(raw),
                        shape=tuple(c.payload.shape),
                        dtype=_dtype_name(c),
                    )
                )
                offset += len(raw)
            f.flush()
            os.fsync(f.fileno())
        self._append_manifest(entries)
        with self._lock:
            for e in entries:
                self._index.setdefault(e.key, []).append(e)
            members = group.members if group is not None else 1
            self.stats.chunks_written += len(chunks)
            self.stats.files_written += 1
            self.stats.sessions += 1
            self.stats.bytes_written += offset
            self.stats.wall_write_s += time.perf_counter() - t0
            self.stats.virtual_io_s += (
                self.cost.file_open_cost + offset / self.cost.disk_bandwidth
            )
            # group members synchronize to enter the session together
            self.stats.virtual_sync_s += self.cost.sync_cost * max(0, members - 1)

    def flush(self) -> None:
        """Drain all buffers (and, in separated mode, quiesce the workers)."""
        if self.io_mode == "separated":
            for w in self._workers:
                w.q.join_thread = None  # no-op, keep interface simple
            for w in self._workers:
                w.q.put(None)
            for w in self._workers:
                w.join()
            # restart workers so the store remains usable
            old = self._workers
            self._workers = []
            for i, w in enumerate(old):
                nw = _IOWorker(i, w.group)
                self._workers.append(nw)
                nw.start()
        else:
            with self._lock:
                groups = list(getattr(self, "_colocated_groups", {}).values())
            for g in groups:
                g.drain()

    def close(self) -> None:
        """Drain buffers and retire the I/O workers for good (flush()
        restarts them so the store stays usable; close() does not)."""
        if self.io_mode == "separated":
            workers, self._workers = self._workers, []
            for w in workers:
                w.q.put(None)
            for w in workers:
                w.join()
        else:
            self.flush()

    # -- read path ---------------------------------------------------------------------
    def get(self, key: RegionKey, roi: BoundingBox) -> np.ndarray:
        """The ROI assembled from the chunks' files. Each chunk is read into a
        spare (``copies.Spares``: page-locked once the process holds a CUDA
        context, reused once every array over it is gone) and handed out
        read-only, so a ROI that one chunk holds is a read-only view of a
        spare. While a profiler records, the read is the span ``disk.get``
        (``repro_torch.spans``)."""
        with spans.span("disk.get"):
            return self._get(key, roi)

    def drop_spares(self) -> None:
        """Let go of the free read spares and give their page-locked memory
        back, as a bulk read that will not come again (a checkpoint restore)
        ends."""
        self._spares.clear()
        staging.empty_host_cache()

    def _read(self, e: _ManifestEntry) -> np.ndarray:
        """One chunk, read-only, as its manifest entry gives it."""
        path = os.path.join(self.root, e.file)
        out, reused = self._spares.fill(e.nbytes, _stored_dtype(e.dtype), e.shape,
                                        lambda buf: _read_into(path, e, buf))
        with self._lock:
            self.stats.bytes_read += e.nbytes
            self.stats.chunk_reads += 1
            self.stats.chunk_reads_reused += reused
        return out

    def _get(self, key: RegionKey, roi: BoundingBox) -> np.ndarray:
        from repro_torch.storage.tiers import _assemble

        with self._lock:
            entries = list(self._index.get(key, []))
        if not entries:
            raise KeyError(f"DISK: no data for {key}")

        pieces = ((e.bb, self._read(e)) for e in entries if e.bb.intersects(roi))
        out, covered = _assemble(pieces, roi, share=True)
        if out is None:
            raise KeyError(f"DISK: {key} has no chunks intersecting {roi}")
        if covered < roi.volume:
            raise KeyError(f"DISK: {key} covers only {covered}/{roi.volume} of {roi}")
        return out

    def query(self, namespace: str, name: str) -> list[tuple[RegionKey, BoundingBox]]:
        with self._lock:
            out: dict[RegionKey, BoundingBox] = {}
            for key, entries in self._index.items():
                if key.namespace == namespace and key.name == name:
                    for e in entries:
                        out[key] = e.bb if key not in out else out[key].union(e.bb)
            return sorted(out.items(), key=lambda kv: kv[0])

    def delete(self, key: RegionKey) -> None:
        with self._lock:
            self._index.pop(key, None)
        # files are shared between chunks; physical GC is a separate sweep

    def keys(self) -> list[RegionKey]:
        with self._lock:
            return sorted(self._index)
