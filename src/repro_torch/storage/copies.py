"""Host bytes that the region stores copied, and the buffers they copy into.

A store copies on ``put`` (a block kept apart from the caller's array) and
on ``get`` (a read assembled from its blocks). :func:`stats` counts both
since the last :func:`reset_stats`, as ``repro_torch.staging.stats`` counts
the uploads: the bytes an operator can weigh against what the data had to
move. Beside them, ``get_views`` counts the gets that one block answered
with its read-only view, which copy nothing.

:class:`Spares` keeps the host buffers of arrays that were let go of for the
next copies of the same size. A block of a 4096^2 tile is 67-201 MB: fresh
from the allocator, its pages fault in as the copy first writes them. An
array in a spare buffer is read-only and nothing else can write its buffer,
so a store keeps it without a copy (:func:`immutable`): :func:`download`
brings a tensor to the host that way, as the region-template stages hand
their outputs to the stores. The DISK tier reads each chunk from its
file straight into a spare (:meth:`Spares.fill`, ``storage/disk.py``), so a
read, like a put or a download, writes pages that an earlier block of its
size faulted in, and the block it hands out goes up by DMA.

New spares come from ``staging.host_buffer``: page-locked where the process
already holds a CUDA context, from torch's caching host allocator (which
rounds a block up to a power of two and takes it back into its cache, never
freeing it to the driver while the process runs). Torch fills them: a host
array by ``copy_`` on the intra-op threads, a tensor on a card by DMA at the
copy engines' rate (``staging.to_host``). A store block in such a spare is
uploaded by DMA with no staging copy (``staging.upload``,
``staging.to_device``). A process that never opened a context, such as a
socket storage server, pins nothing and keeps pageable spares. Through
pageable spares, on an H100 machine's host: a 201 MB copy took 80-92 ms into
fresh pages and 23-26 ms (``np.copyto``, one thread) into pages written
before; a 67 MB download from the card 26-36 ms and 10-17 ms.
"""
from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from repro_torch import staging

_STATS = ("put_copies", "put_bytes", "get_copies", "get_bytes", "get_views")
_stats = dict.fromkeys(_STATS, 0)
_stats_lock = threading.Lock()


def count(kind: str, nbytes: int) -> None:
    """One copy of ``nbytes`` host bytes by a store's ``kind`` ("put" or "get")."""
    with _stats_lock:
        _stats[kind + "_copies"] += 1
        _stats[kind + "_bytes"] += int(nbytes)


def count_view() -> None:
    """One get answered by a block's read-only view: no copy."""
    with _stats_lock:
        _stats["get_views"] += 1


def stats() -> dict[str, int]:
    """Copies, bytes and views since the last :func:`reset_stats`."""
    with _stats_lock:
        return dict(_stats)


def reset_stats() -> None:
    with _stats_lock:
        _stats.update(dict.fromkeys(_STATS, 0))


class _Lease:
    """The read-only buffer of one block over a spare: numpy keeps it as the
    base of the block and of every view of it, so it dies with the last."""

    __slots__ = ("raw", "__weakref__")

    def __init__(self, raw: np.ndarray) -> None:
        self.raw = raw

    def __buffer__(self, flags: int) -> memoryview:
        return memoryview(self.raw).toreadonly()


def _host_copy(out: np.ndarray, src: np.ndarray) -> None:
    """``np.copyto(out, src)``, by torch's ``copy_`` on its intra-op threads
    where torch can view ``src`` (not a read-only array, of which it warns)."""
    if src.flags.writeable:
        try:
            torch.from_numpy(out).copy_(torch.from_numpy(src))
            return
        except (TypeError, ValueError):  # a dtype or byte order torch has not
            pass
    np.copyto(out, src)


class Spares:
    """Host buffers for read-only blocks, reused once every array over them
    has gone.

    :meth:`copy` returns a read-only copy of an array in a buffer that a
    block of the same size held before, where one is free; :meth:`fill`
    lets its caller write that buffer, as a file read does. The buffer comes
    back when the last array over the copy dies, the store's block and every
    view handed out of it alike, so a buffer is never written while anything
    can read it. At most ``keep`` free buffers of one size are kept; the rest
    go back to the allocator. Once the process holds a CUDA context, new
    buffers are page-locked, and a pageable one is dropped, not reused.
    """

    def __init__(self, keep: int = 2) -> None:
        self.keep = keep
        self._free: dict[int, list[tuple[np.ndarray, bool]]] = {}
        self._lock = threading.Lock()

    def copy(self, src) -> np.ndarray:
        """A read-only host copy of ``src``: a host array, or a tensor on any
        device (copied by torch, a download from a card)."""
        if isinstance(src, torch.Tensor):
            dtype = _NUMPY.get(src.dtype)
            if dtype is None:  # bfloat16 and the like: no numpy twin to copy into
                from repro_torch.core.regions import to_numpy

                return _read_only(np.array(to_numpy(src), copy=True))
            shape, nbytes = tuple(src.shape), src.numel() * src.element_size()
        else:
            dtype, shape, nbytes = src.dtype, src.shape, src.nbytes
            if not nbytes or dtype.hasobject:
                return _read_only(np.array(src, copy=True))

        def write(raw: np.ndarray) -> None:
            out = raw.view(dtype).reshape(shape)
            if isinstance(src, torch.Tensor):
                staging.to_host(src.detach(), torch.from_numpy(out))
            else:
                _host_copy(out, src)

        return self.fill(nbytes, dtype, shape, write)[0]

    def fill(self, nbytes: int, dtype, shape, write) -> tuple[np.ndarray, bool]:
        """(A read-only array of ``dtype`` and ``shape`` over a spare of
        ``nbytes``, whether that spare is one an earlier array let go of).
        ``write(raw)`` fills the spare first, given it as a writable uint8
        array of ``nbytes`` that it must not keep; where it raises, the spare
        is dropped. The lease is :meth:`copy`'s."""
        pin = staging.pinning()
        with self._lock:
            free = self._free.get(nbytes)
            if free and pin:  # pageable spares from before the context
                free[:] = [spare for spare in free if spare[1]]
            raw, pinned = free.pop() if free else (None, pin)
        reused = raw is not None
        if not reused:
            raw = staging.host_buffer(nbytes)  # page-locked where ``pin``
        write(raw)
        lease = _Lease(raw)
        block = np.frombuffer(lease, dtype=dtype)
        weakref.finalize(lease, self._give_back, raw, pinned).atexit = False
        return block.reshape(shape), reused

    def clear(self) -> None:
        """Let go of every free buffer; a buffer still leased comes back as
        before."""
        with self._lock:
            self._free.clear()

    def _give_back(self, raw: np.ndarray, pinned: bool) -> None:
        if not pinned and staging.pinning():
            return  # dropped: page-locked spares take its place
        with self._lock:
            free = self._free.setdefault(raw.nbytes, [])
            if len(free) < self.keep:
                free.append((raw, pinned))


def _read_only(array: np.ndarray) -> np.ndarray:
    array.setflags(write=False)
    return array


_NUMPY = {t: np.dtype(n) for t, n in (
    (torch.float64, np.float64), (torch.float32, np.float32), (torch.float16, np.float16),
    (torch.int64, np.int64), (torch.int32, np.int32), (torch.int16, np.int16),
    (torch.int8, np.int8), (torch.uint8, np.uint8), (torch.bool, np.bool_))}


def _lease(array) -> _Lease | None:
    base = array
    while isinstance(base, np.ndarray):
        base = base.base
    return base if isinstance(base, _Lease) else None


def immutable(array) -> bool:
    """Whether ``array`` lies in a spare buffer: read-only, and no array that
    can write its buffer exists until every array over it is gone."""
    return _lease(array) is not None


_downloads = Spares(keep=8)  # an image of 4 tiles downloads 8 planes (mask, hematoxylin)


def download(tensor: torch.Tensor) -> np.ndarray:
    """``tensor`` on the host, read-only, in a buffer that an earlier download
    of its size let go of where one is free: no fresh pages to fault in, and
    a store keeps the result without copying it again (:func:`immutable`).
    From a card into a page-locked spare it moves by DMA (``staging.to_host``,
    which counts its bytes by the spare's kind)."""
    return _downloads.copy(tensor)
