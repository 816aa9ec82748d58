"""Host bytes that the region stores copied, and the buffers they copy into.

A store copies on ``put`` (a block kept apart from the caller's array) and
on ``get`` (a read assembled from its blocks). :func:`stats` counts both
since the last :func:`reset_stats`, as ``repro_torch.staging.stats`` counts
the uploads: the bytes an operator can weigh against what the data had to
move.

:class:`Spares` keeps the host buffers of arrays that were let go of for the
next copies of the same size. A block of a 4096^2 tile is 67-201 MB: fresh
from the allocator, its pages fault in as the copy first writes them (a
201 MB copy took 80-92 ms into fresh pages and 23-26 ms into pages written
before, on an H100 machine's host; a 67 MB download from the card 26-36 ms
and 10-17 ms). An array in a spare buffer is read-only and nothing else can
write its buffer, so a store keeps it without a copy (:func:`immutable`):
:func:`download` brings a tensor to the host that way, as the
region-template stages hand their outputs to the stores.
"""
from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

_STATS = ("put_copies", "put_bytes", "get_copies", "get_bytes")
_stats = dict.fromkeys(_STATS, 0)
_stats_lock = threading.Lock()


def count(kind: str, nbytes: int) -> None:
    """One copy of ``nbytes`` host bytes by a store's ``kind`` ("put" or "get")."""
    with _stats_lock:
        _stats[kind + "_copies"] += 1
        _stats[kind + "_bytes"] += int(nbytes)


def stats() -> dict[str, int]:
    """Copies and bytes since the last :func:`reset_stats`."""
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


class Spares:
    """Host buffers for read-only blocks, reused once every array over them
    has gone.

    :meth:`copy` returns a read-only copy of an array in a buffer that a
    block of the same size held before, where one is free. The buffer comes
    back when the last array over the copy dies, the store's block and every
    view handed out of it alike, so a buffer is never written while anything
    can read it. At most ``keep`` free buffers of one size are kept; the rest
    go back to the allocator.
    """

    def __init__(self, keep: int = 2) -> None:
        self.keep = keep
        self._free: dict[int, list[np.ndarray]] = {}
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
        with self._lock:
            free = self._free.get(nbytes)
            raw = free.pop() if free else None
        if raw is None:
            raw = np.empty(nbytes, np.uint8)
        out = raw.view(dtype).reshape(shape)
        if isinstance(src, torch.Tensor):
            torch.from_numpy(out).copy_(src.detach())
        else:
            np.copyto(out, src)
        lease = _Lease(raw)
        try:
            block = np.frombuffer(lease, dtype=dtype)
        except TypeError:  # a Python before 3.12 exports no buffer from a class
            return _read_only(out)
        weakref.finalize(lease, self._give_back, raw).atexit = False
        return block.reshape(shape)

    def _give_back(self, raw: np.ndarray) -> None:
        with self._lock:
            free = self._free.setdefault(raw.nbytes, [])
            if len(free) < self.keep:
                free.append(raw)


def _read_only(array: np.ndarray) -> np.ndarray:
    array.setflags(write=False)
    return array


_NUMPY = {t: np.dtype(n) for t, n in (
    (torch.float64, np.float64), (torch.float32, np.float32), (torch.float16, np.float16),
    (torch.int64, np.int64), (torch.int32, np.int32), (torch.int16, np.int16),
    (torch.int8, np.int8), (torch.uint8, np.uint8), (torch.bool, np.bool_))}


def immutable(array) -> bool:
    """Whether ``array`` lies in a spare buffer: read-only, and no array that
    can write its buffer exists until every array over it is gone."""
    base = array
    while isinstance(base, np.ndarray):
        base = base.base
    return isinstance(base, _Lease)


_downloads = Spares(keep=8)  # an image of 4 tiles downloads 8 planes (mask, hematoxylin)


def download(tensor: torch.Tensor) -> np.ndarray:
    """``tensor`` on the host, read-only, in a buffer that an earlier download
    of its size let go of where one is free: no fresh pages to fault in, and
    a store keeps the result without copying it again (:func:`immutable`)."""
    return _downloads.copy(tensor)
