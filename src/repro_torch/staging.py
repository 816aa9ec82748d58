"""Every move of region data between host memory and a card.

``torch.as_tensor(x, device="cuda")`` hands a pageable host array to the
CUDA driver, which moves it through its own small staging buffers, one after
the other, on the calling thread: about 6 GB/s for the 201 MB RGB of a 4096^2
tile on an H100. The card reads page-locked memory by DMA at about 50 GB/s.
This module makes every decision that follows, and the port's other modules
call it: ``pipeline/wsi.py``'s stages and the chains' local call
(:func:`upload`), ``DataRegion.to_device`` and ``runtime/prefetch.py``
(:func:`to_device`, :func:`to_host`), and the region stores' spare buffers
(``storage/copies.py``: :func:`host_buffer`, :func:`page_locked`,
:func:`to_host`).

* The view. A C-contiguous host array or CPU tensor is moved as a CPU tensor
  over its own memory (:func:`_host_view`); an ``ml_dtypes`` bfloat16 array
  through its bits, as :func:`host_tensor` takes it. A read-only array, such
  as a store's block, is viewed through a writable alias that never leaves
  this module, so torch does not warn of it and no process-wide warnings
  filter changes under the threads that upload at the same time.
* The rule. Host memory is page-locked only where this process already holds
  a CUDA context (:func:`pinning`), so a process that never meets a card,
  such as a socket storage server, pins nothing. New page-locked buffers come
  from torch's caching host allocator (:func:`host_buffer`), which keeps
  them when they die until :func:`empty_host_cache`.
  :func:`page_locked` says whether a host buffer is page-locked.
* Host to card (:func:`to_device`): a page-locked source is read by DMA as it
  is; a pageable one is copied first into pinned memory by ``pin_memory()``
  (torch's CPU ``copy_`` on the intra-op threads, into a block that torch's
  allocator keeps for the next upload of its size; uploads from several
  threads at once each take a block of their own); anything else (a CPU
  device, a tensor already on a card, a non-contiguous input) takes
  ``torch.as_tensor``. The DMA is queued on a stream, and an event recorded
  after it. :func:`upload` waits for that event.
* Card to host (:func:`to_host`), into a caller's buffer or a fresh
  page-locked one.
* The counts. :func:`stats` counts the uploads and bytes of each path.
  :func:`transfer_stats` counts, apart, the host-card bytes of the uploads
  and the downloads by whether their host buffer was page-locked before the
  transfer.

:func:`upload`'s contract is the pageable copy's: it returns once the data is
on the card, so the source may be overwritten at once and every stream sees
the data. Where the source's dtype differs from ``dtype`` the bytes move as
they are and the cast runs on the card before the event; for the casts the
tests hold (integers and float64 to float32) the bits are those of
``torch.as_tensor``, which casts on the host.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import types

import numpy as np
import torch

_STATS = ("staged_uploads", "staged_bytes", "direct_uploads", "direct_bytes")
_stats = dict.fromkeys(_STATS, 0)
_lock = threading.Lock()  # the counters and the held sources

# host-card transfers by their host buffer: already page-locked ("pinned"),
# copied into pinned memory first ("staged"), or pageable
TRANSFERS = ("upload_pinned", "upload_staged", "upload_direct",
             "download_pinned", "download_pageable")
_transfers = dict.fromkeys([k for path in TRANSFERS for k in (path, path + "_bytes")], 0)

# (event, source) of DMAs queued from page-locked memory that torch's
# allocator does not own, oldest first: torch records its uses only of its
# own blocks, so the source is kept here until its event completes
_held: collections.deque = collections.deque()


def pinning() -> bool:
    """Whether this process page-locks new host buffers: only once it holds a
    CUDA context, so a process that never meets a card creates none."""
    return torch.cuda.is_initialized()


def host_buffer(nbytes: int) -> np.ndarray:
    """``nbytes`` of host memory as a uint8 array: page-locked where
    :func:`pinning`, from torch's caching host allocator (which rounds a
    block up to a power of two and takes it back into its cache when the
    array dies, never freeing it to the driver, whose free synchronises the
    device); else numpy's."""
    if pinning():
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True).numpy()
    return np.empty(nbytes, np.uint8)


def empty_host_cache() -> None:
    """Free the page-locked blocks that torch's caching host allocator keeps
    and nothing holds (a free synchronises the device), as a bulk read whose
    buffers will not be wanted again ends."""
    if pinning():
        empty = getattr(torch.accelerator, "empty_host_cache", None)  # newer torch's name
        (empty or torch._C._host_emptyCache)()


def page_locked(x) -> bool:
    """Whether the host array or CPU tensor ``x`` lies in page-locked memory
    (never in a process that holds no CUDA context)."""
    return pinning() and (src := _host_view(x)) is not None and src.is_pinned()


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    """``torch.from_numpy(arr)``, an ``ml_dtypes`` bfloat16 array through its
    bits; raises where ``torch.from_numpy`` would. A read-only array is
    viewed through a writable export of its memory (``torch.from_numpy``
    warns of a read-only array), which keeps the array, and so its buffer,
    alive."""
    bf16 = arr.dtype.kind == "V" and arr.dtype.name == "bfloat16"  # ``name`` takes microseconds
    bits = arr.view(np.uint16) if bf16 else arr
    if not bits.flags.writeable:
        face = bits.__array_interface__
        bits = np.asarray(types.SimpleNamespace(
            __array_interface__={**face, "data": (face["data"][0], False)}, array=bits))
    out = torch.from_numpy(bits)
    return out.view(torch.bfloat16) if bf16 else out


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host numpy array -> a CPU tensor (bfloat16 from ``ml_dtypes`` goes
    through its bits). It shares ``arr``'s memory where ``arr`` is writable
    and contiguous, else holds a copy."""
    return _from_numpy(np.require(arr, requirements=["C", "W"]))


def _host_view(x) -> torch.Tensor | None:
    """``x`` as a CPU tensor over its own memory, for a transfer: a
    C-contiguous host array that torch can view, or a contiguous CPU tensor
    that requires no grad (whose copy ``as_tensor`` would record); else None.
    The view of a read-only array is writable to torch, so it never leaves
    this module."""
    if isinstance(x, np.ndarray):
        if not x.flags.c_contiguous:
            return None
        try:
            return _from_numpy(x)
        except (TypeError, ValueError):  # a dtype or byte order torch has not
            return None
    if (isinstance(x, torch.Tensor) and x.device.type == "cpu" and x.is_contiguous()
            and not x.requires_grad):
        return x
    return None


def _count(path: str, nbytes: int) -> None:
    with _lock:
        _stats[path + "_uploads"] += 1
        _stats[path + "_bytes"] += nbytes


def _put(x, device: torch.device, dtype: torch.dtype | None):
    """(``x`` on ``device``, the event recorded after its DMA, the page-locked
    source the DMA reads); no event where ``torch.as_tensor`` made the copy,
    or nothing crossed."""
    src = _host_view(x) if device.type == "cuda" else None
    if src is None:
        if not (isinstance(x, torch.Tensor) and x.is_cuda):
            nbytes = int(getattr(x, "nbytes", 0))
            _count("direct", nbytes)
            if device.type == "cuda":
                count_transfer("upload_direct", nbytes)
        host = host_tensor(x) if isinstance(x, np.ndarray) else x  # no alias of a read-only array
        return torch.as_tensor(host, dtype=dtype, device=device), None, None
    pinned = page_locked(src)  # then ``pin_memory`` would return it as it is
    out = (src if pinned else src.pin_memory()).to(device, non_blocking=True)
    if dtype is not None:
        out = out.to(dtype)
    done = torch.cuda.current_stream(device).record_event()
    _count("staged", src.nbytes)
    count_transfer("upload_pinned" if pinned else "upload_staged", src.nbytes)
    return out, done, src if pinned else None


def to_device(x, device, dtype: torch.dtype | None = None, *, stream=None):
    """``torch.as_tensor(x, dtype=dtype, device=device)`` and the CUDA event
    that marks the end of its DMA, queued on ``stream`` (default: the
    current one) without blocking where ``x`` is a contiguous host array
    bound for a card; the event is None where the host waited for the copy
    or nothing was copied. A pageable source may be overwritten at once; a
    page-locked one is kept alive until its event completes (checked at
    later calls)."""
    # ``torch.cuda.stream(None)`` would open a CUDA context for a CPU device
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        out, done, source = _put(x, torch.device(device), dtype)
    if source is not None:
        with _lock:
            while _held and _held[0][0].query():
                _held.popleft()
            _held.append((done, source))
    return out, done


def upload(x, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``: the copy of
    :func:`to_device` on the current stream, which the host waits for."""
    out, done, _ = _put(x, torch.device(device), dtype)
    if done is not None:
        done.synchronize()  # the copy, and the cast, are on the card
    return out


def to_host(tensor: torch.Tensor, out: torch.Tensor | None = None, *,
            stream=None) -> torch.Tensor:
    """``tensor`` copied to host memory on ``stream`` (default: the current
    one): into ``out``, a CPU tensor of its shape that the caller reads at
    once, by a copy the host waits for; else into a fresh buffer,
    page-locked where :func:`pinning`, without blocking (the caller records
    the event to wait on). A copy from a card is counted by the host
    buffer's kind."""
    fresh = out is None
    if fresh:
        out = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=pinning())
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        out.copy_(tensor, non_blocking=fresh)
    if tensor.is_cuda:
        count_transfer("download_pinned" if page_locked(out) else "download_pageable",
                       out.nbytes)
    return out


def stats() -> dict[str, int]:
    """Uploads and bytes since the last :func:`reset_stats`: ``staged_*``
    through pinned memory, ``direct_*`` host data handed to
    ``torch.as_tensor``."""
    with _lock:
        return dict(_stats)


def reset_stats() -> None:
    with _lock:
        _stats.update(dict.fromkeys(_STATS, 0))


def count_transfer(path: str, nbytes: int) -> None:
    """One host-card transfer of ``nbytes`` by ``path``, one of :data:`TRANSFERS`."""
    with _lock:
        _transfers[path] += 1
        _transfers[path + "_bytes"] += int(nbytes)


def transfer_stats() -> dict[str, int]:
    """Transfers and bytes of each of :data:`TRANSFERS` since the last
    :func:`reset_transfer_stats`; apart from :func:`stats`."""
    with _lock:
        return dict(_transfers)


def reset_transfer_stats() -> None:
    with _lock:
        _transfers.update(dict.fromkeys(_transfers, 0))
