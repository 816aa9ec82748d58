"""Host-to-card uploads through pinned memory.

``torch.as_tensor(x, device="cuda")`` hands a pageable host array to the
CUDA driver, which moves it through its own small staging buffers, one after
the other, on the calling thread: about 6 GB/s for the 201 MB RGB of a 4096^2
tile on an H100. :func:`upload` copies the array into pinned memory first
(``Tensor.pin_memory``, as ``runtime/prefetch.py`` does), with torch's CPU
``copy_`` on the intra-op threads, and the card then reads it by DMA at
about 50 GB/s. Torch's caching host allocator keeps the pinned block for
the next upload of its size; uploads from several threads at once each take
a block of their own, so none waits for another. A source that is already
page-locked, such as a region store's block in a pinned spare
(``storage/copies.py``), is read by DMA as it is, with no staging copy.

The contract is the pageable copy's: :func:`upload` returns once the data is
on the card, so the source may be overwritten at once and every stream sees
the data. The DMA runs on the device's current stream, where the caching
allocator may hand the destination's block out again. Where the source's
dtype differs from ``dtype`` the bytes move as they are and the cast runs on
the card before the return; for the casts the tests hold (integers and
float64 to float32) the bits are those of ``torch.as_tensor``, which casts
on the host.

It engages for a CUDA device and a C-contiguous host NumPy array or CPU
tensor. Everything else (a CPU device, a tensor already on the card, a
non-contiguous input) takes ``torch.as_tensor`` as before. :func:`stats`
counts the uploads and bytes of each path. :func:`transfer_stats` counts,
apart, the host-card bytes of the uploads and of the stores' downloads
(``copies.download``) by whether their host buffer was page-locked before
the transfer.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

_STATS = ("staged_uploads", "staged_bytes", "direct_uploads", "direct_bytes")
_stats = dict.fromkeys(_STATS, 0)
_stats_lock = threading.Lock()

# host-card transfers by their host buffer: already page-locked ("pinned"),
# copied into pinned memory first ("staged"), or pageable
TRANSFERS = ("upload_pinned", "upload_staged", "upload_direct",
             "download_pinned", "download_pageable")
_transfers = dict.fromkeys([k for path in TRANSFERS for k in (path, path + "_bytes")], 0)


def _host_tensor(x) -> torch.Tensor | None:
    """``x`` as a CPU tensor sharing its memory, where ``x`` is a C-contiguous
    host array that torch can view (and no tensor that requires grad, whose
    copy ``as_tensor`` would record); else None."""
    if isinstance(x, np.ndarray):
        if not x.flags.c_contiguous:
            return None
        try:
            return torch.from_numpy(x)
        except (TypeError, ValueError):  # a dtype or byte order torch has not
            return None
    if (isinstance(x, torch.Tensor) and x.device.type == "cpu" and x.is_contiguous()
            and not x.requires_grad):
        return x
    return None


def _count(path: str, nbytes: int) -> None:
    with _stats_lock:
        _stats[path + "_uploads"] += 1
        _stats[path + "_bytes"] += nbytes


def upload(x, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``, through pinned
    memory where ``x`` is a contiguous host array bound for a card."""
    device = torch.device(device)
    src = _host_tensor(x) if device.type == "cuda" else None
    if src is None:
        if not (isinstance(x, torch.Tensor) and x.is_cuda):
            nbytes = int(getattr(x, "nbytes", 0))
            _count("direct", nbytes)
            if device.type == "cuda":
                count_transfer("upload_direct", nbytes)
        return torch.as_tensor(x, dtype=dtype, device=device)
    pinned = src.is_pinned()  # then ``pin_memory`` would return it as it is
    out = (src if pinned else src.pin_memory()).to(device, non_blocking=True)
    if dtype is not None:
        out = out.to(dtype)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    done.synchronize()  # the copy, and the cast, are on the card
    _count("staged", src.nbytes)
    count_transfer("upload_pinned" if pinned else "upload_staged", src.nbytes)
    return out


def stats() -> dict[str, int]:
    """Uploads and bytes since the last :func:`reset_stats`: ``staged_*``
    through pinned memory, ``direct_*`` host data handed to
    ``torch.as_tensor``."""
    with _stats_lock:
        return dict(_stats)


def reset_stats() -> None:
    with _stats_lock:
        _stats.update(dict.fromkeys(_STATS, 0))


def count_transfer(path: str, nbytes: int) -> None:
    """One host-card transfer of ``nbytes`` by ``path``, one of :data:`TRANSFERS`."""
    with _stats_lock:
        _transfers[path] += 1
        _transfers[path + "_bytes"] += int(nbytes)


def transfer_stats() -> dict[str, int]:
    """Transfers and bytes of each of :data:`TRANSFERS` since the last
    :func:`reset_transfer_stats`; apart from :func:`stats`."""
    with _stats_lock:
        return dict(_transfers)


def reset_transfer_stats() -> None:
    with _stats_lock:
        _transfers.update(dict.fromkeys(_transfers, 0))
