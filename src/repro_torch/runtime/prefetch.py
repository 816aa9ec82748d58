"""Data prefetching and asynchronous copy (paper S3.2.1, last subsection).

Accelerator work is pipelined through three phases — *upload, processing,
download* — so the upload of task N+1 and the download of task N-1 overlap
the compute of task N.  On the CUDA card this module realises them with
streams and events:

  * uploads run on a copy stream, from pinned host buffers, and record an
    event;
  * ``fn`` runs on the caller's current stream after waiting on that event,
    so the hand-written kernels (which launch on the current stream) run
    there;
  * downloads run on a second copy stream into pinned host buffers, after
    waiting on the compute, and an event on that stream is synchronised
    before the numpy result is handed out.

A tensor allocated on one stream and used on another is marked with
``record_stream``, so the caching allocator does not hand its memory to a
later allocation while the other stream may still read it.  On the CPU
every phase runs synchronously on the host and nothing is pinned.

This module provides

  * :class:`DevicePipeline` — a generic 3-phase pipeline over an iterator
    of host batches: ``put -> fn -> fetch`` with a bounded in-flight
    window (the paper's upload/process/download chain);
  * :func:`prefetch_to_device` — the standard training-loop helper: wraps
    a host-batch iterator and keeps ``depth`` batches resident ahead of
    the consumer.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch.core.regions import host_tensor, to_numpy
from repro_torch.device import resolve_device


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree: Any) -> list:
    leaves: list = []
    _tree_map(leaves.append, tree)
    return leaves


def _upload(batch: Any, dev: torch.device, stream) -> tuple[Any, Any]:
    """Host batch -> (the same tree as tensors on ``dev``, the event that
    marks the end of the copies, or ``None`` on the CPU)."""

    def put(x: Any) -> torch.Tensor:
        src = host_tensor(x) if isinstance(x, np.ndarray) else torch.as_tensor(x)
        if stream is None:
            return src.to(dev)
        if not src.is_cuda:
            src = src.pin_memory()
        return src.to(dev, non_blocking=True)

    if stream is None:
        return _tree_map(put, batch), None
    with torch.cuda.stream(stream):
        out = _tree_map(put, batch)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def _consume_on(tree: Any, event, stream) -> None:
    """Make ``stream`` wait for ``event`` before it touches ``tree``'s
    tensors, and keep their memory from reuse until ``stream`` is done."""
    stream.wait_event(event)
    for leaf in _tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            leaf.record_stream(stream)


def prefetch_to_device(
    it: Iterable[Any],
    depth: int = 2,
    device: str | torch.device | None = None,
) -> Iterator[Any]:
    """Keep ``depth`` batches device-resident ahead of the consumer.

    Uploads happen on a background thread (on a copy stream, on the card),
    so host->device copies overlap the consumer's compute.  ``device=None``
    means the CUDA card. An exception that ends ``it`` is raised to the
    consumer after the batches staged before it.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    dev = resolve_device(device)
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: collections.deque = collections.deque()
    cv = threading.Condition()
    DONE = object()
    failed: list[BaseException] = []  # what ended the producer, raised to the consumer

    def _producer() -> None:
        try:
            for batch in it:
                staged = _upload(batch, dev, copy_stream)
                with cv:
                    while len(q) >= depth:
                        cv.wait()
                    q.append(staged)
                    cv.notify_all()
        except BaseException as e:  # noqa: BLE001 - handed to the consumer below
            failed.append(e)
        finally:
            with cv:
                q.append(DONE)
                cv.notify_all()

    threading.Thread(target=_producer, daemon=True, name="prefetcher").start()
    while True:
        with cv:
            while not q:
                cv.wait()
            item = q.popleft()
            cv.notify_all()
        if item is DONE:
            if failed:  # the reference's copy ends the stream here in silence
                raise failed[0]
            return
        batch, event = item
        if event is not None:
            _consume_on(batch, event, torch.cuda.current_stream(dev))
        yield batch


class DevicePipeline:
    """Explicit upload -> compute -> download pipeline (paper's 3 phases).

    ``fn`` must launch its work asynchronously (the kernels and PyTorch's
    CUDA ops do); with ``window`` outstanding computations the host thread
    stays ahead of the device, so uploads/downloads of neighbours overlap
    compute.  ``device=None`` means the CUDA card.
    """

    def __init__(
        self,
        fn: Callable[..., Any],
        *,
        window: int = 2,
        device: str | torch.device | None = None,
        host_fn: Callable[[Any], Any] | None = None,
    ) -> None:
        self.fn = fn
        self.window = max(1, window)
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        self._upload_stream = torch.cuda.Stream(self.device) if on_card else None
        self._download_stream = torch.cuda.Stream(self.device) if on_card else None
        # optional terminal host stage applied to each downloaded result
        # (e.g. a kernel chain's host-side reduction): it runs while the
        # next items' device work is still in flight, so host post-
        # processing overlaps compute just like the downloads do
        self.host_fn = host_fn
        self.stats = {"uploaded": 0, "computed": 0, "downloaded": 0}

    def map_tagged(self, tagged: Iterable[tuple]) -> "Iterator[tuple]":
        """Like :meth:`map`, but over ``(tag, batch)`` pairs: the tag
        rides the pipeline untouched — never uploaded, never handed to
        ``fn`` — and is re-paired with its batch's result, yielding
        ``(tag, out)``.  For callers whose per-batch metadata (region
        keys, windows) is not device-puttable; the FIFO pairing
        invariant lives HERE, not in a caller-side side channel."""
        tags: collections.deque = collections.deque()

        def _strip() -> Iterator[Any]:
            for tag, batch in tagged:
                tags.append(tag)
                yield batch

        for out in self.map(_strip()):
            yield tags.popleft(), out

    def map(self, batches: Iterable[Any]) -> Iterator[Any]:
        inflight: collections.deque = collections.deque()
        for host_batch in batches:
            dev_batch, uploaded = _upload(host_batch, self.device, self._upload_stream)
            self.stats["uploaded"] += 1
            inflight.append(self._compute(dev_batch, uploaded))
            self.stats["computed"] += 1
            if len(inflight) >= self.window:
                yield self._download(inflight.popleft())
        while inflight:
            yield self._download(inflight.popleft())

    def _compute(self, dev_batch: Any, uploaded) -> tuple[Any, Any]:
        """Run ``fn`` after the upload and queue the copy of its result to
        the host; returns (the result's host buffers, the copy's event)."""
        if uploaded is None:  # the CPU: nothing is asynchronous
            return self.fn(dev_batch), None
        compute = torch.cuda.current_stream(self.device)
        _consume_on(dev_batch, uploaded, compute)
        out = self.fn(dev_batch)
        computed = torch.cuda.Event()
        computed.record(compute)
        down = self._download_stream

        def fetch(x: Any) -> Any:
            if not (isinstance(x, torch.Tensor) and x.is_cuda):
                return x
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
            return host

        with torch.cuda.stream(down):
            _consume_on(out, computed, down)
            host = _tree_map(fetch, out)
            fetched = torch.cuda.Event()
            fetched.record(down)
        return host, fetched

    def _download(self, pending: tuple[Any, Any]) -> Any:
        out, fetched = pending
        if fetched is not None:
            fetched.synchronize()
        host = _tree_map(lambda x: to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x),
                         out)
        self.stats["downloaded"] += 1
        return self.host_fn(host) if self.host_fn is not None else host
