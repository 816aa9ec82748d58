"""Fault-tolerant checkpointing built on region templates + the DISK store
(``repro.storage.checkpoint``).

A checkpoint is a *versioned set of data regions*: each leaf of the state
tree becomes a data region named by its "/"-joined tree path, with
``timestamp = step``. The layout is the reference's, so a checkpoint that
either package writes restores in the other:

  * leaf names are the paths of the reference's tree (``params/layers/attn/wq``,
    ``opt/m/embed/tok``, ``opt/count``, ``step``). A module in the tree (the
    model) stands for its parameters under the reference's names
    (``convert.reference_leaves``), and a layer stack's per-layer tensors
    (a ``LayerStack``) are written as one stacked ``(L, ...)`` region and
    sliced back into the layers on restore;
  * a scalar is a one-element region; a bfloat16 leaf is its raw 16-bit
    words under ``ElementType.BFLOAT16`` (the DISK store records it as
    ``"bfloat16"`` and reads the words back), so no ``ml_dtypes`` is needed;
  * restore reads each leaf's full box, which the DISK store assembles
    from whatever chunks cover it: the shards the reference's sharded save
    writes (one chunk per shard's index box) restore on one card.

Protocol (crash tolerant):
  1. write all leaf chunks for ``step``;
  2. write a tiny COMMIT region for ``step`` — only committed steps are
     visible to ``steps()``/``latest_step()``/``restore``.

``save`` copies the tree to the host at once (the caller may then update
its tensors in place) and can write on a writer thread (the paper's
separated-I/O configuration: training is the compute core, the writer is
the I/O core).
"""
from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.convert import LayerStack, reference_leaves
from repro_torch.core.bbox import BoundingBox
from repro_torch.core.regions import ElementType, RegionKey
from repro_torch.storage.disk import DiskStorage

_COMMIT = "__ckpt_commit__"


def _leaf_paths(tree: Any, prefix: tuple[str, ...] = ()) -> list[tuple[str, Any]]:
    """(name, leaf) for every leaf of ``tree``, in the order
    ``jax.tree_util`` flattens the reference's tree: dicts by sorted key,
    lists and tuples by index, a module as its reference leaves; a leaf is
    a tensor, a ``LayerStack``, a numpy array or a Python scalar."""
    if isinstance(tree, nn.Module):
        tree = reference_leaves(tree)
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _leaf_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, LayerStack):
        return [item for i, v in enumerate(tree) for item in _leaf_paths(v, prefix + (str(i),))]
    return [("/".join(prefix) or "leaf", tree)]


def _to_host(leaf: Any) -> tuple[np.ndarray, ElementType]:
    """A host copy of one leaf (never a view of a tensor the caller may
    update) as a numpy array of at least one dimension, and its element
    type; bfloat16 as its 16-bit words."""
    if isinstance(leaf, LayerStack):
        leaf = torch.stack([t.detach() for t in leaf])
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        etype = ElementType.from_dtype(t.dtype)
        bf16 = t.dtype == torch.bfloat16
        arr = t.view(torch.int16).numpy().view(np.uint16) if bf16 else t.numpy()
    else:
        arr = np.array(leaf)  # a copy
        etype = ElementType.from_dtype(arr.dtype)
    return (arr.reshape(1) if not arr.shape else arr), etype


def _dtype_of(leaf: Any) -> torch.dtype | np.dtype:
    if isinstance(leaf, LayerStack):
        return leaf[0].dtype
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return np.asarray(leaf).dtype


def _shape_of(leaf: Any) -> tuple[int, ...]:
    if isinstance(leaf, LayerStack):
        return (len(leaf), *leaf[0].shape)
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)


def _as_tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A stored array as a tensor of ``dtype`` (bfloat16 from its words)."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dtype)


class CheckpointManager:
    """Async, versioned checkpoints in the reference's layout.

    ``last_save`` describes the newest save: its step, the bytes written,
    the seconds the caller waited for the host copy (``snapshot_s``) and
    the writer's seconds (``write_s``, leaves, flushes and commit).
    """

    def __init__(
        self,
        store: DiskStorage,
        *,
        namespace: str = "ckpt",
        keep: int = 3,
    ) -> None:
        self.store = store
        self.namespace = namespace
        self.keep = keep
        self.last_save: dict = {}
        self._inflight: threading.Thread | None = None
        self._error: BaseException | None = None
        self._lock = threading.Lock()

    # -- save ----------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = True) -> None:
        """Snapshot ``tree`` at ``step``; async if ``blocking=False``."""
        self.wait()  # one in-flight save at a time
        t0 = time.perf_counter()
        host = [(name, *_to_host(leaf)) for name, leaf in _leaf_paths(tree)]
        info = {"step": step, "bytes": sum(arr.nbytes for _, arr, _ in host),
                "snapshot_s": time.perf_counter() - t0}

        def _write() -> None:
            try:
                t1 = time.perf_counter()
                for name, arr, etype in host:
                    key = RegionKey(self.namespace, name, etype, timestamp=step)
                    self.store.put(key, BoundingBox.from_shape(arr.shape), arr)
                self.store.flush()
                commit_key = RegionKey(self.namespace, _COMMIT, ElementType.INT64,
                                       timestamp=step)
                self.store.put(commit_key, BoundingBox((0,), (1,)), np.asarray([step]))
                self.store.flush()
                self._gc()
                info["write_s"] = time.perf_counter() - t1
                with self._lock:
                    self.last_save = info
            except BaseException as e:  # surfaced on next wait()/save()
                with self._lock:
                    self._error = e

        if blocking:
            _write()
            self._raise_if_failed()
        else:
            t = threading.Thread(target=_write, daemon=True, name=f"ckpt-save-{step}")
            self._inflight = t
            t.start()

    def wait(self) -> None:
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
        self._raise_if_failed()

    def close(self) -> None:
        """Join any in-flight async save (surfacing its error, if any)."""
        self.wait()

    def _raise_if_failed(self) -> None:
        with self._lock:
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError("async checkpoint save failed") from err

    def _gc(self) -> None:
        steps = self.steps()
        for old in steps[: -self.keep] if self.keep > 0 else []:
            for key in self.store.keys():
                if key.namespace == self.namespace and key.timestamp == old:
                    self.store.delete(key)

    # -- inspect -----------------------------------------------------------------
    def steps(self) -> list[int]:
        return sorted({key.timestamp for key, _ in self.store.query(self.namespace, _COMMIT)})

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- restore --------------------------------------------------------------------
    def restore(self, target: Any, step: int | None = None) -> Any:
        """Rebuild a tree like ``target`` from the checkpoint at ``step``
        (the latest if None).

        ``target``'s leaves give each region's name, shape and dtype. A
        tensor leaf comes back as a new tensor on the leaf's device (the
        CPU for a meta tensor), a numpy array or Python scalar as a numpy
        value; a module is filled in place and returned, its layer stacks
        sliced from their stacked regions, as is a ``LayerStack``'s tensors.
        """
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no committed checkpoint found")
        if step not in self.steps():
            raise FileNotFoundError(f"no committed checkpoint at step {step}")

        def read(name: str, leaf: Any) -> np.ndarray:
            dtype = _dtype_of(leaf)
            key = RegionKey(self.namespace, name, ElementType.from_dtype(dtype), timestamp=step)
            shape = _shape_of(leaf)
            if not shape:
                return self.store.get(key, BoundingBox((0,), (1,))).reshape(())
            return self.store.get(key, BoundingBox.from_shape(shape))

        def rebuild(tree: Any, prefix: tuple[str, ...]) -> Any:
            if isinstance(tree, nn.Module):
                with torch.no_grad():
                    for name, leaf in reference_leaves(tree).items():
                        rebuild(leaf, prefix + (name,))
                return tree
            if isinstance(tree, dict):
                return {k: rebuild(v, prefix + (str(k),)) for k, v in tree.items()}
            if isinstance(tree, LayerStack):
                arr = read("/".join(prefix), tree)
                with torch.no_grad():
                    for i, t in enumerate(tree):
                        t.copy_(_as_tensor(arr[i], t.dtype))
                return tree
            if isinstance(tree, (list, tuple)):
                return type(tree)(rebuild(v, prefix + (str(i),)) for i, v in enumerate(tree))
            name = "/".join(prefix) or "leaf"
            arr = read(name, tree)
            if not isinstance(tree, torch.Tensor):
                return np.array(arr)
            value = _as_tensor(arr, tree.dtype)
            if isinstance(tree, nn.Parameter):  # a module's: filled in place
                with torch.no_grad():
                    tree.copy_(value)
                return tree
            return value if tree.device.type == "meta" else value.to(tree.device)

        return rebuild(target, ())
