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
  * a ``DTensor`` leaf (a parameter or optimizer state on a device mesh)
    is written as one chunk per local shard, its box the shard's index box
    in the whole tensor; a shard replicated over some mesh dims is written
    once, by the rank at coordinate 0 along them (the reference's sharded
    save). In a world of several processes, each writes its own shards in
    turn, rank 0 the plain leaves and the commit;
  * restore reads each leaf's box, which the DISK store assembles from
    whatever chunks cover it: the whole tensor for a plain leaf, the
    rank's own shard for a DTensor leaf (or one laid out by
    ``target_placements``). So a checkpoint saved on one mesh restores on
    another, on one card, and in the reference (elastic restore).

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
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from repro_torch.convert import LayerStack, reference_leaves
from repro_torch.core.bbox import BoundingBox
from repro_torch.core.regions import ElementType, RegionKey
from repro_torch.models.spec import local_box
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


def _sharded(leaf: Any) -> DTensor | None:
    """The leaf's (first) DTensor, if it is one or a stack of them."""
    first = leaf[0] if isinstance(leaf, LayerStack) else leaf
    return first if isinstance(first, DTensor) else None


def _box(shape: tuple[int, ...], mesh, placements, stacked: int | None) -> BoundingBox:
    """The index box of this rank's shard of a leaf of ``shape`` (for a
    stack of ``stacked`` layers, every layer's shard of its (L, ...) leaf)."""
    inner = shape[1:] if stacked is not None else shape
    box = local_box(tuple(inner), mesh, placements) if inner else ()
    lo = [s.start for s in box]
    hi = [s.stop for s in box]
    if stacked is not None:
        lo, hi = [0, *lo], [stacked, *hi]
    return BoundingBox(tuple(lo), tuple(hi)) if lo else BoundingBox((0,), (1,))


def _chunks(leaf: Any) -> list[tuple[BoundingBox | None, np.ndarray, ElementType]]:
    """(box, host array, element type) of each chunk this rank writes for a
    leaf: the whole leaf (box None) for a plain one; its local shard for a
    DTensor, none if another rank holds the same shard and writes it."""
    d = _sharded(leaf)
    if d is None:
        return [(None, *_to_host(leaf))]
    mesh = d.device_mesh
    coord = mesh.get_coordinate()
    if any(not isinstance(p, Shard) and c != 0 for p, c in zip(d.placements, coord)):
        return []  # a replica: the rank at coordinate 0 writes it
    if isinstance(leaf, LayerStack):
        local = LayerStack(t.to_local() for t in leaf)
        box = _box(_shape_of(leaf), mesh, d.placements, len(leaf))
    else:
        local = d.to_local()
        box = _box(tuple(d.shape), mesh, d.placements, None)
    return [(box, *_to_host(local))]


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
        """Snapshot ``tree`` at ``step``; async if ``blocking=False``.

        In a world of several processes every rank calls it (a collective):
        each writes its shards in turn, rank 0 also the plain leaves and,
        last, the commit; the save is then blocking."""
        self.wait()  # one in-flight save at a time
        world = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if world > 1 else 0
        t0 = time.perf_counter()
        host = [(name, box, arr, etype) for name, leaf in _leaf_paths(tree)
                for box, arr, etype in _chunks(leaf)
                if box is not None or rank == 0]
        info = {"step": step, "bytes": sum(arr.nbytes for _, _, arr, _ in host),
                "snapshot_s": time.perf_counter() - t0}

        def _put_leaves() -> None:
            for name, box, arr, etype in host:
                key = RegionKey(self.namespace, name, etype, timestamp=step)
                self.store.put(key, box or BoundingBox.from_shape(arr.shape), arr)
            self.store.flush()

        def _commit() -> None:
            commit_key = RegionKey(self.namespace, _COMMIT, ElementType.INT64, timestamp=step)
            self.store.put(commit_key, BoundingBox((0,), (1,)), np.asarray([step]))
            self.store.flush()
            self._gc()

        def _write() -> None:
            try:
                t1 = time.perf_counter()
                _put_leaves()
                _commit()
                info["write_s"] = time.perf_counter() - t1
                with self._lock:
                    self.last_save = info
            except BaseException as e:  # surfaced on next wait()/save()
                with self._lock:
                    self._error = e

        if world > 1:  # one writer at a time on the shared manifest
            t1 = time.perf_counter()
            for r in range(world):
                if r == rank:
                    _put_leaves()
                dist.barrier()
            if rank == 0:
                self.store.reload()
                _commit()
            dist.barrier()
            self.store.reload()
            info["write_s"] = time.perf_counter() - t1
            with self._lock:
                self.last_save = info
        elif blocking:
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
    def restore(self, target: Any, step: int | None = None, *,
                target_placements: Any | None = None, mesh=None) -> Any:
        """Rebuild a tree like ``target`` from the checkpoint at ``step``
        (the latest if None).

        ``target``'s leaves give each region's name, shape and dtype. A
        tensor leaf comes back as a new tensor on the leaf's device (the
        CPU for a meta tensor), a numpy array or Python scalar as a numpy
        value; a module is filled in place and returned, its layer stacks
        sliced from their stacked regions, as is a ``LayerStack``'s tensors.
        A DTensor leaf (a module's parameter laid out by
        ``transformer.shard_params``, or a state tensor) reads only this
        rank's shard. ``target_placements`` (a tree like ``target``'s, as
        ``train.step.state_shardings`` gives, over ``mesh``) lays a plain
        tensor leaf out as a DTensor the same way; a stacked leaf's
        placements there are the stack's, layer axis first.
        """
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no committed checkpoint found")
        if step not in self.steps():
            raise FileNotFoundError(f"no committed checkpoint at step {step}")
        placements = dict(_placement_paths(target_placements)) if target_placements else {}

        def read(name: str, leaf: Any, box: BoundingBox | None = None) -> np.ndarray:
            dtype = _dtype_of(leaf)
            key = RegionKey(self.namespace, name, ElementType.from_dtype(dtype), timestamp=step)
            shape = _shape_of(leaf)
            if not shape:
                return self.store.get(key, BoundingBox((0,), (1,))).reshape(())
            return self.store.get(key, box or BoundingBox.from_shape(shape))

        def fill(dst: torch.Tensor, arr: np.ndarray) -> None:
            local = dst.to_local() if isinstance(dst, DTensor) else dst
            local.copy_(_as_tensor(arr, dst.dtype))

        def rebuild(tree: Any, prefix: tuple[str, ...]) -> Any:
            if isinstance(tree, nn.Module):
                with torch.no_grad():
                    for name, leaf in reference_leaves(tree).items():
                        rebuild(leaf, prefix + (name,))
                return tree
            if isinstance(tree, dict):
                return {k: rebuild(v, prefix + (str(k),)) for k, v in tree.items()}
            name = "/".join(prefix) or "leaf"
            if isinstance(tree, LayerStack):
                d = _sharded(tree)
                box = (_box(_shape_of(tree), d.device_mesh, d.placements, len(tree))
                       if d is not None else None)
                arr = read(name, tree, box)
                with torch.no_grad():
                    for i, t in enumerate(tree):
                        fill(t, arr[i])
                return tree
            if isinstance(tree, (list, tuple)):
                return type(tree)(rebuild(v, prefix + (str(i),)) for i, v in enumerate(tree))
            if not isinstance(tree, torch.Tensor):
                return np.array(read(name, tree))
            d = _sharded(tree)
            lay = placements.get(name)
            if d is None and lay is not None and tree.dim():
                return _as_dtensor(read(name, tree, _box(_shape_of(tree), mesh, lay, None)),
                                   tree, mesh, lay)
            if d is not None:
                if not tree.dim():
                    arr = read(name, tree)
                else:
                    arr = read(name, tree, _box(_shape_of(tree), d.device_mesh, d.placements,
                                                None))
                if isinstance(tree, nn.Parameter):
                    with torch.no_grad():
                        fill(tree, arr)
                    return tree
                return _as_dtensor(arr, tree, d.device_mesh, d.placements)
            value = _as_tensor(read(name, tree), tree.dtype)
            if isinstance(tree, nn.Parameter):  # a module's: filled in place
                with torch.no_grad():
                    tree.copy_(value)
                return tree
            return value if tree.device.type == "meta" else value.to(tree.device)

        return rebuild(target, ())


def _placement_paths(tree: Any, prefix: tuple[str, ...] = ()) -> list[tuple[str, tuple]]:
    """("/"-joined name, placements) of every leaf of a placements tree."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _placement_paths(tree[k],
                                                                        prefix + (str(k),))]
    return [("/".join(prefix), tuple(tree))]


def _as_dtensor(arr: np.ndarray, like: torch.Tensor, mesh, placements) -> DTensor:
    """This rank's shard ``arr`` of a leaf shaped as ``like``, as a DTensor."""
    device = like.device if like.device.type != "meta" else torch.device("cpu")
    local = _as_tensor(arr, like.dtype).to(device)
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False,
                              shape=like.shape, stride=torch.empty(like.shape,
                                                                   device="meta").stride())
