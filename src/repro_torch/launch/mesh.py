"""Device meshes (``repro.launch.mesh``), defined as functions: importing
this module touches no process group.

Single pod : (16, 16)      axes (data, model)        = 256 ranks
Multi-pod  : (2, 16, 16)   axes (pod, data, model)   = 512 ranks

The shapes are the reference's, so each rank's shard of every tensor is the
reference's per-chip shard. The ``pod`` axis is the slow link between
hosts, ``data`` and ``model`` the fast one; the gradient compression and
ZeRO-1 of ``repro_torch.train`` key off these names.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, which must hold one rank for each mesh position.
``fake_world`` makes such a group of 256 or 512 ranks in one process for
the dry run; ``make_host_mesh`` runs over a world that the caller started
(``gloo`` on the CPU, ``nccl`` on the card), or starts a world of one rank
itself.

Every mesh ``_mesh`` builds also registers flattened submeshes
(``DeviceMesh._flatten``) for its contiguous axis runs ``(pod, data)``,
``(data, model)`` and ``(pod, data, model)`` that hold more than one rank
along at least two axes. DTensor's redistribute then issues a Partial over
such a run, or ZeRO-1's gather over ``(pod, data)``, as one collective on
the flattened group where it would issue one a mesh axis; this is the one
reduction over all the axes at once that the reference's GSPMD issues.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device


def fake_world(size: int) -> None:
    """Make the default process group a ``"fake"`` one of ``size`` ranks, this
    process rank 0: every collective returns at once and moves nothing. For
    the dry run, which traces one rank's share of a step on meta tensors.
    A default group of another kind or size is destroyed first."""
    # FakeStore lives in torch's private testing package; it is imported
    # here only, and only when a fake world is asked for.
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def _world_of_one(device: torch.device) -> None:
    """Start a default process group of one rank (an in-process store, no
    network), or keep one that is there; a group of another size (a fake
    world) is destroyed first."""
    if dist.is_initialized():
        if dist.get_world_size() == 1 and dist.get_backend() != "fake":
            return
        dist.destroy_process_group()
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _flatten_axis_runs(mesh: DeviceMesh) -> None:
    """Register a flattened submesh, named by its axes joined with ``_``, for
    each contiguous run of two or more axes with more than one rank along at
    least two of them. A run whose axes of more than one rank equal an
    earlier run's has that run's layout (DTensor looks a flattened mesh up by
    layout), so it is left out: ``(pod, data, model)`` on a (2, 2, 1) mesh is
    ``(pod, data)``. A collective, like making the mesh: every rank calls it."""
    names, shape = mesh.mesh_dim_names, mesh.shape
    seen = set()
    for width in range(2, len(names) + 1):
        for start in range(len(names) - width + 1):
            run = names[start:start + width]
            wide = tuple(a for a, n in zip(run, shape[start:start + width]) if n > 1)
            if len(wide) >= 2 and wide not in seen:
                seen.add(wide)
                mesh[run]._flatten()


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str) -> DeviceMesh:
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else "no"
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} ranks; {have} ranks")
    mesh = DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)
    _flatten_axis_runs(mesh)
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's production mesh over a world of 256 (512) ranks, as
    ``fake_world`` makes; its tensors live on the meta device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, "cpu")


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1, *, device=None) -> DeviceMesh:
    """A small mesh over the ranks of the default process group (tests, the
    launchers, ``chip_smoke.py``): ``(data, model)``, or ``(pod, data, model)``
    with ``pod > 1``. ``device=None`` means the CUDA card and raises without
    one; pass ``device="cpu"`` for the CPU. A mesh of one rank starts its
    own world of one if there is none."""
    dev = resolve_device(device)
    shape = (pod, data, model) if pod > 1 else (data, model)
    axes = ("pod", "data", "model") if pod > 1 else ("data", "model")
    if math.prod(shape) == 1:
        _world_of_one(dev)
    return _mesh(shape, axes, dev.type)
