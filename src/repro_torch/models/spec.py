"""ParamSpec machinery: one source of truth for shapes, init and sharding
(``repro.models.spec``).

``abstract_params(cfg)`` (per family) returns a tree of :class:`ParamSpec`
leaves carrying shape, dtype, *logical axes* and an init rule. From that
one tree come
  * randomly initialized tensors (``materialize``) and the parameter count;
  * meta-device stand-ins for the dry run (``abstract``);
  * :class:`PartitionSpec` s through a logical -> mesh-axis rule table
    (``partition_specs``), and from them ``torch.distributed.tensor``
    placements on a ``DeviceMesh`` (``to_placements``, ``named_shardings``).

Activations are constrained as the reference constrains them:
``shard_activation`` inside ``activation_sharding(mesh, rules)`` redistributes
a ``DTensor`` to the rule's placements. Regions that run on each rank's
local shards (the kernels, and ops that DTensor has no sharding strategy
for) go through :func:`local_region`, ``local_map`` with placements from the
same rules. On a mesh whose every axis has size 1 all of it is the identity:
tensors stay plain and the one-card paths run as they did.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis names, len == len(shape)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | small
    scale: float | None = None  # stddev override

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} rank != shape {self.shape}")


def leaves(tree: Any) -> list[ParamSpec]:
    """The spec leaves of a nested dict, in insertion order."""
    if isinstance(tree, ParamSpec):
        return [tree]
    return [leaf for sub in tree.values() for leaf in leaves(sub)]


def materialize_leaf(
    spec: ParamSpec,
    generator: torch.Generator | None,
    device: torch.device,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """One randomly initialized tensor on ``device``; draws from
    ``generator`` (which must live on ``device``'s type). On the meta device
    nothing is drawn or allocated."""
    dtype = dtype or spec.dtype
    if device.type == "meta":
        return torch.empty(spec.shape, dtype=dtype, device=device)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    noise = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
    if spec.init == "small":
        std = 0.002
    else:
        fan_in = spec.shape[0] if spec.shape else 1
        std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return (noise * std).to(dtype)


def materialize(
    tree: Any,
    generator: torch.Generator | None,
    *,
    device: torch.device | str = "cpu",
    dtype_override: torch.dtype | None = None,
) -> Any:
    """Random-init every ParamSpec leaf of a nested dict, in insertion order.

    The draws cannot equal the reference's ``jax.random`` folding; tests that
    compare the two packages carry the reference's parameters across
    (``convert.lm_params_from_reference``).
    """
    device = torch.device(device)
    if isinstance(tree, ParamSpec):
        return materialize_leaf(tree, generator, device, dtype_override)
    return {k: materialize(v, generator, device=device, dtype_override=dtype_override)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Trees of specs: nested dicts with ParamSpec leaves
# ---------------------------------------------------------------------------
def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the ParamSpec leaves of a nested dict (and the matching
    leaves of ``rest``, trees of the same structure)."""
    if isinstance(tree, ParamSpec):
        return fn(tree, *rest)
    return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}


def abstract(tree: Any, shardings: Any | None = None, mesh=None) -> Any:
    """Meta-device tensors for the dry run (nothing allocated): plain meta
    tensors, or meta ``DTensor`` s when ``shardings`` (a tree of placements,
    :func:`named_shardings`) and its ``mesh`` are given."""
    if shardings is None:
        return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), tree)
    return tree_map(lambda s, pl: distribute(
        torch.empty(s.shape, dtype=s.dtype, device="meta"), mesh, pl), tree, shardings)


# ---------------------------------------------------------------------------
# Logical -> physical rules
# ---------------------------------------------------------------------------
# Default logical->physical rules for the production (pod, data, model) mesh.
# Order matters: first matching mesh axis set wins; axes absent from the
# mesh map to None (replicated).
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "q_lora": None,
    "kv_lora": None,
    "ffn": "model",
    "experts": "model",
    "expert_ffn": None,
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "conv": None,
    "layers": None,
    "frontend": None,
    "stack": None,
    # cache sequence dim: None normally; "model" for sequence-sharded decode
    "kv_seq": None,
    # residual-stream sequence dim: None normally; "model" under Megatron-
    # style sequence parallelism (seq_parallel_rules)
    "res_seq": None,
}


def seq_shard_rules() -> dict:
    """Rules variant for sequence-sharded decode (see serve.cache_pspecs)."""
    rules = dict(DEFAULT_RULES)
    rules["kv_seq"] = "model"
    return rules


def seq_parallel_rules() -> dict:
    """Megatron-style sequence parallelism for training and prefill: residual
    activations shard their *sequence* dim over the model axis."""
    rules = dict(DEFAULT_RULES)
    rules["res_seq"] = "model"
    return rules


class PartitionSpec(tuple):
    """One entry per tensor dim, as ``jax.sharding.PartitionSpec``: ``None``
    (replicated), a mesh axis name, or a tuple of names (the dim split over
    those axes, the first the major one). Trailing ``None`` s are dropped."""

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def mesh_axes(mesh) -> dict[str, int]:
    """The mesh's axis sizes by name, in the mesh's order."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))


def is_trivial(mesh) -> bool:
    """No mesh, or one whose every axis has size 1: every sharding is the
    identity there."""
    return mesh is None or all(n == 1 for n in mesh_axes(mesh).values())


def _physical(axis: str | None, rules: dict, names: tuple[str, ...]) -> Any:
    if axis is None:
        return None
    phys = rules.get(axis, None)
    if phys is None:
        return None
    if isinstance(phys, tuple):
        present = tuple(p for p in phys if p in names)
        return present if present else None
    return phys if phys in names else None


def logical_to_pspec(
    axes: tuple[str | None, ...],
    mesh,
    rules: dict | None = None,
    *,
    shape: tuple[int, ...] | None = None,
) -> PartitionSpec:
    """Logical axes -> PartitionSpec, dropping non-divisible shardings: a
    mesh axis is used at most once a tensor, and a dim whose size its mesh
    axes do not divide drops axes from the right until they do."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    parts: list[Any] = []
    for i, ax in enumerate(axes):
        phys = _physical(ax, rules, tuple(sizes))
        if phys is None:
            parts.append(None)
            continue
        names = phys if isinstance(phys, tuple) else (phys,)
        names = tuple(n for n in names if n not in used)
        if shape is not None:
            while names and shape[i] % math.prod(sizes[n] for n in names):
                names = names[:-1]
        if not names:
            parts.append(None)
            continue
        used.update(names)
        parts.append(names if len(names) > 1 else names[0])
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def partition_specs(tree: Any, mesh, rules: dict | None = None) -> Any:
    return tree_map(lambda s: logical_to_pspec(s.axes, mesh, rules, shape=s.shape), tree)


def _names(entry: Any) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(pspec: PartitionSpec, mesh) -> tuple[Placement, ...]:
    """DTensor placements of a PartitionSpec: ``Shard(dim)`` on every mesh
    dim that tensor dim ``dim`` names, ``Replicate()`` on the others. A dim
    split over several mesh axes (``("pod", "data")``) is sharded on each,
    the mesh's earlier dim the major one, as the spec's first name is."""
    order = list(mesh.mesh_dim_names)
    out: list[Placement] = [Replicate()] * len(order)
    for dim, entry in enumerate(pspec):
        for name in _names(entry):
            out[order.index(name)] = Shard(dim)
    return tuple(out)


def named_shardings(tree: Any, mesh, rules: dict | None = None) -> Any:
    """The placements of every leaf of a spec tree."""
    return tree_map(lambda s: to_placements(
        logical_to_pspec(s.axes, mesh, rules, shape=s.shape), mesh), tree)


# ---------------------------------------------------------------------------
# DTensors from tensors that every rank holds whole
# ---------------------------------------------------------------------------
def local_box(shape: tuple[int, ...], mesh, placements) -> tuple[slice, ...]:
    """This rank's index box of a tensor of global ``shape`` laid out by
    ``placements``: each ``Shard(d)`` splits dim d evenly, mesh dims in
    order (the earlier the major)."""
    coord = mesh.get_coordinate()
    lo, size = [0] * len(shape), list(shape)
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.mesh.shape[mdim]
            if size[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not split {n} ways")
            size[pl.dim] //= n
            lo[pl.dim] += coord[mdim] * size[pl.dim]
    return tuple(slice(a, a + n) for a, n in zip(lo, size))


def distribute(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A DTensor of ``t`` laid out by ``placements``, from this rank's own
    copy of the whole tensor: every rank takes its box, with no
    communication (every rank built ``t`` from the same seed or data). A
    ``Partial`` placement is not taken here. On a trivial mesh, ``t``."""
    if is_trivial(mesh):
        return t
    placements = tuple(placements)
    if any(not isinstance(p, (Shard, Replicate)) for p in placements):
        raise ValueError(f"distribute takes Shard and Replicate placements, not {placements}")
    local = t[local_box(tuple(t.shape), mesh, placements)].contiguous()
    stride = [1] * t.dim()
    for d in range(t.dim() - 2, -1, -1):
        stride[d] = stride[d + 1] * t.shape[d + 1]
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=t.shape,
                              stride=tuple(stride))


def replicate_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` (a plain tensor every rank holds whole) as a replicated DTensor
    on ``ref``'s mesh when ``ref`` is a DTensor; else ``t``."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, in place; a DTensor ``dst`` is written through its
    local shard, with ``src`` laid out as ``dst`` first (so a view's write
    reaches its base, which a redistributed temporary would not)."""
    if isinstance(dst, DTensor):
        src = replicate_like(src, dst).redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src)


def unflatten(t: torch.Tensor, dim: int, sizes: tuple[int, ...]) -> torch.Tensor:
    """``t.unflatten(dim, sizes)``. A DTensor split along ``dim`` more ways
    than divide ``sizes[0]`` (the dim's shards would not fall on whole
    rows of the new leading dim) is gathered along ``dim`` first."""
    if isinstance(t, DTensor):
        d = dim % t.dim()
        along = [m for m, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == d]
        if sizes[0] % math.prod(t.device_mesh.mesh.shape[m] for m in along):
            t = t.redistribute(t.device_mesh, [Replicate() if m in along else p
                                               for m, p in enumerate(t.placements)])
    return t.unflatten(dim, sizes)


def unstack(t: torch.Tensor) -> list[torch.Tensor]:
    """``t[0], t[1], ...``; a DTensor sharded along dim 0 is gathered along
    it first (a select cannot cut a sharded dim)."""
    if isinstance(t, DTensor) and any(isinstance(p, Shard) and p.dim == 0 for p in t.placements):
        t = t.redistribute(t.device_mesh, [Replicate() if isinstance(p, Shard) and p.dim == 0
                                           else p for p in t.placements])
    return [t[i] for i in range(t.shape[0])]


def empty_as(shape: tuple[int, ...], dtype: torch.dtype, like: torch.Tensor) -> torch.Tensor:
    """An uninitialized tensor of ``shape`` laid out as ``like`` (a DTensor
    with ``like``'s placements, or a plain tensor on its device)."""
    if not isinstance(like, DTensor):
        return torch.empty(shape, dtype=dtype, device=like.device)
    local = torch.empty(shape, dtype=dtype, device="meta")
    local = local[local_box(tuple(shape), like.device_mesh, like.placements)]
    return DTensor.from_local(torch.empty(local.shape, dtype=dtype, device=like.device),
                              like.device_mesh, like.placements, run_check=False,
                              shape=torch.Size(shape), stride=local.new_empty(shape).stride())


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (gathered on every rank), else ``t``."""
    return t.full_tensor() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------
# (mesh, rules, whether the mesh is trivial): the flag is read on every call
# of the model's hot path, so it is worked out once, on entry
_ACTIVATION_CTX: list[tuple[Any, dict | None, bool]] = []


class activation_sharding:
    """Context manager installing the mesh used by ``shard_activation`` and
    ``local_region``.

    Model code calls ``shard_activation(x, logical_axes)`` freely; outside
    this context, or for a tensor that is not a DTensor, or on a trivial
    mesh, it is the identity.
    """

    def __init__(self, mesh, rules: dict | None = None) -> None:
        self.mesh = mesh
        self.rules = rules

    def __enter__(self):
        _ACTIVATION_CTX.append((self.mesh, self.rules, is_trivial(self.mesh)))
        return self

    def __exit__(self, *exc):
        _ACTIVATION_CTX.pop()
        return False


def current_mesh() -> tuple[Any, dict | None] | None:
    """(mesh, rules) of the innermost ``activation_sharding`` whose mesh is
    not trivial, or None."""
    if not _ACTIVATION_CTX or _ACTIVATION_CTX[-1][2]:
        return None
    return _ACTIVATION_CTX[-1][:2]


def shard_activation(x: torch.Tensor, axes: tuple[str | None, ...]) -> torch.Tensor:
    """Redistribute a DTensor to the rule table's placements for ``axes``
    (no-op off-mesh, on a plain tensor, or on a trivial mesh).

    If no axis maps to a mesh axis the constraint is skipped entirely, as
    the reference skips it: pinning a tensor replicated would force
    collectives the producer's own sharding does not need.
    """
    ctx = current_mesh()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = logical_to_pspec(axes, mesh, rules, shape=tuple(x.shape))
    if not any(p is not None for p in spec):
        return x
    placements = to_placements(spec, mesh)
    return x if tuple(x.placements) == placements else x.redistribute(mesh, placements)


def shard_input(t: torch.Tensor, axes: tuple[str | None, ...]) -> torch.Tensor:
    """An input that every rank holds whole (tokens, positions) as a DTensor
    laid out by the rule table, as the reference's ``in_shardings`` lay out
    a step's inputs; the identity off-mesh or for a DTensor."""
    ctx = current_mesh()
    if ctx is None or isinstance(t, DTensor):
        return t
    mesh, rules = ctx
    return distribute(t, mesh, to_placements(
        logical_to_pspec(axes, mesh, rules, shape=tuple(t.shape)), mesh))


def shard_offset(axis: str, size: int) -> tuple[int, int]:
    """(offset, local size) of this rank's shard of a dim of logical
    ``axis`` and global ``size`` under the current mesh and rules; (0,
    size) off-mesh. For a local region that must know where its shard sits
    (the experts a rank holds, its query heads)."""
    ctx = current_mesh()
    if ctx is None:
        return 0, size
    mesh, rules = ctx
    spec = logical_to_pspec((axis,), mesh, rules, shape=(size,))
    names = _names(spec[0] if spec else None)
    sizes, coord = mesh_axes(mesh), mesh.get_coordinate()
    order = list(mesh.mesh_dim_names)
    index, ways = 0, 1
    for name in names:
        index = index * sizes[name] + coord[order.index(name)]
        ways *= sizes[name]
    return index * (size // ways), size // ways


@dataclasses.dataclass(frozen=True)
class Out:
    """A local region's output: its logical ``axes`` and the logical axes
    whose mesh axes it is a partial sum over (``partial``)."""

    axes: tuple[str | None, ...]
    partial: tuple[str, ...] = ()


def local_region(fn: Callable[..., Any], in_axes: tuple, out: tuple[Out | None, ...]
                 ) -> Callable[..., Any]:
    """``fn`` run on each rank's local shards (``local_map``), its inputs and
    outputs laid out by the current rule table.

    ``in_axes`` has one entry a positional argument: the logical axes of a
    tensor (a DTensor is redistributed to them first; a plain tensor, which
    every rank holds whole, is split), or None for an argument passed as
    is. ``out`` has one :class:`Out` (or None for a non-tensor) an output,
    in order. An output dim's divisibility is decided by the size of an
    input dim of the same logical axis. Off-mesh, or on a trivial mesh,
    ``fn`` runs on its arguments as they are.
    """

    def run(*args):
        ctx = current_mesh()
        if ctx is None or not any(isinstance(a, DTensor) for a in args):
            return fn(*args)
        mesh, rules = ctx
        sizes: dict[str, int] = {}
        in_pl, call = [], []
        for a, axes in zip(args, in_axes):
            if axes is None:
                in_pl.append(None)
                call.append(a)
                continue
            sizes.update((ax, n) for ax, n in zip(axes, a.shape) if ax is not None)
            pl = to_placements(logical_to_pspec(axes, mesh, rules, shape=tuple(a.shape)), mesh)
            in_pl.append(pl)
            call.append(a if isinstance(a, DTensor) else distribute(a, mesh, pl))
        out_pl = []
        for o in out:
            if o is None:
                out_pl.append(None)
                continue
            shape = tuple(sizes.get(ax, 1) if ax is not None else 1 for ax in o.axes)
            pl = list(to_placements(logical_to_pspec(o.axes, mesh, rules, shape=shape), mesh))
            order = list(mesh.mesh_dim_names)
            for ax in o.partial:
                spec = logical_to_pspec((ax,), mesh, rules, shape=(sizes[ax],))
                for name in _names(spec[0] if spec else None):
                    pl[order.index(name)] = Partial()
            out_pl.append(tuple(pl))
        # the gradient of an input replicated along a mesh dim that another
        # input or an output splits is each rank's partial sum along it
        split = {m for pl in (*in_pl, *out_pl) if pl is not None
                 for m, p in enumerate(pl) if not isinstance(p, Replicate)}
        grad_pl = tuple(None if pl is None else tuple(
            Partial() if m in split and isinstance(p, Replicate) else p for m, p in enumerate(pl))
            for pl in in_pl)
        return local_map(fn, out_placements=tuple(out_pl), in_placements=tuple(in_pl),
                         in_grad_placements=grad_pl, device_mesh=mesh,
                         redistribute_inputs=True)(*call)

    return run
