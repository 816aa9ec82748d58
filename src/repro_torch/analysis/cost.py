"""Per-rank cost counter for a traced step: the counterpart of the
reference's multiplicity-aware HLO analyzer (``repro/analysis/hlo.py``).

A step here is PyTorch run eagerly, not an HLO module, so there is no text
to parse and no ``while`` body to multiply: the counter watches the ops as
they run. ``CostCounter`` is a ``TorchDispatchMode``; a DTensor op passes
through it to DTensor's own dispatch, which runs the op on each rank's
local shard and comes back through the counter with those local tensors.
So every count is per rank, from the local shapes (``FlopCounterMode``
above DTensor would count the global op, and dividing that by the rank
count is wrong wherever work is replicated). The global shape
propagation DTensor runs on fake tensors is not counted. A Python loop over
L layers runs its ops L times, and is counted L times.

Reported, all per rank, under the keys of ``HloCost.as_dict``:
  * ``flops``            — 2*M*N*K for every matrix product (``mm``,
                           ``addmm``, ``bmm``, ``baddbmm``);
  * ``bytes``            — operand plus result bytes of every op that is
                           not a view, on local shards: an unfused upper
                           bound on memory traffic, so larger than the
                           reference's fusion-level proxy by design;
  * ``collective_bytes`` — max(operand, result) bytes of every
                           ``_c10d_functional`` collective, with a
                           breakdown and op counts per category (the HLO
                           names: all-reduce, all-gather, reduce-scatter,
                           all-to-all, collective-permute). DTensor's
                           Shard(i) -> Shard(j) redistribution is an
                           all-to-all; on a CPU mesh DTensor issues it as
                           an all-gather and a chunk (gloo has none), so the
                           counter counts it as the all-to-all a card's NCCL
                           runs: one, of the input's bytes. The bytes follow
                           the tensors' dtype: a bf16 partial sum moves in
                           bf16, where XLA's CPU backend carries it in f32;
  * ``while_trip_counts`` is always empty (nothing is a loop op here).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch
import torch.distributed.tensor.placement_types as _placement_types
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
    "shard_dim_alltoall": "all-to-all",  # DTensor's own op, off a CPU mesh
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")
# ops that move no memory: views, allocations, metadata and the collectives'
# bookkeeping
_NO_BYTES = {
    "view", "_unsafe_view", "reshape", "t", "transpose", "permute", "expand", "slice",
    "select", "alias", "as_strided", "detach", "unsqueeze", "squeeze", "split",
    "split_with_sizes", "unbind", "narrow", "chunk", "view_as", "unflatten", "flatten",
    "diagonal", "empty", "empty_strided", "empty_like", "lift_fresh", "wait_tensor",
    "_wrap_tensor_autograd", "sym_size", "sym_stride", "sym_numel", "is_same_size",
    "_local_scalar_dense",
}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    collective_counts: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    while_trip_counts: list = dataclasses.field(default_factory=list)
    dot_flops_by_shape: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    bytes_by_opcode: dict = dataclasses.field(default_factory=lambda: defaultdict(float))

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": self.collective_bytes,
            "collectives": dict(self.collectives),
            "collective_counts": dict(self.collective_counts),
            "while_trip_counts": list(self.while_trip_counts),
            "dot_flops_by_shape": dict(self.dot_flops_by_shape),
            "bytes_by_opcode": dict(self.bytes_by_opcode),
        }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(func, args) -> tuple[float, str] | None:
    """(2*M*N*K, "MxNxK" or "BxMxNxK") of a matrix product, else None."""
    if func in (_aten.mm.default, _aten.addmm.default):
        a, b = (args[0], args[1]) if func is _aten.mm.default else (args[1], args[2])
        (m, k), n = a.shape, b.shape[1]
        return 2.0 * m * n * k, f"{m}x{n}x{k}"
    if func in (_aten.bmm.default, _aten.baddbmm.default):
        a, b = (args[0], args[1]) if func is _aten.bmm.default else (args[1], args[2])
        (bt, m, k), n = a.shape, b.shape[2]
        return 2.0 * bt * m * n * k, f"{bt}x{m}x{n}x{k}"
    return None


class CostCounter(TorchDispatchMode):
    """Counts the ops that run inside ``with CostCounter() as c:`` into
    ``c.cost`` (see the module's docstring)."""

    def __init__(self) -> None:
        super().__init__()
        self.cost = Cost()
        self._in_alltoall = False
        self._shard_dim_alltoall = None

    def __enter__(self):
        self._shard_dim_alltoall = _placement_types.shard_dim_alltoall
        _placement_types.shard_dim_alltoall = self._alltoall
        return super().__enter__()

    def __exit__(self, *exc):
        _placement_types.shard_dim_alltoall = self._shard_dim_alltoall
        return super().__exit__(*exc)

    def _alltoall(self, local, gather_dim, shard_dim, mesh, mesh_dim):
        """DTensor's all-to-all. On a CPU mesh it runs as an all-gather and
        a chunk; that is counted as one all-to-all of ``local``'s bytes, and
        the stand-in's own ops not at all."""
        if mesh.device_type != "cpu":
            return self._shard_dim_alltoall(local, gather_dim, shard_dim, mesh, mesh_dim)
        self._add_collective("all-to-all", _nbytes(local))
        self._in_alltoall = True
        try:
            return self._shard_dim_alltoall(local, gather_dim, shard_dim, mesh, mesh_dim)
        finally:
            self._in_alltoall = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on local shards, which come back here
        out = func(*args, **kwargs)
        tensors = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if (any(isinstance(t, FakeTensor) for t in tensors)
                or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None):
            return out  # DTensor's shape propagation on the global shapes
        self._count(func, args, tensors, out)
        return out

    def _add_collective(self, kind: str, moved: int) -> None:
        c = self.cost
        c.collective_bytes += moved
        c.collectives[kind] += moved
        c.collective_counts[kind] += 1

    def _count(self, func, args, tensors, out) -> None:
        if self._in_alltoall:
            return
        c = self.cost
        name = func.overloadpacket.__name__
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        dot = _dot_flops(func, args)
        if dot is not None:
            c.flops += dot[0]
            c.dot_flops_by_shape[dot[1]] += dot[0]
        if func.namespace in _COLLECTIVE_NAMESPACES and name in _COLLECTIVES:
            moved = max(sum(map(_nbytes, tensors)), sum(map(_nbytes, outs)))
            self._add_collective(_COLLECTIVES[name], moved)
            return
        if name in _NO_BYTES or func.namespace in _COLLECTIVE_NAMESPACES:
            return
        seen, moved = set(), 0
        for t in [*tensors, *outs]:
            if id(t) not in seen:
                seen.add(id(t))
                moved += _nbytes(t)
        c.bytes += moved
        c.bytes_by_opcode[name] += moved
