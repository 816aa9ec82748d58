"""Named kernel chains: the unit of near-data compute (paper §3, §5.1).

The paper decomposes coarse-grain analysis stages into fine-grain
operations that run next to their data; a *kernel chain* is the wire
name for such a decomposition — a ``|``-separated sequence of registered
stages, e.g. ``"deconv|threshold|ccl"``, that a client ships to the
region gateway instead of pulling raw tiles and computing locally.

Every stage dispatches through :mod:`repro_torch.kernels.ops`, so the same
chain launches the hand-written CUDA kernels on the card and runs their plain
PyTorch versions on the CPU (``impl="auto"``); chains therefore inherit the
per-kernel exactness that ``chip_smoke.py`` holds each kernel to. Names,
errors, messages and digests are ``repro.kernels.chains``'s.

Registry contract:

* a stage declares its parameter schema (name, type, default, check) and
  its input/output ranks; :func:`resolve_chain` validates the whole
  request *before* any data moves — unknown stages raise
  :class:`UnknownChainError`, bad/unknown/ill-typed params and rank
  mismatches raise :class:`ChainParamError` — so a gateway fails fast at
  submit time, never inside a worker;
* device stages compose into one plain function on tensors (fed whole
  windows through ``runtime/prefetch.DevicePipeline``; nothing is traced
  or compiled, the kernels launch eagerly); host stages (terminal
  reductions like ``count``) run on the downloaded result;
* :meth:`Chain.digest` is a stable content hash of the canonical chain
  string plus its fully-defaulted params — the derived-product cache key
  component, so ``"deconv|threshold"`` with ``thr=0.5`` and the same
  chain with ``{"thr": 0.5}`` spelled explicitly share cache entries.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch import staging
from repro_torch.core.regions import to_numpy
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref


class ChainError(Exception):
    """Base for chain resolution failures (always raised at submit time)."""


class UnknownChainError(ChainError):
    """The chain names a stage that is not registered."""


class ChainParamError(ChainError):
    """Bad parameter (unknown name, wrong type, failed check) or an
    input whose rank no stage composition can accept."""


@dataclasses.dataclass(frozen=True)
class Param:
    """One stage parameter: declared type, default, optional validator."""

    type: type
    default: Any
    check: Callable[[Any], bool] | None = None
    doc: str = ""

    def coerce(self, stage: str, name: str, value: Any) -> Any:
        if self.type is float and isinstance(value, int) and not isinstance(value, bool):
            value = float(value)
        if not isinstance(value, self.type) or (
            self.type is int and isinstance(value, bool)
        ):
            raise ChainParamError(
                f"stage {stage!r} param {name!r} wants {self.type.__name__}, "
                f"got {type(value).__name__} ({value!r})"
            )
        if self.check is not None and not self.check(value):
            raise ChainParamError(
                f"stage {stage!r} param {name!r} rejected value {value!r} ({self.doc})"
            )
        return value


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One registered stage.

    ``fn(x, params, impl)`` — device stages take/return tensors, host
    stages take/return numpy (they run after the pipeline download).
    ``out_rank(in_rank, params)`` lets rank depend on params (``deconv``
    with ``stain=-1`` keeps all 3 stain planes).
    """

    name: str
    fn: Callable[[Any, dict, str], Any]
    in_ranks: tuple[int, ...]
    out_rank: Callable[[int, dict], int]
    params: Mapping[str, Param] = dataclasses.field(default_factory=dict)
    host: bool = False
    reduces: bool = False  # output is a small feature vector, not an image
    doc: str = ""


_STAGES: dict[str, StageSpec] = {}


def register_stage(spec: StageSpec) -> StageSpec:
    if spec.name in _STAGES:
        raise ValueError(f"stage {spec.name!r} already registered")
    if "|" in spec.name or not spec.name:
        raise ValueError(f"bad stage name {spec.name!r}")
    _STAGES[spec.name] = spec
    return spec


def list_stages() -> dict[str, StageSpec]:
    return dict(_STAGES)


# ---------------------------------------------------------------------------
# Built-in stages (the paper's segmentation + feature operators)
# ---------------------------------------------------------------------------
_MINV = ref.stain_inverse()  # Ruifrok-Johnston H&E+DAB unmixing matrix


def _deconv(x, params, impl):
    minv = torch.as_tensor(_MINV, device=x.device)
    stains = ops.color_deconv(x.to(torch.float32).contiguous(), minv, impl=impl)
    stain = params["stain"]
    return stains if stain < 0 else stains[stain]


def _threshold(x, params, impl):
    x = x.to(torch.float32)
    if params["norm"]:
        # one sort for both order statistics; torch.quantile refuses inputs
        # above 2**24 elements, a 4096^2 window
        lo, hi = ref.percentile(x, (5.0, 99.5))
        x = torch.clamp((x - lo) / torch.clamp(hi - lo, min=1e-6), 0.0, 1.0)
    # uint8 on purpose: a binary mask is the derived product, and the
    # egress win (vs float32 raw tiles) is the whole point of the chain
    return (x > params["thr"]).to(torch.uint8)


def _fill(x, params, impl):
    filled = ops.fill_holes(x.to(torch.float32).contiguous(), impl=impl)
    return (filled > 0.5).to(torch.uint8)


def _ccl(x, params, impl):
    return ops.connected_components((x != 0).to(torch.int32).contiguous(), impl=impl)


def _count(x, params, impl):
    labels = np.asarray(x)
    return np.array([np.unique(labels[labels >= 0]).size], dtype=np.int32)


def _glcm(x, params, impl):
    nb = params["num_bins"]
    bins = ref.quantize_ref(x.to(torch.float32), nb).contiguous()
    return ops.texture_features(bins[None], nb, impl=impl)[0]


register_stage(StageSpec(
    "deconv",
    _deconv,
    in_ranks=(3,),
    out_rank=lambda r, p: 3 if p["stain"] < 0 else 2,
    params={
        "stain": Param(int, 0, lambda v: -1 <= v <= 2,
                       "-1=all planes, 0=hematoxylin, 1=eosin, 2=DAB"),
    },
    doc="(3,H,W) RGB in [0,1] -> stain optical densities",
))
register_stage(StageSpec(
    "threshold",
    _threshold,
    in_ranks=(2,),
    out_rank=lambda r, p: 2,
    params={
        "thr": Param(float, 0.5, lambda v: 0.0 < v < 1.0, "in (0,1)"),
        "norm": Param(bool, True, None, "percentile-normalize (5/99.5) first"),
    },
    doc="(H,W) intensity -> (H,W) uint8 binary mask",
))
register_stage(StageSpec(
    "fill",
    _fill,
    in_ranks=(2,),
    out_rank=lambda r, p: 2,
    doc="(H,W) binary mask -> holes filled (border-seeded reconstruction)",
))
register_stage(StageSpec(
    "ccl",
    _ccl,
    in_ranks=(2,),
    out_rank=lambda r, p: 2,
    doc="(H,W) mask -> int32 canonical labels (min flat index; bg=-1)",
))
register_stage(StageSpec(
    "count",
    _count,
    in_ranks=(2,),
    out_rank=lambda r, p: 1,
    host=True,
    reduces=True,
    doc="(H,W) labels -> [n_components] (host reduction)",
))
register_stage(StageSpec(
    "glcm",
    _glcm,
    in_ranks=(2,),
    out_rank=lambda r, p: 1,
    reduces=True,
    params={
        "num_bins": Param(int, 32, lambda v: 2 <= v <= 256, "in [2,256]"),
    },
    doc="(H,W) intensity in [0,1] -> (9,) GLCM+histogram features",
))

# Canonical chains exercised by tests and benchmarks (any |-composition
# of registered stages that type-checks is equally valid on the wire).
STANDARD_CHAINS: tuple[str, ...] = (
    "deconv",
    "deconv|threshold",
    "deconv|threshold|fill",
    "deconv|threshold|ccl",
    "deconv|threshold|ccl|count",
    "threshold|ccl",
    "glcm",
)


# ---------------------------------------------------------------------------
# Chain resolution
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Chain:
    """A validated stage composition with fully-defaulted params."""

    name: str                     # canonical "a|b|c"
    stages: tuple[StageSpec, ...]
    params: tuple[tuple[str, Any], ...]  # sorted, defaults filled
    in_ranks: tuple[int, ...]     # acceptable input ranks
    out_rank: int                 # given the smallest acceptable input
    reduces: bool                 # ends in a feature-vector reduction

    @property
    def params_dict(self) -> dict:
        return dict(self.params)

    def digest(self) -> str:
        """Stable content hash: the derived-cache key component."""
        blob = f"{self.name}::{self.params!r}".encode()
        return hashlib.sha1(blob).hexdigest()[:16]

    def check_input_rank(self, rank: int) -> None:
        if rank not in self.in_ranks:
            raise ChainParamError(
                f"chain {self.name!r} takes rank-{'/'.join(map(str, self.in_ranks))} "
                f"input, got rank-{rank}"
            )

    def device_fn(self, impl: str = "auto") -> Callable[[torch.Tensor], torch.Tensor]:
        """The composed device stages as one function on tensors; its
        kernels run where its input lies (``ops``' dispatch)."""
        return _device_fn(self.name, self.params, impl)

    def host_fn(self) -> Callable[[np.ndarray], np.ndarray] | None:
        """The terminal host stages (None when the chain is all-device)."""
        host = [s for s in self.stages if s.host]
        if not host:
            return None
        params = self.params_dict

        def run(x: np.ndarray) -> np.ndarray:
            for s in host:
                x = s.fn(x, params, "torch")
            return x

        return run

    def __call__(self, x, impl: str = "auto", device=None) -> np.ndarray:
        """Full local execution (device stages + host reductions) -> numpy.

        The device stages run on ``device`` (``None``: the CUDA card;
        ``"cpu"``: the plain versions on the CPU). This is the reference a
        gateway ``compute()`` must match bit-for-bit on identical input
        slices.
        """
        dev = resolve_device(device)
        arr = np.asarray(x)
        self.check_input_rank(arr.ndim)
        out = to_numpy(self.device_fn(impl)(staging.upload(arr, dev)))
        hfn = self.host_fn()
        return hfn(out) if hfn is not None else out


@functools.lru_cache(maxsize=128)
def _device_fn(name: str, params: tuple, impl: str):
    stages = [_STAGES[s] for s in name.split("|") if not _STAGES[s].host]
    pdict = dict(params)

    def run(x):
        for s in stages:
            x = s.fn(x, pdict, impl)
        return x

    return run


def resolve_chain(chain: str, params: Mapping[str, Any] | None = None) -> Chain:
    """Parse + validate ``"a|b|c"`` against the registry; fail fast.

    Raises :class:`UnknownChainError` for unregistered stage names and
    :class:`ChainParamError` for unknown/ill-typed/out-of-range params or
    stage compositions whose ranks cannot connect.
    """
    if not isinstance(chain, str) or not chain.strip():
        raise UnknownChainError(f"empty chain {chain!r}")
    names = [s.strip() for s in chain.split("|")]
    specs = []
    for n in names:
        if n not in _STAGES:
            raise UnknownChainError(
                f"unknown stage {n!r} in chain {chain!r} "
                f"(registered: {', '.join(sorted(_STAGES))})"
            )
        specs.append(_STAGES[n])
    # host stages are terminal reductions: nothing device-side may follow
    seen_host = False
    for s in specs:
        if seen_host and not s.host:
            raise ChainParamError(
                f"chain {chain!r}: device stage {s.name!r} cannot follow a "
                f"host reduction stage"
            )
        seen_host = seen_host or s.host
    # validate params: every key must belong to some stage in the chain
    params = dict(params or {})
    known: dict[str, tuple[StageSpec, Param]] = {}
    for s in specs:
        for pname, p in s.params.items():
            known.setdefault(pname, (s, p))
    unknown = set(params) - set(known)
    if unknown:
        raise ChainParamError(
            f"chain {chain!r}: unknown param(s) {sorted(unknown)} "
            f"(accepted: {sorted(known) or 'none'})"
        )
    resolved: dict[str, Any] = {}
    for pname, (s, p) in known.items():
        if pname in params:
            resolved[pname] = p.coerce(s.name, pname, params[pname])
        else:
            resolved[pname] = p.default
    # rank-connect the composition for every acceptable input rank
    in_ranks = []
    out_rank = None
    for r0 in specs[0].in_ranks:
        r = r0
        ok = True
        for s in specs:
            if r not in s.in_ranks:
                ok = False
                break
            r = s.out_rank(r, resolved)
        if ok:
            in_ranks.append(r0)
            out_rank = r if out_rank is None else out_rank
    if not in_ranks:
        raise ChainParamError(
            f"chain {chain!r}: no input rank connects the stage composition "
            f"(e.g. {specs[0].name!r} outputs rank the next stage rejects)"
        )
    return Chain(
        name="|".join(names),
        stages=tuple(specs),
        params=tuple(sorted(resolved.items())),
        in_ranks=tuple(in_ranks),
        out_rank=out_rank,
        reduces=specs[-1].reduces,
    )
