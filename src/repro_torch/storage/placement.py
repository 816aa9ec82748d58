"""Placement policies for the tiered storage hierarchy.

The paper's unified region interface (§4, Fig. 8) hides *where* a data
region's bytes live; a :class:`PlacementPolicy` is the hook that decides
it.  Given the region identifier and payload metadata, the policy answers

  * which tier a fresh ``put`` should land in (pin hot namespaces to the
    memory tier, push cold/bulky regions straight to DISK or DMS);
  * whether the region may be promoted above / demoted below its tier;
  * the write policy for the region (write-through vs. write-back);
  * the spill granularity: demotions may be re-blocked into fixed ROI
    tiles so a later partial read from the lower tier moves only the
    tiles that intersect the request.

Policies are plain data + pure functions of the request, so the
:class:`~repro.storage.tiers.TieredStore` can evaluate them under its
lock without side effects.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.bbox import BoundingBox
from repro_torch.core.regions import RegionKey


@dataclasses.dataclass(frozen=True)
class Placement:
    """One placement decision for a region.

    ``tier``: target tier *name* (None = the store's top tier).
    ``pinned``: region must stay in its tier (never demoted out, never
    promoted above).
    ``write_policy``: per-region override of the store default
    ("write_through" | "write_back" | None = store default).
    ``spill_block``: ROI tile shape used when demoting; None spills the
    region as one chunk.
    """

    tier: str | None = None
    pinned: bool = False
    write_policy: str | None = None
    spill_block: tuple[int, ...] | None = None

    def __post_init__(self) -> None:
        if self.write_policy not in (None, "write_through", "write_back", "lazy"):
            raise ValueError(
                f"unknown write_policy {self.write_policy!r} "
                "(want 'write_through' | 'write_back' | 'lazy')"
            )


@dataclasses.dataclass(frozen=True)
class PlacementRule:
    """A predicate + the placement it yields; first matching rule wins."""

    match: Callable[[RegionKey, BoundingBox, int, np.dtype], bool]
    placement: Placement
    label: str = "rule"


def pin_namespace(namespace: str, tier: str, **kw) -> PlacementRule:
    """Pin every region of ``namespace`` to ``tier`` (paper: hot stage
    intermediates stay in the memory layer)."""
    return PlacementRule(
        match=lambda key, bb, nbytes, dtype: key.namespace == namespace,
        placement=Placement(tier=tier, pinned=True, **kw),
        label=f"pin:{namespace}->{tier}",
    )


def size_threshold(max_bytes: int, tier: str, **kw) -> PlacementRule:
    """Regions larger than ``max_bytes`` bypass the fast tiers and land
    directly in ``tier`` (bulk payloads would only thrash the cache)."""
    return PlacementRule(
        match=lambda key, bb, nbytes, dtype: nbytes > max_bytes,
        placement=Placement(tier=tier, **kw),
        label=f"size>{max_bytes}->{tier}",
    )


def when(
    cond: Callable[[RegionKey, BoundingBox, int, np.dtype], bool],
    tier: str,
    *,
    label: str | None = None,
    **kw,
) -> PlacementRule:
    """The general rule: route regions matching an arbitrary predicate
    ``cond(key, bb, nbytes, dtype)`` to ``tier``.  The named helpers are
    special cases of this; use it for ad-hoc routing (e.g. steering a
    timestamp range to the DMS tier while an elastic fleet rebalances)."""
    return PlacementRule(
        match=cond,
        placement=Placement(tier=tier, **kw),
        label=label or f"when:{getattr(cond, '__name__', 'cond')}->{tier}",
    )


def dtype_tier(dtypes: Sequence, tier: str, **kw) -> PlacementRule:
    """Route payloads of the given dtypes to ``tier`` (e.g. uint8 masks
    are cheap to recompute — keep them out of the memory tier)."""
    dts = {np.dtype(d) for d in dtypes}
    return PlacementRule(
        match=lambda key, bb, nbytes, dtype: np.dtype(dtype) in dts,
        placement=Placement(tier=tier, **kw),
        label=f"dtype:{sorted(str(d) for d in dts)}->{tier}",
    )


class PlacementPolicy:
    """Ordered rule list with a default placement.

    ``rules`` are evaluated first-match-wins; when none matches the
    default placement (top tier, store-default write policy) applies.
    ``spill_block`` set on the policy applies to every demotion whose
    matched placement did not set its own.
    """

    def __init__(
        self,
        rules: Sequence[PlacementRule] = (),
        *,
        default: Placement | None = None,
        spill_block: tuple[int, ...] | None = None,
    ) -> None:
        self.rules = list(rules)
        self.default = default or Placement()
        self.spill_block = spill_block

    def place(
        self, key: RegionKey, bb: BoundingBox, nbytes: int, dtype
    ) -> Placement:
        for rule in self.rules:
            if rule.match(key, bb, nbytes, dtype):
                return self._with_spill(rule.placement)
        return self._with_spill(self.default)

    def _with_spill(self, p: Placement) -> Placement:
        if p.spill_block is None and self.spill_block is not None:
            return dataclasses.replace(p, spill_block=self.spill_block)
        return p

    def __repr__(self) -> str:
        labels = ", ".join(r.label for r in self.rules) or "default-only"
        return f"PlacementPolicy({labels})"
