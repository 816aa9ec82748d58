"""Spatio-temporal bounding boxes for region templates.

The paper (S3.3) defines a region template as a container bounded by a
spatial + temporal bounding box; data regions carry their own bounding box
and an ROI (region of interest) restricting what is materialized.  Boxes
here are half-open integer boxes ``[lo, hi)`` over an n-dimensional index
domain, which composes exactly with array slicing.

Ghost cells (S3.4) are handled by ``inflate`` (grow the ROI before reading)
and ``shrink`` (drop the halo before staging).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Iterator, Sequence


@dataclasses.dataclass(frozen=True, order=True)
class BoundingBox:
    """Half-open n-D box ``[lo, hi)`` with an optional time interval."""

    lo: tuple[int, ...]
    hi: tuple[int, ...]
    t_lo: int = 0
    t_hi: int = 1

    def __post_init__(self) -> None:
        if len(self.lo) != len(self.hi):
            raise ValueError(f"rank mismatch: {self.lo} vs {self.hi}")
        if any(h < l for l, h in zip(self.lo, self.hi)):
            raise ValueError(f"inverted box: {self.lo}..{self.hi}")
        if self.t_hi < self.t_lo:
            raise ValueError(f"inverted time interval: {self.t_lo}..{self.t_hi}")

    # -- construction helpers -------------------------------------------------
    @staticmethod
    def from_shape(shape: Sequence[int], t_lo: int = 0, t_hi: int = 1) -> "BoundingBox":
        return BoundingBox(tuple(0 for _ in shape), tuple(int(s) for s in shape), t_lo, t_hi)

    # -- basic geometry --------------------------------------------------------
    @property
    def rank(self) -> int:
        return len(self.lo)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(h - l for l, h in zip(self.lo, self.hi))

    @property
    def volume(self) -> int:
        v = 1
        for s in self.shape:
            v *= s
        return v

    @property
    def is_empty(self) -> bool:
        return self.volume == 0

    def slices(self) -> tuple[slice, ...]:
        """Slices addressing this box inside the global domain."""
        return tuple(slice(l, h) for l, h in zip(self.lo, self.hi))

    def local_slices(self, outer: "BoundingBox") -> tuple[slice, ...]:
        """Slices addressing this box inside an array whose origin is ``outer.lo``."""
        if not outer.contains(self):
            raise ValueError(f"{self} not contained in {outer}")
        return tuple(
            slice(l - ol, h - ol) for l, h, ol in zip(self.lo, self.hi, outer.lo)
        )

    # -- set operations ---------------------------------------------------------
    def contains(self, other: "BoundingBox") -> bool:
        return all(ol >= l for ol, l in zip(other.lo, self.lo)) and all(
            oh <= h for oh, h in zip(other.hi, self.hi)
        )

    def contains_point(self, pt: Sequence[int]) -> bool:
        return all(l <= p < h for p, l, h in zip(pt, self.lo, self.hi))

    def intersects(self, other: "BoundingBox") -> bool:
        return all(
            max(l, ol) < min(h, oh)
            for l, h, ol, oh in zip(self.lo, self.hi, other.lo, other.hi)
        )

    def intersect(self, other: "BoundingBox") -> "BoundingBox":
        lo = tuple(max(l, ol) for l, ol in zip(self.lo, other.lo))
        hi = tuple(max(lo_i, min(h, oh)) for lo_i, h, oh in zip(lo, self.hi, other.hi))
        return BoundingBox(lo, hi, max(self.t_lo, other.t_lo), max(self.t_hi, other.t_hi))

    def union(self, other: "BoundingBox") -> "BoundingBox":
        """Minimum bounding box of both (paper: RT bb grows as regions insert)."""
        lo = tuple(min(l, ol) for l, ol in zip(self.lo, other.lo))
        hi = tuple(max(h, oh) for h, oh in zip(self.hi, other.hi))
        return BoundingBox(lo, hi, min(self.t_lo, other.t_lo), max(self.t_hi, other.t_hi))

    # -- ghost-cell handling ------------------------------------------------------
    def inflate(self, halo: int | Sequence[int], within: "BoundingBox | None" = None) -> "BoundingBox":
        """Grow by ``halo`` per dim (clamped to ``within``): ghost-cell read ROI."""
        h = tuple(halo for _ in self.lo) if isinstance(halo, int) else tuple(halo)
        lo = tuple(l - hh for l, hh in zip(self.lo, h))
        hi = tuple(x + hh for x, hh in zip(self.hi, h))
        box = BoundingBox(lo, hi, self.t_lo, self.t_hi)
        return box.intersect(within) if within is not None else box

    def shrink(self, halo: int | Sequence[int]) -> "BoundingBox":
        """Drop the halo before staging results back (paper S3.4)."""
        h = tuple(halo for _ in self.lo) if isinstance(halo, int) else tuple(halo)
        return BoundingBox(
            tuple(l + hh for l, hh in zip(self.lo, h)),
            tuple(x - hh for x, hh in zip(self.hi, h)),
            self.t_lo,
            self.t_hi,
        )

    # -- partitioning ---------------------------------------------------------------
    def tiles(self, tile_shape: Sequence[int]) -> Iterator["BoundingBox"]:
        """Regular partition (paper Fig. 7 left: 50x50 blocks). Edge tiles clip."""
        ranges = []
        for l, h, t in zip(self.lo, self.hi, tile_shape):
            starts = range(l, h, int(t)) if h > l else []
            ranges.append([(s, min(s + int(t), h)) for s in starts])
        for combo in itertools.product(*ranges):
            lo = tuple(c[0] for c in combo)
            hi = tuple(c[1] for c in combo)
            yield BoundingBox(lo, hi, self.t_lo, self.t_hi)

    def split_weighted(self, weights: Sequence[float], axis: int = 0) -> list["BoundingBox"]:
        """Irregular 1-axis partition for load balance (paper Fig. 7 right)."""
        total = float(sum(weights))
        if total <= 0:
            raise ValueError("weights must sum > 0")
        extent = self.hi[axis] - self.lo[axis]
        cuts = [self.lo[axis]]
        acc = 0.0
        for w in weights[:-1]:
            acc += w / total
            cuts.append(self.lo[axis] + int(round(acc * extent)))
        cuts.append(self.hi[axis])
        out = []
        for a, b in zip(cuts[:-1], cuts[1:]):
            lo = list(self.lo)
            hi = list(self.hi)
            lo[axis], hi[axis] = a, max(a, b)
            out.append(BoundingBox(tuple(lo), tuple(hi), self.t_lo, self.t_hi))
        return out

    # -- misc ----------------------------------------------------------------
    def translate(self, offset: Sequence[int]) -> "BoundingBox":
        return BoundingBox(
            tuple(l + o for l, o in zip(self.lo, offset)),
            tuple(h + o for h, o in zip(self.hi, offset)),
            self.t_lo,
            self.t_hi,
        )

    def at_time(self, t_lo: int, t_hi: int | None = None) -> "BoundingBox":
        return BoundingBox(self.lo, self.hi, t_lo, t_hi if t_hi is not None else t_lo + 1)

    def __repr__(self) -> str:  # compact: <0,0;99,99>@[0,1)
        lo = ",".join(map(str, self.lo))
        hi = ",".join(map(str, self.hi))
        return f"<{lo};{hi}>@[{self.t_lo},{self.t_hi})"


def union_all(boxes: Iterable[BoundingBox]) -> BoundingBox:
    it = iter(boxes)
    try:
        acc = next(it)
    except StopIteration:
        raise ValueError("union_all of no boxes") from None
    for b in it:
        acc = acc.union(b)
    return acc
