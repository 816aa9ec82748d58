"""Hilbert space-filling curve (SFC) used by the DMS distributed hash table.

The paper (S4.1, Fig. 9) maps n-D bounding boxes to a 1-D domain with a
Hilbert SFC, compacts the (possibly non-contiguous) image of the
application domain into a *virtual domain*, and range-partitions that
virtual domain over the storage servers.

We implement the classic iterative 2-D Hilbert transform (Wikipedia /
Warren variant) plus a Morton (Z-order) fallback for ranks != 2.  Both are
bijective on [0, 2^order)^rank -> [0, 2^(rank*order)) and are
property-tested in tests/test_hilbert.py.
"""
from __future__ import annotations

from typing import Sequence


def hilbert_d2xy(order: int, d: int) -> tuple[int, int]:
    """Distance along the curve -> (x, y) on a 2^order x 2^order grid."""
    n = 1 << order
    x = y = 0
    t = d
    s = 1
    while s < n:
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        x, y = _rot(s, x, y, rx, ry)
        x += s * rx
        y += s * ry
        t //= 4
        s *= 2
    return x, y


def hilbert_xy2d(order: int, x: int, y: int) -> int:
    """(x, y) -> distance along the curve."""
    n = 1 << order
    if not (0 <= x < n and 0 <= y < n):
        raise ValueError(f"point ({x},{y}) outside 2^{order} grid")
    d = 0
    s = n // 2
    while s > 0:
        rx = 1 if (x & s) > 0 else 0
        ry = 1 if (y & s) > 0 else 0
        d += s * s * ((3 * rx) ^ ry)
        x, y = _rot(s, x, y, rx, ry)
        s //= 2
    return d


def _rot(s: int, x: int, y: int, rx: int, ry: int) -> tuple[int, int]:
    if ry == 0:
        if rx == 1:
            x = s - 1 - x
            y = s - 1 - y
        x, y = y, x
    return x, y


def morton_encode(order: int, coords: Sequence[int]) -> int:
    """Z-order interleave for arbitrary rank (DMS fallback for rank != 2)."""
    d = 0
    rank = len(coords)
    for bit in range(order):
        for axis, c in enumerate(coords):
            d |= ((c >> bit) & 1) << (bit * rank + axis)
    return d


def morton_decode(order: int, rank: int, d: int) -> tuple[int, ...]:
    coords = [0] * rank
    for bit in range(order):
        for axis in range(rank):
            coords[axis] |= ((d >> (bit * rank + axis)) & 1) << bit
    return tuple(coords)


def sfc_index(order: int, coords: Sequence[int]) -> int:
    """Unified entry point used by the DHT: Hilbert for 2-D, Morton otherwise."""
    if len(coords) == 2:
        return hilbert_xy2d(order, coords[0], coords[1])
    return morton_encode(order, coords)


def sfc_order_for(extent: int) -> int:
    """Smallest order such that 2^order covers ``extent`` grid cells."""
    order = 0
    while (1 << order) < extent:
        order += 1
    return max(order, 1)
