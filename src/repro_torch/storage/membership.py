"""Elastic fleet membership: the epoch'd SFC ring (single placement truth).

The paper's deployment assumes a fixed server set for the whole run; the
DMS inherited that as a frozen ``num_servers`` captured at construction.
This module removes the assumption.  A :class:`RingView` is a versioned,
immutable snapshot of the fleet:

  * a **monotone epoch number** — every membership change (join/leave)
    produces a new view with ``epoch + 1``; servers and clients adopt
    whichever view carries the highest epoch, so propagation order never
    matters;
  * the **ordered live-server set** — join order is preserved, and the
    replica walk (home, then successors) follows this order, so the
    genesis view reproduces the legacy ``(home + i) % N`` ring exactly;
  * the **arc table** — who owns which span of the SFC virtual domain.

Arcs are *exact rationals* over the unit interval, independent of any
particular store's virtual-domain size: a block with compacted SFC rank
``r`` out of ``V`` lives at point ``r/V`` and is owned by the arc that
contains it.  The genesis arcs put server ``i``'s boundary at ``i/n``,
which makes ``owner(r, V) == (r * n) // V`` — bit-identical to the
legacy range partition, so a never-resized fleet sees zero placement
change from this refactor.

Minimal remap (the property the rebalancer and its tests rely on):

  * ``join(sid)`` — every existing server donates exactly ``1/(m+1)`` of
    its share (peeled from the tail of its arc list) to the newcomer.  A
    block moves **iff** the newcomer now owns its point; nothing shuffles
    between the incumbents.  With the equal shares the scheme maintains,
    that is ``K/(m+1)`` blocks for K blocks on m servers.
  * ``leave(sid)`` — only the departed server's arcs change hands,
    redistributed proportionally over the survivors (in ring order).  A
    block moves **iff** the departed server owned its point: ``K/m``
    blocks.

Because donations are exact fractions, shares stay *exactly* equal
(``1/m`` each) through any join/leave sequence — the property test
asserts equality, not a tolerance.

:class:`~repro.core.pacing.TokenBucket` (re-exported here for backward
compatibility) is the rebalance pacer: the sweep pays one token per
migrated block, so background migration yields to foreground traffic at
a configurable blocks/second rate instead of saturating the fleet.
"""
from __future__ import annotations

import bisect
import hashlib
import json
from fractions import Fraction
from typing import Iterable, Sequence

from repro_torch.core.pacing import TokenBucket

__all__ = ["RingView", "TokenBucket", "adopt_newer"]


class RingView:
    """Immutable fleet snapshot: ``(epoch, ordered servers, arc table)``.

    Construct with :meth:`genesis`, evolve with :meth:`join` /
    :meth:`leave` (each returns a NEW view with ``epoch + 1``), compare
    with ``epoch`` (monotone) or :meth:`checksum` (content digest).
    Serializes to plain JSON for the ``join``/``leave``/``epoch``
    transport ops, with arcs as exact ``[numerator, denominator, owner]``
    triples.
    """

    __slots__ = ("epoch", "servers", "_starts", "_owners")

    def __init__(
        self,
        epoch: int,
        servers: Sequence[int],
        arcs: Iterable[tuple[Fraction, int]],
    ) -> None:
        self.epoch = int(epoch)
        self.servers = tuple(int(s) for s in servers)
        pairs = sorted((Fraction(a), int(s)) for a, s in arcs)
        if not pairs or pairs[0][0] != 0:
            raise ValueError("arc table must start at 0")
        # merge adjacent same-owner arcs so the table stays compact
        starts: list[Fraction] = []
        owners: list[int] = []
        for start, owner in pairs:
            if owners and owners[-1] == owner:
                continue
            starts.append(start)
            owners.append(owner)
        self._starts = tuple(starts)
        self._owners = tuple(owners)
        live = set(self.servers)
        if not live.issuperset(owners):
            raise ValueError(f"arc owners {sorted(set(owners) - live)} not in live set")

    # -- construction / evolution --------------------------------------

    @classmethod
    def genesis(cls, num_servers: int) -> "RingView":
        """Epoch 0 over servers ``0..n-1`` with the legacy range
        partition: server ``i`` owns ``[i/n, (i+1)/n)``."""
        n = int(num_servers)
        if n < 1:
            raise ValueError("need at least one server")
        return cls(0, range(n), [(Fraction(i, n), i) for i in range(n)])

    def _arc_list(self) -> list[list]:
        """Mutable ``[start, end, owner]`` rows (end exclusive)."""
        rows = []
        for i, (start, owner) in enumerate(zip(self._starts, self._owners)):
            end = self._starts[i + 1] if i + 1 < len(self._starts) else Fraction(1)
            rows.append([start, end, owner])
        return rows

    def join(self, sid: int) -> "RingView":
        """New view with ``sid`` appended: every incumbent donates
        exactly ``share/(m+1)`` from the tail of its arc list, so only
        the newcomer's arcs change owner (minimal remap)."""
        sid = int(sid)
        if sid in self.servers:
            raise ValueError(f"server {sid} is already a ring member")
        m = len(self.servers)
        rows = self._arc_list()
        out: list[tuple[Fraction, int]] = []
        for owner in self.servers:
            mine = [r for r in rows if r[2] == owner]
            donate = sum((r[1] - r[0] for r in mine), Fraction(0)) / (m + 1)
            # peel the donation off the tail (highest-start arcs first)
            for r in reversed(mine):
                if donate <= 0:
                    break
                width = r[1] - r[0]
                give = min(width, donate)
                out.append((r[1] - give, sid))  # donated span -> newcomer
                r[1] -= give
                donate -= give
        out.extend((r[0], r[2]) for r in rows if r[1] > r[0])
        return RingView(self.epoch + 1, self.servers + (sid,), out)

    def leave(self, sid: int) -> "RingView":
        """New view without ``sid``: its arcs are handed to the
        survivors proportionally to their shares (walked in ring
        order), so only the departed server's arcs change owner."""
        sid = int(sid)
        if sid not in self.servers:
            raise ValueError(f"server {sid} is not a ring member")
        survivors = tuple(s for s in self.servers if s != sid)
        if not survivors:
            raise ValueError("cannot remove the last ring member")
        rows = self._arc_list()
        freed = [r for r in rows if r[2] == sid]
        kept = [r for r in rows if r[2] != sid]
        total = sum((r[1] - r[0] for r in freed), Fraction(0))
        shares = {
            s: sum((r[1] - r[0] for r in kept if r[2] == s), Fraction(0))
            for s in survivors
        }
        remaining = 1 - total
        out = [(r[0], r[2]) for r in kept]
        cursor = 0  # index into freed
        offset = Fraction(0)  # consumed prefix of freed[cursor]
        granted = Fraction(0)
        for i, s in enumerate(survivors):
            if i + 1 == len(survivors):
                gain = total - granted  # exact remainder to the last survivor
            else:
                gain = shares[s] * total / remaining if remaining else Fraction(0)
            granted += gain
            while gain > 0 and cursor < len(freed):
                lo, hi, _ = freed[cursor]
                lo = lo + offset
                width = hi - lo
                take = min(width, gain)
                out.append((lo, s))
                gain -= take
                if take == width:
                    cursor += 1
                    offset = Fraction(0)
                else:
                    offset += take
        return RingView(self.epoch + 1, survivors, out)

    # -- placement ------------------------------------------------------

    def owner(self, rank: int, virtual_size: int) -> int:
        """Home server of the block at compacted SFC ``rank`` (of
        ``virtual_size``): the owner of the arc containing ``rank/V``."""
        point = Fraction(int(rank), int(virtual_size))
        i = bisect.bisect_right(self._starts, point) - 1
        return self._owners[i]

    def walk(self, rank: int, virtual_size: int) -> list[int]:
        """Replica ring order for a block: its home first, then the
        remaining live servers in ring (join) order — the elastic
        generalization of the legacy ``(home + i) % N`` walk."""
        home = self.owner(rank, virtual_size)
        i = self.servers.index(home)
        n = len(self.servers)
        return [self.servers[(i + j) % n] for j in range(n)]

    def share(self, sid: int) -> Fraction:
        """Exact fraction of the SFC domain ``sid`` owns."""
        total = Fraction(0)
        for i, owner in enumerate(self._owners):
            if owner != int(sid):
                continue
            end = self._starts[i + 1] if i + 1 < len(self._starts) else Fraction(1)
            total += end - self._starts[i]
        return total

    @property
    def arcs(self) -> tuple[tuple[Fraction, int], ...]:
        return tuple(zip(self._starts, self._owners))

    # -- wire form ------------------------------------------------------

    def to_json(self) -> dict:
        return {
            "epoch": self.epoch,
            "servers": list(self.servers),
            "arcs": [
                [s.numerator, s.denominator, o]
                for s, o in zip(self._starts, self._owners)
            ],
        }

    @classmethod
    def from_json(cls, data: dict) -> "RingView":
        return cls(
            data["epoch"],
            data["servers"],
            [(Fraction(int(n), int(d)), int(o)) for n, d, o in data["arcs"]],
        )

    def checksum(self) -> str:
        """Short content digest of the view — epoch'd placement truth in
        one comparable token (operator dashboards, rebalance reports)."""
        blob = json.dumps(self.to_json(), separators=(",", ":"), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:12]

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, RingView)
            and self.epoch == other.epoch
            and self.servers == other.servers
            and self._starts == other._starts
            and self._owners == other._owners
        )

    def __hash__(self) -> int:
        return hash((self.epoch, self.servers, self._starts, self._owners))

    def __repr__(self) -> str:
        return (
            f"RingView(epoch={self.epoch}, servers={list(self.servers)}, "
            f"arcs={len(self._starts)})"
        )


def adopt_newer(current: "RingView | None", candidate: "RingView | None"):
    """The propagation rule, shared by servers and clients: keep
    whichever view has the higher epoch (ties keep the incumbent —
    epochs are produced by a single coordinator per change, so a tie IS
    the same view)."""
    if candidate is None:
        return current
    if current is None or candidate.epoch > current.epoch:
        return candidate
    return current
