"""Per-client fairness for the serving gateway: weighted priority
classes and per-client pacing.

One FIFO admission queue lets a single hog monopolize every worker: its
burst sits at the head and the batch window drains it first, every time.
This module replaces the FIFO with two explicit mechanisms:

* :class:`FairScheduler` — one queue per priority class, drained by
  deficit round-robin with unit request cost: each visit to a class
  grants it ``weight`` requests of budget, so over any window the
  classes share workers in proportion to their weights no matter how
  deep any one backlog is.  Within a class, order stays FIFO, and the
  coalescer's same-key batching drains from the *scheduled* class only —
  fairness is decided before batching, so a low-priority scan cannot
  ride a high-priority request's batch window.
* :class:`ClientPacer` — a lazily-created
  :class:`~repro_torch.core.pacing.TokenBucket` per client id.  ``submit``
  pays one token before admission, so a client exceeding its rate blocks
  *itself* (bounded by its own bucket, outside every gateway lock) while
  everyone else's admission latency is untouched.

The scheduler is deliberately lock-free: the gateway serializes access
under its own admission lock, exactly as it did with the plain deque.
"""
from __future__ import annotations

import collections
import threading
from typing import Iterable, Iterator, Mapping

from repro_torch.core.pacing import TokenBucket

DEFAULT_CLASSES: tuple[tuple[str, int], ...] = (
    ("interactive", 4),
    ("default", 2),
    ("batch", 1),
)


class FairScheduler:
    """Weighted deficit-round-robin over per-class FIFO queues.

    NOT thread-safe: the owning gateway calls every method under its
    admission lock.  Tickets carry a ``priority`` attribute naming their
    class; unknown names fall back to ``"default"`` (or the first
    configured class when no ``"default"`` exists) so a typo degrades a
    request's priority instead of dropping it.
    """

    def __init__(self, classes: "Mapping[str, int] | Iterable[tuple[str, int]]") -> None:
        pairs = list(classes.items() if isinstance(classes, Mapping) else classes)
        if not pairs:
            raise ValueError("need at least one priority class")
        self._weights: dict[str, int] = {}
        for name, weight in pairs:
            if int(weight) < 1:
                raise ValueError(f"class {name!r} weight must be >= 1, got {weight}")
            self._weights[str(name)] = int(weight)
        self._order = list(self._weights)
        self._fallback = "default" if "default" in self._weights else self._order[0]
        self._queues: dict[str, collections.deque] = {
            name: collections.deque() for name in self._order
        }
        self._ptr = 0
        # current class's remaining budget (deficit counter with unit
        # request cost): refilled to the class weight when the pointer
        # arrives, spent one request at a time
        self._budget = self._weights[self._order[0]]
        self._len = 0

    def resolve(self, priority: "str | None") -> str:
        name = priority if priority in self._weights else self._fallback
        return name

    def push(self, ticket) -> None:
        self._queues[self.resolve(getattr(ticket, "priority", None))].append(ticket)
        self._len += 1

    def __len__(self) -> int:
        return self._len

    def pop_head(self):
        """The next ticket by weighted round-robin, or None when empty."""
        if self._len == 0:
            return None
        while True:
            name = self._order[self._ptr]
            queue = self._queues[name]
            if queue and self._budget > 0:
                self._budget -= 1
                self._len -= 1
                return queue.popleft()
            # class idle or budget spent: move on, refill the next class
            self._ptr = (self._ptr + 1) % len(self._order)
            self._budget = self._weights[self._order[self._ptr]]

    def drain_matching(self, head, limit: int, coalesce: bool) -> list:
        """Pop up to ``limit - 1`` more tickets batchable with ``head``
        (same key, same group) from *head's own class* — other classes'
        budgets are not consumed by someone else's batch window."""
        batch = [head]
        if not coalesce or limit <= 1:
            return batch
        queue = self._queues[self.resolve(getattr(head, "priority", None))]
        keep: collections.deque = collections.deque()
        while queue:
            ticket = queue.popleft()
            if (
                ticket.key == head.key
                and ticket.group == head.group
                and len(batch) < limit
            ):
                batch.append(ticket)
                self._len -= 1
            else:
                keep.append(ticket)
        queue.extend(keep)
        return batch

    def tickets(self) -> Iterator:
        """Every queued ticket (shutdown sweep)."""
        for queue in self._queues.values():
            yield from queue


class ClientPacer:
    """Per-client token buckets: one client's burst throttles only
    itself.  ``None`` client ids share one anonymous bucket (they are
    indistinguishable anyway, and an unthrottled anonymous path would be
    the obvious loophole)."""

    def __init__(
        self,
        rate: float,
        burst: float | None = None,
        *,
        clock=None,
        sleep=None,
    ) -> None:
        self.rate = float(rate)
        self.burst = burst
        self._kw = {}
        if clock is not None:
            self._kw["clock"] = clock
        if sleep is not None:
            self._kw["sleep"] = sleep
        self._lock = threading.Lock()
        self._buckets: dict[object, TokenBucket] = {}

    def take(self, client) -> float:
        """Pay one token from ``client``'s bucket; returns seconds waited.
        The wait happens inside the bucket, never under this lock."""
        with self._lock:
            bucket = self._buckets.get(client)
            if bucket is None:
                bucket = TokenBucket(self.rate, self.burst, **self._kw)
                self._buckets[client] = bucket
        return bucket.take(1.0)

    def clients(self) -> int:
        with self._lock:
            return len(self._buckets)
