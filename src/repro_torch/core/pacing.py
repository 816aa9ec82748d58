"""Shared rate pacing: the token bucket.

One implementation serves every layer that needs to cap a request or
migration rate — the elastic-fleet rebalancer paces block migration with
it (one token per migrated block, yielding to foreground traffic), and
the serving gateway's per-client throttle paces request admission with
it (one token per submitted request, so a hog client self-limits before
it can monopolize the admission queue).
"""
from __future__ import annotations

import threading
import time


class TokenBucket:
    """Blocking token-bucket pacer.

    ``rate`` tokens refill per second up to ``burst`` (default: one
    second's worth).  :meth:`take` blocks until the requested tokens are
    available and returns the seconds it waited — the rebalance sweep
    pays one token per migrated block, which caps migration throughput
    and leaves the fleet's remaining capacity to foreground traffic; the
    gateway's client throttle pays one token per request, which caps a
    single client's submit rate without touching anyone else's.
    ``clock``/``sleep`` are injectable for deterministic tests.
    """

    def __init__(
        self,
        rate: float,
        burst: float | None = None,
        *,
        clock=time.monotonic,
        sleep=time.sleep,
    ) -> None:
        self.rate = float(rate)
        if self.rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        self.burst = float(burst) if burst is not None else max(self.rate, 1.0)
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._last = clock()

    def _refill_locked(self, now: float) -> None:
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now

    def take(self, n: float = 1.0) -> float:
        """Consume ``n`` tokens, sleeping as needed; returns the seconds
        spent waiting (0.0 on the fast path)."""
        waited = 0.0
        while True:
            with self._lock:
                self._refill_locked(self._clock())
                if self._tokens >= n:
                    self._tokens -= n
                    return waited
                # clamp to 1us: float dust near the boundary would make
                # the sleep too small to advance any clock (and a real
                # clock would busy-spin instead of sleeping)
                need = max((n - self._tokens) / self.rate, 1e-6)
            # sleep OUTSIDE the lock: other takers must not queue behind
            # this waiter's nap
            self._sleep(need)
            waited += need
