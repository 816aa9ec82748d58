"""One driver a form of the program, found by the name a traffic file gives
under ``"form"``: ``forms/<form>.py`` holds a class ``Form``.

A form's life in one run: ``setup()`` builds the program and its inputs
(``make_inputs()``) from the seed and warms every shape the traffic uses,
noting the seconds of each part in ``phases``; ``install(tracer)``
(traced runs only) puts the benchmark's spans around the program's
functions; ``run(seconds)`` drives the traffic, starting work until
``seconds`` have passed and returning once all started work has finished;
``counters()`` snapshots the program's own counters; ``release()`` frees the
program's state; ``check(device)`` compares a sample of the answers with the
reference and returns the worst reading of each number; ``control(device,
dtype)`` reads the same numbers with the reference in ``dtype`` in the
program's place.
"""
from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from rtbench import compare, reference, tiles


class Tally:
    """What the window did: units attempted, completed and failed, and each
    completed unit's latency (a failed one counts as infinitely late)."""

    def __init__(self) -> None:
        self.attempted = self.completed = self.failed = 0
        self.latencies: list[float] = []
        self.errors: list[str] = []
        self._lock = threading.Lock()

    def done(self, n: int, seconds: float | None = None) -> None:
        with self._lock:
            self.attempted += n
            self.completed += n
            if seconds is not None:
                self.latencies.append(seconds)

    def fail(self, n: int, err: BaseException) -> None:
        with self._lock:
            self.attempted += n
            self.failed += n
            self.latencies.extend([float("inf")] * n)
            if len(self.errors) < 5:
                self.errors.append(f"{type(err).__name__}: {err}")


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from the seed."""

    def __init__(self, k: int, rng: np.random.Generator) -> None:
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class TileForm:
    """Shared by the forms that analyse whole tiles: a pool of distinct
    tiles made from the seed, visited in a seed-drawn order, and a sample of
    the answers kept for the check."""

    unit = "tile"

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        rng = np.random.default_rng([ctx.seed & (2**63 - 1), 1])
        self.sample = Reservoir(ctx.traffic["check_tiles"], rng)
        self.tally = Tally()
        self.phases: dict[str, float] = {}  # seconds of each part of the set-up

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.phases[name] = time.perf_counter() - t0

    def make_inputs(self) -> None:
        """The pool of distinct tiles and the order the window visits them in."""
        t = self.ctx.traffic
        size = self.ctx.config["wsi"]["tile"]
        with self.phase("inputs_s"):
            self.pool = tiles.make_pool(self.ctx.seed, t["pool_tiles"], size, self.ctx.device)
        rng = np.random.default_rng([self.ctx.seed & (2**63 - 1), 2])
        self.order = [int(i) for i in rng.permutation(t["pool_tiles"])]

    def keep(self, k: int, out: dict) -> None:
        self.sample.offer((k, out))

    def counters(self) -> dict:
        return {}

    def release(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, device) -> dict:
        wsi = self.ctx.config["wsi"]
        want: dict[int, dict] = {}
        readings = []
        for k, got in sorted(self.sample.items, key=lambda kv: kv[0]):
            if k not in want:
                want[k] = reference.analyze(self.pool[k], wsi, device)
            readings.append(compare.tile_numbers(got, want[k]))
        return compare.worst(readings)

    def control(self, device, dtype) -> dict:
        """The reference computed in ``dtype`` put in the program's place, on
        as many distinct pool tiles as a run compares."""
        wsi = self.ctx.config["wsi"]
        readings = []
        for k in self.order[: self.ctx.traffic["check_tiles"]]:
            want = reference.analyze(self.pool[k], wsi, device)
            got = reference.analyze(self.pool[k], wsi, device, dtype)
            readings.append(compare.tile_numbers(got, want))
        return compare.worst(readings)


def closed_loop(seconds: float, unit, tally: Tally, units: int = 1) -> None:
    """Call ``unit()`` back to back until ``seconds`` have passed; each call
    completes ``units`` units or fails them all."""
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        try:
            unit()
        except Exception as err:  # noqa: BLE001 — a failed unit is counted, the run goes on
            tally.fail(units, err)
            continue
        tally.done(units, time.perf_counter() - t0)
