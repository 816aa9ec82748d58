"""Worker Resource Manager: fine-grain task scheduling (paper S3.2.1).

Policies
--------
* **FCFS** — first-come first-served.
* **PATS** — the ready queue is kept sorted by estimated accelerator
  speedup; an idle accelerator takes the *max*-speedup ready task, an idle
  CPU core the *min*-speedup one.  Only the *ordering* of estimates
  matters, which is why PATS tolerates large estimate errors (Fig. 17).
* **DL** (orthogonal flag) — data-locality conscious assignment: when a
  device finishes a task, prefer a ready successor that reuses the data
  just produced there.  Under PATS the reuse task is taken iff
  ``S_d >= S_q * (1 - transfer_impact)`` (paper's rule verbatim); under
  FCFS any reuse task wins.  On CPUs the same rule gives NUMA-style
  affinity.
* **Pref** (simulator flag) — prefetch/async-copy: upload of a task's
  inputs overlaps the previous task's compute, so transfer cost only
  contributes ``max(0, transfer - prev_compute)``.

Two engines share the policy code:
  * :class:`ThreadedWRM` — real execution; one thread per (virtual)
    device; used by the live pipelines.
  * :class:`SimulatedWRM` — deterministic virtual-time list scheduler;
    used by the paper-figure benchmarks (no wall-clock sleeps).
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
from typing import Callable, Iterable

from repro_torch.runtime.dag import DeviceKind, Task, TaskState
from repro_torch.storage.tiers import TIER_BANDWIDTH


@dataclasses.dataclass(frozen=True)
class Device:
    did: int
    kind: DeviceKind

    def __repr__(self) -> str:
        return f"{self.kind.name}{self.did}"


def make_devices(num_cpus: int, num_accels: int) -> list[Device]:
    devs = [Device(i, DeviceKind.CPU) for i in range(num_cpus)]
    devs += [Device(num_cpus + i, DeviceKind.ACCEL) for i in range(num_accels)]
    return devs


@dataclasses.dataclass
class SchedulerConfig:
    policy: str = "PATS"  # PATS | FCFS
    data_locality: bool = False  # DL
    prefetch: bool = False  # Pref (simulator)
    transfer_impact: float = 0.2  # user-provided in the paper
    pcie_bandwidth: float = 8.0e9  # bytes/s, upload/download cost model
    # tier-locality refinement: maps a task's region_key to the storage
    # tier currently holding it (e.g. TieredStore.locality); tier names
    # price the staging transfer.  None = the paper's flat cost model.
    locality_fn: Callable | None = None
    tier_bandwidth: dict = dataclasses.field(
        default_factory=lambda: dict(TIER_BANDWIDTH)
    )

    def staging_cost(self, task: Task) -> float | None:
        """Seconds to stage the task's input from its resident tier, or
        None when locality is unknown (no refinement possible)."""
        if self.locality_fn is None:
            return None
        key = getattr(task, "region_key", None)
        if key is None:
            return None
        tier = self.locality_fn(key)
        bw = self.tier_bandwidth.get(tier) if tier is not None else None
        if bw is None:
            return None
        return task.cost.input_bytes / bw

    def transfer_impact_for(self, task: Task) -> float:
        """DL transfer impact, refined by tier locality when known:
        memory-resident inputs are nearly free to move (impact -> 0),
        DMS/DISK-resident inputs charge the modeled staging cost."""
        staging = self.staging_cost(task)
        if staging is None:
            return self.transfer_impact
        accel_s = task.cost.cpu_s / max(task.cost.speedup, 1e-9)
        return min(0.95, staging / max(staging + accel_s, 1e-12))


class ReadyQueue:
    """Ready tasks, sorted by speedup when PATS is active (paper Fig. 5)."""

    def __init__(self, policy: str) -> None:
        self.policy = policy
        self._tasks: list[Task] = []
        self._seq = 0
        self._arrival: dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._tasks)

    def push(self, task: Task) -> None:
        task.state = TaskState.READY
        self._arrival[task.tid] = self._seq
        self._seq += 1
        self._tasks.append(task)

    def peek_for(self, kind: DeviceKind) -> Task | None:
        cands = [t for t in self._tasks if t.runnable_on(kind)]
        if not cands:
            return None
        return self._best(cands, kind)

    def _best(self, cands: list[Task], kind: DeviceKind) -> Task:
        if self.policy == "FCFS":
            return min(cands, key=lambda t: self._arrival[t.tid])
        # PATS: accelerator takes max speedup, CPU takes min; FIFO tiebreak
        if kind == DeviceKind.ACCEL:
            return max(cands, key=lambda t: (t.speedup, -self._arrival[t.tid]))
        return min(cands, key=lambda t: (t.speedup, self._arrival[t.tid]))

    def pop(self, task: Task) -> Task:
        self._tasks.remove(task)
        self._arrival.pop(task.tid, None)
        return task

    def reuse_candidates(self, finished: Task, kind: DeviceKind) -> list[Task]:
        """Ready successors of ``finished`` (they reuse its output: DL)."""
        ready_ids = {t.tid for t in self._tasks}
        return [
            c
            for c in finished.children
            if c.tid in ready_ids and c.runnable_on(kind)
        ]

    def select(
        self,
        kind: DeviceKind,
        cfg: SchedulerConfig,
        last_finished: Task | None,
    ) -> Task | None:
        """Full policy: PATS/FCFS base + optional DL reuse rule."""
        best = self.peek_for(kind)
        if best is None:
            return None
        if cfg.data_locality and last_finished is not None:
            reuse = self.reuse_candidates(last_finished, kind)
            if reuse:
                best_reuse = self._best(reuse, kind)
                if cfg.policy == "FCFS":
                    return self.pop(best_reuse)
                s_q, s_d = best.speedup, best_reuse.speedup
                # impact of *not* reusing = cost of staging the queue-best
                # task's data (tier-refined when locality is known)
                impact = cfg.transfer_impact_for(best)
                if kind == DeviceKind.ACCEL:
                    if s_d >= s_q * (1.0 - impact):
                        return self.pop(best_reuse)
                else:
                    # CPU mirror: reuse unless it is much *better* on accel
                    if s_d <= s_q / (1.0 - impact):
                        return self.pop(best_reuse)
        return self.pop(best)


class _DepTracker:
    """Pending-task bookkeeping shared by both engines."""

    def __init__(self) -> None:
        self.waiting: dict[int, Task] = {}

    def admit(self, task: Task, ready: ReadyQueue) -> None:
        if all(d.state == TaskState.DONE for d in task.deps):
            ready.push(task)
        else:
            task.state = TaskState.PENDING
            self.waiting[task.tid] = task

    def release(self, finished: Task, ready: ReadyQueue) -> None:
        for child in finished.children:
            if child.tid in self.waiting and all(
                d.state == TaskState.DONE for d in child.deps
            ):
                del self.waiting[child.tid]
                ready.push(child)


# ---------------------------------------------------------------------------
# Real threaded engine
# ---------------------------------------------------------------------------
class ThreadedWRM:
    """One computing thread per device (paper Fig. 5), real execution."""

    def __init__(self, devices: Iterable[Device], cfg: SchedulerConfig | None = None):
        self.devices = list(devices)
        self.cfg = cfg or SchedulerConfig()
        self.ready = ReadyQueue(self.cfg.policy)
        self.deps = _DepTracker()
        self._cv = threading.Condition()
        self._outstanding = 0
        self._shutdown = False
        self._last_on: dict[int, Task | None] = {d.did: None for d in self.devices}
        self.completed: list[Task] = []
        self.profile: dict[str, dict] = {}
        self._threads = [
            threading.Thread(target=self._loop, args=(d,), daemon=True, name=f"wrm-{d}")
            for d in self.devices
        ]
        for t in self._threads:
            t.start()

    def submit(self, task: Task) -> Task:
        with self._cv:
            self._outstanding += 1
            self.deps.admit(task, self.ready)
            self._cv.notify_all()
        return task

    def _loop(self, dev: Device) -> None:
        while True:
            with self._cv:
                task = None
                while task is None:
                    if self._shutdown:
                        return
                    task = self.ready.select(dev.kind, self.cfg, self._last_on[dev.did])
                    if task is None:
                        self._cv.wait(timeout=0.05)
                task.state = TaskState.RUNNING
            import time as _time

            t0 = _time.perf_counter()
            try:
                fn = task.fn_for(dev.kind)
                task.result = fn(*task.args, **task.kwargs) if fn else None
                task.state = TaskState.DONE
            except BaseException as e:  # noqa: BLE001 - surfaced via task.error
                task.error = e
                task.state = TaskState.FAILED
            dt = _time.perf_counter() - t0
            task.ran_on = dev.kind
            with self._cv:
                prof = self.profile.setdefault(
                    task.name, {"cpu_s": 0.0, "accel_s": 0.0, "cpu_n": 0, "accel_n": 0}
                )
                if dev.kind == DeviceKind.CPU:
                    prof["cpu_s"] += dt
                    prof["cpu_n"] += 1
                else:
                    prof["accel_s"] += dt
                    prof["accel_n"] += 1
                self._last_on[dev.did] = task
                self.completed.append(task)
                if task.state == TaskState.DONE:
                    self.deps.release(task, self.ready)
                self._outstanding -= 1
                self._cv.notify_all()

    def measured_speedup(self, name: str) -> float | None:
        """Online EWMA-free estimate: mean cpu time / mean accel time."""
        p = self.profile.get(name)
        if not p or not p["cpu_n"] or not p["accel_n"]:
            return None
        return (p["cpu_s"] / p["cpu_n"]) / max(p["accel_s"] / p["accel_n"], 1e-12)

    def wait_all(self) -> None:
        with self._cv:
            while self._outstanding > 0:
                self._cv.wait(timeout=0.05)
        failed = [t for t in self.completed if t.state == TaskState.FAILED]
        if failed:
            raise RuntimeError(f"{len(failed)} task(s) failed") from failed[0].error

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)


# ---------------------------------------------------------------------------
# Deterministic virtual-time engine (paper-figure benchmarks)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SimResult:
    makespan: float
    per_device_busy: dict[str, float]
    task_log: list[tuple[float, float, str, str]]  # (start, end, task, device)
    accel_task_count: dict[str, int]


class SimulatedWRM:
    """Event-driven list scheduler over virtual time.

    Transfer model: executing on the accelerator charges
    ``input_bytes/pcie_bw`` upload unless DL just reused the producer's
    output on that device, and ``output_bytes/pcie_bw`` download unless a
    successor immediately reuses it there.  With Pref, the upload overlaps
    the device's previous compute.
    """

    def __init__(self, devices: Iterable[Device], cfg: SchedulerConfig | None = None):
        self.devices = list(devices)
        self.cfg = cfg or SchedulerConfig()

    def run(self, tasks: list[Task]) -> SimResult:
        cfg = self.cfg
        ready = ReadyQueue(cfg.policy)
        deps = _DepTracker()
        for t in tasks:
            t.state = TaskState.PENDING
        for t in tasks:
            deps.admit(t, ready)

        free_at = {d.did: 0.0 for d in self.devices}
        busy = {repr(d): 0.0 for d in self.devices}
        last_on: dict[int, Task | None] = {d.did: None for d in self.devices}
        prev_compute: dict[int, float] = {d.did: 0.0 for d in self.devices}
        # where each task's output currently lives (device id) - DL state
        output_home: dict[int, int] = {}
        events: list[tuple[float, int, int]] = []  # (time, seq, device_id)
        seq = 0
        for d in self.devices:
            heapq.heappush(events, (0.0, seq, d.did))
            seq += 1
        running: dict[int, Task | None] = {d.did: None for d in self.devices}
        dev_by_id = {d.did: d for d in self.devices}
        log: list[tuple[float, float, str, str]] = []
        accel_count: dict[str, int] = {}
        done = 0
        makespan = 0.0

        while events:
            now, _, did = heapq.heappop(events)
            dev = dev_by_id[did]
            fin = running[did]
            if fin is not None:
                fin.state = TaskState.DONE
                done += 1
                deps.release(fin, ready)
                last_on[did] = fin
                output_home[fin.tid] = did
                running[did] = None
                makespan = max(makespan, now)
                # a completion may unblock other idle devices
                for od in self.devices:
                    if running[od.did] is None and od.did != did:
                        heapq.heappush(events, (max(now, free_at[od.did]), seq, od.did))
                        seq += 1
            task = ready.select(dev.kind, cfg, last_on[did])
            if task is None:
                continue
            task.state = TaskState.RUNNING
            compute = (
                task.cost.cpu_s
                if dev.kind == DeviceKind.CPU
                else task.cost.cpu_s / max(task.cost.speedup, 1e-9)
            )
            transfer = 0.0
            if dev.kind == DeviceKind.ACCEL:
                inputs_resident = all(
                    output_home.get(d.tid) == did for d in task.deps
                ) and bool(task.deps)
                if not inputs_resident and task.cost.input_bytes:
                    transfer = task.cost.input_bytes / cfg.pcie_bandwidth
                if cfg.prefetch:
                    transfer = max(0.0, transfer - prev_compute[did])
                accel_count[task.name] = accel_count.get(task.name, 0) + 1
            # tier staging: inputs must reach host memory regardless of
            # device; memory-resident data is near-free, DMS/DISK charge
            # the modeled per-tier bandwidth (0.0 when unrefined)
            staging = cfg.staging_cost(task) or 0.0
            duration = compute + transfer + staging
            start = max(now, free_at[did])
            end = start + duration
            free_at[did] = end
            busy[repr(dev)] += duration
            prev_compute[did] = compute
            running[did] = task
            task.ran_on = dev.kind
            log.append((start, end, task.name, repr(dev)))
            heapq.heappush(events, (end, seq, did))
            seq += 1

        if done != len(tasks):
            raise RuntimeError(f"simulation deadlock: {done}/{len(tasks)} completed")
        return SimResult(makespan, busy, log, accel_count)
