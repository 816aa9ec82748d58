"""Manager-Worker execution of the coarse-grain dataflow (paper S3.2, Fig. 4).

The Manager owns the (incrementally growable) stage dependency graph and
hands stage instances to Workers **demand-driven**: workers request work
whenever they have a free slot; assignment granularity is one stage
instance.  Each Worker runs a Worker Coordinator (WCT) that

  1. unpacks the stage's region-template *metadata* (payloads never ride
     the control channel — they go through global storage),
  2. materializes the input data regions from their storage backends
     (overlapping with the compute of other active stage instances),
  3. executes the stage body, whose fine-grain tasks flow through the
     shared per-worker :class:`ThreadedWRM`,
  4. stages output data regions to their global storage backends,
  5. notifies the Manager, which releases dependent stages.

While a profiler records, each stage leaves two spans (``repro_torch.spans``):
``rt.dispatch``, from the moment it became ready (submitted with no
dependency, its last dependency done, or re-queued) to the moment its
worker started it, and ``rt.stage.<class>`` around its execution on the
worker; the spans of its tasks nest under the latter.

Fault tolerance beyond the paper (needed at 1000+ nodes):
  * heartbeat-based worker failure detection; in-flight stages of a dead
    worker are re-queued (stage writes are idempotent — last staged wins);
  * bounded retry of failed stages on a different worker;
  * speculative re-execution of stragglers once the ready frontier is
    empty and idle workers remain.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any

from repro_torch import spans
from repro_torch.core.regions import STORAGE, DataRegion, RegionTemplate, StorageRegistry
from repro_torch.runtime.dag import (
    Stage,
    StageContext,
    StageState,
    Task,
)
from repro_torch.runtime.scheduler import Device, SchedulerConfig, ThreadedWRM, make_devices


class Worker:
    """One compute node: a WCT + a WRM over its devices (paper Fig. 4/5)."""

    def __init__(
        self,
        wid: int,
        manager: "Manager",
        devices: list[Device],
        *,
        max_active: int = 2,
        registry: StorageRegistry | None = None,
        sched: SchedulerConfig | None = None,
    ) -> None:
        self.wid = wid
        self.manager = manager
        self.registry = registry or STORAGE
        self.wrm = ThreadedWRM(devices, sched)
        self.max_active = max_active
        self.inbox: "queue.Queue[Stage | None]" = queue.Queue()
        self._slots = threading.Semaphore(max_active)
        self.alive = True
        self.last_seen = time.monotonic()
        self._wct = threading.Thread(target=self._wct_loop, daemon=True, name=f"wct-{wid}")
        self._wct.start()

    # -- WCT -------------------------------------------------------------------
    def _wct_loop(self) -> None:
        while self.alive:
            self.last_seen = time.monotonic()
            self._slots.acquire()
            if not self.alive:
                return
            self.manager._request_work(self.wid)
            try:
                stage = self.inbox.get(timeout=5.0)
            except queue.Empty:
                self._slots.release()
                continue
            if stage is None:
                self._slots.release()
                return
            threading.Thread(
                target=self._handle_stage,
                args=(stage,),
                daemon=True,
                name=f"stage-{stage.sid}@w{self.wid}",
            ).start()

    def _handle_stage(self, stage: Stage) -> None:
        ready_ns, stage.ready_ns = stage.ready_ns, None
        if ready_ns is not None:
            spans.record("rt.dispatch", ready_ns, time.time_ns())
        try:
            if not self.alive:
                return
            with spans.span("rt.stage." + type(stage).__name__):
                self._run_stage(stage)
        except BaseException as e:  # noqa: BLE001
            stage.error = e
            if self.alive:
                self.manager._notify_failed(stage, self.wid, e)
        finally:
            stage.unbind_thread_templates()
            self._slots.release()

    def _run_stage(self, stage: Stage) -> None:
        """Steps (1)-(5) of the module's docstring, for one stage instance."""
        stage.state = StageState.RUNNING
        # Worker-local template copies (metadata only, paper S3.2).
        # Copies are bound per-thread: a zombie execution on a dead
        # worker must never leak its (mutated) templates into a retry.
        local_templates = {
            k: RegionTemplate.unpack(v.pack()) for k, v in stage.templates.items()
        }
        stage.bind_thread_templates(local_templates)
        ctx = StageContext(
            stage,
            self,
            submit_task=self.wrm.submit,
            spawn_stage=self.manager.execute_component,
        )
        submitted: list[Task] = []
        orig_submit = ctx._submit_task

        def tracking_submit(task: Task) -> None:
            submitted.append(task)
            orig_submit(task)

        ctx._submit_task = tracking_submit

        # (2) materialize inputs — overlaps other stages' compute
        for b in stage.input_bindings():
            rt = local_templates[b.template]
            try:
                region = rt.get(b.region)
            except KeyError:
                # region produced upstream but unknown to this stage's
                # metadata: associative query against global storage
                # (paper S3.3: query interface on the tuple identifier)
                backend = self.registry.get(b.read_storage)
                cands = backend.query(rt.namespace, b.region)
                if not cands:
                    raise
                key, bb = max(cands, key=lambda kv: (kv[0].timestamp, kv[0].version))
                region = DataRegion(key, bb, input_storage=b.read_storage, lazy=True)
                rt.insert(region)
            local = region.with_roi(b.roi)
            if b.read_storage:
                local.input_storage = b.read_storage
                # record which storage layer serves this input
                # (observable consumption of the locality query)
                tier = self.registry.locality(b.read_storage, region.key)
                with self.manager._lock:
                    self.manager.events.append(
                        ("locality", (stage.sid, b.region, tier))
                    )
            local.instantiate(self.registry)
            ctx.regions[(b.template, b.region)] = local

        # (3) run the body; fine-grain tasks flow through the WRM
        stage.result = stage.run(ctx)
        self._wait_tasks(submitted)

        # (4) stage outputs to global storage
        for b in stage.output_bindings():
            rt = local_templates[b.template]
            region = rt.get(b.region)
            if region.empty():
                raise RuntimeError(
                    f"stage {stage.name}: output region {b.region!r} never materialized"
                )
            out = region.with_roi(b.roi)
            out._data = region.to_host()
            out._location = "host"
            out.output_storage = b.storage or region.output_storage
            out.write(self.registry)
        if not self.alive:
            return  # died mid-stage: manager's heartbeat will requeue
        # expose the winning execution's templates for inspection
        stage.templates = local_templates
        self.manager._notify_done(stage, self.wid)

    def _wait_tasks(self, tasks: list[Task]) -> None:
        from repro_torch.runtime.dag import TaskState

        while True:
            states = [t.state for t in tasks]
            if any(s == TaskState.FAILED for s in states):
                bad = next(t for t in tasks if t.state == TaskState.FAILED)
                raise RuntimeError(f"task {bad.name} failed") from bad.error
            if all(s == TaskState.DONE for s in states):
                return
            time.sleep(0.001)

    def kill(self) -> None:
        """Simulate node failure (tests/benchmarks)."""
        self.alive = False
        self.wrm.shutdown()

    def shutdown(self) -> None:
        self.alive = False
        self.inbox.put(None)
        self.wrm.shutdown()


class Manager:
    """Owns the stage graph; demand-driven dispatch; failure handling."""

    def __init__(
        self,
        *,
        heartbeat_timeout: float = 5.0,
        max_retries: int = 2,
        speculative: bool = False,
        speculation_factor: float = 2.5,
        registry: StorageRegistry | None = None,
    ) -> None:
        self.stages: dict[int, Stage] = {}
        # storage registry for tier-locality-aware dispatch (optional):
        # among equally-ready stages, prefer the one whose inputs sit in
        # the fastest storage tier (cheapest staging transfer)
        self.registry = registry
        from repro_torch.storage.tiers import TIER_BANDWIDTH

        # overridden by SysEnv from SchedulerConfig.tier_bandwidth so
        # dispatch and the WRM price tiers with the same table
        self.tier_bandwidth: dict[str, float] = dict(TIER_BANDWIDTH)
        # sticky: flips true once a hierarchical backend is registered,
        # keeping flat-storage dispatch on the cheap first-ready path
        self._locality_seen = False
        self.heartbeat_timeout = heartbeat_timeout
        self.max_retries = max_retries
        self.speculative = speculative
        self.speculation_factor = speculation_factor
        self.workers: dict[int, Worker] = {}
        self._requests: "queue.Queue[int]" = queue.Queue()
        self._lock = threading.RLock()
        self._done_evt = threading.Event()
        self._inflight: dict[int, tuple[int, float]] = {}  # sid -> (wid, t_start)
        self._speculated: set[int] = set()
        self.events: list[tuple[str, Any]] = []

    # -- graph construction (application Manager code, paper Fig. 8a) -------------
    def execute_component(self, stage: Stage) -> Stage:
        with self._lock:
            self.stages[stage.sid] = stage
            self._done_evt.clear()
            self._mark_ready(stage)
        return stage

    def _mark_ready(self, stage: Stage) -> None:
        """Note when ``stage`` became ready, for its ``rt.dispatch`` span."""
        if spans.enabled() and all(d.state == StageState.DONE for d in stage.deps):
            stage.ready_ns = time.time_ns()

    def add_worker(self, worker: Worker) -> None:
        with self._lock:
            self.workers[worker.wid] = worker

    # -- worker-facing protocol -----------------------------------------------------
    def _request_work(self, wid: int) -> None:
        self._requests.put(wid)

    def _notify_done(self, stage: Stage, wid: int) -> None:
        with self._lock:
            cur = self.stages.get(stage.sid)
            if cur is not None and cur.state == StageState.DONE:
                return  # speculative duplicate lost the race
            stage.state = StageState.DONE
            self.stages[stage.sid] = stage
            self._inflight.pop(stage.sid, None)
            self.events.append(("done", (stage.sid, wid)))
            if spans.enabled():
                for waiting in self.stages.values():
                    if waiting.state == StageState.WAITING and stage in waiting.deps:
                        self._mark_ready(waiting)

    def _notify_failed(self, stage: Stage, wid: int, err: BaseException) -> None:
        with self._lock:
            if self.stages.get(stage.sid) and self.stages[stage.sid].state == StageState.DONE:
                return
            stage.attempts += 1
            self._inflight.pop(stage.sid, None)
            self.events.append(("failed", (stage.sid, wid, repr(err))))
            if stage.attempts > self.max_retries:
                stage.state = StageState.FAILED
                self._done_evt.set()  # unrecoverable: surface to run()
            else:
                stage.state = StageState.WAITING  # re-queue elsewhere
                self._mark_ready(stage)

    # -- main loop --------------------------------------------------------------------
    def run(self, poll: float = 0.005) -> None:
        """Block until every stage is DONE (or raise on unrecoverable FAIL)."""
        while True:
            with self._lock:
                states = [s.state for s in self.stages.values()]
                if any(s == StageState.FAILED for s in states):
                    bad = next(
                        s for s in self.stages.values() if s.state == StageState.FAILED
                    )
                    raise RuntimeError(
                        f"stage {bad.name}#{bad.sid} failed after {bad.attempts} attempts"
                    ) from bad.error
                if states and all(s == StageState.DONE for s in states):
                    return
                self._check_heartbeats()
            try:
                wid = self._requests.get(timeout=poll)
            except queue.Empty:
                continue
            with self._lock:
                worker = self.workers.get(wid)
                if worker is None or not worker.alive:
                    continue
                stage = self._pick_ready()
                if stage is None and self.speculative:
                    stage = self._pick_straggler()
                if stage is None:
                    # nothing ready: requeue the request (demand persists)
                    threading.Timer(poll, self._requests.put, args=(wid,)).start()
                    continue
                stage.state = StageState.DISPATCHED
                stage.worker = wid
                self._inflight[stage.sid] = (wid, time.monotonic())
                self.events.append(("dispatch", (stage.sid, wid)))
            worker.inbox.put(stage)

    def _pick_ready(self) -> Stage | None:
        ready = [
            s
            for s in self.stages.values()
            if s.state == StageState.WAITING
            and all(d.state == StageState.DONE for d in s.deps)
        ]
        if not ready:
            return None
        if self.registry is None or len(ready) == 1 or not self._locality_available():
            return ready[0]
        # min() is stable: ties keep the original demand-driven order
        return min(ready, key=self._staging_estimate)

    def _locality_available(self) -> bool:
        if self._locality_seen:
            return True
        try:
            names = self.registry.names()
        except Exception:  # noqa: BLE001 - registry shape is caller-defined
            return False
        for name in names:
            if callable(getattr(self.registry.get(name), "locality", None)):
                self._locality_seen = True
                return True
        return False

    def _staging_estimate(self, stage: Stage) -> float:
        """Virtual seconds to stage the stage's inputs, priced per tier.

        Backends without a ``locality`` query contribute 0 (no
        information), so flat-storage runs keep the original order.
        """
        total = 0.0
        for b in stage.input_bindings():
            if not b.read_storage:
                continue
            rt = stage.templates.get(b.template)
            if rt is None:
                continue
            try:
                backend = self.registry.get(b.read_storage)
                region = rt.get(b.region)
            except KeyError:
                continue  # unknown backend / region produced upstream
            # only hierarchical backends carry placement information; a
            # flat backend whose *name* collides with a tier label must
            # not be priced as that tier
            if not callable(getattr(backend, "locality", None)):
                continue
            tier = backend.locality(region.key)
            bw = self.tier_bandwidth.get(tier) if tier is not None else None
            if bw:
                # the stage stages only its bound ROI, not the whole region
                roi_bytes = b.roi.volume * region.key.elem_type.itemsize
                total += roi_bytes / bw
        return total

    def _pick_straggler(self) -> Stage | None:
        """Speculative re-execution: duplicate the longest-running stage."""
        if not self._inflight:
            return None
        durations = [
            (time.monotonic() - t0, sid) for sid, (_, t0) in self._inflight.items()
        ]
        if len(durations) < 1:
            return None
        dur, sid = max(durations)
        med = sorted(d for d, _ in durations)[len(durations) // 2]
        if sid in self._speculated or dur < self.speculation_factor * max(med, 1e-3):
            return None
        self._speculated.add(sid)
        original = self.stages[sid]
        self.events.append(("speculate", (sid,)))
        return original  # idempotent outputs: duplicate is safe

    def _check_heartbeats(self) -> None:
        now = time.monotonic()
        for wid, w in list(self.workers.items()):
            if not w.alive or now - w.last_seen <= self.heartbeat_timeout:
                if not w.alive:
                    self._requeue_from(wid)
                continue
            # stale heartbeat: only declare death if the WCT thread is
            # actually gone — a starved-but-live worker is a straggler,
            # not a failure (speculation handles stragglers)
            if w._wct.is_alive():
                continue
            w.alive = False
            self._requeue_from(wid)
            self.events.append(("worker-dead", (wid,)))

    def _requeue_from(self, wid: int) -> None:
        for sid, (w, _) in list(self._inflight.items()):
            if w == wid:
                stage = self.stages[sid]
                if stage.state in (StageState.DISPATCHED, StageState.RUNNING):
                    stage.state = StageState.WAITING
                    stage.attempts += 1
                    self._mark_ready(stage)
                self._inflight.pop(sid, None)
                self.events.append(("requeue", (sid, wid)))


class SysEnv:
    """Application facade (paper Fig. 8a): storages + workers + manager."""

    def __init__(
        self,
        *,
        num_workers: int = 1,
        cpus_per_worker: int = 2,
        accels_per_worker: int = 1,
        sched: SchedulerConfig | None = None,
        registry: StorageRegistry | None = None,
        max_active: int = 2,
        speculative: bool = False,
        heartbeat_timeout: float = 5.0,
    ) -> None:
        self.registry = registry or STORAGE
        self.manager = Manager(
            speculative=speculative,
            heartbeat_timeout=heartbeat_timeout,
            registry=self.registry,
        )
        if sched is not None:
            self.manager.tier_bandwidth = dict(sched.tier_bandwidth)
        self.workers = [
            Worker(
                w,
                self.manager,
                make_devices(cpus_per_worker, accels_per_worker),
                max_active=max_active,
                registry=self.registry,
                sched=sched,
            )
            for w in range(num_workers)
        ]
        for w in self.workers:
            self.manager.add_worker(w)

    def register_storage(self, backend) -> Any:
        return self.registry.register(backend)

    def execute_component(self, stage: Stage) -> Stage:
        return self.manager.execute_component(stage)

    def startup_execution(self) -> None:
        self.manager.run()

    def finalize_system(self) -> None:
        for w in self.workers:
            w.shutdown()
        # the manager and its workers refer to each other: once they are shut
        # down the manager lets go of them, so that the stages and their data
        # are freed with their last reference, not by the garbage collector
        with self.manager._lock:
            self.manager.workers.clear()
