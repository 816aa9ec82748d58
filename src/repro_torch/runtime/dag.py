"""Hierarchical dataflow representation (paper S3.2, Figs. 3-5).

Two levels (extensible to more):
  * **Stage** — coarse-grain component; what the Manager ships to Workers.
    A stage declares which region-template data regions it reads/writes
    (``bind_region``), may depend on other stages, and its ``run`` body
    emits fine-grain **Task**s.
  * **Task** — fine-grain operation scheduled by the Worker Resource
    Manager onto a CPU core or an accelerator.  A task carries one
    implementation *variant per device kind* plus an estimated accelerator
    speedup (PATS) and the ids of the data it consumes/produces (DL).

The dependency graph is allowed to grow at runtime (a stage may spawn new
stage instances through its context) — the paper calls this incremental
DAG construction and it is what separates this runtime from static-DAG
systems (StarPU/DAGuE, see S6).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
from typing import Any, Callable

from repro_torch.core.bbox import BoundingBox
from repro_torch.core.regions import DataRegion, Intent, RegionTemplate

_ids = itertools.count()


class DeviceKind(enum.IntEnum):
    CPU = 0
    ACCEL = 1  # the CUDA card (GPU in the paper); with one card, every worker's is cuda:0


class TaskState(enum.IntEnum):
    PENDING = 0  # dependencies unresolved
    READY = 1
    RUNNING = 2
    DONE = 3
    FAILED = 4


@dataclasses.dataclass
class TaskCost:
    """Cost model for the virtual-time simulator (benchmarks) and PATS.

    ``cpu_s`` is the CPU-core execution time; the accelerator time is
    ``cpu_s / speedup``; ``input_bytes``/``output_bytes`` drive transfer
    costs unless the scheduler's DL policy avoids the movement.
    """

    cpu_s: float = 1e-3
    speedup: float = 1.0
    input_bytes: int = 0
    output_bytes: int = 0


class Task:
    """Fine-grain operation with per-device variants."""

    def __init__(
        self,
        name: str,
        *,
        cpu_fn: Callable[..., Any] | None = None,
        accel_fn: Callable[..., Any] | None = None,
        args: tuple = (),
        kwargs: dict | None = None,
        deps: list["Task"] | None = None,
        cost: TaskCost | None = None,
        produces: tuple[str, ...] = (),
        consumes: tuple[str, ...] = (),
        region_key: Any = None,
    ) -> None:
        self.tid = next(_ids)
        self.name = name
        self.variants: dict[DeviceKind, Callable[..., Any]] = {}
        if cpu_fn is not None:
            self.variants[DeviceKind.CPU] = cpu_fn
        if accel_fn is not None:
            self.variants[DeviceKind.ACCEL] = accel_fn
        self.args = args
        self.kwargs = kwargs or {}
        self.deps: list[Task] = list(deps or [])
        self.children: list[Task] = []
        for d in self.deps:
            d.children.append(self)
        self.cost = cost or TaskCost()
        self.produces = produces  # data ids this task outputs (DL)
        self.consumes = consumes  # data ids this task reads (DL)
        # RegionKey of the input data region (tier-locality transfer costs)
        self.region_key = region_key
        self.state = TaskState.PENDING
        self.result: Any = None
        self.error: BaseException | None = None
        self.ran_on: DeviceKind | None = None
        # PATS schedules on the *estimate*; execution cost uses the truth
        # (cost.speedup).  None = estimate equals truth (Fig. 17 baseline).
        self.est_speedup: float | None = None

    @property
    def speedup(self) -> float:
        return self.est_speedup if self.est_speedup is not None else self.cost.speedup

    def runnable_on(self, kind: DeviceKind) -> bool:
        return kind in self.variants or not self.variants

    def fn_for(self, kind: DeviceKind) -> Callable[..., Any] | None:
        if not self.variants:
            return None
        if kind in self.variants:
            return self.variants[kind]
        # fall back to the other variant (a CPU can always emulate)
        return next(iter(self.variants.values()))

    def __repr__(self) -> str:
        return f"Task#{self.tid}({self.name} state={self.state.name} S={self.speedup:.1f})"


@dataclasses.dataclass
class RegionBinding:
    """A stage's declared use of one data region (paper Fig. 8)."""

    template: str
    region: str
    roi: BoundingBox
    intent: Intent
    storage: str | None = None  # backend name for the *write* side
    read_storage: str | None = None


class StageState(enum.IntEnum):
    WAITING = 0
    DISPATCHED = 1
    RUNNING = 2
    DONE = 3
    FAILED = 4


class Stage:
    """Coarse-grain component; subclass and implement :meth:`run`."""

    def __init__(self, name: str | None = None) -> None:
        self.sid = next(_ids)
        self.name = name or type(self).__name__
        self.bindings: list[RegionBinding] = []
        self.deps: list[Stage] = []
        self.state = StageState.WAITING
        self.templates: dict[str, RegionTemplate] = {}
        self.attempts = 0
        self.worker: int | None = None
        self.result: Any = None
        self.error: BaseException | None = None
        self._lock = threading.Lock()
        # per-executing-thread template copies: retries may overlap with a
        # zombie execution on a dead worker; each must see its own copy
        self._templates_by_thread: dict[int, dict[str, RegionTemplate]] = {}

    # -- wiring (manager side, paper Fig. 8a) ------------------------------------
    def add_region_template(
        self,
        rt: RegionTemplate,
        region: str,
        roi: BoundingBox,
        intent: Intent,
        storage: str | None = None,
        read_storage: str | None = None,
    ) -> None:
        self.templates[rt.name] = rt
        self.bindings.append(
            RegionBinding(rt.name, region, roi, intent, storage, read_storage)
        )

    def add_dependency(self, other: "Stage") -> None:
        self.deps.append(other)

    def get_region_template(self, name: str) -> RegionTemplate:
        local = self._templates_by_thread.get(threading.get_ident())
        if local is not None:
            return local[name]
        return self.templates[name]

    def bind_thread_templates(self, templates: dict[str, RegionTemplate]) -> None:
        self._templates_by_thread[threading.get_ident()] = templates

    def unbind_thread_templates(self) -> None:
        self._templates_by_thread.pop(threading.get_ident(), None)

    # -- worker side -----------------------------------------------------------------
    def input_bindings(self) -> list[RegionBinding]:
        return [b for b in self.bindings if b.intent.reads]

    def output_bindings(self) -> list[RegionBinding]:
        return [b for b in self.bindings if b.intent.writes]

    def run(self, ctx: "StageContext") -> Any:  # pragma: no cover - abstract
        raise NotImplementedError

    # -- Manager<->Worker shipping (metadata only; payloads ride global storage) ----
    def pack(self) -> dict:
        return {
            "cls": type(self),
            "sid": self.sid,
            "name": self.name,
            "bindings": self.bindings,
            "templates": {k: v.pack() for k, v in self.templates.items()},
            "state": dict(self.__dict__.get("config", {})),
        }

    def __repr__(self) -> str:
        return f"Stage#{self.sid}({self.name} state={self.state.name})"


class StageContext:
    """What a running stage sees: its data regions, a task submitter, and
    the ability to spawn further stage instances (incremental DAG)."""

    def __init__(self, stage: Stage, worker: Any, submit_task, spawn_stage) -> None:
        self.stage = stage
        self.worker = worker
        self._submit_task = submit_task
        self._spawn_stage = spawn_stage
        self.regions: dict[tuple[str, str], DataRegion] = {}

    def region(self, template: str, name: str) -> DataRegion:
        return self.regions[(template, name)]

    def submit(self, task: Task) -> Task:
        self._submit_task(task)
        return task

    def spawn_stage(self, stage: Stage, deps: list[Stage] | None = None) -> Stage:
        for d in deps or []:
            stage.add_dependency(d)
        self._spawn_stage(stage)
        return stage


def toposort_ready(stages: list[Stage]) -> list[Stage]:
    """Stages whose dependencies are all DONE (demand-driven frontier)."""
    return [
        s
        for s in stages
        if s.state == StageState.WAITING and all(d.state == StageState.DONE for d in s.deps)
    ]
