"""The port's Manager-Worker runtime and WRM (``repro_torch.runtime``): the
cases of ``tests/test_manager.py`` (demand-driven dispatch, fault
tolerance, incremental DAG), and the deterministic virtual-time scheduler
against the JAX package's on the same DAG and configuration."""
import threading
import time

import numpy as np
import pytest

import repro.runtime as jruntime
import repro_torch.runtime as truntime
from repro_torch.configs.wsi import PAPER_OP_COSTS, PAPER_OP_SPEEDUPS
from repro_torch.core import BoundingBox, Intent, RegionTemplate, StorageRegistry
from repro_torch.runtime import Stage, SysEnv, Task
from repro_torch.storage import DistributedMemoryStorage

DOM = BoundingBox((0, 0), (64, 64))


class AddOne(Stage):
    def run(self, ctx):
        reg = ctx.region("P", "X")
        rt = self.get_region_template("P")
        out = rt.new_region("Y", reg.roi, np.float32)

        def work():
            out.set_data(np.asarray(reg.data) + 1)

        ctx.submit(Task("addone", cpu_fn=work))


def _env(**kw):
    reg = StorageRegistry()
    dms = reg.register(DistributedMemoryStorage(DOM, (32, 32), 2, name="DMS"))
    env = SysEnv(num_workers=2, cpus_per_worker=2, accels_per_worker=0,
                 registry=reg, **kw)
    return env, dms


def _wire(env, dms, n_parts=4, stage_cls=AddOne):
    rt = RegionTemplate("P")
    x = rt.new_region("X", DOM, np.float32, input_storage="DMS", lazy=True)
    data = np.random.default_rng(0).random((64, 64), dtype=np.float32)
    dms.put(x.key, DOM, data)
    stages = []
    for part in list(DOM.tiles((32, 32)))[:n_parts]:
        s = stage_cls()
        s.add_region_template(rt, "X", part, Intent.INPUT, read_storage="DMS")
        s.add_region_template(rt, "Y", part, Intent.OUTPUT, storage="DMS")
        env.execute_component(s)
        stages.append(s)
    return rt, data, stages


def test_e2e_pipeline_two_workers():
    env, dms = _env()
    rt, data, stages = _wire(env, dms)
    env.startup_execution()
    env.finalize_system()
    key = stages[0].templates["P"].get("Y").key
    assert np.allclose(dms.get(key, DOM), data + 1)
    dispatched = {pay[1] for ev, pay in env.manager.events if ev == "dispatch"}
    assert len(dispatched) >= 1


def test_stage_failure_retried_then_succeeds():
    attempts = []

    class Flaky(AddOne):
        def run(self, ctx):
            attempts.append(self.sid)
            if len(attempts) == 1:
                raise RuntimeError("transient")
            return super().run(ctx)

    env, dms = _env()
    _wire(env, dms, n_parts=1, stage_cls=Flaky)
    env.startup_execution()
    env.finalize_system()
    assert len(attempts) == 2  # failed once, re-ran elsewhere


def test_stage_failure_exhausts_retries():
    class AlwaysBad(Stage):
        def run(self, ctx):
            raise RuntimeError("permanent")

    env, dms = _env()
    s = AlwaysBad()
    s.templates["P"] = RegionTemplate("P")
    env.execute_component(s)
    with pytest.raises(RuntimeError, match="failed after"):
        env.startup_execution()
    env.finalize_system()


def test_worker_death_requeues_inflight():
    """Node-failure fault tolerance: stages of a dead worker re-run."""
    release = []

    class Slow(AddOne):
        def run(self, ctx):
            while not release:
                time.sleep(0.01)
            return super().run(ctx)

    env, dms = _env(heartbeat_timeout=10.0)
    rt, data, stages = _wire(env, dms, n_parts=2, stage_cls=Slow)

    def killer():
        time.sleep(0.3)
        env.workers[0].kill()  # node dies mid-stage
        time.sleep(0.1)
        release.append(1)

    threading.Thread(target=killer, daemon=True).start()
    env.startup_execution()
    env.finalize_system()
    key = stages[0].templates["P"].get("Y").key
    covered = BoundingBox((0, 0), (32, 64))  # the two dispatched partitions
    assert np.allclose(dms.get(key, covered), data[:32] + 1)
    assert "requeue" in [ev for ev, _ in env.manager.events]


def test_incremental_dag_spawn():
    spawned = []

    class Parent(Stage):
        def run(self, ctx):
            child = AddOne()
            rt = self.get_region_template("P")
            child.add_region_template(rt, "X", self.bindings[0].roi, Intent.INPUT,
                                      read_storage="DMS")
            child.add_region_template(rt, "Y", self.bindings[0].roi, Intent.OUTPUT,
                                      storage="DMS")
            spawned.append(ctx.spawn_stage(child, deps=[self]))

    env, dms = _env()
    rt = RegionTemplate("P")
    x = rt.new_region("X", DOM, np.float32, input_storage="DMS", lazy=True)
    dms.put(x.key, DOM, np.ones((64, 64), np.float32))
    p = Parent()
    p.add_region_template(rt, "X", DOM, Intent.INPUT, read_storage="DMS")
    env.execute_component(p)
    env.startup_execution()
    env.finalize_system()
    assert spawned and spawned[0].state.name == "DONE"


def test_zombie_execution_does_not_poison_retry():
    """A stage killed AFTER it created its output region must retry
    cleanly: the zombie's mutated template copy never leaks into the retry."""
    entered = []
    release = []

    class CreatesThenBlocks(Stage):
        def run(self, ctx):
            rt = self.get_region_template("P")
            out = rt.new_region("Y", self.bindings[0].roi, np.float32)
            entered.append(threading.get_ident())
            if len(entered) == 1:  # first (to-be-killed) execution blocks
                while not release:
                    time.sleep(0.01)

            def work():
                out.set_data(np.ones(self.bindings[0].roi.shape, np.float32))

            ctx.submit(Task("mk", cpu_fn=work))

    env, dms = _env(heartbeat_timeout=10.0)
    rt = RegionTemplate("P")
    x = rt.new_region("X", DOM, np.float32, input_storage="DMS", lazy=True)
    dms.put(x.key, DOM, np.zeros((64, 64), np.float32))
    s = CreatesThenBlocks()
    part = BoundingBox((0, 0), (32, 32))
    s.add_region_template(rt, "X", part, Intent.INPUT, read_storage="DMS")
    s.add_region_template(rt, "Y", part, Intent.OUTPUT, storage="DMS")
    env.execute_component(s)

    def killer():
        while not entered:
            time.sleep(0.01)
        env.workers[s.worker].kill()  # dies after new_region, before finishing
        time.sleep(0.05)
        release.append(1)

    threading.Thread(target=killer, daemon=True).start()
    env.startup_execution()  # must NOT raise duplicate-region failures
    env.finalize_system()
    assert (dms.get(s.templates["P"].get("Y").key, part) == 1).all()
    assert "Y" not in rt.region_names() or rt.get("Y").empty()


# -- the virtual-time scheduler, both packages ----------------------------------------
OPS = ("Color deconv.", "AreaThreshold", "FillHolles", "ReconToNuclei", "BWLabel", "Features")


def _wsi_dag(runtime, partitions: int) -> list:
    """The WSI stages' fine-grain chain per partition, with the paper's
    per-op costs and speedups, a tile's bytes on the first op."""
    tasks = []
    for p in range(partitions):
        prev = None
        for i, op in enumerate(OPS):
            cost = runtime.TaskCost(cpu_s=PAPER_OP_COSTS[op] * (1 + 0.1 * p),
                                    speedup=PAPER_OP_SPEEDUPS[op],
                                    input_bytes=(3 << 24) if i == 0 else (1 << 24),
                                    output_bytes=1 << 24)
            t = runtime.Task(f"{op}#{p}", cpu_fn=lambda: None, accel_fn=lambda: None,
                             deps=[prev] if prev else [], cost=cost)
            tasks.append(t)
            prev = t
    return tasks


@pytest.mark.parametrize("policy", ["PATS", "FCFS"])
@pytest.mark.parametrize("data_locality", [False, True])
@pytest.mark.parametrize("prefetch", [False, True])
def test_simulated_wrm_equals_the_reference(policy, data_locality, prefetch):
    results = []
    for runtime in (jruntime, truntime):
        cfg = runtime.SchedulerConfig(policy=policy, data_locality=data_locality,
                                      prefetch=prefetch)
        sim = runtime.SimulatedWRM(runtime.make_devices(2, 1), cfg)
        results.append(sim.run(_wsi_dag(runtime, partitions=5)))
    want, got = results
    assert got.makespan == want.makespan
    assert got.per_device_busy == want.per_device_busy
    assert got.task_log == want.task_log
    assert got.accel_task_count == want.accel_task_count
    assert sum(got.accel_task_count.values()) > 0
