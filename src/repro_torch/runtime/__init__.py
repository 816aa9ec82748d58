"""Hierarchical-dataflow runtime (paper S3.2): Manager-Worker + WRM."""
from repro_torch.runtime.dag import (
    DeviceKind,
    RegionBinding,
    Stage,
    StageContext,
    StageState,
    Task,
    TaskCost,
    TaskState,
)
from repro_torch.runtime.manager import Manager, SysEnv, Worker
from repro_torch.runtime.prefetch import DevicePipeline, prefetch_to_device
from repro_torch.runtime.scheduler import (
    Device,
    ReadyQueue,
    SchedulerConfig,
    SimResult,
    SimulatedWRM,
    ThreadedWRM,
    make_devices,
)

__all__ = [
    "DeviceKind",
    "RegionBinding",
    "Stage",
    "StageContext",
    "StageState",
    "Task",
    "TaskCost",
    "TaskState",
    "Manager",
    "SysEnv",
    "Worker",
    "DevicePipeline",
    "prefetch_to_device",
    "Device",
    "ReadyQueue",
    "SchedulerConfig",
    "SimResult",
    "SimulatedWRM",
    "ThreadedWRM",
    "make_devices",
]
