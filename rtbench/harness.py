"""Run one cell of the benchmark once and build its result line.

Everything that belongs to one configuration, traffic mix, form or metric is
found by name: ``BENCHMARK.json`` names the cell's configuration and traffic;
``configs/<config>.json`` and ``traffic/<traffic>.json`` hold their
parameters; the traffic names its form, ``forms/<form>.py``; each metric is
read by ``metrics/<metric>.py``; each kernel op's work is counted by
``counts/<op>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(manifest: dict, key: str, name: str) -> dict:
    for entry in manifest[key]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The cell with its configuration and traffic files read in."""
    m = load_manifest(root)
    cell = find(m, "workloads", workload)
    cfg = find(m, "configs", cell["config"])
    return {**cell,
            "config_data": json.loads((root / cfg["file"]).read_text()),
            "traffic_data": json.loads(
                (root / HERE.name / "traffic" / f"{cell['traffic']}.json").read_text())}


def cell_metrics(manifest: dict, workload: str, kind: str) -> list[dict]:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that the cell
    reports: an end-to-end metric that lists no cells is reported in all of
    them; a per-layer metric lists its cells."""
    if kind == "end_to_end":
        return [m for m in manifest["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]
    return [m for m in manifest["per_layer"] if workload in m["workloads"]]


def load_reader(name: str, root: Path = ROOT):
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("rtbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loaded_forbidden() -> list[str]:
    """Loaded modules whose whole top-level name is one the runs may not load."""
    return sorted({n.split(".")[0] for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Ctx:
    cell: str
    config: dict
    traffic: dict
    seed: int
    device: object


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: str
    unit: str
    config: dict
    traffic: dict
    peaks: dict
    setup_s: float
    window_s: float
    tally: object
    counters: dict  # the program's counters over the window
    spans: dict  # span name -> host seconds of each call (traced runs)
    tracer_counters: dict  # the spans' own counters, e.g. bound_s.op.<op>
    trace: dict | None  # trace.summarize() of the traced window


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _measure(form, seconds, trace, peaks, sync, form_hook, setup_clock) -> dict:
    """Set the form up, then drive its window (traced or not)."""
    import torch

    from rtbench import trace as tr

    started_s = setup_clock()
    form.setup()
    sync()
    if form_hook is not None:
        form_hook(form)
    setup_s = setup_clock()
    phases = {"start_s": started_s, **form.phases}
    phases["other_s"] = setup_s - sum(phases.values())
    tracer = prof = None
    if trace:
        tracer = tr.Tracer(peaks, sync)
        form.install(tracer)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:  # the stages' worker threads too
            cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
            prof = torch.profiler.profile(activities=acts, experimental_config=cfg)
        except (AttributeError, TypeError):
            prof = torch.profiler.profile(activities=acts)
        prof.start()
    before = form.counters()
    t0 = time.perf_counter()
    with torch.autograd.profiler.record_function(tr.PREFIX + "window"):
        tally = form.run(seconds)
        sync()
    window_s = time.perf_counter() - t0
    after = form.counters()
    summary = None
    if trace:
        prof.stop()
        tracer.remove()
        summary = tr.summarize(prof.events())
    return {"setup_s": setup_s, "setup_phases": phases, "window_s": window_s, "tally": tally,
            "summary": summary,
            "counters": {k: after.get(k, 0) - before.get(k, 0) for k in after},
            "spans": dict(tracer.spans) if tracer else {},
            "tracer_counters": dict(tracer.counters) if tracer else {}}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             setup_clock=None, root: Path = ROOT, form_hook=None) -> dict:
    """One run of ``workload``; returns the result line as a dict.

    ``setup_clock()`` gives the seconds since the process started (the
    default counts from this call). ``form_hook(form)``, for tests, may
    change the form once it is set up."""
    import torch

    from rtbench import compare
    from rtbench import trace as tr

    t_call = time.perf_counter()
    setup_clock = setup_clock or (lambda: time.perf_counter() - t_call)
    manifest = load_manifest(root)
    cell = load_cell(workload, root)
    config, traffic = cell["config_data"], cell["traffic_data"]
    peaks = json.loads((HERE / "peaks.json").read_text())
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(dev)

    form_mod = importlib.import_module(f"rtbench.forms.{traffic['form']}")
    form = form_mod.Form(Ctx(workload, config, traffic, int(seed), dev))
    try:
        m = _measure(form, seconds, trace, peaks, sync, form_hook, setup_clock)
        memory_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    finally:
        form.release()  # stores, servers and the program's device memory

    bad = loaded_forbidden()
    if bad:
        raise SystemExit(f"rtbench: the run loaded {', '.join(bad)}; no result")

    tally, summary = m["tally"], m["summary"]
    run = Run(workload, form.unit, config, traffic, peaks, m["setup_s"], m["window_s"], tally,
              m["counters"], m["spans"], m["tracer_counters"], summary)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for metric in cell_metrics(manifest, workload, kind):
        value = load_reader(metric["name"], root)(run)
        if value is None:
            if kind == "end_to_end":
                raise RuntimeError(f"end-to-end metric {metric['name']} read nothing")
            continue
        metrics[metric["name"]] = {"value": float(value), "unit": metric["unit"]}

    numbers = form.check(dev)
    numbers["failed_share"] = tally.failed / max(tally.attempted, 1)
    correct, checks = compare.judge(numbers, config["limits"])
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": memory_peak,
                   "power": power_limit() if cuda else "cpu"}
    result = {"correct": bool(correct), "attempted": tally.attempted, "failed": tally.failed,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": tr.top(summary["device_s"]),
                               "idle_gaps": tr.top(summary["idle_gaps"])}
        result["trace"] = {**summary["stats"], "op_device_s": summary["op_device_s"],
                           "copy_s": summary["copy_s"]}
    lat = sorted(x for x in tally.latencies if x != float("inf"))
    if lat:
        result["unit_s"] = {"min": lat[0], "median": lat[len(lat) // 2], "max": lat[-1]}
    result["setup_phases"] = m["setup_phases"]
    result["errors"] = tally.errors
    result["checks"] = checks
    return result
