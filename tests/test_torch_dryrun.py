"""The port's dry run: the per-rank cost counter (the counterparts of
``tests/test_hlo_analysis.py``'s loop cases), its matrix-product FLOPs on a
sharded cell against the reference's HLO analyzer, the roofline terms
against the reference's, and the CLI's artifact."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from repro.analysis import roofline as ref_roofline
from repro.analysis.hlo import HloCost
from repro_torch.analysis import roofline
from repro_torch.analysis.cost import CostCounter
from repro_torch.launch.cells import build_cell, trace_cell
from repro_torch.launch.mesh import fake_world, make_host_mesh
from repro_torch.models.spec import distribute

ROOT = Path(__file__).resolve().parents[1]


def _lower_priority() -> None:
    """A busy subprocess runs below the test workers' priority, so that it
    does not starve their timing-sensitive threads."""
    os.nice(10)


def test_loop_over_layers_counts_every_layer():
    d, layers, b = 64, 8, 32
    x = torch.randn(b, d)
    ws = torch.randn(layers, d, d)
    with CostCounter() as c:
        y = x
        for i in range(layers):
            y = torch.tanh(y @ ws[i])
    assert c.cost.flops == layers * 2 * b * d * d
    assert c.cost.dot_flops_by_shape == {f"{b}x{d}x{d}": layers * 2.0 * b * d * d}
    with CostCounter() as once:
        torch.tanh(x @ ws[0])
    assert c.cost.bytes == pytest.approx(layers * once.cost.bytes)
    assert c.cost.while_trip_counts == []  # nothing is a loop op


def test_collectives_inside_a_loop_counted_each_time():
    fake_world(4)
    mesh = make_host_mesh(2, 2, device="cpu")
    layers, b, d = 12, 8, 128
    x = distribute(torch.empty(b, d, device="meta"), mesh, (Shard(0), Shard(1)))
    w = distribute(torch.empty(d, d, device="meta"), mesh, (Replicate(), Shard(0)))
    with CostCounter() as c:
        y = x
        for _ in range(layers):
            y = y @ w  # contracts the model-sharded dim: a partial sum
            assert y.placements == (Shard(0), Partial())
            y = y.redistribute(mesh, (Shard(0), Shard(1)))
    local = (b // 2) * d * 4  # the all-reduce's local (B/2, D) float32 operand
    assert c.cost.collective_counts.get("all-reduce", 0) + c.cost.collective_counts.get(
        "reduce-scatter", 0) == layers
    assert c.cost.collective_bytes == layers * local
    assert c.cost.flops == layers * 2 * (b // 2) * (d // 2) * d


_REF_CELL = r"""
import os, sys
# four host devices on one thread each: the other test workers share the cores
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
sys.path.insert(0, "src")
from repro.analysis import hlo
from repro.launch.cells import build_cell, lower_cell
from repro.launch.mesh import make_host_mesh
mesh = make_host_mesh(2, 2)
cell = build_cell("qwen3-0.6b", "prefill_32k", mesh, cfg_overrides={"num_layers": 2})
print("REF_FLOPS", hlo.analyze(lower_cell(cell, mesh).compile().as_text()).flops)
"""


def test_prefill_cell_flops_per_rank_match_the_reference_hlo():
    """A 2-layer qwen3 prefill_32k cell on a (2, 2) mesh: the counter's
    per-rank matrix-product FLOPs against the reference's multiplicity-aware
    HLO count of the same cell compiled for 4 host devices."""
    ref = subprocess.run([sys.executable, "-c", _REF_CELL], capture_output=True, text=True,
                         timeout=600, cwd=ROOT, preexec_fn=_lower_priority)
    line = [ln for ln in ref.stdout.splitlines() if ln.startswith("REF_FLOPS ")]
    assert line, ref.stdout + ref.stderr
    ref_flops = float(line[0].split()[1])
    fake_world(4)
    mesh = make_host_mesh(2, 2, device="cpu")
    cell = build_cell("qwen3-0.6b", "prefill_32k", mesh, cfg_overrides={"num_layers": 2})
    _, cost, _ = trace_cell(cell, mesh)
    assert cost.flops == pytest.approx(ref_flops, rel=0.02)
    assert cost.collective_counts.get("all-reduce", 0) > 0  # the heads' partial sums


def test_compute_terms_match_the_reference():
    v5e = ref_roofline.V5E
    hw = roofline.HardwareSpec(name=v5e.name, peak_flops=v5e.peak_flops, hbm_bw=v5e.hbm_bw,
                               link_bw=v5e.ici_bw, hbm_bytes=v5e.hbm_bytes)
    for args in [dict(flops_per_chip=3e14, bytes_per_chip=2e11, collective_bytes_per_chip=1e9,
                      chips=256, model_flops_total=5e16),
                 dict(flops_per_chip=1e12, bytes_per_chip=8e10, collective_bytes_per_chip=5e10,
                      chips=512, model_flops_total=1e14),
                 dict(flops_per_chip=0.0, bytes_per_chip=0.0, collective_bytes_per_chip=0.0,
                      chips=1, model_flops_total=0.0)]:
        want = ref_roofline.compute_terms(**args, hw=v5e).as_dict()
        assert roofline.compute_terms(**args, hw=hw).as_dict() == want
    assert roofline.model_flops(10, 7, training=True) == ref_roofline.model_flops(
        10, 7, training=True)
    assert roofline.H100.peak_flops == 989e12 and roofline.H100.hbm_bw == 3.35e12


# the keys the reference's run_cell writes for a cell that ran
REF_KEYS = {"arch", "shape", "mesh", "zero1", "status", "tag", "cfg_overrides",
            "seq_shard_cache", "seq_parallel", "chips", "mesh_shape", "kind",
            "tokens_per_step", "lower_s", "compile_s", "memory_analysis", "xla_cost_analysis",
            "hlo_bytes_len", "hlo_analysis_s", "hlo", "roofline", "n_params",
            "n_active_params", "total_s"}


def test_dryrun_cli_writes_an_artifact_with_the_reference_keys(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-0.6b", "--shape",
         "train_4k", "--mesh", "single", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT,
        preexec_fn=_lower_priority)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[ok] qwen3-0.6b x train_4k x single" in proc.stdout
    rec = json.loads((tmp_path / "qwen3-0.6b__train_4k__single.json").read_text())
    assert set(rec) == REF_KEYS
    assert rec["chips"] == 256 and rec["mesh_shape"] == {"data": 16, "model": 16}
    assert set(rec["hlo"]) == set(HloCost().as_dict())
    assert set(rec["roofline"]) == set(ref_roofline.RooflineTerms(
        *([0.0] * 6), "compute", 0.0, 0.0).as_dict())
    mem = rec["memory_analysis"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes"}
    assert mem["argument_size_in_bytes"] > 0
    assert rec["hlo"]["flops"] > 0 and rec["hlo"]["collective_bytes"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
