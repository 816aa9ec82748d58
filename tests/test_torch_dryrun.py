"""The port's dry run: the per-rank cost counter (the counterparts of
``tests/test_hlo_analysis.py``'s loop cases), its matrix-product FLOPs on a
sharded cell against the reference's HLO analyzer, the roofline terms
against the reference's, and the CLI's artifact."""
import json
import math
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
from tests._torch_dist import destroy_default_group


@pytest.fixture(scope="module", autouse=True)
def _no_group_outlives_this_file():
    """The fake worlds this file's tests make are destroyed when the file
    ends, so the next file on this pytest worker starts with no group."""
    yield
    destroy_default_group()


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
import json, re
mesh = make_host_mesh(2, 2)
out = {}
for impl in ("xla", "chunked"):
    cell = build_cell("qwen3-0.6b", "prefill_32k", mesh,
                      cfg_overrides={"num_layers": 2, "attn_impl": impl})
    text = lower_cell(cell, mesh).compile().as_text()
    cost = hlo.analyze(text)
    # the element type of every collective's result, by kind
    kinds = "all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute"
    dtypes = sorted({(m[1], m[0]) for m in re.findall(
        r"= \(?(\w+)\[[\d,]*\]\S* (" + kinds + r")(?:-start)?\(", text)})
    out[impl] = {"flops": cost.flops, "collectives": cost.collectives,
                 "collective_counts": cost.collective_counts, "dtypes": dtypes,
                 "while_trip_counts": cost.while_trip_counts}
print("REF_CELL", json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_prefill_cells():
    """The reference's multiplicity-aware HLO counts of the 2-layer qwen3
    prefill_32k cell compiled for 4 host devices on a (2, 2) mesh, on its
    plain route (``"xla"``) and its chunked one, from one subprocess."""
    ref = subprocess.run([sys.executable, "-c", _REF_CELL], capture_output=True, text=True,
                         timeout=600, cwd=ROOT, preexec_fn=_lower_priority)
    line = [ln for ln in ref.stdout.splitlines() if ln.startswith("REF_CELL ")]
    assert line, ref.stdout + ref.stderr
    return json.loads(line[0].split(" ", 1)[1])


def _port_prefill_cost(impl: str):
    fake_world(4)
    mesh = make_host_mesh(2, 2, device="cpu")
    cell = build_cell("qwen3-0.6b", "prefill_32k", mesh,
                      cfg_overrides={"num_layers": 2, "attn_impl": impl})
    return trace_cell(cell, mesh)[1]


@pytest.fixture(scope="module")
def prefill_cell(ref_prefill_cells):
    """The 2-layer qwen3 prefill_32k cell on a (2, 2) mesh: the reference's
    multiplicity-aware HLO count of the cell compiled for 4 host devices, and
    the port's per-rank count of the same cell."""
    return ref_prefill_cells["xla"], _port_prefill_cost("torch")


def test_chunked_prefill_cell_flops_match_the_reference_chunked_hlo(ref_prefill_cells):
    """On the chunked route the reference's HLO scans 64 key chunks of 512 a
    layer in a while loop (the analyzer multiplies its body by the trip
    count); the port runs them as a Python loop. Same matrix products, same
    FLOPs as the plain route, and the same five all-reduces."""
    ref = ref_prefill_cells["chunked"]
    assert 64 in ref["while_trip_counts"]
    cost = _port_prefill_cost("chunked")
    assert cost.flops == pytest.approx(ref["flops"], rel=0.02)
    assert cost.flops == pytest.approx(ref_prefill_cells["xla"]["flops"], rel=0.02)
    assert dict(cost.collective_counts) == {"all-reduce": 5}


def test_prefill_cell_flops_per_rank_match_the_reference_hlo(prefill_cell):
    """The counter's per-rank matrix-product FLOPs against the reference's."""
    ref, cost = prefill_cell
    assert cost.flops == pytest.approx(ref["flops"], rel=0.02)
    assert cost.collective_counts.get("all-reduce", 0) > 0  # the heads' partial sums


def test_prefill_cell_collective_bytes_by_kind_are_the_reference_in_bf16(prefill_cell):
    """Both sides issue the same collectives on the cell: five all-reduces of
    a (16, 32768, 1024) partial sum a rank (two a layer, the attention's
    and the MLP's output projections, and the embedding lookup's). The port
    all-reduces them in the model's bf16; XLA's CPU backend promotes a bf16
    all-reduce to f32 (its reduction computations are the `*.clone_promoted`
    ones), so the reference counts each at twice the bytes. The ratio is
    exactly f32's size over bf16's, kind by kind."""
    ref, cost = prefill_cell
    assert ref["dtypes"] == [["all-reduce", "f32"]]
    assert dict(cost.collective_counts) == {"all-reduce": 5}
    assert {k: int(v) for k, v in ref["collective_counts"].items()} == {"all-reduce": 5}
    bf16, f32 = torch.bfloat16.itemsize, torch.float32.itemsize
    assert dict(cost.collectives) == {
        k: v * bf16 / f32 for k, v in ref["collectives"].items()}
    assert cost.collectives["all-reduce"] == 5 * 16 * 32768 * 1024 * bf16


_REF_KV2 = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
sys.path.insert(0, "src")
from repro.analysis import hlo
from repro.launch.cells import build_cell, lower_cell
from repro.launch.mesh import make_host_mesh
import json
mesh = make_host_mesh(1, 4)
out = {}
for shape in ("prefill_32k", "train_4k"):
    cell = build_cell("qwen3-0.6b", shape, mesh,
                      cfg_overrides={"num_layers": 2, "num_kv_heads": 2})
    cost = hlo.analyze(lower_cell(cell, mesh).compile().as_text())
    out[shape] = {"flops": cost.flops, "dots": cost.dot_flops_by_shape}
print("REF_CELL", json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_kv2_cells():
    """The reference's HLO counts of the 2-layer qwen3 prefill_32k and
    train_4k cells with 2 KV heads, compiled for 4 host devices on a (1, 4)
    mesh: the KV heads too few for the model axis."""
    ref = subprocess.run([sys.executable, "-c", _REF_KV2], capture_output=True, text=True,
                         timeout=600, cwd=ROOT, preexec_fn=_lower_priority)
    line = [ln for ln in ref.stdout.splitlines() if ln.startswith("REF_CELL ")]
    assert line, ref.stdout + ref.stderr
    return json.loads(line[0].split(" ", 1)[1])


def _port_kv2_cost(shape: str):
    fake_world(4)
    mesh = make_host_mesh(1, 4, device="cpu")
    cell = build_cell("qwen3-0.6b", shape, mesh,
                      cfg_overrides={"num_layers": 2, "num_kv_heads": 2})
    return trace_cell(cell, mesh)[1]


def _families(dots: dict, port: bool) -> dict:
    """Matrix-product FLOPs by the product's result, (rows, columns), the
    leading dims taken together: the port keys a product ``BxMxNxK``, the
    reference's analyzer by its result type, e.g. ``f32[1048576,128]{1,0}``."""
    out: dict = {}
    for key, flops in dots.items():
        if port:
            b, m, n, _ = map(int, key.split("x"))
            fam = (b * m, n)
        else:
            dims = [int(d) for d in key[key.index("[") + 1:key.index("]")].split(",")]
            fam = (math.prod(dims[:-1]), dims[-1])
        out[fam] = out.get(fam, 0.0) + flops
    return out


def test_v_projected_by_rank_flops_match_the_reference_hlo_dot_by_dot(ref_kv2_cells):
    """With 2 KV heads on a model axis of 4 the reference projects K whole
    and V for each rank's one KV head (GSPMD propagates the attention's
    split of the heads back into V's projection); the port does the same
    work a rank, product family by product family."""
    ref = _families(ref_kv2_cells["prefill_32k"]["dots"], port=False)
    cost = _port_kv2_cost("prefill_32k")
    port = _families(cost.dot_flops_by_shape, port=True)
    assert set(port) == set(ref)
    for fam, flops in ref.items():
        assert port[fam] == pytest.approx(flops, rel=1e-3), fam
    tokens = 32 * 32768
    assert port[(tokens, 128)] == 2 * 2 * tokens * 128 * 1024  # V: one head, two layers
    assert port[(tokens, 256)] == 2 * 2 * tokens * 256 * 1024  # K: both heads
    assert cost.flops == pytest.approx(ref_kv2_cells["prefill_32k"]["flops"], rel=1e-3)


def test_train_cell_flops_with_two_kv_heads_on_four_ranks_match_the_reference_hlo(
        ref_kv2_cells):
    """The same cell trained: the forward projects V by rank, and the
    gradients, laid out where the activations are constrained, take the
    reference's strategies, so a rank's FLOPs are the reference's."""
    cost = _port_kv2_cost("train_4k")
    assert cost.flops == pytest.approx(ref_kv2_cells["train_4k"]["flops"], rel=1e-3)


def test_a_shard_to_shard_redistribution_counts_as_one_all_to_all():
    """DTensor issues Shard(i) -> Shard(j) as an all-gather and a chunk on a
    CPU mesh; the counter counts what a card runs, one all-to-all of the
    local shard's bytes, and nothing of the stand-in."""
    fake_world(4)
    mesh = make_host_mesh(2, 2, device="cpu")
    x = distribute(torch.empty(8, 16, 32, device="meta"), mesh, (Shard(0), Shard(1)))
    with CostCounter() as c:
        y = x.redistribute(mesh, (Shard(0), Shard(2)))
    assert y.placements == (Shard(0), Shard(2))
    assert dict(c.cost.collective_counts) == {"all-to-all": 1}
    assert c.cost.collective_bytes == (8 // 2) * (16 // 2) * 32 * 4
    assert c.cost.bytes == 0


def test_moe_cell_counts_its_all_to_alls_as_all_to_alls():
    """The 2-layer qwen3-moe prefill_32k cell on (2, 2) moves its key and
    value heads between shardings with two all-to-alls a step."""
    fake_world(4)
    mesh = make_host_mesh(2, 2, device="cpu")
    cell = build_cell("qwen3-moe-235b-a22b", "prefill_32k", mesh,
                      cfg_overrides={"num_layers": 2})
    _, cost, _ = trace_cell(cell, mesh)
    assert cost.collective_counts["all-to-all"] == 2
    assert cost.collectives["all-to-all"] == 2 * 8 * 4 * 32768 * 128 * 2


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
