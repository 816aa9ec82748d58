"""The port's cell builder (``repro_torch.launch.cells``) on a one-rank
(1, 1) mesh, as ``tests/test_cells.py`` checks the reference's: every
architecture's train and decode cells build, their argument and placement
trees align, every argument is on the meta device, and the shapes follow
the shape table; the reference's cell builds beside each for its leaf
count. One 2-layer ZeRO-1 train cell also traces on a three-axis (pod,
data, model) mesh in a fake world of 8 ranks, and the meshes' flattened
axis runs make a reduction over several axes one collective."""
import jax
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro.launch.cells import build_cell as ref_build_cell
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported, get_config
from repro_torch.convert import reference_leaves
from repro_torch.launch.cells import build_cell, trace_cell
from repro_torch.launch.dryrun import sequential_collectives
from repro_torch.analysis.cost import CostCounter
from repro_torch.launch.mesh import fake_world, make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models.spec import activation_sharding, distribute
from tests._torch_dist import destroy_default_group


@pytest.fixture(scope="module", autouse=True)
def _no_group_outlives_this_file():
    """The fake worlds this file's tests make are destroyed when the file
    ends, so the next file on this pytest worker starts with no group."""
    yield
    destroy_default_group()


def _tensors(tree) -> list:
    """The tensors of an argument, a module as its reference leaves (a
    layer stack as one leaf, as the reference's tree holds it)."""
    if isinstance(tree, torch.nn.Module):
        return [v for v in reference_leaves(tree).values()]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    return [tree]


def _placements(tree) -> list:
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _placements(tree[k])]
    return [tree]


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_cell_builds_and_shardings_align(arch, shape):
    ok, _ = cell_supported(get_config(arch), shape)
    assert ok
    mesh = make_host_mesh(1, 1, device="cpu")
    cell = build_cell(arch, shape, mesh)
    assert len(cell.args) == len(cell.in_shardings)
    for arg, sh in zip(cell.args, cell.in_shardings):
        if sh is None:  # the decode position, a Python int
            assert isinstance(arg, int)
            continue
        tensors, placements = _tensors(arg), _placements(sh)
        assert len(tensors) == len(placements), f"{arch}/{shape}: sharding tree mismatch"
        for t, pl in zip(tensors, placements):
            assert len(pl) == 2  # one placement a mesh dim
            for leaf in (t if isinstance(t, list) else [t]):
                assert leaf.device.type == "meta"  # nothing allocated
    assert cell.meta["tokens"] > 0
    assert cell.cfg.attn_impl == "torch"
    # as many leaves as the reference's cell
    ref = ref_build_cell(arch, shape, ref_host_mesh(1, 1))
    assert [len(jax.tree_util.tree_leaves(a)) for a in ref.args] == [
        len(_tensors(a)) if not isinstance(a, int) else 1 for a in cell.args]


def test_unsupported_cell_raises():
    mesh = make_host_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        build_cell("gemma-2b", "long_500k", mesh)


def test_decode_cell_shapes_match_spec():
    mesh = make_host_mesh(1, 1, device="cpu")
    cell = build_cell("qwen3-0.6b", "decode_32k", mesh)
    params, tokens, cache, pos = cell.args
    spec = SHAPES["decode_32k"]
    assert tuple(tokens.shape) == (spec.global_batch, 1)
    assert cache["layers"]["k"].shape[3] == spec.seq_len
    assert isinstance(pos, int) and 0 <= pos < spec.seq_len


def test_train_cell_batch_matches_spec():
    mesh = make_host_mesh(1, 1, device="cpu")
    cell = build_cell("internvl2-1b", "train_4k", mesh)
    state, batch = cell.args
    spec = SHAPES["train_4k"]
    cfg = cell.cfg
    assert tuple(batch["tokens"].shape) == (spec.global_batch, spec.seq_len - cfg.frontend_len)
    assert tuple(batch["prefix"].shape) == (spec.global_batch, cfg.frontend_len, cfg.d_model)


@pytest.mark.parametrize("attn_impl", ["torch", "chunked"])
def test_multi_pod_train_cell_with_zero1_traces(attn_impl):
    """A 2-layer qwen3 train_4k cell with ZeRO-1 on a (pod, data, model) =
    (2, 2, 2) mesh, the multi-pod mesh's three axes in a fake world of 8
    ranks, traces on both dry-run routes: ZeRO-1 gathers the updated
    parameter shards, and the chunked route does the plain route's matrix
    products. The mesh's flattened axis runs leave DTensor no redistribution
    to split into one collective a mesh axis for want of one."""
    fake_world(8)
    mesh = make_host_mesh(2, 2, 2, device="cpu")
    assert mesh.mesh_dim_names == ("pod", "data", "model")
    cell = build_cell("qwen3-0.6b", "train_4k", mesh, zero1=True,
                      cfg_overrides={"num_layers": 2, "attn_impl": attn_impl})
    assert cell.cfg.attn_impl == attn_impl
    with sequential_collectives() as sequential:
        (state, metrics), cost, _ = trace_cell(cell, mesh)
    assert set(state) == set(cell.args[0])
    assert metrics["loss"].shape == ()
    assert cost.collective_counts["all-gather"] > 0
    # the reference's HLO count of the same cell compiled for 8 host devices:
    # the gradients laid out where the activations are constrained, as the
    # reference's sharding constraints lay out the cotangents
    assert cost.flops == 182_278_412_042_240
    assert sequential is not None  # this torch's redistribute merges over flattened axes
    assert [k for k in sequential if k.endswith("no_flattened_mesh")] == []


@pytest.mark.parametrize("shape,flat", [
    ((2, 2, 2), {"pod_data": 4, "data_model": 4, "pod_data_model": 8}),
    ((2, 2, 1), {"pod_data": 4}),
    ((2, 1, 2), {"pod_data_model": 4}),
    ((1, 2, 2), {"data_model": 4}),
    ((1, 4, 1), {}),
])
def test_meshes_register_flattened_axis_runs(shape, flat):
    """A mesh registers one flattened submesh for each contiguous run of axes
    with more than one rank along at least two of them, one a layout."""
    pod, data, model = shape
    fake_world(pod * data * model)
    mesh = make_host_mesh(data, model, pod, device="cpu")
    assert {k: v.size() for k, v in mesh._flatten_mapping.items()} == flat


def test_a_partial_over_pod_and_data_is_one_collective():
    """On the (2, 2, 2) mesh a sum partial over (pod, data) becomes one
    all-reduce over the flattened group, and ZeRO-1's gather of a shard
    over (pod, data) one all-gather; a mesh of the same ranks with no
    flattened submesh issues one a mesh axis."""
    fake_world(8)
    flat = make_host_mesh(2, 2, 2, device="cpu")
    bare = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                      mesh_dim_names=("pod", "data", "model"))
    partial, rep = (Partial(), Partial(), Replicate()), (Replicate(),) * 3
    counts = {}
    for name, mesh in (("flat", flat), ("bare", bare)):
        x = DTensor.from_local(torch.empty(4, 8, device="meta"), mesh, partial,
                               run_check=False)
        with CostCounter() as c:
            x.redistribute(mesh, rep)
        shard = distribute(torch.empty(16, 8, device="meta"), mesh,
                           (Shard(0), Shard(0), Replicate()))
        with CostCounter() as g:
            shard.redistribute(mesh, rep)
        counts[name] = (dict(c.cost.collective_counts), dict(g.cost.collective_counts))
    assert counts["flat"] == ({"all-reduce": 1}, {"all-gather": 1})
    assert counts["bare"] == ({"all-reduce": 2}, {"all-gather": 2})


def test_a_rank_reads_its_kv_heads_as_a_contiguous_copy():
    """On (1, 4) with 16 query heads over 2 KV heads, rank 0's query heads
    read KV head 0: its slice of the whole keys comes out contiguous, as
    the attention kernel takes its operands on the card."""
    fake_world(4)
    mesh = make_host_mesh(1, 4, device="cpu")
    k = torch.randn(2, 2, 8, 16)
    with activation_sharding(mesh):
        local = L._local_kv(k, 16)
    assert local.is_contiguous()
    assert torch.equal(local, k[:, :1])
