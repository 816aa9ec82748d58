"""The port's cell builder (``repro_torch.launch.cells``) on a one-rank
(1, 1) mesh, as ``tests/test_cells.py`` checks the reference's: every
architecture's train and decode cells build, their argument and placement
trees align, every argument is on the meta device, and the shapes follow
the shape table; the reference's cell builds beside each for its leaf
count."""
import jax
import pytest
import torch

from repro.launch.cells import build_cell as ref_build_cell
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported, get_config
from repro_torch.convert import reference_leaves
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import make_host_mesh


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
