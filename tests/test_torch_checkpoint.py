"""The port's checkpoints (``repro_torch.storage.checkpoint``): the cases of
``tests/test_checkpoint.py`` on torch tensors, and checkpoints that cross
between the packages both ways, bf16 included, on the CPU.

A train state's checkpoint holds the reference's layout (leaf names, layer
stacks as ``(L, ...)`` regions, scalars as one-element regions), so the
other package restores it leaf for leaf, bit for bit, and its next train
step matches the writer's next step (losses within 1e-4, as
tests/test_torch_train.py holds three steps). bfloat16 leaves are written
and read as 16-bit words: a subprocess in which importing ``ml_dtypes``
fails restores them.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.storage import CheckpointManager as JCheckpointManager
from repro.storage import DiskStorage as JDiskStorage
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.convert import LayerStack, reference_leaves
from repro_torch.core import BoundingBox, ElementType, RegionKey
from repro_torch.data import SyntheticTokens
from repro_torch.models import build
from repro_torch.storage import CheckpointManager, DiskStorage
from repro_torch.train import AdamW, AdamWConfig, init_state, make_train_step
from tests._torch_dist import destroy_default_group, spawn

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_process():
    """Each test here starts with no default process group: a save in a world
    of several ranks takes the collective path, and a group left behind by
    an earlier test file on this worker (a dry run's fake world) would turn
    these one-process cases into it."""
    destroy_default_group()


def _tree():
    return {
        "params": {"w": torch.arange(24.0).reshape(4, 6), "b": torch.ones((6,))},
        "opt": [torch.zeros((2, 3)), torch.tensor(7)],
        "step": torch.tensor(42),
    }


def _target(tree):
    """Leaves that name shape and dtype only: meta tensors."""
    def meta(x):
        if isinstance(x, dict):
            return {k: meta(v) for k, v in x.items()}
        if isinstance(x, list):
            return [meta(v) for v in x]
        return torch.empty(x.shape, dtype=x.dtype, device="meta")

    return meta(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# The reference's cases (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------
def test_roundtrip(tmp_path):
    ck = CheckpointManager(DiskStorage(str(tmp_path)), keep=3)
    tree = _tree()
    ck.save(10, tree)
    out = ck.restore(_target(tree), 10)
    for a, b in zip(_leaves(tree), _leaves(out)):
        assert a.dtype == b.dtype and a.shape == b.shape and b.device.type == "cpu"
        assert torch.equal(a, b)


def test_async_save_and_wait(tmp_path):
    ck = CheckpointManager(DiskStorage(str(tmp_path)), keep=3)
    tree = _tree()
    ck.save(1, tree, blocking=False)
    tree["params"]["w"].add_(1.0)  # the save copied the tree before returning
    ck.wait()
    assert ck.steps() == [1]
    assert torch.equal(ck.restore(_target(tree))["params"]["w"], torch.arange(24.0).reshape(4, 6))
    assert ck.last_save["step"] == 1 and ck.last_save["bytes"] == 4 * (24 + 6 + 6) + 8 + 8
    assert ck.last_save["snapshot_s"] >= 0 and ck.last_save["write_s"] >= 0


def test_retention_gc(tmp_path):
    ck = CheckpointManager(DiskStorage(str(tmp_path)), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree())
    assert ck.steps() == [3, 4]
    with pytest.raises(FileNotFoundError):
        ck.restore(_target(_tree()), 1)


def _four_saves_at_keep_two(rank: int, ckdir: str) -> dict:
    """Each of the ranks saves steps 1-4 at ``keep=2`` over one directory, a
    leaf sharded over the ranks among the plain ones, then reports what it
    sees: its steps, its latest step, whether step 1 is refused, and the
    step-4 tree it restores whole."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.spec import distribute

    mesh = make_host_mesh(2, 1, device="cpu")
    ck = CheckpointManager(DiskStorage(ckdir), keep=2)
    for s in (1, 2, 3, 4):
        tree = _tree()
        tree["params"]["w"] += s
        tree["sharded"] = distribute(torch.arange(16.0).reshape(8, 2) * s, mesh,
                                     (Shard(0), Shard(1)))
        ck.save(s, tree)
    target = _target(_tree())
    target["sharded"] = torch.empty((8, 2), device="meta")
    try:
        ck.restore(target, 1)
        refused = False
    except FileNotFoundError:
        refused = True
    mine = {"steps": ck.steps(), "latest": ck.latest_step(), "refused": refused,
            "restored": {n: t.numpy() for n, t in _named(ck.restore(target, 4))}}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _named(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _named(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def test_retention_holds_on_every_rank_of_a_multi_rank_save(tmp_path):
    """Two gloo ranks save four steps at keep=2 as one process does: rank 0
    commits and every rank drops the old steps after it re-reads the
    manifest, so both see [3, 4], refuse step 1 and restore step 4 bit for
    bit."""
    ranks = spawn(_four_saves_at_keep_two, 2, str(tmp_path))
    want = _tree()
    want["params"]["w"] += 4
    want["sharded"] = torch.arange(16.0).reshape(8, 2) * 4
    for rank, seen in enumerate(ranks):
        assert seen["steps"] == [3, 4], rank
        assert seen["latest"] == 4 and seen["refused"], rank
        got = seen["restored"]
        assert set(got) == {n for n, _ in _named(want)}
        for name, t in _named(want):
            assert got[name].dtype == t.numpy().dtype, (rank, name)
            np.testing.assert_array_equal(got[name], t.numpy(), err_msg=f"{rank} {name}")
    # a fresh handle reads the manifest, which keeps every committed step: a
    # delete is index-only, as in the reference's store
    assert CheckpointManager(DiskStorage(str(tmp_path)), keep=2).steps() == [1, 2, 3, 4]


def test_uncommitted_invisible(tmp_path):
    store = DiskStorage(str(tmp_path))
    ck = CheckpointManager(store, keep=3)
    tree = _tree()
    # write leaves WITHOUT commit (simulates a crash mid-save)
    key = RegionKey("ckpt", "params/w", ElementType.FLOAT32, timestamp=9)
    store.put(key, BoundingBox.from_shape((4, 6)), np.zeros((4, 6), np.float32))
    assert ck.steps() == []
    with pytest.raises(FileNotFoundError):
        ck.restore(_target(tree))
    ck.save(10, tree)
    assert ck.latest_step() == 10


def test_restart_new_process_view(tmp_path):
    ck = CheckpointManager(DiskStorage(str(tmp_path)), keep=3)
    ck.save(5, _tree())
    # fresh manager over a fresh store handle = restarted job
    ck2 = CheckpointManager(DiskStorage(str(tmp_path)), keep=3)
    assert ck2.latest_step() == 5
    out = ck2.restore(_target(_tree()))
    assert torch.equal(out["params"]["w"], torch.arange(24.0).reshape(4, 6))


def test_restore_from_chunked_shards(tmp_path):
    """Shards written as separate bounding-box chunks (as the reference's
    sharded save writes them) reassemble into the full leaf on one card."""
    store = DiskStorage(str(tmp_path))
    ck = CheckpointManager(store, keep=3)
    full = np.arange(64, dtype=np.float32).reshape(8, 8)
    key = RegionKey("ckpt", "w", ElementType.FLOAT32, timestamp=1)
    store.put(key, BoundingBox((0, 0), (4, 8)), full[:4])
    store.put(key, BoundingBox((4, 0), (8, 8)), full[4:])
    store.put(RegionKey("ckpt", "__ckpt_commit__", ElementType.INT64, timestamp=1),
              BoundingBox((0,), (1,)), np.asarray([1]))
    out = ck.restore({"w": torch.empty((8, 8), device="meta")}, 1)
    assert torch.equal(out["w"], torch.from_numpy(full))
    assert np.array_equal(store.get(key, BoundingBox((0, 4), (8, 8))), full[:, 4:])


def test_a_failed_async_save_surfaces_on_wait(tmp_path):
    ck = CheckpointManager(DiskStorage(str(tmp_path)), keep=3)
    store = ck.store

    def broken(*a, **k):
        raise OSError("disk full")

    store.put = broken
    ck.save(2, _tree(), blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        ck.wait()


# ---------------------------------------------------------------------------
# Modules and layer stacks
# ---------------------------------------------------------------------------
def test_a_model_is_written_stacked_and_restored_in_place(tmp_path):
    cfg = get_config("qwen3-0.6b").scaled_down()
    model = build(cfg, device="cpu", seed=1)
    store = DiskStorage(str(tmp_path))
    ck = CheckpointManager(store, keep=3)
    ck.save(3, {"params": model})
    names = {k.name: bb.shape for k, bb in store.query("ckpt", "params/layers/attn/wq")}
    assert names == {"params/layers/attn/wq": (cfg.num_layers, cfg.d_model, cfg.num_heads,
                                               cfg.resolved_head_dim)}
    other = build(cfg, device="cpu", seed=2)
    out = ck.restore({"params": other})
    assert out["params"] is other
    for (n, p), q in zip(model.named_parameters(), other.parameters()):
        assert torch.equal(p, q), n
    stack = LayerStack(torch.zeros_like(p) for p in reference_leaves(model)["layers/mlp/w1"])
    ck.restore({"params": {"layers": {"mlp": {"w1": stack}}}})
    for a, b in zip(stack, reference_leaves(model)["layers/mlp/w1"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------
def _configs(dtype: str):
    jd, td = DTYPES[dtype]
    jcfg = jget_config("qwen3-0.6b").scaled_down(param_dtype=jd)
    tcfg = get_config("qwen3-0.6b").scaled_down(param_dtype=td).replace(attn_impl="torch")
    return jcfg, tcfg


def _flat_np(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_np(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def _port_flat(state) -> dict:
    """The port state's leaves by name, as numpy (bf16 as its 16-bit words)."""
    from repro_torch.storage.checkpoint import _leaf_paths, _to_host

    return {name: _to_host(leaf)[0] for name, leaf in _leaf_paths(state)}


def _ref_flat(jstate) -> dict:
    out = {}
    for name, arr in _flat_np(jstate).items():
        if arr.dtype == jnp.bfloat16:
            arr = arr.view(np.uint16)
        out[name] = arr.reshape(1) if not arr.shape else arr
    return out


def _assert_same_leaves(port: dict, ref: dict):
    assert set(port) == set(ref), sorted(set(port) ^ set(ref))
    for name, want in ref.items():
        got = port[name]
        assert got.shape == want.shape and got.dtype.itemsize == want.dtype.itemsize, name
        assert np.array_equal(got.view(want.dtype) if got.dtype != want.dtype else got, want), name


def _batch(vocab: int, i: int) -> dict:
    return SyntheticTokens(vocab, 16, 4, seed=1).batch_at(i)


def _steps(dtype: str):
    jcfg, tcfg = _configs(dtype)
    jopt, topt = (joptim.AdamW(joptim.AdamWConfig(lr=1e-2)), AdamW(AdamWConfig(lr=1e-2)))
    return (jcfg, jopt, jax.jit(jstep.make_train_step(jcfg, jopt)),
            tcfg, topt, make_train_step(tcfg, topt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    jcfg, jopt, jfn, tcfg, topt, fn = _steps(dtype)
    jstate = jstep.init_state(jax.random.key(0), jcfg, jopt)
    jstate, _ = jfn(jstate, {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab, 0).items()})
    JCheckpointManager(JDiskStorage(str(tmp_path)), keep=2).save(1, jstate)

    state = init_state(tcfg, topt, seed=9, device="cpu")
    ck = CheckpointManager(DiskStorage(str(tmp_path)), keep=2)
    assert ck.latest_step() == 1
    state = ck.restore(state)
    _assert_same_leaves(_port_flat(state), _ref_flat(jstate))
    assert int(state["step"]) == 1 and state["step"].dtype == torch.int32
    assert all(p.dtype == DTYPES[dtype][1] for p in state["params"].parameters())

    batch = _batch(jcfg.vocab, 1)
    _, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    _, m = fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_port_checkpoint_restores_in_the_reference(tmp_path, dtype):
    jcfg, jopt, jfn, tcfg, topt, fn = _steps(dtype)
    state = init_state(tcfg, topt, seed=4, device="cpu")
    state, _ = fn(state, {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab, 0).items()})
    CheckpointManager(DiskStorage(str(tmp_path)), keep=2).save(1, state)

    template = jstep.init_state(jax.random.key(7), jcfg, jopt)
    target = jax.tree.map(lambda x: jax.ShapeDtypeStruct(jnp.shape(x), jnp.result_type(x)),
                          template)
    jstate = JCheckpointManager(JDiskStorage(str(tmp_path)), keep=2).restore(target)
    _assert_same_leaves(_port_flat(state), _ref_flat(jstate))

    batch = _batch(tcfg.vocab, 1)
    _, m = fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    jstate = jax.tree.map(jnp.asarray, jstate)
    _, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-4)


def test_bf16_leaves_need_no_ml_dtypes(tmp_path):
    """In a process where importing ``ml_dtypes`` fails, the port writes and
    restores bf16 leaves, and restores the reference's bf16 checkpoint,
    every 16-bit word equal."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    rng = np.random.default_rng(0)
    words = {"w": rng.standard_normal((5, 7)).astype(jnp.bfloat16),
             "s": np.asarray(rng.standard_normal(()), jnp.bfloat16)}
    JCheckpointManager(JDiskStorage(str(ref_dir))).save(
        3, {k: jnp.asarray(v) for k, v in words.items()})
    np.save(tmp_path / "w.npy", words["w"].view(np.uint16))
    np.save(tmp_path / "s.npy", words["s"].view(np.uint16))
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "ml_dtypes" or name.startswith("ml_dtypes."):
            raise ImportError("ml_dtypes is blocked")
sys.meta_path.insert(0, Block())
import numpy as np, torch
from repro_torch.storage import CheckpointManager, DiskStorage
w = np.load({str(tmp_path / 'w.npy')!r}); s = np.load({str(tmp_path / 's.npy')!r})
def words(t):
    return t.view(torch.int16).numpy().view(np.uint16)
target = {{"w": torch.empty((5, 7), dtype=torch.bfloat16, device="meta"),
           "s": torch.empty((), dtype=torch.bfloat16, device="meta")}}
ref = CheckpointManager(DiskStorage({str(ref_dir)!r})).restore(target)
assert ref["w"].dtype == torch.bfloat16 and np.array_equal(words(ref["w"]), w)
assert np.array_equal(words(ref["s"]).reshape(()), s.reshape(()))
tree = {{"w": torch.from_numpy(w.view(np.int16)).view(torch.bfloat16),
         "s": torch.from_numpy(s.view(np.int16)).view(torch.bfloat16)}}
ck = CheckpointManager(DiskStorage({str(port_dir)!r}))
ck.save(4, tree)
back = ck.restore(target)
assert np.array_equal(words(back["w"]), w) and np.array_equal(words(back["s"]), s)
assert "ml_dtypes" not in sys.modules
print("OK")
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stdout + proc.stderr
    # the port's bf16 checkpoint in the reference
    out = JCheckpointManager(JDiskStorage(str(port_dir))).restore(
        {"w": jax.ShapeDtypeStruct((5, 7), jnp.bfloat16),
         "s": jax.ShapeDtypeStruct((), jnp.bfloat16)})
    assert np.array_equal(np.asarray(out["w"]).view(np.uint16), words["w"].view(np.uint16))
    assert np.asarray(out["s"]).view(np.uint16) == words["s"].view(np.uint16)


def test_bf16_regions_read_back_as_words(tmp_path):
    store = DiskStorage(str(tmp_path))
    key = RegionKey("x", "w", ElementType.BFLOAT16)
    words = np.arange(6, dtype=np.uint16).reshape(2, 3)
    store.put(key, BoundingBox.from_shape((2, 3)), words)
    store.flush()
    got = DiskStorage(str(tmp_path)).get(key, BoundingBox.from_shape((2, 3)))
    assert got.dtype == np.uint16 and np.array_equal(got, words)
    with pytest.raises(TypeError, match="16-bit words"):
        store.put(RegionKey("x", "v", ElementType.BFLOAT16), BoundingBox.from_shape((2,)),
                  np.zeros(2, np.float32))
