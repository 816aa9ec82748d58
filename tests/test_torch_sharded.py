"""The port's sharded paths on a (data=2, model=2) mesh of four ``gloo``
processes on the CPU, at narrow widths, 2 layers, float32, against the same
models run unsharded in this process: prefill logits and greedy decode of a
dense (qwen3), an MoE/MLA (deepseek) and an SSM (mamba2) config, and of
the hybrid (hymba), encoder-decoder (seamless), patch-prefix (internvl2)
and MQA (gemma) ones; one ZeRO-1 train step of the first three; a checkpoint saved on (2, 2) and restored bit for
bit on (1, 4), on one process and in the reference; qwen3 with 2 KV heads
on (1, 4), where each rank projects V for its own KV head (prefill,
decode and a train step); and the kernels' refusal of a DTensor. The four processes start once (a module fixture) and
run every check's sharded half."""
import copy
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.storage import CheckpointManager as JCheckpointManager
from repro.storage import DiskStorage as JDiskStorage
from repro.train import AdamW as JAdamW
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokens
from repro_torch.models import build
from repro_torch.serve.step import generate, make_cache, make_prefill_step
from repro_torch.storage import CheckpointManager, DiskStorage
from repro_torch.storage.checkpoint import _leaf_paths, _to_host
from repro_torch.train import AdamW, init_state, make_train_step
from tests._torch_dist import spawn

ARCHS = ("qwen3-0.6b", "deepseek-v2-lite-16b", "mamba2-2.7b")  # served and trained
SERVED = (*ARCHS, "hymba-1.5b", "seamless-m4t-large-v2", "internvl2-1b", "gemma-2b")
PROMPT = np.random.default_rng(0).integers(0, 128, (2, 8)).astype(np.int32)
MAX_NEW = 4
TOL = 1e-5


def _cfg(arch: str):
    cfg = get_config(arch).scaled_down(vocab=128).replace(
        param_dtype=torch.float32, compute_dtype=torch.float32, num_layers=2)
    return cfg.replace(first_k_dense=1) if cfg.family == "moe" else cfg


def _stubs(cfg) -> dict:
    """The encoder frames or the patch prefix a config's prompts take."""
    rng = np.random.default_rng(1)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)}
    if cfg.frontend:
        return {"prefix": rng.standard_normal((2, cfg.frontend_len, cfg.d_model)).astype(
            np.float32)}
    return {}


def _prefill(model, cfg, cache_fn=None):
    """Last-position logits of the prompt's prefill (with its stubs)."""
    stubs = _stubs(cfg)
    batch = {"tokens": torch.from_numpy(PROMPT), **{k: torch.from_numpy(v)
                                                    for k, v in stubs.items()}}
    enc_len = stubs["frames"].shape[1] if "frames" in stubs else 64
    extra = cfg.frontend_len if cfg.frontend else 0
    cache = make_cache(cfg, PROMPT.shape[0], 16 + extra, enc_len=enc_len, device="cpu")
    if cache_fn is not None:
        cache = cache_fn(cache)
    return make_prefill_step(cfg)(model, batch, cache)[0]


def _batch(cfg) -> dict:
    return {k: torch.from_numpy(v)
            for k, v in SyntheticTokens(cfg.vocab, 16, 4, seed=0).batch_at(0).items()}


def _flat(state) -> dict:
    """Every leaf of a state as its host array, by checkpoint name (DTensor
    leaves gathered whole)."""
    from repro_torch.convert import LayerStack
    from repro_torch.models.spec import full

    out = {}
    for name, leaf in _leaf_paths(state):
        if isinstance(leaf, LayerStack):
            leaf = LayerStack(full(t) for t in leaf)
        elif isinstance(leaf, torch.Tensor):
            leaf = full(leaf)
        out[name] = _to_host(leaf)[0]
    return out


def _world(rank: int, ckdir: str) -> dict:
    """Every sharded run, in each of the four ranks; rank 0's results."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.spec import activation_sharding, full
    from repro_torch.models.transformer import shard_params
    from repro_torch.serve.step import cache_shardings, shard_tree
    from repro_torch.train import shard_state

    mesh = make_host_mesh(2, 2, device="cpu")
    out: dict = {"serve": {}, "train": {}}
    with activation_sharding(mesh):
        for arch in SERVED:
            cfg = _cfg(arch)
            model = shard_params(build(cfg, device="cpu", seed=0), mesh)
            logits = _prefill(model, cfg, lambda c: shard_tree(c, mesh, cache_shardings(
                cfg, c, mesh)))
            tokens = generate(model, cfg, PROMPT, max_new=MAX_NEW, device="cpu", **_stubs(cfg))
            stack = model.dec_layers if cfg.family == "encdec" else model.layers
            heads = stack[0].attn.wq.to_local().shape if cfg.family != "ssm" else None
            out["serve"][arch] = (full(logits).numpy(), tokens.numpy(), heads)
        for arch in ARCHS:
            cfg = _cfg(arch).replace(attn_impl="torch")
            optim = AdamW()
            state = shard_state(init_state(cfg, optim, seed=0, device="cpu"), cfg, mesh, optim,
                                zero1=True)
            state, metrics = make_train_step(cfg, optim)(state, _batch(cfg))
            out["train"][arch] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                                  _flat(state))
            if arch == ARCHS[0]:
                CheckpointManager(DiskStorage(ckdir)).save(1, state)
                saved = out["train"][arch][2]
        try:
            _build.require(state["opt"]["m"]["embed/tok"], "probe", torch.float32, 2)
            out["require"] = None
        except TypeError as e:
            out["require"] = str(e)

    # the (2, 2) checkpoint restored on a (1, 4) mesh of the same ranks
    cfg, optim = _cfg(ARCHS[0]).replace(attn_impl="torch"), AdamW()
    other = make_host_mesh(1, 4, device="cpu")
    target = shard_state(init_state(cfg, optim, seed=9, device="cpu"), cfg, other, optim,
                         zero1=True)
    restored = _flat(CheckpointManager(DiskStorage(ckdir)).restore(target))
    out["restore_1x4"] = sorted(n for n in saved if not np.array_equal(saved[n], restored[n]))
    out["restore_1x4_local"] = tuple(
        target["params"].layers[0].mlp.w1.to_local().shape)
    # a plain state's tensors laid out on (1, 4) by the state's placements
    from repro_torch.train import state_shardings
    laid = CheckpointManager(DiskStorage(ckdir)).restore(
        init_state(cfg, optim, seed=9, device="cpu"),
        target_placements=state_shardings(cfg, other, optim, zero1=True), mesh=other)
    m = laid["opt"]["m"]["layers/mlp/w1"]
    out["placed"] = (type(m).__name__, tuple(m.placements), tuple(m.to_local().shape),
                     sorted(n for n, arr in _flat(laid).items()
                            if n.startswith("opt/") and not np.array_equal(arr, saved[n])))

    # 2 KV heads on a model axis of 4: each rank projects V for its query
    # heads' one KV head, and the cache gathers the whole V
    cfg = _v_by_rank_cfg()
    with activation_sharding(other):
        model = shard_params(build(cfg, device="cpu", seed=0), other)
        v_local = tuple(model.layers[0].attn.wv.to_local().shape)
        logits = _prefill(model, cfg, lambda c: shard_tree(c, other, cache_shardings(
            cfg, c, other)))
        tokens = generate(model, cfg, PROMPT, max_new=MAX_NEW, device="cpu")
        state = shard_state(init_state(cfg, AdamW(), seed=0, device="cpu"), cfg, other, AdamW())
        state, metrics = make_train_step(cfg, AdamW())(state, _batch(cfg))
    out["v_by_rank"] = (full(logits).numpy(), tokens.numpy(), v_local,
                        float(metrics["loss"]), float(metrics["grad_norm"]), _flat(state))
    return out


def _v_by_rank_cfg():
    return _cfg("qwen3-0.6b").replace(num_kv_heads=2, attn_impl="torch")


@pytest.fixture(scope="module")
def world():
    with tempfile.TemporaryDirectory(prefix="sharded_ckpt_") as ckdir:
        yield spawn(_world, 4, ckdir), ckdir


@pytest.mark.parametrize("arch", SERVED)
def test_sharded_prefill_and_decode_match_the_unsharded_run(world, arch):
    results, _ = world
    logits, tokens, heads = results["serve"][arch]
    cfg = _cfg(arch)
    model = build(cfg, device="cpu", seed=0)
    want = _prefill(copy.deepcopy(model), cfg)
    np.testing.assert_allclose(logits, want.numpy(), rtol=0, atol=TOL)
    np.testing.assert_array_equal(tokens, generate(model, cfg, PROMPT, max_new=MAX_NEW,
                                                   device="cpu", **_stubs(cfg)).numpy())
    if heads is not None:  # each rank holds its share of the query heads
        ways = 2 if cfg.num_heads % 2 == 0 else 1
        assert heads[1] == cfg.num_heads // ways


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_zero1_train_step_matches_the_unsharded_run(world, arch):
    results, _ = world
    loss, grad_norm, leaves = results["train"][arch]
    cfg, optim = _cfg(arch).replace(attn_impl="torch"), AdamW()
    state, metrics = make_train_step(cfg, optim)(init_state(cfg, optim, seed=0, device="cpu"),
                                                 _batch(cfg))
    assert abs(loss - float(metrics["loss"])) <= TOL
    assert abs(grad_norm / float(metrics["grad_norm"]) - 1) <= TOL
    want = _flat(state)
    assert set(leaves) == set(want)
    for name, arr in want.items():
        np.testing.assert_allclose(leaves[name], arr, rtol=0, atol=TOL, err_msg=name)


def test_a_sharded_checkpoint_restores_on_other_meshes_and_in_the_reference(world):
    results, ckdir = world
    saved = results["train"][ARCHS[0]][2]
    assert results["restore_1x4"] == []
    cfg = _cfg(ARCHS[0])
    assert results["restore_1x4_local"] == (cfg.d_model, cfg.d_ff // 4)  # ffn over 4 ranks
    kind, placements, local, differ = results["placed"]  # by target_placements
    assert kind == "DTensor" and differ == []
    assert local == (cfg.num_layers, cfg.d_model, cfg.d_ff // 4)  # (L, d, ffn / 4)
    # one process, the (1, 1) case: the DISK store assembles each leaf from the shards
    cfg, optim = cfg.replace(attn_impl="torch"), AdamW()
    restored = _flat(CheckpointManager(DiskStorage(ckdir)).restore(
        init_state(cfg, optim, seed=9, device="cpu")))
    assert set(restored) == set(saved)
    for name in saved:
        assert np.array_equal(restored[name], saved[name]), name
    # the reference's manager, on the same directory
    jcfg = ref_config(ARCHS[0]).scaled_down(vocab=128).replace(
        param_dtype=jnp.float32, compute_dtype=jnp.float32, num_layers=2)
    template = jstep.init_state(jax.random.key(0), jcfg, JAdamW())
    target = jax.tree.map(lambda x: jax.ShapeDtypeStruct(jnp.shape(x), jnp.result_type(x)),
                          template)
    jstate = JCheckpointManager(JDiskStorage(ckdir)).restore(target)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jstate)
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v).reshape(-1)
           for path, v in leaves}
    assert set(ref) == set(saved)
    for name, arr in ref.items():
        assert np.array_equal(arr, saved[name].reshape(-1)), name


def test_a_kernel_refuses_a_dtensor(world):
    results, _ = world
    assert results["require"] is not None and "DTensor" in results["require"]


def test_v_projected_by_rank_matches_the_unsharded_run(world):
    """On (1, 4) with 2 KV heads (too few for the model axis) each rank
    projects V for its query heads' KV head alone: the prefill logits,
    the greedy tokens and a train step (loss, gradient norm, every updated
    leaf) match one process within 1e-5."""
    results, _ = world
    logits, tokens, v_local, loss, grad_norm, leaves = results["v_by_rank"]
    cfg, optim = _v_by_rank_cfg(), AdamW()
    assert v_local == (cfg.d_model, 2, cfg.resolved_head_dim)  # wv itself stays whole
    model = build(cfg, device="cpu", seed=0)
    np.testing.assert_allclose(logits, _prefill(copy.deepcopy(model), cfg).numpy(),
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(tokens, generate(model, cfg, PROMPT, max_new=MAX_NEW,
                                                   device="cpu").numpy())
    state, metrics = make_train_step(cfg, optim)(init_state(cfg, optim, seed=0, device="cpu"),
                                                 _batch(cfg))
    assert abs(loss - float(metrics["loss"])) <= TOL
    assert abs(grad_norm / float(metrics["grad_norm"]) - 1) <= TOL
    want = _flat(state)
    assert set(leaves) == set(want)
    for name, arr in want.items():
        np.testing.assert_allclose(leaves[name], arr, rtol=0, atol=TOL, err_msg=name)
