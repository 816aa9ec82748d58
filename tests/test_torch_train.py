"""The port's training path against the JAX package, on the CPU.

Both packages run the same parameters (the reference's random init,
converted to numpy and loaded into the port with
``convert.lm_params_from_reference``) on the same seeded numpy batches.
The configs are scaled down in float32 (``remat="none"``); the JAX side
runs ``attn_impl="xla"``, as the reference trains, and the port's CPU
tensors take the plain versions under autograd.

Tolerances: losses at 1e-5 relative (one forward, summed in another
order); gradients leaf for leaf at rtol 1e-3 with an atol of 1e-3 of the
leaf's largest element (a leaf's small elements are differences of large
terms, a few float32 ulps of the leaf's scale); optimizer updates from the
same params, grads and state at 1e-6; three train steps' losses at 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import registry as jregistry
from repro.models import spec as jspec
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.convert import LayerStack, reference_leaves
from repro_torch.data import SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.launch.train import main as train_main
from repro_torch.train import (
    Adafactor,
    AdafactorConfig,
    AdamW,
    AdamWConfig,
    cosine_lr,
    cross_entropy,
    init_state,
    loss_fn,
    make_eval_step,
    make_train_step,
)
from repro_torch.train import optim as toptim

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# one config of each family the loss covers: dense, MoE (aux loss), the VLM
# backbone (a patch prefix whose logits are dropped), the encoder-decoder
# (frames), and the SSM and hybrid families (the plain SSD scan under autograd)
ARCHS = ["qwen3-0.6b", "qwen3-moe-235b-a22b", "internvl2-1b", "seamless-m4t-large-v2",
         "mamba2-2.7b", "hymba-1.5b"]


def _configs(arch: str, over: tuple = ()):
    kw = dict(over)
    jkw = {k: (jnp.dtype(v) if k.endswith("dtype") else v) for k, v in kw.items()}
    tkw = {k: (TORCH_DTYPES[v] if k.endswith("dtype") else v) for k, v in kw.items()}
    jcfg = jget_config(arch).scaled_down(**jkw)
    return jcfg, get_config(arch).scaled_down(**tkw).replace(attn_impl="torch")


@functools.lru_cache(maxsize=None)
def _jparams(arch: str, over: tuple = ()):
    jcfg, _ = _configs(arch, over)
    return jspec.materialize(jax.random.key(5), jregistry.abstract_params(jcfg))


def _model(arch: str, over: tuple = ()):
    """A fresh port model with the reference's weights, gradients on."""
    _, tcfg = _configs(arch, over)
    tree = jax.tree_util.tree_map(np.asarray, _jparams(arch, over))
    return convert.lm_params_from_reference(tree, tcfg, device="cpu").requires_grad_(True)


def _batch(cfg, b=2, s=12, seed=0) -> dict:
    """Tokens and next-token labels (-1 last), plus frames or the prefix."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    out = {"tokens": toks,
           "labels": np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((b, 10, cfg.d_model)).astype(np.float32) * 0.1
    elif cfg.frontend:
        out["prefix"] = (rng.standard_normal((b, cfg.frontend_len, cfg.d_model))
                         .astype(np.float32) * 0.1)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _flat(tree, prefix=()) -> dict:
    """A nested dict of arrays -> {"a/b/c": numpy array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree, dtype=np.float32)}


def _stacked(leaf) -> np.ndarray:
    """A port leaf (tensor or LayerStack) as one float32 numpy array."""
    if isinstance(leaf, LayerStack):
        return torch.stack([t.detach().float() for t in leaf]).numpy()
    return leaf.detach().float().numpy()


def _port_grads(model) -> dict:
    return {name: _stacked(LayerStack(t.grad for t in p) if isinstance(p, LayerStack)
                           else p.grad)
            for name, p in reference_leaves(model).items()}


def _assert_leaves_close(got: dict, want: dict, rtol: float, scaled_atol: float, what=""):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        atol = scaled_atol * max(float(np.abs(w).max(initial=0.0)), 1e-30)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"{what} {name}")


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------
def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(-1, 50, (3, 7)).astype(np.int32)
    for z in (0.0, 1e-4, 0.1):
        want = jstep.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z_loss=z)
        got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), z_loss=z)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


def test_cross_entropy_upcasts_bf16_logits():
    logits = torch.randn((2, 5, 30), generator=torch.Generator().manual_seed(0))
    labels = torch.randint(0, 30, (2, 5), generator=torch.Generator().manual_seed(1))
    got = cross_entropy(logits.to(torch.bfloat16), labels)
    want = cross_entropy(logits.to(torch.bfloat16).float(), labels)
    assert got[0].dtype == torch.float32
    assert float(got[0]) == float(want[0])


def test_cross_entropy_ignores_masked_labels():
    """``tests/test_train.py``'s masked case: two of four labels masked."""
    total, ce = cross_entropy(torch.zeros((1, 4, 8)), torch.tensor([[1, 2, -1, -1]]), z_loss=0.0)
    assert float(ce) == pytest.approx(np.log(8), rel=1e-5)
    assert float(total) == float(ce)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch):
    jcfg, tcfg = _configs(arch)
    batch = _batch(tcfg, seed=1)
    want_loss, want = jax.jit(jstep.loss_fn, static_argnums=2)(_jparams(arch), _j(batch), jcfg)
    with torch.no_grad():
        loss, got = loss_fn(_model(arch), _t(batch), tcfg)
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    if tcfg.family == "moe":
        assert float(got["aux"]) > 0.0  # the routers' balance loss is in the sum


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad_leaf_for_leaf(arch):
    jcfg, tcfg = _configs(arch)
    batch = _batch(tcfg, seed=2)
    grad_fn = jax.jit(jax.grad(lambda p, b: jstep.loss_fn(p, b, jcfg)[0]))
    want = _flat(grad_fn(_jparams(arch), _j(batch)))
    model = _model(arch)
    loss, _ = loss_fn(model, _t(batch), tcfg)
    loss.backward()
    _assert_leaves_close(_port_grads(model), want, rtol=1e-3, scaled_atol=1e-3, what=arch)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gives_the_gradients_of_no_remat(remat):
    """``cfg.remat`` changes what autograd keeps, not what it computes."""
    _, tcfg = _configs("qwen3-0.6b")
    batch = _t(_batch(tcfg, seed=3))
    grads = {}
    for mode in ("none", remat):
        model = _model("qwen3-0.6b")
        loss, _ = loss_fn(model, batch, tcfg.replace(remat=mode))
        loss.backward()
        grads[mode] = _port_grads(model)
    for name, want in grads["none"].items():
        np.testing.assert_allclose(grads[remat][name], want, rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_dots_remat_saves_only_products_without_batch_dims():
    """The selective policy saves the weight products' outputs and
    recomputes attention's scores (a product with batch dims)."""
    from repro_torch.models.transformer import _save_dots
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    weight = (torch.zeros(1, 6, 4), torch.zeros(1, 4, 5))
    scores = (torch.zeros(8, 6, 4), torch.zeros(8, 4, 6))
    assert _save_dots(None, aten.bmm.default, *weight) == CheckpointPolicy.MUST_SAVE
    assert _save_dots(None, aten.mm.default, weight[0][0], weight[1][0]) == \
        CheckpointPolicy.MUST_SAVE
    assert _save_dots(None, aten.bmm.default, *scores) == CheckpointPolicy.PREFER_RECOMPUTE
    assert _save_dots(None, aten.exp.default, scores[0]) == CheckpointPolicy.PREFER_RECOMPUTE


def test_eval_step_is_the_loss_without_gradients():
    _, tcfg = _configs("qwen3-0.6b")
    batch = _t(_batch(tcfg, seed=4))
    model = _model("qwen3-0.6b")
    metrics = make_eval_step(tcfg)(model, batch)
    _, want = loss_fn(model, batch, tcfg)
    assert float(metrics["loss"]) == float(want["loss"])
    assert not metrics["loss"].requires_grad
    assert all(p.grad is None for p in model.parameters())


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------
def _opt_inputs(dtype: str, seed=0):
    """Params (the dense config's, in ``dtype``), grads (global norm above
    the clip) and a nonzero optimizer state, as numpy trees."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.dtype(dtype))),
        _jparams("qwen3-0.6b"))
    grads = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32), params)
    return params, grads, rng


def _port_tree(tree, model) -> dict:
    """A reference-shaped numpy tree as float32 tensors by the port's
    leaves: a stack's leaf a LayerStack of its layers."""
    flat = _flat(tree)
    return {name: LayerStack(torch.from_numpy(flat[name][i].copy()) for i in range(len(p)))
            if isinstance(p, LayerStack) else torch.from_numpy(flat[name].copy())
            for name, p in reference_leaves(model).items()}


def _load(model, tree) -> dict:
    """Copy a reference-shaped numpy tree into the model; its leaves."""
    leaves = reference_leaves(model)
    with torch.no_grad():
        for name, p in _port_tree(tree, model).items():
            for dst, src in zip(*((leaves[name], p) if isinstance(p, LayerStack)
                                  else ([leaves[name]], [p]))):
                dst.copy_(src)
    return leaves


def _nested(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        *head, last = name.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    params, grads, rng = _opt_inputs(dtype)
    jopt = joptim.AdamW(joptim.AdamWConfig(lr=1e-2))
    jstate = jopt.init(params)
    jstate = {"m": jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * 0.01, jstate["m"]),
        "v": jax.tree_util.tree_map(lambda a: np.abs(rng.standard_normal(a.shape)).astype(
            np.float32) * 1e-4, jstate["v"]),
        "count": np.int32(3)}
    want_p, want_s, want_m = jopt.update(grads, jstate, params, 0.02)

    model = _model("qwen3-0.6b", (("param_dtype", dtype),))
    leaves = _load(model, params)
    opt = AdamW(AdamWConfig(lr=1e-2))
    state = {"m": {k: torch.from_numpy(v.copy()) for k, v in _flat(jstate["m"]).items()},
             "v": {k: torch.from_numpy(v.copy()) for k, v in _flat(jstate["v"]).items()},
             "count": torch.tensor(3, dtype=torch.int32)}
    _, new_state, metrics = opt.update(_port_tree(grads, model), state, leaves, 0.02)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(want_m["grad_norm"]),
                               rtol=1e-6)
    assert float(metrics["grad_norm"]) > 1.0  # the clip is active
    assert int(new_state["count"]) == 4 and new_state["count"].dtype == torch.int32
    got_p = {name: _stacked(p) for name, p in leaves.items()}
    if dtype == "bfloat16":  # the same float32 update, cast once
        assert all(p.dtype == torch.bfloat16 for p in model.parameters())
        for name, w in _flat(want_p).items():
            np.testing.assert_array_equal(got_p[name], w, err_msg=name)
    else:
        _assert_leaves_close(got_p, _flat(want_p), rtol=1e-6, scaled_atol=1e-6, what="params")
    for key in ("m", "v"):
        got = {k: v.numpy() for k, v in new_state[key].items()}
        _assert_leaves_close(got, _flat(want_s[key]), rtol=1e-6, scaled_atol=1e-6, what=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adafactor_update_matches_reference(dtype):
    """Factored (both of the last two dims >= the threshold) and unfactored
    leaves: the threshold is cut to 32 so the scaled config has both."""
    params, grads, rng = _opt_inputs(dtype, seed=1)
    jopt = joptim.Adafactor(joptim.AdafactorConfig(min_dim_size_to_factor=32))
    jstate = jopt.init(params)
    jstate = {"v": jax.tree_util.tree_map(
        lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32) * 1e-3,
        jstate["v"]), "count": np.int32(5)}
    want_p, want_s, want_m = jopt.update(grads, jstate, params, 0.05)

    model = _model("qwen3-0.6b", (("param_dtype", dtype),))
    leaves = _load(model, params)
    opt = Adafactor(AdafactorConfig(min_dim_size_to_factor=32))
    init = opt.init(leaves)
    flat_v = _flat(jstate["v"])
    state = {"v": {name: {k: torch.from_numpy(flat_v[f"{name}/{k}"].copy()) for k in sub}
                   for name, sub in init["v"].items()},
             "count": torch.tensor(5, dtype=torch.int32)}
    assert {f"{n}/{k}" for n, sub in init["v"].items() for k in sub} == set(flat_v)
    assert any("vr" in sub for sub in init["v"].values())
    assert any("v" in sub for sub in init["v"].values())
    _, new_state, metrics = opt.update(_port_tree(grads, model), state, leaves, 0.05)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(want_m["grad_norm"]),
                               rtol=1e-6)
    got_p = {name: _stacked(p) for name, p in leaves.items()}
    if dtype == "bfloat16":
        for name, w in _flat(want_p).items():
            np.testing.assert_array_equal(got_p[name], w, err_msg=name)
    else:
        _assert_leaves_close(got_p, _flat(want_p), rtol=1e-6, scaled_atol=1e-6, what="params")
    got_v = {f"{n}/{k}": v.numpy() for n, sub in new_state["v"].items() for k, v in sub.items()}
    _assert_leaves_close(got_v, _flat(want_s["v"]), rtol=1e-6, scaled_atol=1e-6, what="v")
    assert int(new_state["count"]) == 6


def test_optimizer_state_matches_the_reference_layout():
    """AdamW's moments are stacked (L, ...) float32 tensors by the
    reference's leaf names; Adafactor's factoring follows the stacked
    shapes, at the default threshold of 128 too."""
    jcfg, tcfg = _configs("qwen3-0.6b", (("d_model", 128), ("d_ff", 256)))
    jparams = jspec.materialize(jax.random.key(0), jregistry.abstract_params(jcfg))
    leaves = reference_leaves(convert.lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu"))
    for jopt, opt in ((joptim.AdamW(), AdamW()), (joptim.Adafactor(), Adafactor())):
        want = {k: (v.shape, v.dtype.name) for k, v in _flat(jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, a.dtype), jopt.init(jparams))).items()}
        got = {f"{k}": (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in _flat_t(opt.init(leaves)).items()}
        assert got == {k: (s, "float32" if k != "count" else "int32")
                       for k, (s, _) in want.items()}


def _flat_t(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_t(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def test_global_norm_and_clip_match_reference():
    _, grads, _ = _opt_inputs("float32", seed=2)
    flat = _flat(grads)
    want_tree, want_norm = joptim.clip_by_global_norm(grads, 0.5)
    tgrads = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    np.testing.assert_allclose(float(toptim.global_norm(tgrads)),
                               float(joptim.global_norm(grads)), rtol=1e-6)
    got_tree, norm = toptim.clip_by_global_norm(tgrads, 0.5)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
    _assert_leaves_close({k: v.numpy() for k, v in got_tree.items()}, _flat(want_tree),
                         rtol=1e-6, scaled_atol=1e-6)


def test_cosine_lr_matches_reference():
    for step in (0, 1, 5, 9, 10, 11, 37, 64, 99, 100, 150):
        for base, warmup, total, floor in ((1.0, 10, 100, 0.1), (3e-3, 10, 20, 0.1),
                                           (0.5, 0, 40, 0.0)):
            want = joptim.cosine_lr(jnp.asarray(step), base=base, warmup=warmup, total=total,
                                    floor=floor)
            got = cosine_lr(torch.tensor(step, dtype=torch.int32), base=base, warmup=warmup,
                            total=total, floor=floor)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-9)
    assert float(cosine_lr(torch.tensor(0), base=1.0, warmup=10, total=100)) == 0.0
    assert float(cosine_lr(torch.tensor(10), base=1.0, warmup=10, total=100)) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
def _port_state(arch: str, optim, over: tuple = ()) -> dict:
    model = _model(arch, over)
    return {"params": model, "opt": optim.init(reference_leaves(model)),
            "step": torch.zeros((), dtype=torch.int32)}


def test_microbatches_match_the_full_batch():
    """Gradient accumulation equals the single-shot gradient, in the port
    and against the reference's accumulating step."""
    jcfg, tcfg = _configs("qwen3-0.6b")
    batch = _batch(tcfg, b=4, s=10, seed=5)
    frozen = AdamWConfig(lr=0.0, weight_decay=0.0)
    metrics = {}
    for mb in (1, 2):
        state = _port_state("qwen3-0.6b", AdamW(frozen))
        _, metrics[mb] = make_train_step(tcfg, AdamW(frozen), microbatches=mb)(state, _t(batch))
    jopt = joptim.AdamW(joptim.AdamWConfig(lr=0.0, weight_decay=0.0))
    jstate = {"params": _jparams("qwen3-0.6b"), "opt": jopt.init(_jparams("qwen3-0.6b")),
              "step": jnp.zeros((), jnp.int32)}
    _, jm = jax.jit(jstep.make_train_step(jcfg, jopt, microbatches=2))(jstate, _j(batch))
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(metrics[2][key]), float(metrics[1][key]), rtol=1e-5,
                                   err_msg=key)
        np.testing.assert_allclose(float(metrics[2][key]), float(jm[key]), rtol=1e-5,
                                   err_msg=key)


def test_microbatched_gradients_are_float32_and_the_mean():
    _, tcfg = _configs("qwen3-0.6b", (("param_dtype", "bfloat16"),))
    batch = _t(_batch(tcfg, b=4, s=8, seed=6))
    seen = {}

    class Spy(AdamW):
        def update(self, grads, state, params, lr=None):
            seen["dtypes"] = {t.dtype for g in grads.values()
                              for t in (g if isinstance(g, LayerStack) else [g])}
            return super().update(grads, state, params, lr)

    state = _port_state("qwen3-0.6b", Spy(), (("param_dtype", "bfloat16"),))
    make_train_step(tcfg, Spy(), microbatches=2)(state, batch)
    assert seen["dtypes"] == {torch.float32}
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tcfg, AdamW(), microbatches=3)(state, batch)


@pytest.mark.parametrize("schedule", [False, True])
def test_three_train_steps_match_the_reference(schedule):
    """qwen3 reduced, AdamW at lr 1e-2 (or launch.train's cosine
    schedule with 1 warmup step), three steps on the synthetic token
    stream: losses within 1e-4. The parameters after them agree within 1%
    of the most three steps can move one (3 lr): Adam normalises each
    element's gradient, so an element whose gradient is a small difference
    of large terms (held only to the leaf-scaled atol of the gradient test)
    still moves by about lr a step, and its last bits move it."""
    jcfg, tcfg = _configs("qwen3-0.6b")
    data = SyntheticTokens(tcfg.vocab, 16, 4, seed=0)
    jsched = (lambda s: joptim.cosine_lr(s, base=1e-2, warmup=1, total=3)) if schedule else None
    tsched = (lambda s: cosine_lr(s, base=1e-2, warmup=1, total=3)) if schedule else None
    jopt = joptim.AdamW(joptim.AdamWConfig(lr=1e-2))
    jstate = {"params": _jparams("qwen3-0.6b"), "opt": jopt.init(_jparams("qwen3-0.6b")),
              "step": jnp.zeros((), jnp.int32)}
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt, lr_schedule=jsched))
    state = _port_state("qwen3-0.6b", AdamW(AdamWConfig(lr=1e-2)))
    fn = make_train_step(tcfg, AdamW(AdamWConfig(lr=1e-2)), lr_schedule=tsched)
    for i in range(3):
        batch = data.batch_at(i)
        jstate, jm = jfn(jstate, _j(batch))
        state, m = fn(state, _t(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        if schedule:
            np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(state["step"]) == 3 and int(state["opt"]["count"]) == 3
    got = {n: _stacked(p) for n, p in reference_leaves(state["params"]).items()}
    for name, want in _flat(jstate["params"]).items():
        np.testing.assert_allclose(got[name], want, rtol=1e-4, atol=1e-2 * 3 * 1e-2,
                                   err_msg=name)


def test_all_masked_labels_do_not_poison_the_loss():
    """``tests/test_train.py``'s NaN-label case: every label masked."""
    _, tcfg = _configs("qwen3-0.6b")
    batch = _batch(tcfg, seed=7)
    batch["labels"] = np.full_like(batch["labels"], -1)
    state = _port_state("qwen3-0.6b", AdamW())
    before = {n: _stacked(p) for n, p in reference_leaves(state["params"]).items()}
    _, m = make_train_step(tcfg, AdamW())(state, _t(batch))
    assert np.isfinite(float(m["loss"])) and float(m["ce"]) == 0.0
    after = {n: _stacked(p) for n, p in reference_leaves(state["params"]).items()}
    assert all(np.isfinite(a).all() for a in after.values())
    assert any(not np.array_equal(before[n], after[n]) for n in before)  # decay still applies


def test_init_state_turns_gradients_on():
    _, tcfg = _configs("qwen3-0.6b")
    state = init_state(tcfg, AdamW(), seed=3, device="cpu")
    assert all(p.requires_grad for p in state["params"].parameters())
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    assert set(state["opt"]) == {"m", "v", "count"}


def test_launch_train_smoke_lowers_the_loss_and_restores(tmp_path, capsys):
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--steps", "16",
            "--batch", "4", "--seq", "32", "--ckpt-every", "8", "--log-every", "8",
            "--ckpt-dir", str(tmp_path)]
    out = train_main(argv)
    assert len(out["losses"]) == 16 and out["losses"][-1] < out["losses"][0]
    assert out["ckpt"].steps() == [8, 16]
    assert out["async_save"]["step"] == 8 and out["async_save"]["bytes"] > 0
    text = capsys.readouterr().out
    assert "attn_impl='torch'" in text and "no kernel here has a backward" in text
    again = train_main(argv[:6] + ["20"] + argv[7:] + ["--restore"])
    assert again["start_step"] == 16 and len(again["losses"]) == 4
    assert int(again["state"]["step"]) == 20


# ---------------------------------------------------------------------------
# The kernels have no backward: a CUDA route refuses autograd
# ---------------------------------------------------------------------------
def _kernel_calls():
    from repro_torch.kernels import ccl, color_deconv, flash_attention, glcm, morph_recon
    from repro_torch.kernels import ssd_scan

    def f(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, requires_grad=dtype.is_floating_point)

    return {
        "flash_attention": lambda: flash_attention.flash_attention_cuda(
            f(1, 2, 4, 16), f(1, 2, 4, 16), f(1, 2, 4, 16)),
        "ssd_scan": lambda: ssd_scan.ssd_scan_cuda(
            f(1, 4, 2, 16), f(1, 4, 2), f(2), f(1, 4, 1, 8), f(1, 4, 1, 8), f(2)),
        "color_deconv": lambda: color_deconv.color_deconv_cuda(f(3, 4, 4), f(3, 3)),
        "morph_recon": lambda: morph_recon.morph_recon_cuda(f(4, 4), f(4, 4)),
        # the integer kernels take tensors autograd cannot record; a float
        # mask (as a caller might pass) is refused for the gradient first
        "ccl": lambda: ccl.ccl_cuda(f(4, 4)),
        "glcm": lambda: glcm.glcm_cuda(f(1, 4, 4), 8),
    }


@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan", "color_deconv",
                                    "morph_recon", "ccl", "glcm"])
def test_kernel_wrappers_refuse_tensors_autograd_records(kernel):
    call = _kernel_calls()[kernel]
    with pytest.raises(RuntimeError, match="no backward.*attn_impl='torch'"):
        call()
    with torch.no_grad():  # not recorded: refused only for lying on the CPU
        with pytest.raises((ValueError, TypeError)):
            call()


def test_ops_cuda_route_under_autograd_raises(monkeypatch):
    """A model whose attention takes the kernel route raises under autograd
    instead of training without its q/k/v gradients."""
    monkeypatch.setattr(ops, "_use_kernel", lambda impl, x: True)
    _, tcfg = _configs("qwen3-0.6b")
    model = _model("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="attn_impl='torch'"):
        loss_fn(model, _t(_batch(tcfg)), tcfg.replace(attn_impl="auto"))
