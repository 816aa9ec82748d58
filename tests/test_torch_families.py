"""The port's decoder-only families (dense, MoE with MLA, SSM, the VLM
backbone's patch prefix) against the JAX package, on the CPU.

Both packages run the same parameters: the reference's random init,
converted to numpy and loaded into the port with
``convert.lm_params_from_reference``. The configs are the eight
decoder-only architectures other than Hymba, each ``scaled_down()`` in
float32. The JAX side is jitted, with ``attn_impl="xla"`` and, where the
reference can run it, ``"pallas"`` (the kernels in interpret mode); the
port's runs on CPU tensors, so its ops take the plain versions.

Tolerances: logits and cache leaves at 3e-4 in float32, as the hybrid
family's (tests/test_torch_models.py): the two packages sum in different
orders (einsum, softmax, the SSD recurrence against Pallas's chunked scan),
a few ulps a layer. Cache leaves at 3e-4 of the leaf's scale, since the SSD
state grows to hundreds with random weights. gemma in bf16 computes in
float32 past the embedding in both packages (the promotion of
``repro/models/layers.py:612``), so it is held at float32's 3e-4 too; only
the caches are bf16, written from float32 values the two packages agree on
to 3e-4, which may round them to neighbouring bf16 values (one bf16 ulp,
2**-8 relative).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as JL
from repro.models import registry as jregistry
from repro.models import spec as jspec
from repro.models import transformer as JT
from repro.serve import generate as jgenerate
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import LM, registry
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import generate

TOL = dict(rtol=3e-4, atol=3e-4)
ARCHS = ["qwen3-0.6b", "gemma-2b", "granite-20b", "internvl2-1b", "nemotron-4-340b",
         "deepseek-v2-lite-16b", "qwen3-moe-235b-a22b", "mamba2-2.7b"]
# The Pallas attention kernel takes one head_dim for q, k and v; MLA's
# scoring path gives v 16 dims against q's 24, so the reference runs it on
# xla only (its prefill and decode take the absorbed form, with no kernel).
FORWARD_CASES = [(a, impl) for a in ARCHS for impl in ("xla", "pallas")
                 if not (a == "deepseek-v2-lite-16b" and impl == "pallas")]
PARAM_COUNTS = {  # the reference's, at full size: (total, active)
    "qwen3-0.6b": (596_049_920, 596_049_920),
    "gemma-2b": (2_506_172_416, 2_506_172_416),
    "mamba2-2.7b": (2_831_296_000, 2_831_296_000),
    "granite-20b": (20_316_401_664, 20_316_401_664),
    "internvl2-1b": (629_636_224, 629_636_224),
    "deepseek-v2-lite-16b": (15_706_484_224, 2_661_150_208),
    "qwen3-moe-235b-a22b": (235_093_634_560, 22_190_763_520),
    "nemotron-4-340b": (341_029_195_776, 341_029_195_776),
    "hymba-1.5b": (1_640_872_320, 1_640_872_320),
}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

j_forward = jax.jit(JT.forward, static_argnums=2)
j_prefill = jax.jit(JT.prefill, static_argnums=2)
j_decode = jax.jit(JT.decode_step, static_argnums=2)


def _configs(arch: str, over: tuple = ()):
    """(jax cfg, port cfg) of ``arch`` scaled down, with ``over`` applied to
    both (dtypes named as strings)."""
    kw = dict(over)
    jkw = {k: (jnp.dtype(v) if k.endswith("dtype") else v) for k, v in kw.items()}
    tkw = {k: (TORCH_DTYPES[v] if k.endswith("dtype") else v) for k, v in kw.items()}
    return jget_config(arch).scaled_down(**jkw), get_config(arch).scaled_down(**tkw)


@functools.lru_cache(maxsize=None)
def _models(arch: str, over: tuple = ()):
    """(jax cfg, port cfg, jax params, port model) with the same weights."""
    jcfg, tcfg = _configs(arch, over)
    jparams = jspec.materialize(jax.random.key(1), jregistry.abstract_params(jcfg))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, convert.lm_params_from_reference(tree, tcfg, device="cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _prefix(cfg, b, seed=0):
    """The modality prefix, drawn as the reference's launch driver draws it."""
    if not cfg.frontend:
        return None
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.frontend_len, cfg.d_model)).astype(np.float32) * 0.1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _assert_cache_equal(got: dict, want: dict, rtol=3e-4, where=""):
    """Every leaf relative to the leaf's scale: with random weights the SSD
    state grows to hundreds, and float32 keeps about seven digits of each
    element, whose neighbours may be 100x larger."""
    assert set(got) == set(want), (where, sorted(got), sorted(want))
    for key in want:
        if isinstance(want[key], dict):
            _assert_cache_equal(got[key], want[key], rtol, f"{where}/{key}")
        else:
            g, w = _np(got[key]), _np(want[key])
            assert g.shape == w.shape, (where, key, g.shape, w.shape)
            scale = max(1.0, float(np.abs(w).max(initial=0.0)))
            np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * scale,
                                       err_msg=f"cache leaf {where}/{key}")


@pytest.mark.parametrize("arch,jimpl", FORWARD_CASES)
def test_forward_logits_match(arch, jimpl):
    jcfg, tcfg, jparams, model = _models(arch)
    b, s = 2, 12
    toks, pre = _tokens(tcfg, b, s), _prefix(tcfg, b)
    jpre = None if pre is None else jnp.asarray(pre)
    tpre = None if pre is None else torch.from_numpy(pre)
    want, jaux = j_forward(jparams, jnp.asarray(toks), jcfg.replace(attn_impl=jimpl),
                           prefix_embeds=jpre)
    got, aux = T.forward(model, torch.from_numpy(toks), tcfg, prefix_embeds=tpre)
    assert got.shape == want.shape == (b, s + tcfg.frontend_len, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(model(torch.from_numpy(toks), tpre).numpy(), want, **TOL)


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_every_cache_leaf_match(arch, jimpl):
    jcfg, tcfg, jparams, model = _models(arch)
    b, s = 2, 13
    max_len = s + tcfg.frontend_len + 6
    toks, pre = _tokens(tcfg, b, s, seed=1), _prefix(tcfg, b, seed=1)
    want, jcache = j_prefill(jparams, jnp.asarray(toks), jcfg.replace(attn_impl=jimpl),
                             JT.init_cache(jcfg, b, max_len),
                             prefix_embeds=None if pre is None else jnp.asarray(pre))
    got, cache = T.prefill(model, torch.from_numpy(toks), tcfg,
                           T.init_cache(tcfg, b, max_len, device="cpu"),
                           prefix_embeds=None if pre is None else torch.from_numpy(pre))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _assert_cache_equal(cache, jcache)


def _decode_both(arch, over=(), b=2, s=9, steps=4, seed=2):
    """Prefill then ``steps`` decode steps in both packages; returns the
    pairs of logits and the final caches."""
    jcfg, tcfg, jparams, model = _models(arch, over)
    p = tcfg.frontend_len
    max_len = s + p + steps + 1
    toks, pre = _tokens(tcfg, b, s + steps, seed=seed), _prefix(tcfg, b, seed=seed)
    want, jcache = j_prefill(jparams, jnp.asarray(toks[:, :s]), jcfg,
                             JT.init_cache(jcfg, b, max_len),
                             prefix_embeds=None if pre is None else jnp.asarray(pre))
    got, cache = T.prefill(model, torch.from_numpy(toks[:, :s]), tcfg,
                           T.init_cache(tcfg, b, max_len, device="cpu"),
                           prefix_embeds=None if pre is None else torch.from_numpy(pre))
    pairs = [(got, want)]
    for i in range(s, s + steps):
        want, jcache = j_decode(jparams, jnp.asarray(toks[:, i:i + 1]), jcfg, jcache,
                                jnp.asarray(p + i, jnp.int32))
        got, cache = T.decode_step(model, torch.from_numpy(toks[:, i:i + 1]), tcfg, cache, p + i)
        pairs.append((got, want))
    return pairs, cache, jcache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match(arch):
    pairs, cache, jcache = _decode_both(arch)
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=f"step {i}")
    _assert_cache_equal(cache, jcache)


def test_gemma_in_bf16_promotes_to_float32_as_the_reference():
    """bf16 weights and compute dtype: both packages embed in bf16, scale by
    sqrt(d_model) in float32 and run every later layer in float32, so the
    logits are float32 and agree at float32's tolerance; the caches are
    bf16."""
    over = (("param_dtype", "bfloat16"), ("compute_dtype", "bfloat16"))
    jcfg, tcfg, jparams, model = _models("gemma-2b", over)
    toks = _tokens(tcfg, 2, 12, seed=5)
    x = L.embed_tokens(model["embed"], torch.from_numpy(toks), tcfg)
    jx = JL.embed_tokens(jparams["embed"], jnp.asarray(toks), jcfg)
    assert x.dtype == torch.float32 and jx.dtype == jnp.float32
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    want, _ = j_forward(jparams, jnp.asarray(toks), jcfg)
    got, _ = T.forward(model, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    pairs, cache, jcache = _decode_both("gemma-2b", over)
    for i, (got, want) in enumerate(pairs):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=f"step {i}")
    assert cache["layers"]["k"].dtype == torch.bfloat16
    _assert_cache_equal(cache, jcache, rtol=2**-8)


def _moe_inputs(cfg, t, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, t // 2, cfg.d_model)).astype(np.float32)


def _drops(cfg, idx: np.ndarray, groups: int) -> int:
    """Assignments beyond their expert's capacity, group by group."""
    t = idx.shape[0] // groups
    cap = int(max(1, np.ceil(t * cfg.experts_per_token / cfg.num_experts
                             * cfg.capacity_factor)))
    counts = [np.bincount(g.reshape(-1), minlength=cfg.num_experts)
              for g in idx.reshape(groups, -1)]
    return int(sum(np.maximum(c - cap, 0).sum() for c in counts))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v2-lite-16b"])
def test_moe_layer_with_capacity_drops_matches(arch, groups):
    """A capacity factor of 0.5 forces drops; which assignments are dropped
    follows the stable sort by expert, and the kept ones are combined with
    their gates. One dispatch, or ``moe_groups=2`` (a dispatch per half)."""
    over = (("capacity_factor", 0.5), ("moe_groups", groups))
    jcfg, tcfg, jparams, model = _models(arch, over)
    stack = "layers"
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams[stack]["mlp"])
    tp = model[stack][0]["mlp"]
    x = _moe_inputs(tcfg, 24, seed=groups)
    want, jaux = JL.moe_forward(jp, jnp.asarray(x), jcfg)
    got, aux = L.moe_forward(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-8)
    _, idx, _ = L._route(tp, torch.from_numpy(x).reshape(groups, -1, tcfg.d_model), tcfg)
    assert _drops(tcfg, idx.reshape(-1, tcfg.experts_per_token).numpy(), groups) > 0


def test_moe_router_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability: both packages
    pick experts 0 .. k-1, as jax.lax.top_k breaks ties."""
    jcfg, tcfg, jparams, model = _models("qwen3-moe-235b-a22b")
    tp = model["layers"][0]["mlp"]
    zero = {k: (torch.zeros_like(v) if k == "router" else v) for k, v in tp.named_parameters()}
    x = torch.from_numpy(_moe_inputs(tcfg, 8, seed=3))
    gate, idx, _ = L._route(zero, x, tcfg)
    k = tcfg.experts_per_token
    assert torch.equal(idx, torch.arange(k).expand_as(idx))
    np.testing.assert_allclose(gate.numpy(), 1.0 / k, rtol=1e-6)
    _, jidx = jax.lax.top_k(jnp.full((4, tcfg.num_experts), 0.125), k)
    np.testing.assert_array_equal(np.asarray(jidx), np.arange(k)[None].repeat(4, 0))


def test_moe_groups_model_matches():
    """``moe_groups=2`` through the whole model: forward and decode (where
    the 2 decode tokens split into groups of one)."""
    over = (("moe_groups", 2),)
    jcfg, tcfg, jparams, model = _models("qwen3-moe-235b-a22b", over)
    toks = _tokens(tcfg, 2, 10, seed=7)
    want, jaux = j_forward(jparams, jnp.asarray(toks), jcfg)
    got, aux = T.forward(model, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-8)
    pairs, cache, jcache = _decode_both("qwen3-moe-235b-a22b", over)
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b",
                                  "internvl2-1b", "mamba2-2.7b", "gemma-2b"])
def test_greedy_generate_matches_reference(arch):
    """Identical greedy tokens from the same weights. Decode at batch 2 gives
    a capacity of 1 token an expert (drops whenever two tokens share one).
    With a prefix both packages get an explicit ``max_len``: the
    reference's default omits the prefix and its prefill does not fit."""
    jcfg, tcfg, jparams, model = _models(arch)
    b, s0, max_new = 2, 7, 6
    prompt, pre = _tokens(tcfg, b, s0, seed=11), _prefix(tcfg, b, seed=11)
    kw, tkw = {}, {}
    if pre is not None:
        kw = dict(prefix=jnp.asarray(pre), max_len=s0 + tcfg.frontend_len + max_new + 1)
        tkw = dict(prefix=pre, max_len=kw["max_len"])
    want = np.asarray(jgenerate(jparams, jcfg, jnp.asarray(prompt), max_new=max_new, **kw))
    got = generate(model, tcfg, prompt, max_new=max_new, device="cpu", **tkw)
    np.testing.assert_array_equal(got.numpy(), want)
    if pre is not None:  # the port's default cache holds the prefix
        tkw.pop("max_len")
        again = generate(model, tcfg, prompt, max_new=max_new, device="cpu", **tkw)
        np.testing.assert_array_equal(again.numpy(), want)


def test_generate_refuses_a_prefix_of_another_length():
    _, tcfg, _, model = _models("internvl2-1b")
    pre = np.zeros((1, tcfg.frontend_len + 1, tcfg.d_model), np.float32)
    with pytest.raises(ValueError, match="prefix"):
        generate(model, tcfg, np.zeros((1, 4), np.int32), max_new=1, prefix=pre, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "internvl2-1b", "deepseek-v2-lite-16b",
                                  "mamba2-2.7b"])
def test_launch_serve_smoke_serves_every_family(arch, capsys):
    out = serve_main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                      "--batch", "2", "--prompt-len", "12", "--max-new", "3"])
    assert [o.shape for o in out["outputs"]] == [(2, 15), (1, 15)]
    assert all(o.min() >= 0 and o.max() < 512 for o in out["outputs"])
    text = capsys.readouterr().out
    assert f"arch={arch}" in text and "[serve] decode:" in text and "peak memory" in text


@pytest.mark.parametrize("arch", list(PARAM_COUNTS))
def test_full_size_param_counts_match_reference(arch):
    """The nine decoder-only configs at full size, counted from the specs and
    from a meta-device model: nothing is allocated."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    total, active = PARAM_COUNTS[arch]
    assert registry.count_params(tcfg) == jregistry.count_params(jcfg) == total
    assert registry.count_active_params(tcfg) == jregistry.count_active_params(jcfg) == active
    model = LM(tcfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == total


def test_reference_trees_carry_across_with_every_leaf():
    """Expert stacks (L, E, d, f), shared experts, MLA leaves, the dense
    first layer and tied embeddings arrive leaf for leaf; a missing or an
    unknown leaf is refused."""
    jcfg, tcfg, jparams, model = _models("deepseek-v2-lite-16b")
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    np.testing.assert_array_equal(model["layers"][0]["mlp"]["w1"].numpy(),
                                  tree["layers"]["mlp"]["w1"][0])
    np.testing.assert_array_equal(model["layers"][0]["mlp"]["shared"]["w2"].numpy(),
                                  tree["layers"]["mlp"]["shared"]["w2"][0])
    np.testing.assert_array_equal(model["dense_layers"][0]["attn"]["w_uk"].numpy(),
                                  tree["dense_layers"]["attn"]["w_uk"][0])
    assert "unembed" not in dict(_models("gemma-2b")[3]["embed"].named_parameters())
    lacking = {**tree, "layers": {**tree["layers"], "mlp": {
        k: v for k, v in tree["layers"]["mlp"].items() if k != "shared"}}}
    with pytest.raises(ValueError, match="lacks"):
        convert.lm_params_from_reference(lacking, tcfg, device="cpu")
    extra = {**tree, "embed": {**tree["embed"], "bogus": tree["embed"]["tok"]}}
    with pytest.raises(ValueError, match="not a parameter"):
        convert.lm_params_from_reference(extra, tcfg, device="cpu")
    shallow = {**tree, "layers": jax.tree_util.tree_map(lambda a: a[:0], tree["layers"])}
    with pytest.raises(ValueError, match="layers in the reference"):
        convert.lm_params_from_reference(shallow, tcfg, device="cpu")
