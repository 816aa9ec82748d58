"""The port's hybrid LM (Hymba) against the JAX package, on the CPU.

Both packages run the same parameters: the reference's random init,
converted to numpy and loaded into the port with
``convert.lm_params_from_reference`` (the port's own init cannot reproduce
``jax.random``). Logits and every cache leaf compare at 3e-4 in float32.
The JAX side is jitted, with ``attn_impl="xla"`` (and ``"pallas"``, the
kernels in interpret mode, for prefill); the port's runs on CPU tensors,
so its ops take the plain versions.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ModelConfig as JModelConfig
from repro.models import registry as jregistry
from repro.models import spec as jspec
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import HybridLM, ModelConfig, registry
from repro_torch.models import transformer as T

TOL = dict(rtol=3e-4, atol=3e-4)
BASE = dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab=128, remat="none", family="hybrid", window=8, num_global_layers=1,
            ssm_state=8, ssm_headdim=16)
# the hybrid config of tests/test_models.py, and the reduced Hymba
CONFIGS = {
    "hybrid": (JModelConfig(name="h", param_dtype=jnp.float32, compute_dtype=jnp.float32, **BASE),
               ModelConfig(name="h", param_dtype=torch.float32, compute_dtype=torch.float32,
                           **BASE)),
    "hymba": (jget_config("hymba-1.5b").scaled_down(), get_config("hymba-1.5b").scaled_down()),
}

j_forward = jax.jit(JT.forward, static_argnums=2)
j_prefill = jax.jit(JT.prefill, static_argnums=2)
j_decode = jax.jit(JT.decode_step, static_argnums=2)


@functools.lru_cache(maxsize=None)
def _models(name: str):
    """(jax cfg, port cfg, jax params, port model) with the same weights."""
    jcfg, tcfg = CONFIGS[name]
    jparams = jspec.materialize(jax.random.key(1), jregistry.abstract_params(jcfg))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, convert.lm_params_from_reference(tree, tcfg, device="cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_cache_equal(got: dict, want: dict, where=""):
    """Every leaf at 3e-4 relative to the leaf's scale: with random weights
    the SSD state grows to hundreds, and float32 keeps about seven digits of
    each element, whose neighbours may be 100x larger."""
    assert set(got) == set(want), (where, sorted(got), sorted(want))
    for key in want:
        if isinstance(want[key], dict):
            _assert_cache_equal(got[key], want[key], f"{where}/{key}")
        else:
            g, w = _np(got[key]), np.asarray(want[key])
            assert g.shape == w.shape, (where, key, g.shape, w.shape)
            scale = max(1.0, float(np.abs(w).max(initial=0.0)))
            np.testing.assert_allclose(g, w, rtol=3e-4, atol=3e-4 * scale,
                                       err_msg=f"cache leaf {where}/{key}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_logits_match(name):
    jcfg, tcfg, jparams, model = _models(name)
    toks = _tokens(tcfg, 2, 12)
    want, _ = j_forward(jparams, jnp.asarray(toks), jcfg)
    got, aux = T.forward(model, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(aux) == 0.0
    np.testing.assert_allclose(model(torch.from_numpy(toks)).numpy(), want, **TOL)


@pytest.mark.parametrize("jimpl", ["xla", "pallas", "chunked"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_logits_and_every_cache_leaf_match(name, jimpl):
    """A prompt longer than the window and no multiple of it, so the ring
    wraps: its slots and ``slotpos`` must land where the reference's do.
    ``"chunked"`` runs the chunked route in both packages (online-softmax
    attention and the chunked SSD scan); the port's plain route stands
    against ``"xla"`` and ``"pallas"``."""
    jcfg, tcfg, jparams, model = _models(name)
    if jimpl == "chunked":
        tcfg = tcfg.replace(attn_impl="chunked")
    b, s, max_len = 2, tcfg.window + 5, tcfg.window + 12
    toks = _tokens(tcfg, b, s, seed=1)
    want, jcache = j_prefill(jparams, jnp.asarray(toks), jcfg.replace(attn_impl=jimpl),
                             JT.init_cache(jcfg, b, max_len))
    got, cache = T.prefill(model, torch.from_numpy(toks), tcfg,
                           T.init_cache(tcfg, b, max_len, device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _assert_cache_equal(cache, jcache)


@pytest.mark.parametrize("prompt", ["below", "above"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_steps_match(name, prompt):
    jcfg, tcfg, jparams, model = _models(name)
    w = tcfg.window
    b, s, steps = 2, (w - 2 if prompt == "below" else w + 5), 4
    max_len = s + steps + 1
    toks = _tokens(tcfg, b, s + steps, seed=2)
    _, jcache = j_prefill(jparams, jnp.asarray(toks[:, :s]), jcfg,
                          JT.init_cache(jcfg, b, max_len))
    _, cache = T.prefill(model, torch.from_numpy(toks[:, :s]), tcfg,
                         T.init_cache(tcfg, b, max_len, device="cpu"))
    for i in range(s, s + steps):
        want, jcache = j_decode(jparams, jnp.asarray(toks[:, i:i + 1]), jcfg, jcache,
                                jnp.asarray(i, jnp.int32))
        got, cache = T.decode_step(model, torch.from_numpy(toks[:, i:i + 1]), tcfg, cache, i)
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=f"decode step at {i}")
    _assert_cache_equal(cache, jcache)


def _stacked_shapes_of_model(model) -> dict:
    """{"layers/attn/wq": (L, ...)} from the port's per-layer parameters."""
    out: dict = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] in ("layers", "global_layers"):
            key = "/".join([parts[0], *parts[2:]])
            n = out.get(key, (0,))[0] + 1
            out[key] = (n, *p.shape)
        else:
            out["/".join(parts)] = tuple(p.shape)
    return out


def _spec_shapes(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_spec_shapes(v, path) if isinstance(v, dict) else {path: tuple(v.shape)})
    return out


def test_full_hymba_param_count_and_shapes_match_reference():
    """1.64 B parameters, counted from the specs and a meta-device model:
    nothing is allocated."""
    jcfg, tcfg = jget_config("hymba-1.5b"), get_config("hymba-1.5b")
    assert registry.count_params(tcfg) == jregistry.count_params(jcfg) == 1_640_872_320
    assert tcfg.params_count() == 1_640_872_320
    want = _spec_shapes(jregistry.abstract_params(jcfg))
    assert _spec_shapes(registry.abstract_params(tcfg)) == want
    model = HybridLM(tcfg, device="meta")
    assert all(p.is_meta for p in model.parameters())
    assert _stacked_shapes_of_model(model) == want
    assert sum(p.numel() for p in model.parameters()) == 1_640_872_320


def test_other_families_and_archs_raise():
    """Every family is ported: the encoder-decoder config builds (an
    ``EncDec``, not an ``LM``); an unknown arch still raises."""
    from repro_torch.models import EncDec, build

    cfg = get_config("seamless-m4t-large-v2")
    assert cfg.family == "encdec"
    assert isinstance(build(cfg, device="meta"), EncDec)
    assert set(registry.abstract_params(cfg)) == {"embed", "enc_layers", "enc_norm",
                                                  "dec_layers", "final_norm"}
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        HybridLM(ModelConfig(family="encdec"), device="meta")


@pytest.mark.parametrize("knob", [
    dict(mlp_kind="geglu"), dict(mlp_kind="relu2"), dict(mlp_kind="gelu"),
    dict(norm_type="layernorm"), dict(qk_norm=True), dict(embed_scale=True),
    dict(tie_embeddings=True), dict(logit_softcap=30.0), dict(frontend="patch", frontend_len=4),
])
def test_transformer_details_match_reference(knob):
    """Each transformer detail other than Hymba's, turned on in the hybrid
    config: forward logits, and prefill logits with every cache leaf, equal
    the reference's (with the patch prefix in front of the tokens when the
    frontend is on)."""
    jcfg0, tcfg0 = CONFIGS["hybrid"]
    jcfg, tcfg = jcfg0.replace(**knob), tcfg0.replace(**knob)
    jparams = jspec.materialize(jax.random.key(4), jregistry.abstract_params(jcfg))
    model = convert.lm_params_from_reference(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                             device="cpu")
    b, s = 2, 12
    toks = _tokens(tcfg, b, s, seed=4)
    pre = None
    if tcfg.frontend:
        pre = np.random.default_rng(4).standard_normal(
            (b, tcfg.frontend_len, tcfg.d_model)).astype(np.float32)
    jpre = None if pre is None else jnp.asarray(pre)
    tpre = None if pre is None else torch.from_numpy(pre)
    want, _ = j_forward(jparams, jnp.asarray(toks), jcfg, prefix_embeds=jpre)
    got, _ = T.forward(model, torch.from_numpy(toks), tcfg, prefix_embeds=tpre)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    max_len = s + tcfg.frontend_len + 4
    want, jcache = j_prefill(jparams, jnp.asarray(toks), jcfg, JT.init_cache(jcfg, b, max_len),
                             prefix_embeds=jpre)
    got, cache = T.prefill(model, torch.from_numpy(toks), tcfg,
                           T.init_cache(tcfg, b, max_len, device="cpu"), prefix_embeds=tpre)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _assert_cache_equal(cache, jcache)


def test_bf16_parameters_cross_through_their_bits():
    """ml_dtypes bfloat16 leaves load bit for bit (torch.from_numpy refuses
    them as they are)."""
    jcfg = CONFIGS["hybrid"][0].replace(param_dtype=jnp.bfloat16)
    tcfg = CONFIGS["hybrid"][1].replace(param_dtype=torch.bfloat16)
    jparams = jspec.materialize(jax.random.key(2), jregistry.abstract_params(jcfg))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    model = convert.lm_params_from_reference(tree, tcfg, device="cpu")
    wq = model["layers"][1]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(wq.view(torch.int16).numpy(),
                                  tree["layers"]["attn"]["wq"][1].view(np.int16))
    assert model["layers"][0]["ssd"]["a_log"].dtype == torch.float32
    with pytest.raises(ValueError, match="lacks"):
        convert.lm_params_from_reference({k: v for k, v in tree.items() if k != "final_norm"}
                                         | {"final_norm": {}}, tcfg, device="cpu")
