"""The port's encoder-decoder family (seamless-m4t-large-v2) against the JAX
package, on the CPU.

Both packages run the same parameters: the reference's random init,
converted to numpy and loaded into the port with
``convert.lm_params_from_reference``. The config is seamless
``scaled_down()`` in float32 (2 encoder and 2 decoder layers, d_model 64).
The JAX side is jitted with ``attn_impl="xla"`` and, where named,
``"pallas"`` (its kernel in interpret mode: non-causal in the encoder,
causal in the decoder); the port's runs on CPU tensors, so its attention
takes the plain version.

Tolerance: 3e-4 in float32, as the other families' (tests/
test_torch_families.py): the packages sum in different orders, a few ulps
a layer.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import registry as jregistry
from repro.models import spec as jspec
from repro.serve import generate as jgenerate
from repro.serve.step import make_prefill_step as jmake_prefill_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import EncDec, build, registry
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.serve import generate, make_cache, make_decode_step, make_prefill_step

TOL = dict(rtol=3e-4, atol=3e-4)
ARCH = "seamless-m4t-large-v2"
SEAMLESS_PARAMS = 1_632_131_072  # the reference's count at full size

j_forward = jax.jit(JE.forward, static_argnums=3)
j_prefill = jax.jit(JE.prefill, static_argnums=3)
j_decode = jax.jit(JE.decode_step, static_argnums=2)


@functools.lru_cache(maxsize=None)
def _models():
    """(jax cfg, port cfg, jax params, port model) with the same weights."""
    jcfg, tcfg = jget_config(ARCH).scaled_down(), get_config(ARCH).scaled_down()
    jparams = jspec.materialize(jax.random.key(3), jregistry.abstract_params(jcfg))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, convert.lm_params_from_reference(tree, tcfg, device="cpu")


def _inputs(cfg, b, s, s_enc, seed=0):
    """Decoder tokens and encoder frames, the frames drawn as the reference's
    launch.serve draws them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    frames = rng.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32) * 0.1
    return toks, frames


def _assert_cache_equal(got: dict, want: dict):
    assert set(got) == set(want) == {"k", "v", "xk", "xv"}
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL,
                                   err_msg=f"cache leaf {key}")


def test_scaled_config_is_an_encoder_decoder():
    _, tcfg, _, model = _models()
    assert isinstance(model, EncDec) and tcfg.family == "encdec"
    assert len(model.enc_layers) == tcfg.enc_layers == 2
    assert len(model.dec_layers) == tcfg.num_layers == 2


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
def test_forward_logits_match(jimpl):
    jcfg, tcfg, jparams, model = _models()
    toks, frames = _inputs(tcfg, 2, 11, 17)
    want, jaux = j_forward(jparams, jnp.asarray(frames), jnp.asarray(toks),
                           jcfg.replace(attn_impl=jimpl))
    got, aux = E.forward(model, torch.from_numpy(frames), torch.from_numpy(toks), tcfg)
    assert got.shape == want.shape == (2, 11, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(model(torch.from_numpy(frames), torch.from_numpy(toks)).numpy(),
                               want, **TOL)


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
def test_encoder_states_match(jimpl):
    jcfg, tcfg, jparams, model = _models()
    _, frames = _inputs(tcfg, 2, 1, 40, seed=4)
    want = jax.jit(JE.encode, static_argnums=2)(jparams, jnp.asarray(frames),
                                                jcfg.replace(attn_impl=jimpl))
    got = E.encode(model, torch.from_numpy(frames), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
def test_prefill_logits_and_every_cache_leaf_match(jimpl):
    jcfg, tcfg, jparams, model = _models()
    b, s, s_enc, max_len = 2, 13, 21, 20
    toks, frames = _inputs(tcfg, b, s, s_enc, seed=1)
    want, jcache = j_prefill(jparams, jnp.asarray(frames), jnp.asarray(toks),
                             jcfg.replace(attn_impl=jimpl),
                             JE.init_cache(jcfg, b, max_len, s_enc))
    got, cache = E.prefill(model, torch.from_numpy(frames), torch.from_numpy(toks), tcfg,
                           E.init_cache(tcfg, b, max_len, s_enc, device="cpu"))
    assert got.shape == want.shape == (b, 1, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _assert_cache_equal(cache, jcache)


def test_prefill_refuses_a_cross_cache_of_another_length():
    _, tcfg, _, model = _models()
    toks, frames = _inputs(tcfg, 1, 4, 9)
    with pytest.raises(ValueError, match="cross cache"):
        E.prefill(model, torch.from_numpy(frames), torch.from_numpy(toks), tcfg,
                  E.init_cache(tcfg, 1, 8, 10, device="cpu"))


def test_decode_steps_match():
    jcfg, tcfg, jparams, model = _models()
    b, s, s_enc, steps = 2, 9, 15, 4
    max_len = s + steps + 1
    toks, frames = _inputs(tcfg, b, s + steps, s_enc, seed=2)
    jbatch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks[:, :s])}
    want, jcache = jmake_prefill_step(jcfg)(jparams, jbatch,
                                            JE.init_cache(jcfg, b, max_len, s_enc))
    batch = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks[:, :s])}
    got, cache = make_prefill_step(tcfg)(model, batch,
                                         make_cache(tcfg, b, max_len, enc_len=s_enc,
                                                    device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg="prefill")
    decode = make_decode_step(tcfg)
    for i in range(s, s + steps):
        want, jcache = j_decode(jparams, jnp.asarray(toks[:, i:i + 1]), jcfg, jcache,
                                jnp.asarray(i, jnp.int32))
        got, cache = decode(model, torch.from_numpy(toks[:, i:i + 1]), cache, i)
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=f"step {i}")
    _assert_cache_equal(cache, jcache)


def test_generate_greedy_tokens_match():
    jcfg, tcfg, jparams, model = _models()
    toks, frames = _inputs(tcfg, 2, 7, 12, seed=6)
    want = jgenerate(jparams, jcfg, jnp.asarray(toks), max_new=6, frames=jnp.asarray(frames))
    got = generate(model, tcfg, toks, max_new=6, frames=frames, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_needs_frames():
    _, tcfg, _, model = _models()
    with pytest.raises(ValueError, match="encoder frames"):
        generate(model, tcfg, np.zeros((1, 3), np.int32), max_new=1, device="cpu")


def _attention_case(branch: str):
    """(jax out, port out) of one non-causal self-attention call."""
    jcfg, tcfg, jparams, model = _models()
    rng = np.random.default_rng(7)
    lp, jlp = model["enc_layers"][0]["attn"], jax.tree_util.tree_map(
        lambda a: a[0], jparams["enc_layers"])["attn"]
    b, t, hd, kv = 2, 12, tcfg.resolved_head_dim, tcfg.num_kv_heads
    s = 1 if branch == "decode" else 5
    start = 6 if branch != "no cache" else 0
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(start, start + s, dtype=np.int32)[None], (b, s)).copy()
    ck = rng.standard_normal((b, kv, t, hd)).astype(np.float32)
    cv = rng.standard_normal((b, kv, t, hd)).astype(np.float32)
    jkw, tkw = {}, {}
    if branch != "no cache":
        jkw = dict(kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
                   cache_pos=jnp.asarray(start, jnp.int32))
        tkw = dict(kv_cache=(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())),
                   cache_pos=start)
    want, jnew = JL.attention_forward(jlp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                      causal=False, **jkw)
    got, new = L.attention_forward(lp, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
                                   causal=False, **tkw)
    return (want, jnew), (got, new)


@pytest.mark.parametrize("branch", ["prefill", "decode", "no cache"])
def test_attention_forward_not_causal_matches(branch):
    """The prefill branch attends over the new K/V through ``ops.attention``
    with ``causal=False``; the decode branch over the cache up to and
    including the new position (``kpos < q_offset + s``), on
    ``_masked_attention``."""
    (want, jnew), (got, new) = _attention_case(branch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if branch == "no cache":
        assert new is None and jnew is None
        return
    for g, w in zip(new, jnew):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_non_causal_decode_sees_the_keys_the_causal_one_sees():
    """A decode query at position p attends to keys 0..p, as the causal one
    does: ``kpos < q_offset + 1`` is ``kpos <= q_offset``."""
    (_, _), (got, _) = _attention_case("decode")
    _, tcfg, _, model = _models()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    b, t, hd, kv = 2, 12, tcfg.resolved_head_dim, tcfg.num_kv_heads
    ck = torch.from_numpy(rng.standard_normal((b, kv, t, hd)).astype(np.float32))
    cv = torch.from_numpy(rng.standard_normal((b, kv, t, hd)).astype(np.float32))
    pos = torch.full((2, 1), 6, dtype=torch.int32)
    lp = model["enc_layers"][0]["attn"]
    causal, _ = L.attention_forward(lp, torch.from_numpy(x), tcfg, pos,
                                    kv_cache=(ck, cv), cache_pos=6)
    np.testing.assert_allclose(got.numpy(), causal.numpy(), rtol=1e-6, atol=1e-6)


def _spec_shapes(tree, prefix=()):
    if hasattr(tree, "shape") and not isinstance(tree, dict):
        return {prefix: tuple(tree.shape)}
    out = {}
    for k, v in tree.items():
        out.update(_spec_shapes(v, prefix + (k,)))
    return out


def test_full_size_parameter_count_and_shapes_match_the_reference():
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    assert registry.count_params(tcfg) == jregistry.count_params(jcfg) == SEAMLESS_PARAMS
    assert tcfg.params_count() == SEAMLESS_PARAMS
    assert _spec_shapes(registry.abstract_params(tcfg)) == _spec_shapes(
        jregistry.abstract_params(jcfg))
    model = build(tcfg, device="meta")
    assert isinstance(model, EncDec) and all(p.is_meta for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == SEAMLESS_PARAMS
    stacked = {tuple(k.split("/")): (len(v), *v[0].shape) if isinstance(v, list)
               else tuple(v.shape) for k, v in convert.reference_leaves(model).items()}
    assert stacked == _spec_shapes(jregistry.abstract_params(jcfg))


def test_launch_serve_smoke_on_the_cpu(capsys):
    out = serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                      "--batch", "2", "--prompt-len", "6", "--max-new", "3"])
    assert [o.shape for o in out["outputs"]] == [(2, 9), (1, 9)]
    assert all(o.min() >= 0 and o.max() < 512 for o in out["outputs"])
    assert "family=encdec" in capsys.readouterr().out


def test_launch_serve_matches_the_reference_launch_serve():
    """The port's launch.serve draws prompts and frames as the reference's does,
    and with the reference's weights gives its greedy tokens."""
    from repro.launch.serve import main as jserve_main

    argv = ["--arch", ARCH, "--smoke", "--requests", "2", "--batch", "2",
            "--prompt-len", "5", "--max-new", "3"]
    want = jserve_main(argv)["outputs"]
    jcfg = jget_config(ARCH).scaled_down(vocab=512)
    tcfg = get_config(ARCH).scaled_down(vocab=512)
    jparams = jspec.materialize(jax.random.key(0), jregistry.abstract_params(jcfg))
    model = convert.lm_params_from_reference(jax.tree_util.tree_map(np.asarray, jparams),
                                             tcfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, tcfg.vocab, (2, 5)).astype(np.int32)
    frames = rng.standard_normal((2, 64, tcfg.d_model)).astype(np.float32) * 0.1
    got = generate(model, tcfg, prompts, max_new=3, frames=frames, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want[0])
