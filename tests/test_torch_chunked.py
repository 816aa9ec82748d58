"""The port's chunked route (``impl="chunked"``: online-softmax attention over
key chunks and the chunked SSD scan) against the JAX package's
``attention_chunked_ref`` and ``ssd_scan_chunked_ref``, on the CPU.

The same numpy inputs go through both packages, at the tolerances of
tests/test_kernels.py (2e-4 for attention, 3e-4 for the SSD scan; bf16 at
3e-2, as tests/test_torch_lm_kernels.py). Also: MLA's narrower v, which
the reference's chunked attention refuses and the port's runs; the
streaming prefill under ``"chunked"`` against ``forward``; the impls each
op refuses.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ModelConfig, registry
from repro_torch.models import transformer as T


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# the cases of tests/test_kernels.py's chunked attention; ops.attention scans
# chunks of 4 * block_k, so each case's chunk there is 4 * bk (20 in place of
# 13 for the last: 48 keys still end in a short chunk)
ATTN_CASES = [
    (2, 4, 2, 64, 64, True, None, 0, 16, 4),
    (1, 8, 1, 40, 40, True, 8, 0, 16, 4),
    (2, 4, 4, 1, 96, True, None, 95, 32, 8),
    (1, 2, 2, 48, 48, False, None, 0, 13, 5),
]


def _qkv(rng, b, hq, hkv, tq, tk, d, dv=None):
    return (rng.standard_normal((b, hq, tq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, tk, d), dtype=np.float32),
            rng.standard_normal((b, hkv, tk, dv or d), dtype=np.float32))


@pytest.mark.parametrize("b,hq,hkv,tq,tk,causal,window,qoff,chunk,bk", ATTN_CASES)
def test_chunked_attention_matches_the_reference(b, hq, hkv, tq, tk, causal, window, qoff,
                                                 chunk, bk):
    q, k, v = _qkv(np.random.default_rng(b * hq * tq + tk), b, hq, hkv, tq, tk, 32)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = ops.attention(_t(q), _t(k), _t(v), impl="chunked", block_k=bk, **kw)
    want = jref.attention_chunked_ref(jq, jk, jv, chunk=4 * bk, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), ref.attention_ref(_t(q), _t(k), _t(v), **kw).numpy(),
                               rtol=2e-4, atol=2e-4)
    # the case's own chunk, through the plain function
    got = ref.attention_chunked(_t(q), _t(k), _t(v), chunk=chunk, **kw)
    want = jref.attention_chunked_ref(jq, jk, jv, chunk=chunk, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_chunked_attention_bf16_matches_the_reference():
    rng = np.random.default_rng(11)
    q, k, v = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
               for a in _qkv(rng, 1, 4, 2, 48, 48, 32))
    got = ops.attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)), impl="chunked",
                        block_k=4)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jref.attention_chunked_ref(jq, jk, jv, chunk=16), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2, atol=3e-2)


def test_chunked_attention_gradients_match_the_plain_route():
    """Training takes the chunked route through autograd: its gradients are
    those of the materialised softmax."""
    q, k, v = (_t(a).requires_grad_() for a in
               _qkv(np.random.default_rng(4), 1, 4, 2, 24, 24, 16))
    gout = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 4, 24, 16),
                                                                     dtype=np.float32))
    grads = []
    for fn in (lambda: ref.attention_chunked(q, k, v, window=10, chunk=8),
               lambda: ref.attention_ref(q, k, v, window=10)):
        grads.append(torch.autograd.grad(fn(), (q, k, v), gout))
    for g, w in zip(*grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_ssd_scan_matches_the_reference(chunk):
    rng = np.random.default_rng(chunk)
    B, T_, H, P, G, N = 2, 64, 4, 16, 2, 8
    args = (rng.standard_normal((B, T_, H, P), dtype=np.float32),
            rng.random((B, T_, H), dtype=np.float32) * 0.1,
            -np.exp(rng.standard_normal(H)).astype(np.float32),
            rng.standard_normal((B, T_, G, N), dtype=np.float32),
            rng.standard_normal((B, T_, G, N), dtype=np.float32),
            rng.standard_normal(H).astype(np.float32))
    y, hf = ops.ssd_scan(*map(_t, args), impl="chunked", chunk=chunk)
    yr, hr = jref.ssd_scan_chunked_ref(*map(jnp.asarray, args), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), yr, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(hf.numpy(), hr, rtol=3e-4, atol=3e-4)
    assert hf.dtype == torch.float32


def test_chunked_ssd_scan_takes_a_length_no_multiple_of_its_chunk():
    """A 20-step sequence in chunks of 8: the port pads to whole chunks and
    agrees with the sequential scan; the reference asserts ``t % chunk == 0``
    (reached from ``repro/models/layers.py:546`` by any prefill longer than
    ``ssm_chunk`` and no multiple of it)."""
    rng = np.random.default_rng(20)
    B, T_, H, P, G, N = 1, 20, 2, 8, 1, 4
    args = (rng.standard_normal((B, T_, H, P), dtype=np.float32),
            rng.random((B, T_, H), dtype=np.float32) * 0.1,
            -np.ones(H, np.float32),
            rng.standard_normal((B, T_, G, N), dtype=np.float32),
            rng.standard_normal((B, T_, G, N), dtype=np.float32))
    y, hf = ops.ssd_scan(*map(_t, args), impl="chunked", chunk=8)
    yr, hr = ops.ssd_scan(*map(_t, args), impl="torch")
    np.testing.assert_allclose(y.numpy(), yr.numpy(), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(hf.numpy(), hr.numpy(), rtol=3e-4, atol=3e-4)
    with pytest.raises(AssertionError):
        jref.ssd_scan_chunked_ref(*map(jnp.asarray, args), chunk=8)


def test_chunked_attention_takes_mlas_narrower_v():
    """v's head dim (8) below q's and k's (12), as MLA's scoring path has
    (128 under 192): the accumulator takes v's width."""
    q, k, v = _qkv(np.random.default_rng(12), 1, 2, 2, 8, 8, 12, dv=8)
    got = ops.attention(_t(q), _t(k), _t(v), impl="chunked", block_k=1)
    assert got.shape == (1, 2, 8, 8)
    want = ref.attention_ref(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_reference_chunked_attention_refuses_a_narrower_v():
    """The reference's fault at the same shape: it reshapes v with q's head
    dim."""
    q, k, v = _qkv(np.random.default_rng(12), 1, 2, 2, 8, 8, 12, dv=8)
    with pytest.raises(TypeError, match="cannot reshape"):
        jref.attention_chunked_ref(*map(jnp.asarray, (q, k, v)), chunk=4)


BASE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab=128, param_dtype=torch.float32, compute_dtype=torch.float32, remat="none")
FAMILIES = {  # tests/test_models.py's families
    "dense": ModelConfig(name="d", family="dense", qk_norm=True, **BASE),
    "ssm": ModelConfig(name="s", family="ssm", ssm_state=16, ssm_headdim=16, ssm_chunk=4,
                       **BASE),
    "mla": ModelConfig(name="mla", family="moe", attn_kind="mla", kv_lora_rank=32,
                       qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, num_experts=4,
                       experts_per_token=2, capacity_factor=4.0, **BASE),
}


def _count_chunked_calls(monkeypatch) -> list:
    """The names of the chunked functions called from now on, in order."""
    calls: list = []
    for name in ("attention_chunked", "ssd_scan_chunked"):
        fn = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _fn=fn, _n=name, **kw: (
            calls.append(_n), _fn(*a, **kw))[1])
    return calls


def _model_and_tokens(fam: str):
    cfg = FAMILIES[fam].replace(attn_impl="torch")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    return cfg, registry.build(cfg, device="cpu", seed=1), torch.from_numpy(toks)


@pytest.mark.parametrize("fam", ["dense", "ssm"])
def test_streaming_prefill_under_chunked_matches_forward(fam, monkeypatch):
    """The counterpart of tests/test_models.py's streaming-prefill test:
    prefill on the plain and the chunked route gives ``forward``'s last
    logits (the SSM family at a chunk of 4 over 10 tokens, a short last
    chunk), and the chunked prefill runs the chunked functions, once a
    layer."""
    calls = _count_chunked_calls(monkeypatch)
    cfg_t, model, toks = _model_and_tokens(fam)
    with torch.no_grad():
        full, _ = T.forward(model, toks, cfg_t)
        for cfg in (cfg_t, cfg_t.replace(attn_impl="chunked")):
            lp, _ = T.prefill(model, toks, cfg, T.init_cache(cfg, 2, 12, device="cpu"))
            np.testing.assert_allclose(lp[:, 0].numpy(), full[:, -1].numpy(), rtol=3e-4,
                                       atol=3e-4, err_msg=cfg.attn_impl)
            assert len(calls) == (0 if cfg.attn_impl == "torch" else cfg.num_layers), calls


def test_mla_scoring_under_chunked_matches_the_plain_route(monkeypatch):
    """MLA's scoring path (``forward``, q/k of 24 dims and v of 16) runs on
    the chunked route, where the reference's raises; its prefill takes the
    absorbed form over the compressed cache in both packages, no chunked
    call."""
    calls = _count_chunked_calls(monkeypatch)
    cfg_t, model, toks = _model_and_tokens("mla")
    cfg_c = cfg_t.replace(attn_impl="chunked")
    with torch.no_grad():
        want, _ = T.forward(model, toks, cfg_t)
        got, _ = T.forward(model, toks, cfg_c)
        assert calls == ["attention_chunked"] * cfg_c.num_layers
        lp, _ = T.prefill(model, toks, cfg_c, T.init_cache(cfg_c, 2, 12, device="cpu"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(lp[:, 0].numpy(), want[:, -1].numpy(), rtol=3e-4, atol=3e-4)
    assert len(calls) == cfg_c.num_layers


def test_wsi_ops_refuse_chunked():
    x = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="'torch'"):
        ops.morph_recon(x, x, impl="chunked")
    with pytest.raises(ValueError, match="unknown impl 'chunked'"):
        ops.color_deconv(torch.zeros((3, 8, 8)), torch.eye(3), impl="chunked")
    with pytest.raises(ValueError, match="unknown impl 'chunked'"):
        ops.connected_components(x.int(), impl="chunked")
    with pytest.raises(ValueError, match="unknown impl 'chunked'"):
        ops.glcm_histogram(torch.zeros((1, 8, 8), dtype=torch.int32), 8, impl="chunked")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.attention(torch.zeros((1, 1, 2, 4)), torch.zeros((1, 1, 2, 4)),
                      torch.zeros((1, 1, 2, 4)), impl="xla")


@pytest.mark.parametrize("impl", ["cuda", "auto"])
def test_build_cell_refuses_the_kernel_routes(impl):
    mesh = make_host_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="'torch' or 'chunked'"):
        build_cell("qwen3-0.6b", "train_4k", mesh, cfg_overrides={"attn_impl": impl})
    cell = build_cell("qwen3-0.6b", "train_4k", mesh, cfg_overrides={"attn_impl": "chunked"})
    assert cell.cfg.attn_impl == "chunked"
