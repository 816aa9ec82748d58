"""The port's plain attention and SSD scan against the JAX package, on the CPU.

The same numpy inputs go through ``repro`` (the jnp references and the
Pallas kernels in interpret mode, as tests/test_kernels.py runs them) and
through ``repro_torch`` (``ops`` with CPU tensors, which takes the plain
versions), at the tolerances of tests/test_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda, instance
from repro_torch.kernels.ssd_scan import smem_bytes, ssd_scan_cuda


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a):
    """A float32 array rounded to bfloat16, for both packages alike."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "b,hq,hkv,tq,tk,d,causal,window,qoff,bq,bk",
    [
        (2, 4, 2, 64, 64, 32, True, None, 0, 16, 16),
        (1, 8, 1, 32, 32, 16, True, 8, 0, 8, 8),
        (2, 4, 4, 1, 96, 32, True, None, 95, 1, 32),
        (1, 2, 2, 48, 48, 64, False, None, 0, 16, 24),
        (1, 4, 2, 40, 40, 24, True, None, 0, 16, 16),  # ragged blocks
        (1, 4, 1, 48, 48, 256, True, None, 0, 16, 16),  # gemma-2b's head_dim, MQA
        (1, 2, 2, 40, 40, 192, True, None, 0, 16, 8),  # MLA's scoring head_dim, ragged
    ],
)
def test_attention_matches_reference_and_pallas(b, hq, hkv, tq, tk, d, causal, window, qoff,
                                                bq, bk):
    rng = np.random.default_rng(b * hq * tq + d)
    q = rng.standard_normal((b, hq, tq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, tk, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, tk, d), dtype=np.float32)
    got = ops.attention(_t(q), _t(k), _t(v), causal=causal, window=window, q_offset=qoff)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, hq, tq, d)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window, q_offset=qoff)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window, q_offset=qoff,
                                    block_q=bq, block_k=bk, interpret=True)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=3e-4, atol=3e-4)


def test_attention_bf16_matches_reference():
    rng = np.random.default_rng(7)
    q, k, v = (_bf16(rng.standard_normal((1, 2, 32, 32))) for _ in range(3))
    got = ops.attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jref.attention_ref(jq, jk, jv), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2, atol=3e-2)
    pallas = flash_attention_pallas(jq, jk, jv, block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(pallas, np.float32),
                               rtol=3e-2, atol=3e-2)


def test_attention_row_without_keys_is_zero():
    """Causal queries placed before every key see nothing: 0, not NaN."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 2, 4, 16), dtype=np.float32) for _ in range(3))
    got = ops.attention(_t(q), _t(k), _t(v), q_offset=-2).numpy()
    want = np.asarray(jref.attention_ref(*map(jnp.asarray, (q, k, v)), q_offset=-2))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    assert np.all(got[:, :, :2] == 0.0)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------
def _ssd_inputs(b, t, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, t, h, p), dtype=np.float32),
        rng.random((b, t, h), dtype=np.float32) * 0.1,
        -np.exp(rng.standard_normal(h)).astype(np.float32),
        rng.standard_normal((b, t, g, n), dtype=np.float32),
        rng.standard_normal((b, t, g, n), dtype=np.float32),
        rng.standard_normal(h).astype(np.float32),
    )


@pytest.mark.parametrize(
    "b,t,h,p,g,n,chunk",
    [(2, 64, 4, 16, 2, 8, 16), (1, 32, 2, 8, 1, 4, 8), (1, 128, 8, 32, 1, 16, 32)],
)
def test_ssd_scan_matches_reference_and_pallas(b, t, h, p, g, n, chunk):
    args = _ssd_inputs(b, t, h, p, g, n, seed=t + h)
    y, hf = ops.ssd_scan(*map(_t, args), chunk=chunk)
    assert y.dtype == torch.float32 and hf.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in args]
    yr, hr = jref.ssd_scan_ref(*jargs)
    np.testing.assert_allclose(y.numpy(), yr, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(hf.numpy(), hr, rtol=3e-4, atol=3e-4)
    yp, hp = ssd_scan_pallas(*jargs, chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), yp, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(hf.numpy(), hp, rtol=3e-4, atol=3e-4)


def test_ssd_scan_ragged_length_matches_sequential_reference():
    """T = 40 is no multiple of the chunk 16 (the Pallas form refuses it)."""
    args = _ssd_inputs(2, 40, 4, 16, 2, 8, seed=40)
    y, hf = ops.ssd_scan(*map(_t, args), chunk=16)
    yr, hr = jref.ssd_scan_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(y.numpy(), yr, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(hf.numpy(), hr, rtol=3e-4, atol=3e-4)


def test_ssd_scan_initial_state_and_no_skip():
    x, dt, a, bm, cm, _ = _ssd_inputs(1, 12, 2, 8, 1, 4, seed=12)
    h0 = np.random.default_rng(5).standard_normal((1, 2, 4, 8)).astype(np.float32)
    y, hf = ref.ssd_scan_ref(*map(_t, (x, dt, a, bm, cm)), None, _t(h0))
    yr, hr = jref.ssd_scan_ref(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)), None,
                               jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), yr, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(hf.numpy(), hr, rtol=3e-4, atol=3e-4)


def test_ssd_scan_bf16_keeps_dtypes():
    x, dt, a, bm, cm, d = _ssd_inputs(1, 16, 2, 8, 1, 4, seed=16)
    xb, bb, cb = (_t(_bf16(v)).to(torch.bfloat16) for v in (x, bm, cm))
    y, hf = ops.ssd_scan(xb, _t(dt), _t(a), bb, cb, _t(d))
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    yr, hr = jref.ssd_scan_ref(*(jnp.asarray(v, jnp.bfloat16) for v in (x,)), jnp.asarray(dt),
                               jnp.asarray(a), jnp.asarray(bm, jnp.bfloat16),
                               jnp.asarray(cm, jnp.bfloat16), jnp.asarray(d))
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yr, np.float32),
                               rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(hf.numpy(), hr, rtol=3e-4, atol=3e-4)


def test_ssd_shared_memory_at_the_path_shape():
    """The main path's chunk 128, P 64, N 16 fits one H100 block in every
    phase of both instances; chunk 256 does not fit the CUDA-core scan."""
    for dtype in (torch.bfloat16, torch.float32):
        assert max(smem_bytes(128, 64, 16, dtype).values()) <= 232_448
    assert smem_bytes(256, 64, 16)["chunk_scan"] > 232_448


@pytest.mark.parametrize(
    "dtype,d,want",
    [(torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
     (torch.bfloat16, 16, "cuda_core"), (torch.bfloat16, 24, "cuda_core"),
     (torch.bfloat16, 32, "cuda_core"), (torch.float32, 64, "cuda_core"),
     (torch.float32, 128, "cuda_core"), (torch.float32, 16, "cuda_core"),
     (torch.bfloat16, 192, "cuda_core"), (torch.bfloat16, 256, "cuda_core"),
     (torch.float32, 256, "cuda_core")],
)
def test_attention_instance_routing(dtype, d, want):
    """bf16 at D = 64 and 128 takes the tensor-core kernel; float32 (held at
    3e-4, which TF32 would not hold), the small head dims and D = 192, 256
    keep the CUDA cores."""
    assert instance(dtype, d) == want


# ---------------------------------------------------------------------------
# wrapper rules
# ---------------------------------------------------------------------------
def test_lm_ops_impl_cuda_on_a_cpu_tensor_raises():
    q = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, q, q, impl="cuda")
    x, dt = torch.zeros((1, 4, 2, 8)), torch.zeros((1, 4, 2))
    bc = torch.zeros((1, 4, 1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_scan(x, dt, torch.zeros(2), bc, bc, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.attention(q, q, q, impl="xla")


def test_lm_kernel_wrappers_refuse_cpu_tensors_before_building():
    q = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, q, q)
    bc = torch.zeros((1, 4, 1, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_scan_cuda(torch.zeros((1, 4, 2, 8)), torch.zeros((1, 4, 2)), torch.zeros(2), bc, bc)
    assert _build._lib is None  # nothing was compiled or loaded
