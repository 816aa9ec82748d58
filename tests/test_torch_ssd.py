"""The port's chunked SSD decomposition on the CPU.

``ref.ssd_scan_chunked`` is the plain mirror of ``csrc/ssd_scan.cu``'s three
phases (chunk state, state passing, chunk scan). The kernels run only on the
card, so the decomposition itself is checked here: against the JAX package's
chunked reference and its Pallas kernel in interpret mode, and against the
port's sequential recurrence ``ref.ssd_scan_ref`` at ragged lengths, phase by
phase, under strong decay, and with the tensor-core instance's bf16 rounding.
Inputs are made from a seed with numpy. float32 is held at 3e-4, as
tests/test_kernels.py holds the SSD; bf16 outputs at 3e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd_mod

TOL = 3e-4
BF16_TOL = 3e-2


def _inputs(b, t, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, t, h, p), dtype=np.float32),
        rng.random((b, t, h), dtype=np.float32) * 0.1,
        -np.exp(rng.standard_normal(h)).astype(np.float32),
        rng.standard_normal((b, t, g, n), dtype=np.float32),
        rng.standard_normal((b, t, g, n), dtype=np.float32),
        rng.standard_normal(h).astype(np.float32),
    )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_matches_jax_chunked_reference_and_pallas(chunk, g):
    args = _inputs(2, 128, 4, 16, g, 8, seed=chunk + g)
    y, hf = ref.ssd_scan_chunked(*map(_t, args), chunk=chunk)
    jargs = [jnp.asarray(a) for a in args]
    yr, hr = jref.ssd_scan_chunked_ref(*jargs, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), yr, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hf.numpy(), hr, rtol=TOL, atol=TOL)
    yp, hp = ssd_scan_pallas(*jargs, chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), yp, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hf.numpy(), hp, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t,chunk", [(40, 16), (10, 16), (1, 16), (1, 128)])
def test_chunked_ragged_and_short_lengths_match_sequential(t, chunk):
    """A short last chunk (40 = 2*16 + 8), T below the chunk, and T = 1."""
    args = tuple(map(_t, _inputs(2, t, 4, 16, 2, 8, seed=t)))
    y, hf = ref.ssd_scan_chunked(*args, chunk=chunk)
    yr, hr = ref.ssd_scan_ref(*args)
    assert tuple(y.shape) == (2, t, 4, 16) and tuple(hf.shape) == (2, 4, 8, 16)
    torch.testing.assert_close(y, yr, rtol=TOL, atol=TOL)
    torch.testing.assert_close(hf, hr, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", [64, 70])
def test_phases_match_the_sequential_states(t):
    """The state entering chunk c is the recurrence's state after step
    c*L - 1, and the last one passed on is the final state."""
    chunk = 16
    x, dt, a, bm, cm, d = map(_t, _inputs(1, t, 4, 8, 2, 8, seed=3 + t))
    cum, dth, states = ref.ssd_chunk_state_ref(x, dt, a, bm, chunk)
    nc = -(-t // chunk)
    assert tuple(cum.shape) == tuple(dth.shape) == (1, 4, nc, chunk)
    assert tuple(states.shape) == (1, 4, nc, 8, 8)
    entering, hf = ref.ssd_state_passing_ref(states, cum)
    assert float(entering[:, :, 0].abs().max()) == 0.0
    for c in range(1, nc):
        _, h_prefix = ref.ssd_scan_ref(x[:, :c * chunk], dt[:, :c * chunk], a,
                                       bm[:, :c * chunk], cm[:, :c * chunk])
        torch.testing.assert_close(entering[:, :, c], h_prefix, rtol=TOL, atol=TOL)
    _, h_seq = ref.ssd_scan_ref(x, dt, a, bm, cm)
    torch.testing.assert_close(hf, h_seq, rtol=TOL, atol=TOL)
    y = ref.ssd_chunk_scan_ref(x, bm, cm, cum, dth, entering, d, chunk)
    torch.testing.assert_close(y, ref.ssd_scan_ref(x, dt, a, bm, cm, d)[0], rtol=TOL, atol=TOL)


def test_chunked_strong_decay_stays_finite():
    """dt = 2, a = -20: cum falls to -5120 within a chunk of 128, so the
    upper triangle's exp(cum_i - cum_j) would overflow if it were taken."""
    x, _, _, bm, cm, _ = _inputs(1, 256, 2, 16, 1, 8, seed=11)
    dt = np.full((1, 256, 2), 2.0, np.float32)
    a = np.full((2,), -20.0, np.float32)
    args = tuple(map(_t, (x, dt, a, bm, cm)))
    y, hf = ref.ssd_scan_chunked(*args, chunk=128)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(hf).all())
    yr, hr = ref.ssd_scan_ref(*args)
    torch.testing.assert_close(y, yr, rtol=TOL, atol=TOL)
    torch.testing.assert_close(hf, hr, rtol=TOL, atol=TOL)


def test_bf16_rounding_budget_at_hymbas_head_shape():
    """P = 64, N = 16, chunk 128, bf16 inputs, the scaled C B^T, w_j B_j and
    the state entering a chunk each split into two bf16 parts before their
    products, as the tensor-core instance splits them: y within bf16's 3e-2
    of the float32 recurrence, the state within 3e-4."""
    x, dt, a, bm, cm, d = _inputs(1, 256, 4, 64, 1, 16, seed=64)
    xb, bb, cb = (_t(v).to(torch.bfloat16) for v in (x, bm, cm))
    y, hf = ref.ssd_scan_chunked(xb, _t(dt), _t(a), bb, cb, _t(d), chunk=128,
                                 split_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    yr, hr = ref.ssd_scan_ref(xb.float(), _t(dt), _t(a), bb.float(), cb.float(), _t(d))
    y_err = float((y.float() - yr).abs().max())
    h_err = float((hf - hr).abs().max())
    assert torch.allclose(y.float(), yr, rtol=BF16_TOL, atol=BF16_TOL), f"y max |err| {y_err}"
    assert torch.allclose(hf, hr, rtol=TOL, atol=TOL), f"state max |err| {h_err}"
    # the rounding is there (the split's, and y's own in bf16): without it
    # the chunked y is closer still
    y32, _ = ref.ssd_scan_chunked(xb.float(), _t(dt), _t(a), bb.float(), cb.float(), _t(d),
                                  chunk=128)
    assert float((y32 - yr).abs().max()) < y_err, f"y max |err| {y_err} with bf16 rounding"


@pytest.mark.parametrize(
    "dtype,n,p,want",
    [(torch.bfloat16, 16, 64, "tensor_core"),  # Hymba
     (torch.bfloat16, 16, 32, "tensor_core"), (torch.bfloat16, 32, 16, "tensor_core"),
     (torch.bfloat16, 16, 128, "tensor_core"),
     (torch.bfloat16, 8, 16, "cuda_core"), (torch.bfloat16, 4, 8, "cuda_core"),
     (torch.bfloat16, 16, 48, "cuda_core"), (torch.bfloat16, 16, 256, "cuda_core"),
     (torch.float32, 16, 64, "cuda_core"), (torch.float32, 8, 16, "cuda_core"),
     (torch.bfloat16, 128, 64, "tensor_core"),  # mamba2-2.7b
     (torch.bfloat16, 64, 32, "tensor_core"),
     (torch.bfloat16, 48, 64, "cuda_core"), (torch.bfloat16, 256, 64, "cuda_core"),
     (torch.float32, 128, 64, "cuda_core")],
)
def test_ssd_instance_routing(dtype, n, p, want):
    """bf16 with N and P template instances takes the tensor cores; float32
    (held at 3e-4, which TF32 would not hold) and the small card-test shapes
    keep the CUDA cores."""
    assert ssd_mod.instance(dtype, n, p) == want


def _blocks_per_sm(nbytes: int) -> int:
    """Blocks of ``nbytes`` dynamic shared memory that one H100 SM holds at
    once: 233,472 bytes (228 KB), of which each block reserves 1 KB."""
    return 233_472 // (nbytes + 1024)


def test_ssd_phase_shared_memory_at_the_path_shape():
    """chunk 128, P 64, N 16: every phase fits a block in both dtypes, the
    bf16 tensor-core phases in 25,728 and 30,208 bytes (several blocks an
    SM); the float32 CUDA-core scan keeps the state in B^T's room once G is
    made; at chunk 256 its (Lp, Lp) tile does not fit."""
    bf16 = ssd_mod.smem_bytes(128, 64, 16, torch.bfloat16)
    f32 = ssd_mod.smem_bytes(128, 64, 16, torch.float32)
    assert bf16 == {"chunk_state": 25_728, "chunk_scan": 30_208}
    assert min(map(_blocks_per_sm, bf16.values())) >= 5
    assert f32 == {"chunk_state": 50_304, "chunk_scan": 115_712}
    assert max(f32.values()) <= ssd_mod.MAX_SHARED_BYTES
    assert ssd_mod.smem_bytes(256, 64, 16)["chunk_scan"] > ssd_mod.MAX_SHARED_BYTES
    # a ragged chunk is padded to 16 rows
    assert ssd_mod.smem_bytes(40, 64, 16) == ssd_mod.smem_bytes(48, 64, 16)


def test_ssd_phase_shared_memory_at_mamba2s_state_size():
    """mamba2-2.7b: chunk 128, P 64, N 128. The bf16 tensor-core chunk state
    (x, B, dt and cum) fits four blocks an SM and the chunk scan (H's two
    bf16 parts, x, B, cum and dt; C is read into registers) two; the float32
    CUDA-core scan fits only because the state shares B^T's room (263,168
    bytes in separate rooms)."""
    bf16 = ssd_mod.smem_bytes(128, 64, 128, torch.bfloat16)
    f32 = ssd_mod.smem_bytes(128, 64, 128, torch.float32)
    assert bf16 == {"chunk_state": 54_400, "chunk_scan": 91_136}
    assert _blocks_per_sm(bf16["chunk_state"]) == 4
    assert _blocks_per_sm(bf16["chunk_scan"]) == 2
    assert f32 == {"chunk_state": 164_992, "chunk_scan": 230_400}
    assert max(f32.values()) <= ssd_mod.MAX_SHARED_BYTES < 263_168


@pytest.mark.parametrize("t", [256, 200])
def test_chunked_at_mamba2s_state_size_matches_jax(t):
    """N = 128, P = 64, chunk 128 (mamba2-2.7b's head), a whole and a ragged
    last chunk: against the sequential recurrence and, where T is whole
    chunks (as the JAX package's take), the JAX package's chunked reference
    and its Pallas kernel in interpret mode."""
    args = _inputs(1, t, 2, 64, 1, 128, seed=t)
    y, hf = ref.ssd_scan_chunked(*map(_t, args), chunk=128)
    yr, hr = ref.ssd_scan_ref(*map(_t, args))
    torch.testing.assert_close(y, yr, rtol=TOL, atol=TOL)
    torch.testing.assert_close(hf, hr, rtol=TOL, atol=TOL)
    if t % 128 == 0:
        jargs = [jnp.asarray(a) for a in args]
        yj, hj = jref.ssd_scan_chunked_ref(*jargs, chunk=128)
        np.testing.assert_allclose(y.numpy(), yj, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(hf.numpy(), hj, rtol=TOL, atol=TOL)
        yp, hp = ssd_scan_pallas(*jargs, chunk=128, interpret=True)
        np.testing.assert_allclose(y.numpy(), yp, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(hf.numpy(), hp, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", [256, 200])
def test_bf16_split_route_at_mamba2s_state_size(t):
    """N = 128, P = 64, chunk 128, bf16 inputs, a whole and a ragged last
    chunk, with the tensor-core instance's three splits (w_j B_j, the state
    entering a chunk, the scaled C B^T): the final state within 3e-4 and y
    within bf16's 3e-2 of the sequential recurrence and, at whole chunks, of
    the JAX package's chunked reference; each split moves the state by no
    more than what the rounding leaves (about 2^-16 relative)."""
    x, dt, a, bm, cm, d = _inputs(1, t, 2, 64, 1, 128, seed=t + 1)
    xb, bb, cb = (_t(v).to(torch.bfloat16) for v in (x, bm, cm))
    y, hf = ref.ssd_scan_chunked(xb, _t(dt), _t(a), bb, cb, _t(d), chunk=128,
                                 split_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    exact = [v.float() for v in (xb, bb, cb)]  # the bf16 inputs, widened
    yr, hr = ref.ssd_scan_ref(exact[0], _t(dt), _t(a), exact[1], exact[2], _t(d))
    torch.testing.assert_close(hf, hr, rtol=TOL, atol=TOL)
    torch.testing.assert_close(y.float(), yr, rtol=BF16_TOL, atol=BF16_TOL)
    if t % 128 == 0:
        jargs = [jnp.asarray(v.numpy()) for v in (exact[0], _t(dt), _t(a), exact[1], exact[2],
                                                  _t(d))]
        yj, hj = jref.ssd_scan_chunked_ref(*jargs, chunk=128)
        np.testing.assert_allclose(hf.numpy(), hj, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(y.float().numpy(), yj, rtol=BF16_TOL, atol=BF16_TOL)
    # phase by phase: the split state against the unsplit one
    cum, dth, s_split = ref.ssd_chunk_state_ref(xb, _t(dt), _t(a), bb, 128,
                                                split_dtype=torch.bfloat16)
    _, _, s_exact = ref.ssd_chunk_state_ref(xb, _t(dt), _t(a), bb, 128)
    gap = float((s_split - s_exact).abs().max())
    assert 0.0 < gap <= 2.0**-14 * float(s_exact.abs().max())
