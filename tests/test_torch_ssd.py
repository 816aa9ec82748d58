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
    """P = 64, N = 16, chunk 128, bf16 inputs, the scaled C B^T rounded to
    bf16 before the product with x, as the tensor-core instance rounds it:
    y within bf16's 3e-2 of the float32 recurrence, the state within 3e-4
    (phase 1 keeps it in float32)."""
    x, dt, a, bm, cm, d = _inputs(1, 256, 4, 64, 1, 16, seed=64)
    xb, bb, cb = (_t(v).to(torch.bfloat16) for v in (x, bm, cm))
    y, hf = ref.ssd_scan_chunked(xb, _t(dt), _t(a), bb, cb, _t(d), chunk=128,
                                 intra_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    yr, hr = ref.ssd_scan_ref(xb.float(), _t(dt), _t(a), bb.float(), cb.float(), _t(d))
    y_err = float((y.float() - yr).abs().max())
    h_err = float((hf - hr).abs().max())
    assert torch.allclose(y.float(), yr, rtol=BF16_TOL, atol=BF16_TOL), f"y max |err| {y_err}"
    assert torch.allclose(hf, hr, rtol=TOL, atol=TOL), f"state max |err| {h_err}"
    # the rounding is there: without it the chunked y is closer still
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
     (torch.float32, 16, 64, "cuda_core"), (torch.float32, 8, 16, "cuda_core")],
)
def test_ssd_instance_routing(dtype, n, p, want):
    """bf16 with N a multiple of 16 and P a template instance takes the
    tensor cores; float32 (held at 3e-4, which TF32 would not hold) and the
    small card-test shapes keep the CUDA cores."""
    assert ssd_mod.instance(dtype, n, p) == want


def test_ssd_phase_shared_memory_at_the_path_shape():
    """chunk 128, P 64, N 16: every phase fits a block in both dtypes, the
    bf16 tensor-core scan in 35,840 bytes (several blocks an SM); at chunk
    256 the float32 CUDA-core scan's (Lp, Lp) tile does not fit."""
    bf16 = ssd_mod.smem_bytes(128, 64, 16, torch.bfloat16)
    f32 = ssd_mod.smem_bytes(128, 64, 16, torch.float32)
    assert bf16 == {"chunk_state": 29_824, "chunk_scan": 35_840}
    assert f32 == {"chunk_state": 50_304, "chunk_scan": 119_808}
    assert max(f32.values()) <= ssd_mod.MAX_SHARED_BYTES
    assert ssd_mod.smem_bytes(256, 64, 16)["chunk_scan"] > ssd_mod.MAX_SHARED_BYTES
    # a ragged chunk is padded to 16 rows
    assert ssd_mod.smem_bytes(40, 64, 16) == ssd_mod.smem_bytes(48, 64, 16)
