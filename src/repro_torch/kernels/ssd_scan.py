"""Mamba2 SSD chunked scan on the card: wrapper of ``csrc/ssd_scan.cu``.

Replaces ``repro.kernels.ssd_scan.ssd_scan_pallas``. The plain version is
the sequential ``ref.ssd_scan_ref``; ``ops.ssd_scan`` picks between them.
Unlike the Pallas form, the kernel takes any T: the last chunk may be short.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last reset

DTYPES = (torch.float32, torch.bfloat16)  # of x, B, C and y
MAX_SHARED_BYTES = 232_448  # one H100 block's shared memory (227 KB)


def smem_bytes(chunk: int, p: int, n: int) -> int:
    """Dynamic shared memory of one block: x (L, P), B and C (L, N+1), the
    (L, L) decay-weighted C B^T, the (N, P) state and four (L,) vectors."""
    return 4 * (chunk * p + 2 * chunk * (n + 1) + chunk * chunk + n * p + 4 * chunk)


def ssd_scan_cuda(
    x: torch.Tensor,  # (B, T, H, P)
    dt: torch.Tensor,  # (B, T, H) float32
    a: torch.Tensor,  # (H,) float32
    b_: torch.Tensor,  # (B, T, G, N)
    c_: torch.Tensor,  # (B, T, G, N)
    d_: torch.Tensor | None = None,  # (H,) float32
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, T, H, P) in x's dtype, final state (B, H, N, P) float32)."""
    global launches
    _build.require(x, "ssd_scan x", DTYPES, 4)
    _build.require(dt, "ssd_scan dt", torch.float32, 3)
    _build.require(a, "ssd_scan a", torch.float32, 1)
    _build.require(b_, "ssd_scan B", x.dtype, 4)
    _build.require(c_, "ssd_scan C", x.dtype, 4)
    bsz, t, h, p = x.shape
    g, n = b_.shape[2], b_.shape[3]
    if d_ is None:
        d_ = torch.zeros((h,), dtype=torch.float32, device=x.device)
    _build.require(d_, "ssd_scan D", torch.float32, 1)
    if (tuple(dt.shape) != (bsz, t, h) or tuple(a.shape) != (h,) or tuple(d_.shape) != (h,)
            or b_.shape != c_.shape or tuple(b_.shape[:2]) != (bsz, t)):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, B {tuple(b_.shape)}, C {tuple(c_.shape)}, "
                         f"D {tuple(d_.shape)} do not agree")
    if any(u.device != x.device for u in (dt, a, b_, c_, d_)):
        raise ValueError("ssd_scan: every input must be on x's device")
    if g < 1 or h % g:
        raise ValueError(f"ssd_scan: {h} heads do not group over {g} B/C groups")
    chunk = max(1, min(chunk, t))
    smem = smem_bytes(chunk, p, n)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"ssd_scan: chunk {chunk} with P={p}, N={n} needs {smem} bytes of "
                         f"shared memory; a block has {MAX_SHARED_BYTES}")
    if x.numel() >= 2**62 or bsz * h >= 2**31:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} is too large")
    y = torch.empty_like(x)
    hf = torch.empty((bsz, h, n, p), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _build.lib().rt_ssd_scan(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_.data_ptr(), c_.data_ptr(),
            d_.data_ptr(), y.data_ptr(), hf.data_ptr(), bsz, t, h, p, g, n, chunk,
            int(x.dtype == torch.bfloat16), smem, _build.stream(x),
        )
        launches += 1
    _build.check(code, "ssd_scan")
    return y, hf
