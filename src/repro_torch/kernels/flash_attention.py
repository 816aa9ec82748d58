"""Flash attention on the card: wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas``. The plain
version is ``ref.attention_ref``; ``ops.attention`` picks between them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last reset
swa_launches = 0  # of those, launches with a sliding window

HEAD_DIMS = (16, 24, 32, 64, 128)  # the kernel's template instances
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_cuda(
    q: torch.Tensor,  # (B, Hq, Tq, D)
    k: torch.Tensor,  # (B, Hkv, Tk, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Softmax attention with GQA, causal mask, sliding window and query
    offset, on the card; returns (B, Hq, Tq, D) in q's dtype."""
    global launches, swa_launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, f"attention {name}", DTYPES, 4)
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention: q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype} differ")
    if k.device != q.device or v.device != q.device:
        raise ValueError("attention: q, k and v must be on one device")
    if d not in HEAD_DIMS:
        raise ValueError(f"attention: head_dim {d} not in {HEAD_DIMS}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"attention: {hq} query heads do not group over {hkv} KV heads")
    if window is not None and window < 0:
        raise ValueError(f"attention: window must be >= 0, got {window}")
    if max(b * hq, tq, tk, abs(q_offset) + tq + tk) >= 2**31 or q.numel() >= 2**62:
        raise ValueError(f"attention: shapes {tuple(q.shape)}, {tuple(k.shape)} are too large")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = _build.lib().rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, tq, tk, d, int(q.dtype == torch.bfloat16), scale, int(causal),
            -1 if window is None else window, q_offset, _build.stream(q),
        )
        launches += 1
        swa_launches += window is not None
    _build.check(code, "flash_attention")
    return out
