"""Flash attention on the card: wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas``. The plain
version is ``ref.attention_ref``; ``ops.attention`` picks between them.

The source holds two instances of the kernel, and :func:`instance` picks one
by dtype and head_dim: bf16 at D = 64, 128, 192 (nemotron, MLA's scoring
path) or 256 runs on the tensor cores (``mma.sync`` in bf16, K and V staged
as bf16; at 192 and 256 Q is read from shared memory and a staged tile holds
32 keys, as registers bound those widths), float32 at every D and bf16 at
D <= 32 on the CUDA cores in float32 (which holds float32's 3e-4; TF32
would not): from D = 64 up as register-tiled products over 64-query by
64-key tiles, below it one thread a query. From D = 64 up both stage their
tiles with 16-byte copies, so q, k and v must be 16-byte aligned.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last reset
swa_launches = 0  # of those, launches with a sliding window
noncausal_launches = 0  # of those, launches without the causal mask (an encoder's)
INSTANCES = ("tensor_core", "cuda_core")
instance_launches = dict.fromkeys(INSTANCES, 0)  # of those, launches per instance

HEAD_DIMS = (16, 24, 32, 64, 128, 192, 256)  # the CUDA-core kernel's template instances
TC_HEAD_DIMS = (64, 128, 192, 256)  # the tensor-core kernel's (bf16 only)
DTYPES = (torch.float32, torch.bfloat16)
BLOCK_Q = 64  # queries per block in both instances
ALIGNED_HEAD_DIM = 64  # from this D up the kernels stage q, k, v with 16-byte copies
MAX_Q_BLOCKS = 65535  # the grid's y extent


def instance(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel instance that takes a call of this dtype and head_dim."""
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


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
    global launches, swa_launches, noncausal_launches
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
    if -(-tq // BLOCK_Q) > MAX_Q_BLOCKS:
        raise ValueError(f"attention: Tq {tq} needs more than {MAX_Q_BLOCKS} query blocks")
    which = instance(q.dtype, d)
    if d >= ALIGNED_HEAD_DIM and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"attention: the kernel at D = {d} needs 16-byte aligned q, k, v")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = torch.empty_like(q)
    common = (b, hq, hkv, tq, tk, d)
    masks = (int(causal), -1 if window is None else window, q_offset, _build.stream(q))
    with torch.cuda.device(q.device):
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if which == "tensor_core":
            code = _build.lib().rt_flash_attention_tc(*ptrs, *common, scale, *masks)
        else:
            code = _build.lib().rt_flash_attention(
                *ptrs, *common, int(q.dtype == torch.bfloat16), scale, *masks)
        with _build.counter_lock:
            launches += 1
            swa_launches += window is not None
            noncausal_launches += not causal
            instance_launches[which] += 1
    _build.check(code, f"flash_attention ({which})")
    return out
