"""Neural building blocks of the hybrid (Hymba) family, in PyTorch
(``repro.models.layers``, the pieces that family uses).

Plain functions on tensors: ``p`` is a mapping from parameter name to
tensor (a ``transformer.ParamGroup``), laid out as the reference's spec
says. Attention and the SSD scan go through ``repro_torch.kernels.ops``,
which launches the hand-written kernels for CUDA tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import ParamSpec


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Computed in float32, then cast back to x's dtype."""
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * w.float()).to(dtype)


def norm_spec(cfg: ModelConfig) -> dict:
    return {"w": ParamSpec((cfg.d_model,), ("embed",), cfg.param_dtype, "ones")}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) absolute indices."""
    half = x.shape[-1] // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (with sliding window and KV cache)
# ---------------------------------------------------------------------------
def attention_spec(cfg: ModelConfig) -> dict:
    hd = cfg.resolved_head_dim
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", None), cfg.param_dtype),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", None), cfg.param_dtype),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", None), cfg.param_dtype),
        "wo": ParamSpec((h, hd, d), ("heads", None, "embed"), cfg.param_dtype),
    }


def qkv_project(p: Any, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(q (B,S,H,hd), k, v (B,S,kv,hd)), q and k rotated."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> contiguous (B, H, S, hd), the kernels' layout."""
    return t.transpose(1, 2).contiguous()


def attention_forward(
    p: Any,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    positions: torch.Tensor,  # (B, S)
    *,
    window: int | None = None,
    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,  # (B, kv, T, hd) x2
    cache_pos: int | None = None,  # #valid entries already cached
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """Returns (out (B,S,d), kv cache or None).

    Prefill: S > 1, the new K/V are written into the cache at ``cache_pos``
    (in place) and the queries attend over the new K/V through
    ``ops.attention`` (the flash kernel on the card). Decode: S == 1 against
    the whole cache with an explicit mask.
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = qkv_project(p, x, cfg, positions)
    qh, kh, vh = _heads_first(q), _heads_first(k), _heads_first(v)
    new_cache = None
    if kv_cache is not None:
        ck, cv = kv_cache
        start = 0 if cache_pos is None else int(cache_pos)
        at = max(0, min(start, ck.shape[2] - s))  # clamped, as dynamic_update_slice is
        ck[:, :, at:at + s] = kh.to(ck.dtype)
        cv[:, :, at:at + s] = vh.to(cv.dtype)
        new_cache = (ck, cv)
    if kv_cache is not None and s <= 1:
        t = ck.shape[2]
        kpos = torch.arange(t, device=x.device)[None, :]
        qpos = (start + torch.arange(s, device=x.device))[:, None]
        mask = kpos <= qpos
        if window is not None:
            mask = mask & (qpos - kpos < window)
        out = _masked_attention(qh, ck, cv, mask, cfg, hd)
    else:
        out = ops.attention(qh, kh, vh, causal=True, window=window, impl=cfg.attn_impl)
    out = out.transpose(1, 2)  # (B, S, H, hd)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return y, new_cache


def _masked_attention(qh, keys, vals, mask, cfg: ModelConfig, hd: int) -> torch.Tensor:
    """Explicit-mask attention on the cached paths.

    Single-token decode groups the query heads over their KV head (K/V are
    not repeated); several tokens use the flat-head layout.
    """
    b, h, s, _ = qh.shape
    kv = keys.shape[1]
    group = h // kv
    if s == 1:
        qg = qh.reshape(b, kv, group, s, hd).float()
        logits = torch.einsum("bkgqd,bktd->bkgqt", qg, keys.float()) / np.sqrt(hd)
        logits = torch.where(mask[None, None, None], logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgqt,bktd->bkgqd", probs, vals.float())
        return out.reshape(b, h, s, hd).to(qh.dtype)
    kr = torch.repeat_interleave(keys, group, dim=1)
    vr = torch.repeat_interleave(vals, group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kr.float()) / np.sqrt(hd)
    logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vr.float()).to(qh.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp_spec(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": ParamSpec((d, f), ("embed", "ffn"), cfg.param_dtype),
        "w2": ParamSpec((f, d), ("ffn", "embed"), cfg.param_dtype),
        "w3": ParamSpec((d, f), ("embed", "ffn"), cfg.param_dtype),
    }


def mlp_forward(p: Any, x: torch.Tensor) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, p["w1"].to(x.dtype))
    h = F.silu(h) * torch.einsum("bsd,df->bsf", x, p["w3"].to(x.dtype))
    return torch.einsum("bsf,fd->bsd", h, p["w2"].to(x.dtype))


# ---------------------------------------------------------------------------
# Mamba2 SSD block
# ---------------------------------------------------------------------------
def ssd_spec(cfg: ModelConfig) -> dict:
    """Mamba2 block params, with z, x, B, C and dt each its own projection
    and the depthwise conv split the same way (as the reference lays them)."""
    d = cfg.d_model
    di = cfg.ssm_d_inner
    h, g, n = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
    gn = g * n
    k = cfg.ssm_conv
    return {
        "z_proj": ParamSpec((d, di), ("embed", "ssm_inner"), cfg.param_dtype),
        "x_proj": ParamSpec((d, di), ("embed", "ssm_inner"), cfg.param_dtype),
        "b_proj": ParamSpec((d, gn), ("embed", None), cfg.param_dtype),
        "c_proj": ParamSpec((d, gn), ("embed", None), cfg.param_dtype),
        "dt_proj": ParamSpec((d, h), ("embed", "ssm_heads"), cfg.param_dtype),
        "conv_xw": ParamSpec((k, di), ("conv", "ssm_inner"), cfg.param_dtype),
        "conv_xb": ParamSpec((di,), ("ssm_inner",), cfg.param_dtype, "zeros"),
        "conv_bw": ParamSpec((k, gn), ("conv", None), cfg.param_dtype),
        "conv_bb": ParamSpec((gn,), (None,), cfg.param_dtype, "zeros"),
        "conv_cw": ParamSpec((k, gn), ("conv", None), cfg.param_dtype),
        "conv_cb": ParamSpec((gn,), (None,), cfg.param_dtype, "zeros"),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), cfg.param_dtype, "zeros"),
        "a_log": ParamSpec((h,), ("ssm_heads",), torch.float32, "zeros"),
        "d_skip": ParamSpec((h,), ("ssm_heads",), torch.float32, "ones"),
        "norm": ParamSpec((di,), ("ssm_inner",), cfg.param_dtype, "ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed"), cfg.param_dtype),
    }


@dataclasses.dataclass
class SSMState:
    conv: torch.Tensor  # (B, conv-1, conv_dim) rolling conv window
    ssm: torch.Tensor  # (B, H, N, P) recurrent state, float32


def _ssd_project(p: Any, x: torch.Tensor):
    dt_ = x.dtype
    return tuple(
        torch.einsum("bsd,de->bse", x, p[name].to(dt_))
        for name in ("z_proj", "x_proj", "b_proj", "c_proj", "dt_proj")
    )


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """Depthwise causal conv along time for one channel group; the bias is
    cast to the sequence's dtype before the SiLU, as the reference does."""
    s = seq.shape[1]
    padded = F.pad(seq, (0, 0, k - 1, 0))
    out = sum(padded[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return F.silu(out + b.to(seq.dtype))


def ssd_block_forward(
    p: Any,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    *,
    state: SSMState | None = None,
) -> tuple[torch.Tensor, SSMState | None]:
    """Full-sequence SSD block (prefill). If ``state`` is given, the result
    carries the end-of-sequence state instead (prefill -> decode handoff)."""
    b, s, _ = x.shape
    di, g, n, h, pdim = (cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads,
                         cfg.ssm_headdim)
    k = cfg.ssm_conv
    z, xp, bp, cp, dt = _ssd_project(p, x)
    xc = _causal_conv(xp, p["conv_xw"].to(x.dtype), p["conv_xb"], k)
    bc = _causal_conv(bp, p["conv_bw"].to(x.dtype), p["conv_bb"], k)
    cc = _causal_conv(cp, p["conv_cw"].to(x.dtype), p["conv_cb"], k)
    xs = xc.reshape(b, s, h, pdim)
    b_mat = bc.reshape(b, s, g, n)
    c_mat = cc.reshape(b, s, g, n)
    dt_s = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    y, h_final = ops.ssd_scan(xs, dt_s, a, b_mat, c_mat, p["d_skip"].float(),
                              impl=cfg.attn_impl, chunk=min(cfg.ssm_chunk, s))
    y = y.reshape(b, s, di)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    new_state = None
    if state is not None:
        # rolling window = last (conv-1) pre-activation conv inputs
        tail = torch.cat([xp, bp, cp], dim=-1)
        tail = F.pad(tail, (0, 0, k - 1, 0))[:, s:, :]
        new_state = SSMState(conv=tail.to(x.dtype), ssm=h_final)
    return out, new_state


def ssd_block_decode(
    p: Any,
    x: torch.Tensor,  # (B, 1, d)
    cfg: ModelConfig,
    state: SSMState,
) -> tuple[torch.Tensor, SSMState]:
    """Single-token recurrent step: O(1) in sequence length (plain ops)."""
    b = x.shape[0]
    di, g, n, h, pdim = (cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads,
                         cfg.ssm_headdim)
    gn = g * n
    z, xp, bp, cp, dt = _ssd_project(p, x)
    xbc = torch.cat([xp, bp, cp], dim=-1)
    window = torch.cat([state.conv, xbc], dim=1)  # (B, conv, conv_dim)
    conv_w = torch.cat([p["conv_xw"], p["conv_bw"], p["conv_cw"]], dim=-1).to(x.dtype)
    conv_b = torch.cat([p["conv_xb"], p["conv_bb"], p["conv_cb"]]).to(x.dtype)
    conv = torch.einsum("bkc,kc->bc", window, conv_w)[:, None, :] + conv_b
    conv = F.silu(conv)
    xs = conv[..., :di].reshape(b, h, pdim)
    b_vec = conv[..., di:di + gn].reshape(b, g, n)
    c_vec = conv[..., di + gn:].reshape(b, g, n)
    rep = h // g
    b_h = torch.repeat_interleave(b_vec, rep, dim=1)  # (B, H, N)
    c_h = torch.repeat_interleave(c_vec, rep, dim=1)
    dt_s = F.softplus(dt[:, 0].float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt_s * a[None, :])  # (B, H)
    x32 = xs.float()
    h_new = (decay[..., None, None] * state.ssm
             + (dt_s[..., None] * b_h)[..., :, None] * x32[..., None, :])
    y = torch.einsum("bhn,bhnp->bhp", c_h.float(), h_new)
    y = y + p["d_skip"].float()[None, :, None] * x32
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    return out, SSMState(conv=window[:, 1:, :], ssm=h_new)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_spec(cfg: ModelConfig) -> dict:
    return {
        "tok": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), cfg.param_dtype,
                         "normal", 0.02),
        "unembed": ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"), cfg.param_dtype),
    }


def embed_tokens(p: Any, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["tok"][tokens.long()].to(cfg.compute_dtype)


def unembed(p: Any, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,dv->bsv", x, p["unembed"].to(x.dtype))
