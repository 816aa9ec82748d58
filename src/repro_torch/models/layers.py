"""Neural building blocks of every decoder-only family, in PyTorch
(``repro.models.layers``).

Plain functions on tensors: ``p`` is a mapping from parameter name to
tensor (a ``transformer.ParamGroup``), laid out as the reference's spec
says. Attention and the SSD scan go through ``repro_torch.kernels.ops``,
which launches the hand-written kernels for CUDA tensors.
"""
from __future__ import annotations

import dataclasses
import math
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


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Computed in float32, then cast back to x's dtype."""
    dtype = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dtype)


def norm_spec(cfg: ModelConfig) -> dict:
    if cfg.norm_type == "layernorm":
        return {"w": ParamSpec((cfg.d_model,), ("embed",), cfg.param_dtype, "ones"),
                "b": ParamSpec((cfg.d_model,), ("embed",), cfg.param_dtype, "zeros")}
    return {"w": ParamSpec((cfg.d_model,), ("embed",), cfg.param_dtype, "ones")}


def apply_norm(p: Any, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"])


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
# GQA attention (with optional qk-norm, sliding window and KV cache)
# ---------------------------------------------------------------------------
def attention_spec(cfg: ModelConfig) -> dict:
    hd = cfg.resolved_head_dim
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", None), cfg.param_dtype),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", None), cfg.param_dtype),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", None), cfg.param_dtype),
        "wo": ParamSpec((h, hd, d), ("heads", None, "embed"), cfg.param_dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((hd,), (None,), cfg.param_dtype, "ones")
        p["k_norm"] = ParamSpec((hd,), (None,), cfg.param_dtype, "ones")
    return p


def qkv_project(p: Any, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(q (B,S,H,hd), k, v (B,S,kv,hd)), q and k normalised per head (qk-norm)
    and rotated."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
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
    causal: bool = True,
    window: int | None = None,
    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,  # (B, kv, T, hd) x2
    cache_pos: int | None = None,  # #valid entries already cached
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """Returns (out (B,S,d), kv cache or None).

    Prefill: S > 1, the new K/V are written into the cache at ``cache_pos``
    (in place) and the queries attend over the new K/V through
    ``ops.attention`` (the flash kernel on the card). Decode: S == 1 against
    the whole cache with an explicit mask. ``causal=False`` (the encoder's
    self-attention) lets every query see every key written so far.
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
        mask = kpos <= qpos if causal else kpos < start + s
        if window is not None:
            mask = mask & (qpos - kpos < window)
        out = _masked_attention(qh, ck, cv, mask, cfg, hd)
    else:
        out = ops.attention(qh, kh, vh, causal=causal, window=window, impl=cfg.attn_impl)
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
# MLA attention (DeepSeek-V2): low-rank compressed KV + decoupled RoPE
# ---------------------------------------------------------------------------
def mla_spec(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq": ParamSpec((d, h, dn + dr), ("embed", "heads", None), cfg.param_dtype),
        "w_dkv": ParamSpec((d, r), ("embed", "kv_lora"), cfg.param_dtype),
        "w_kr": ParamSpec((d, dr), ("embed", None), cfg.param_dtype),
        "kv_norm": ParamSpec((r,), ("kv_lora",), cfg.param_dtype, "ones"),
        "w_uk": ParamSpec((r, h, dn), ("kv_lora", "heads", None), cfg.param_dtype),
        "w_uv": ParamSpec((r, h, dv), ("kv_lora", "heads", None), cfg.param_dtype),
        "wo": ParamSpec((h, dv, d), ("heads", None, "embed"), cfg.param_dtype),
    }


def mla_forward(
    p: Any,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    positions: torch.Tensor,  # (B, S)
    *,
    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,  # (ckv (B,T,r), krope (B,T,dr))
    cache_pos: int | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """Returns (out (B,S,d), the compressed cache or None).

    With a cache (prefill and decode) the new c_kv and k_rope are written
    into it in place and the queries attend over the whole cache through the
    absorbed form: scores (q_nope W_uk) . c_kv + q_rope . k_rope, so the cache
    stays compressed; plain ops, no kernel. Without one (scoring) the keys
    and values are expanded and go through ``ops.attention``: q and k have
    dn + dr dims, v has dv, and the kernel takes one head_dim, so v is padded
    with zeros to dn + dr and the output sliced back to dv (the padded
    columns of the output are 0; the scores are untouched).
    """
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = rms_norm(torch.einsum("bsd,dr->bsr", x, p["w_dkv"].to(x.dtype)), p["kv_norm"])
    k_rope = apply_rope(torch.einsum("bsd,dr->bsr", x, p["w_kr"].to(x.dtype))[:, :, None, :],
                        positions, cfg.rope_theta)[:, :, 0, :]

    scale = 1.0 / np.sqrt(dn + dr)
    new_cache = None
    if kv_cache is not None:
        cc, cr = kv_cache
        start = 0 if cache_pos is None else int(cache_pos)
        t = cc.shape[1]
        at = max(0, min(start, t - s))  # clamped, as dynamic_update_slice is
        cc[:, at:at + s] = c_kv.to(cc.dtype)
        cr[:, at:at + s] = k_rope.to(cr.dtype)
        new_cache = (cc, cr)
        f32 = torch.float32
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope.to(f32), p["w_uk"].to(f32))
        logits = torch.einsum("bshr,btr->bhst", q_abs, cc.to(f32))
        logits += torch.einsum("bshr,btr->bhst", q_rope.to(f32), cr.to(f32))
        logits *= scale
        qpos = (start + torch.arange(s, device=x.device))[:, None]
        kpos = torch.arange(t, device=x.device)[None, :]
        logits = torch.where((kpos <= qpos)[None, None], logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", probs, cc.to(f32))
        out = torch.einsum("bshr,rhv->bshv", ctx, p["w_uv"].to(f32)).to(x.dtype)
    else:
        k_nope = torch.einsum("bsr,rhn->bshn", c_kv, p["w_uk"].to(x.dtype))
        v = torch.einsum("bsr,rhv->bshv", c_kv, p["w_uv"].to(x.dtype))
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        if dv > dn + dr:
            raise ValueError(f"MLA: v_head_dim {dv} above the query's {dn + dr}")
        v_pad = F.pad(v, (0, dn + dr - dv))
        out = ops.attention(_heads_first(q_full), _heads_first(k_full), _heads_first(v_pad),
                            causal=True, impl=cfg.attn_impl)
        out = out.transpose(1, 2)[..., :dv]
    y = torch.einsum("bshv,hvd->bsd", out, p["wo"].to(x.dtype))
    return y, new_cache


# ---------------------------------------------------------------------------
# MLPs (dense variants)
# ---------------------------------------------------------------------------
def mlp_spec(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {
        "w1": ParamSpec((d, f), ("embed", "ffn"), cfg.param_dtype),
        "w2": ParamSpec((f, d), ("ffn", "embed"), cfg.param_dtype),
    }
    if cfg.mlp_kind in ("swiglu", "geglu"):
        p["w3"] = ParamSpec((d, f), ("embed", "ffn"), cfg.param_dtype)
    return p


def mlp_forward(p: Any, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """swiglu, geglu, relu2 (nemotron's squared ReLU) or gelu; gelu is the
    tanh approximation, as the reference's ``approximate=True``."""
    h = torch.einsum("bsd,df->bsf", x, p["w1"].to(x.dtype))
    if cfg.mlp_kind == "swiglu":
        h = F.silu(h) * torch.einsum("bsd,df->bsf", x, p["w3"].to(x.dtype))
    elif cfg.mlp_kind == "geglu":
        h = F.gelu(h, approximate="tanh") * torch.einsum("bsd,df->bsf", x, p["w3"].to(x.dtype))
    elif cfg.mlp_kind == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["w2"].to(x.dtype))


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based capacity dispatch)
# ---------------------------------------------------------------------------
def moe_spec(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p: dict[str, Any] = {
        "router": ParamSpec((d, e), ("embed", None), cfg.param_dtype, "small"),
        "w1": ParamSpec((e, d, f), ("experts", "embed", "expert_ffn"), cfg.param_dtype),
        "w3": ParamSpec((e, d, f), ("experts", "embed", "expert_ffn"), cfg.param_dtype),
        "w2": ParamSpec((e, f, d), ("experts", "expert_ffn", "embed"), cfg.param_dtype),
    }
    if cfg.num_shared_experts:
        fs = cfg.d_ff * cfg.num_shared_experts
        p["shared"] = {
            "w1": ParamSpec((d, fs), ("embed", "ffn"), cfg.param_dtype),
            "w3": ParamSpec((d, fs), ("embed", "ffn"), cfg.param_dtype),
            "w2": ParamSpec((fs, d), ("ffn", "embed"), cfg.param_dtype),
        }
    return p


def _route(p: Any, xf: torch.Tensor, cfg: ModelConfig):
    """Router over the last two dims of xf (..., t, d): (gates (..., t, k)
    renormalised, expert ids (..., t, k), aux loss). Ties go to the lower
    expert id, as ``jax.lax.top_k``'s do: a stable descending sort."""
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = torch.einsum("...td,de->...te", xf.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[..., :k], ids[..., :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    lead = tuple(range(probs.dim() - 1))
    density = F.one_hot(idx[..., 0], e).float().mean(dim=lead)  # Switch-style balance loss
    aux = torch.sum(density * probs.mean(dim=lead)) * e * cfg.router_aux_loss
    return gate, idx, aux


def _dispatch(xf: torch.Tensor, idx: torch.Tensor, e: int, capacity: int):
    """One group's tokens xf (t, d) into an (E, C, d) buffer: the t*k
    assignments sorted by expert (stable, as ``jnp.argsort`` is: which ones
    are dropped at capacity depends on it), ranked within their expert, and
    kept below ``capacity``. Returns (buffer, (order, sorted slot or -1))."""
    k = idx.shape[-1]
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    rank = (torch.arange(flat_e.numel(), device=xf.device)
            - torch.searchsorted(sorted_e, sorted_e, side="left"))
    keep = rank < capacity
    # kept assignments own distinct slots; dropped ones land on a spare row
    slot = torch.where(keep, sorted_e * capacity + rank, e * capacity)
    buf = torch.zeros((e * capacity + 1, xf.shape[-1]), dtype=xf.dtype, device=xf.device)
    buf.index_copy_(0, slot, xf[order // k])
    return buf[:-1].view(e, capacity, -1), (order, torch.where(keep, slot, -1))


def _combine(eo: torch.Tensor, gate: torch.Tensor, idx: torch.Tensor, meta) -> torch.Tensor:
    """Each token's kept expert outputs eo (E, C, d) times their gates,
    summed in the order the reference's scatter-add takes them: by
    ascending expert id (the sorted order), one rounding a term, in x's
    dtype. A fixed order, so the card's result does not change run to run."""
    order, slot = meta
    t, k = idx.shape
    flat = eo.reshape(-1, eo.shape[-1])
    kept = slot >= 0
    out = torch.where(kept[:, None], flat[slot.clamp(min=0)], 0)
    contrib = out * gate.reshape(-1)[order][:, None].to(eo.dtype)  # sorted order
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=order.device)  # assignment -> sorted slot
    by_expert = torch.argsort(idx, dim=-1)  # a token's k experts are distinct
    per_tok = contrib[pos[(torch.arange(t, device=idx.device)[:, None] * k + by_expert)]]
    y = torch.zeros((t, eo.shape[-1]), dtype=eo.dtype, device=eo.device)
    for j in range(k):
        y = y + per_tok[:, j]
    return y


def _experts(p: Any, buf: torch.Tensor) -> torch.Tensor:
    """The routed experts' swiglu over (..., E, C, d) buffers."""
    dt_ = buf.dtype
    h1 = torch.einsum("...ecd,edf->...ecf", buf, p["w1"].to(dt_))
    h3 = torch.einsum("...ecd,edf->...ecf", buf, p["w3"].to(dt_))
    return torch.einsum("...ecf,efd->...ecd", F.silu(h1) * h3, p["w2"].to(dt_))


def moe_forward(p: Any, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed experts with capacity dropping; returns (out, aux_loss).

    The (B, S) tokens split into ``cfg.moe_groups`` groups when they divide
    evenly (one group otherwise); routing, capacity, dispatch and combine
    stay inside a group, as the reference's ``_moe_forward_grouped``.
    """
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    groups = cfg.moe_groups if cfg.moe_groups > 1 and t % cfg.moe_groups == 0 else 1
    tg = t // groups
    xg = x.reshape(groups, tg, d)
    gate, idx, aux = _route(p, xg, cfg)
    capacity = int(max(1, math.ceil(tg * k / e * cfg.capacity_factor)))
    dispatched = [_dispatch(xg[i], idx[i], e, capacity) for i in range(groups)]
    eo = _experts(p, torch.stack([buf for buf, _ in dispatched]))
    y = torch.stack([_combine(eo[i], gate[i], idx[i], meta)
                     for i, (_, meta) in enumerate(dispatched)])
    if cfg.num_shared_experts:
        y = y + mlp_forward(p["shared"], xg, cfg.replace(mlp_kind="swiglu"))
    return y.reshape(b, s, d), aux


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
    p = {"tok": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), cfg.param_dtype,
                          "normal", 0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"), cfg.param_dtype)
    return p


def embed_tokens(p: Any, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = p["tok"][tokens.long()].to(cfg.compute_dtype)
    if cfg.embed_scale:
        # The reference (repro/models/layers.py:612) multiplies by
        # np.sqrt(d_model), a float64 numpy scalar, which JAX promotes with a
        # bf16 array to float32: its residual stream, and every later layer
        # (weights cast to x's dtype), then run in float32 whatever
        # compute_dtype says. torch keeps bf16 * float in bf16, so the
        # promotion is made here, for parity.
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        x = x * float(np.float32(np.sqrt(cfg.d_model)))
    return x


def unembed(p: Any, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, p["tok"].to(x.dtype))
    else:
        logits = torch.einsum("bsd,dv->bsv", x, p["unembed"].to(x.dtype))
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits
