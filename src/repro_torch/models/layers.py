"""Neural building blocks of every decoder-only family, in PyTorch
(``repro.models.layers``).

Plain functions on tensors: ``p`` is a mapping from parameter name to
tensor (a ``transformer.ParamGroup``), laid out as the reference's spec
says. Attention and the SSD scan go through ``repro_torch.kernels.ops``,
which launches the hand-written kernels for CUDA tensors.

On a device mesh (``spec.activation_sharding``) the parameters and
activations are ``DTensor`` s: ``shard_activation`` constrains them where
the reference does, and DTensor runs the products, norms and elementwise
ops. The kernel calls (attention, the SSD scan), RoPE's position gathers,
the depthwise convolutions, MoE routing, dispatch and combine, the SSD
decode step and the cache writes run on each rank's local shards
(``spec.local_region``, ``local_map``), with the placements the reference's
constraints name. Off a mesh every one of them is the plain function.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.models import spec
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import (
    Out,
    ParamSpec,
    local_region,
    replicate_like,
    shard_activation,
    shard_offset,
)


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


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         axes: tuple[str | None, ...]) -> torch.Tensor:
    """:func:`apply_rope` on each rank's shard of ``x`` (logical ``axes``)
    and of the positions, which are laid out by ("batch", "seq")."""
    return local_region(partial(apply_rope, theta=theta), (axes, ("batch", "seq")),
                        (Out(axes),))(x, positions)


def index_copy(dst: torch.Tensor, dim: int, index: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.index_copy_(dim, index, src)``; a DTensor ``dst`` (not split
    along ``dim``) is written through its local shard."""
    if not isinstance(dst, DTensor):
        dst.index_copy_(dim, index, src)
        return
    if any(isinstance(p, Shard) and p.dim == dim for p in dst.placements):
        raise NotImplementedError(f"index_copy along dim {dim}, which the layout splits")
    src = replicate_like(src, dst).redistribute(dst.device_mesh, dst.placements)
    dst.to_local().index_copy_(dim, index, src.to_local())


def write_cache(dst: torch.Tensor, src: torch.Tensor, at: int, dim: int) -> None:
    """``dst[..., at:at + n, ...] = src`` along ``dim`` (n = src's length
    there), in place. A DTensor ``dst`` is written through its local shard:
    ``src`` is laid out as ``dst`` except along ``dim``, and each rank
    writes the part of the span that falls in its shard of ``dim``."""
    n = src.shape[dim]
    if not isinstance(dst, DTensor):
        dst.narrow(dim, at, n).copy_(src.to(dst.dtype))
        return
    mesh = dst.device_mesh
    placements = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
                  for p in dst.placements]
    src = replicate_like(src, dst)
    local_src = src.redistribute(mesh, placements).to_local()
    local = dst.to_local()
    lo = spec.local_box(tuple(dst.shape), mesh, dst.placements)[dim].start
    a, b = max(at, lo), min(at + n, lo + local.shape[dim])
    if a < b:
        local.narrow(dim, a - lo, b - a).copy_(local_src.narrow(dim, a - at, b - a)
                                               .to(local.dtype))


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
    q = rope(q, positions, cfg.rope_theta, _Q_AXES)
    k = rope(k, positions, cfg.rope_theta, _KV_AXES)
    q = shard_activation(q, _Q_AXES)
    k = shard_activation(k, _KV_AXES)
    return q, k, v


_Q_AXES = ("batch", "seq", "heads", None)
_KV_AXES = ("batch", "seq", "kv_heads", None)
_HEADS_FIRST_Q = ("batch", "heads", None, None)
_HEADS_FIRST_KV = ("batch", "kv_heads", None, None)
_RESIDUAL = ("batch", "res_seq", "embed")


def _local_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """The KV heads of this rank's query heads, when the query heads are
    sharded and the KV heads (too few to shard) are not: query head j
    reads KV head j // (h / kv)."""
    kv = k.shape[1]
    h0, hl = shard_offset("heads", h)
    _, kl = shard_offset("kv_heads", kv)
    if hl == h or kl < kv:  # query heads whole, or the KV heads sharded alike
        return k
    group = h // kv
    first, last = h0 // group, (h0 + hl - 1) // group
    if not ((h0 % group == 0 and hl % group == 0) or first == last):
        raise ValueError(f"query heads {h0}..{h0 + hl} do not cover whole KV groups of {group}")
    return k[:, first:last + 1]


def _attention_local(q, k, v, causal, window, impl, h, dv=None):
    """``ops.attention`` on one rank's heads (the kernel for CUDA tensors).
    With ``dv`` (MLA), v is padded with zeros to q's head dim and the output
    sliced back: the kernel takes one head_dim."""
    k, v = _local_kv(k, h), _local_kv(v, h)
    if dv is not None:
        v = F.pad(v, (0, q.shape[-1] - dv))
    out = ops.attention(q, k, v, causal=causal, window=window, impl=impl)
    return out if dv is None else out[..., :dv]


def attention(qh, kh, vh, cfg: ModelConfig, *, causal: bool = True, window=None,
              dv: int | None = None) -> torch.Tensor:
    """(B, H, S, D) attention over (B, kv, S, D) keys and values, on each
    rank's local heads (batch over data, heads over model)."""
    fn = partial(_attention_local, causal=causal, window=window, impl=cfg.attn_impl,
                 h=qh.shape[1], dv=dv)
    return local_region(fn, (_HEADS_FIRST_Q, _HEADS_FIRST_KV, _HEADS_FIRST_KV),
                        (Out(_HEADS_FIRST_Q),))(qh, kh, vh)


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
        write_cache(ck, kh, at, 2)
        write_cache(cv, vh, at, 2)
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
        out = attention(qh, kh, vh, cfg, causal=causal, window=window)
    out = out.transpose(1, 2)  # (B, S, H, hd)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return shard_activation(y, _RESIDUAL), new_cache


def _masked_attention(qh, keys, vals, mask, cfg: ModelConfig, hd: int) -> torch.Tensor:
    """Explicit-mask attention on the cached paths: (B, H, S, hd) queries
    over (B, kv, T, hd) keys and values under an (S, T) mask. On a mesh it
    runs on each rank's heads (batch over data, heads and KV heads over
    model, the reference's constraint on the decode logits), the cache's
    sequence whole: plain ops on local shards, as DTensor versions differ
    in which of these views they can propagate."""
    fn = partial(_masked_attention_local, hd=hd, h=qh.shape[1])
    return local_region(fn, (_HEADS_FIRST_Q, _HEADS_FIRST_KV, _HEADS_FIRST_KV, (None, None)),
                        (Out(_HEADS_FIRST_Q),))(qh, keys, vals, mask)


def _masked_attention_local(qh, keys, vals, mask, hd: int, h: int) -> torch.Tensor:
    """Single-token decode groups the query heads over their KV head (K/V are
    not repeated); several tokens use the flat-head layout."""
    keys, vals = _local_kv(keys, h), _local_kv(vals, h)
    b, hl, s, _ = qh.shape
    kv = keys.shape[1]
    group = hl // kv
    if s == 1:
        qg = qh.reshape(b, kv, group, s, hd).float()
        logits = torch.einsum("bkgqd,bktd->bkgqt", qg, keys.float()) / np.sqrt(hd)
        logits = torch.where(mask[None, None, None], logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgqt,bktd->bkgqd", probs, vals.float())
        return out.reshape(b, hl, s, hd).to(qh.dtype)
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
    q_rope = rope(q_rope, positions, cfg.rope_theta, _Q_AXES)
    c_kv = rms_norm(torch.einsum("bsd,dr->bsr", x, p["w_dkv"].to(x.dtype)), p["kv_norm"])
    k_rope = rope(torch.einsum("bsd,dr->bsr", x, p["w_kr"].to(x.dtype))[:, :, None, :],
                  positions, cfg.rope_theta, ("batch", "seq", None, None))[:, :, 0, :]

    scale = 1.0 / np.sqrt(dn + dr)
    new_cache = None
    if kv_cache is not None:
        cc, cr = kv_cache
        start = 0 if cache_pos is None else int(cache_pos)
        t = cc.shape[1]
        at = max(0, min(start, t - s))  # clamped, as dynamic_update_slice is
        write_cache(cc, c_kv, at, 1)
        write_cache(cr, k_rope, at, 1)
        new_cache = (cc, cr)
        lora = ("kv_lora", "heads", None)
        out = local_region(
            partial(_mla_absorbed, start=start, scale=scale, dtype=x.dtype),
            (_Q_AXES, _Q_AXES, lora, lora, ("batch", None, None), ("batch", None, None)),
            (Out(_Q_AXES),),
        )(q_nope, q_rope, p["w_uk"], p["w_uv"], cc, cr)
    else:
        k_nope = torch.einsum("bsr,rhn->bshn", c_kv, p["w_uk"].to(x.dtype))
        v = torch.einsum("bsr,rhv->bshv", c_kv, p["w_uv"].to(x.dtype))
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        if dv > dn + dr:
            raise ValueError(f"MLA: v_head_dim {dv} above the query's {dn + dr}")
        out = attention(_heads_first(q_full), _heads_first(k_full), _heads_first(v), cfg,
                        dv=dv).transpose(1, 2)
    y = torch.einsum("bshv,hvd->bsd", out, p["wo"].to(x.dtype))
    return shard_activation(y, _RESIDUAL), new_cache


def _mla_absorbed(q_nope, q_rope, w_uk, w_uv, cc, cr, start: int, scale: float,
                  dtype: torch.dtype) -> torch.Tensor:
    """Attention over the compressed cache in the absorbed form, on a rank's
    heads: scores (q_nope W_uk) . c_kv + q_rope . k_rope, causal from
    ``start``, values W_uv over the context; (B, S, H, dv) in ``dtype``."""
    f32 = torch.float32
    s, t = q_nope.shape[1], cc.shape[1]
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope.to(f32), w_uk.to(f32))
    logits = torch.einsum("bshr,btr->bhst", q_abs, cc.to(f32))
    logits = logits + torch.einsum("bshr,btr->bhst", q_rope.to(f32), cr.to(f32))
    logits = logits * scale
    qpos = (start + torch.arange(s, device=cc.device))[:, None]
    kpos = torch.arange(t, device=cc.device)[None, :]
    logits = torch.where((kpos <= qpos)[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", probs, cc.to(f32))
    return torch.einsum("bshr,rhv->bshv", ctx, w_uv.to(f32)).to(dtype)


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
    h = shard_activation(h, ("batch", "seq", "ffn"))
    if cfg.mlp_kind == "swiglu":
        h = F.silu(h) * torch.einsum("bsd,df->bsf", x, p["w3"].to(x.dtype))
    elif cfg.mlp_kind == "geglu":
        h = F.gelu(h, approximate="tanh") * torch.einsum("bsd,df->bsf", x, p["w3"].to(x.dtype))
    elif cfg.mlp_kind == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return shard_activation(torch.einsum("bsf,fd->bsd", h, p["w2"].to(x.dtype)), _RESIDUAL)


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


def _route_local(xg: torch.Tensor, router: torch.Tensor, e: int, k: int):
    """Router over a rank's groups xg (G, t, d): (gates (G, t, k)
    renormalised, expert ids (G, t, k), and the sums over its tokens of the
    top expert's one-hot and of the probabilities, for the balance loss).
    Ties go to the lower expert id, as ``jax.lax.top_k``'s do: a stable
    descending sort."""
    logits = torch.einsum("gtd,de->gte", xg.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[..., :k], ids[..., :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return (gate, idx, F.one_hot(idx[..., 0], e).float().sum(dim=(0, 1)),
            probs.sum(dim=(0, 1)))


def _route(p: Any, xg: torch.Tensor, cfg: ModelConfig):
    """(gates (G, t, k), expert ids (G, t, k), Switch-style aux loss), each
    rank routing its own groups; the loss's means span every group."""
    e, k = cfg.num_experts, cfg.experts_per_token
    groups = ("batch", None, "embed")
    gate, idx, top1, prob = local_region(
        partial(_route_local, e=e, k=k), (groups, (None, None)),
        (Out(("batch", None, None)), Out(("batch", None, None)),
         Out((None,), partial=("batch",)), Out((None,), partial=("batch",))),
    )(xg, p["router"])
    n = xg.shape[0] * xg.shape[1]
    aux = torch.sum((top1 / n) * (prob / n)) * e * cfg.router_aux_loss
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


def _combine(eo: torch.Tensor, gate: torch.Tensor, idx: torch.Tensor, meta,
             e0: int = 0) -> torch.Tensor:
    """Each token's kept expert outputs eo (E, C, d) times their gates,
    summed in the order the reference's scatter-add takes them: by
    ascending expert id (the sorted order), one rounding a term, in x's
    dtype. A fixed order, so the card's result does not change run to run.
    ``eo`` may hold only the experts from ``e0`` on (one rank's share): the
    others' outputs count as 0, and the ranks' sums add up to the whole."""
    order, slot = meta
    t, k = idx.shape
    flat = eo.reshape(-1, eo.shape[-1])
    slot = slot - e0 * eo.shape[1]
    kept = (slot >= 0) & (slot < flat.shape[0])
    out = torch.where(kept[:, None], flat[torch.where(kept, slot, 0)], 0)
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
    xg = shard_activation(x.reshape(groups, tg, d), ("batch", None, "embed"))
    gate, idx, aux = _route(p, xg, cfg)
    capacity = int(max(1, math.ceil(tg * k / e * cfg.capacity_factor)))
    buf, order, slot = local_region(
        partial(_dispatch_groups, e=e, capacity=capacity),
        (("batch", None, "embed"), ("batch", None, None)),
        (Out(("batch", None, None, "embed")), Out(("batch", None)), Out(("batch", None))),
    )(xg, idx)
    buf = shard_activation(buf, _EXPERT_BUF)
    eo = shard_activation(_experts(p, buf), _EXPERT_BUF)
    y = local_region(
        partial(_combine_groups, e=e),
        (_EXPERT_BUF, ("batch", None, None), ("batch", None, None), ("batch", None),
         ("batch", None)),
        (Out(("batch", None, "embed"), partial=("experts",)),),
    )(eo, gate, idx, order, slot)
    y = shard_activation(y, ("batch", None, "embed"))
    if cfg.num_shared_experts:
        y = y + mlp_forward(p["shared"], xg, cfg.replace(mlp_kind="swiglu"))
    return y.reshape(b, s, d), aux


_EXPERT_BUF = ("batch", "experts", None, "embed")


def _dispatch_groups(xg, idx, e: int, capacity: int):
    """:func:`_dispatch` for each of a rank's groups: (buffers (G, E, C, d),
    sorted order (G, t*k), sorted slot or -1 (G, t*k))."""
    out = [_dispatch(xg[i], idx[i], e, capacity) for i in range(xg.shape[0])]
    return (torch.stack([buf for buf, _ in out]), torch.stack([m[0] for _, m in out]),
            torch.stack([m[1] for _, m in out]))


def _combine_groups(eo, gate, idx, order, slot, e: int):
    """:func:`_combine` for each of a rank's groups, over the experts it
    holds (eo: (G, E_local, C, d))."""
    e0, _ = shard_offset("experts", e)
    return torch.stack([_combine(eo[i], gate[i], idx[i], (order[i], slot[i]), e0)
                        for i in range(eo.shape[0])])


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


def _conv_local(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    s = seq.shape[1]
    padded = F.pad(seq, (0, 0, k - 1, 0))
    out = sum(padded[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return F.silu(out + b.to(seq.dtype))


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int,
                 channels: str | None) -> torch.Tensor:
    """Depthwise causal conv along time for one channel group (logical axis
    ``channels``), on each rank's channels; the bias is cast to the
    sequence's dtype before the SiLU, as the reference does."""
    return local_region(partial(_conv_local, k=k),
                        (("batch", "seq", channels), ("conv", channels), (channels,)),
                        (Out(("batch", "seq", channels)),))(seq, w, b)


def _local_groups(t: torch.Tensor, h: int) -> torch.Tensor:
    """The B/C groups (dim 2 of (B, S, G, N)) of this rank's SSD heads, when
    the heads are sharded and the groups are not: head j reads group
    j // (h / G)."""
    g = t.shape[2]
    h0, hl = shard_offset("ssm_heads", h)
    if hl == h or g == 1:
        return t
    per = h // g
    first, last = h0 // per, (h0 + hl - 1) // per
    if not ((h0 % per == 0 and hl % per == 0) or first == last):
        raise ValueError(f"SSD heads {h0}..{h0 + hl} do not cover whole groups of {per}")
    return t[:, :, first:last + 1]


def _conv_tail(xp, bp, cp, k: int) -> torch.Tensor:
    """[x | B | C] of the last conv-1 positions, zero-padded in front when the
    sequence is shorter."""
    tail = torch.cat([xp, bp, cp], dim=-1)
    return F.pad(tail, (0, 0, k - 1, 0))[:, tail.shape[1]:, :]


def _ssd_scan_local(xs, dt, a, b_mat, c_mat, d_skip, h: int, impl: str, chunk: int):
    """``ops.ssd_scan`` on one rank's heads (the kernel for CUDA tensors)."""
    return ops.ssd_scan(xs, dt, a, _local_groups(b_mat, h), _local_groups(c_mat, h), d_skip,
                        impl=impl, chunk=chunk)


_SSD_X = ("batch", "seq", "ssm_heads", None)
_SSD_BC = ("batch", "seq", None, None)


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
    xc = _causal_conv(xp, p["conv_xw"].to(x.dtype), p["conv_xb"], k, "ssm_inner")
    bc = _causal_conv(bp, p["conv_bw"].to(x.dtype), p["conv_bb"], k, None)
    cc = _causal_conv(cp, p["conv_cw"].to(x.dtype), p["conv_cb"], k, None)
    xs = shard_activation(spec.unflatten(xc, 2, (h, pdim)), _SSD_X)
    b_mat = bc.unflatten(2, (g, n))
    c_mat = cc.unflatten(2, (g, n))
    dt_s = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    scan = partial(_ssd_scan_local, h=h, impl=cfg.attn_impl, chunk=min(cfg.ssm_chunk, s))
    y, h_final = local_region(
        scan, (_SSD_X, ("batch", "seq", "ssm_heads"), ("ssm_heads",), _SSD_BC, _SSD_BC,
               ("ssm_heads",)),
        (Out(_SSD_X), Out(("batch", "ssm_heads", None, None))),
    )(xs, dt_s, a, b_mat, c_mat, p["d_skip"].float())
    # (B, S, H, P) -> (B, S, H*P) on each rank's heads: the merged dim is laid
    # out as the heads are (its gradient is never split as a DTensor view)
    y = local_region(lambda t: t.flatten(2), (_SSD_X,),
                     (Out(("batch", "seq", "ssm_heads")),))(y)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    new_state = None
    if state is not None:
        # rolling window = last (conv-1) pre-activation conv inputs
        last = slice(max(s - (k - 1), 0), s)
        tail = local_region(partial(_conv_tail, k=k), (("batch", "seq", None),) * 3,
                            (Out(("batch", None, None)),))(xp[:, last], bp[:, last], cp[:, last])
        new_state = SSMState(conv=tail.to(x.dtype), ssm=h_final)
    return shard_activation(out, _RESIDUAL), new_state


def ssd_block_decode(
    p: Any,
    x: torch.Tensor,  # (B, 1, d)
    cfg: ModelConfig,
    state: SSMState,
) -> tuple[torch.Tensor, SSMState]:
    """Single-token recurrent step: O(1) in sequence length (plain ops)."""
    b, di = x.shape[0], cfg.ssm_d_inner
    z, xp, bp, cp, dt = _ssd_project(p, x)
    whole = ("batch", None, None)
    conv = [p[name] for name in ("conv_xw", "conv_xb", "conv_bw", "conv_bb", "conv_cw",
                                 "conv_cb")]
    y, window, h_new = local_region(
        partial(_ssd_step, cfg=cfg),
        (whole, whole, whole, ("batch", None, "ssm_heads"), whole,
         ("batch", "ssm_heads", None, None), *[(None,) * t.dim() for t in conv],
         ("ssm_heads",), ("ssm_heads",), ("ssm_heads",)),
        (Out(("batch", "ssm_heads", None)), Out(whole), Out(("batch", "ssm_heads", None, None))),
    )(xp, bp, cp, dt, state.conv, state.ssm, *conv, p["dt_bias"], p["a_log"], p["d_skip"])
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    return out, SSMState(conv=window, ssm=h_new)


def _ssd_step(xp, bp, cp, dt, conv_state, ssm, xw, xb, bw, bb, cw, cb, dt_bias, a_log, d_skip,
              cfg: ModelConfig):
    """The recurrent step on one rank's SSD heads: the convolution over
    every channel (its window is whole on each rank), the state update and
    the output of the rank's heads. Returns (y (B, H_local, P), the new
    window (B, conv-1, conv_dim), the new state (B, H_local, N, P))."""
    b = xp.shape[0]
    di, g, n, h, pdim = (cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads,
                         cfg.ssm_headdim)
    gn = g * n
    xbc = torch.cat([xp, bp, cp], dim=-1)
    window = torch.cat([conv_state, xbc], dim=1)  # (B, conv, conv_dim)
    conv_w = torch.cat([xw, bw, cw], dim=-1).to(xp.dtype)
    conv_b = torch.cat([xb, bb, cb]).to(xp.dtype)
    conv = torch.einsum("bkc,kc->bc", window, conv_w)[:, None, :] + conv_b
    conv = F.silu(conv)
    h0, hl = shard_offset("ssm_heads", h)
    heads = slice(h0, h0 + hl)
    xs = conv[..., :di].reshape(b, h, pdim)[:, heads]
    b_vec = conv[..., di:di + gn].reshape(b, g, n)
    c_vec = conv[..., di + gn:].reshape(b, g, n)
    rep = h // g
    b_h = torch.repeat_interleave(b_vec, rep, dim=1)[:, heads]  # (B, H_local, N)
    c_h = torch.repeat_interleave(c_vec, rep, dim=1)[:, heads]
    dt_s = F.softplus(dt[:, 0].float() + dt_bias.float())
    a = -torch.exp(a_log.float())
    decay = torch.exp(dt_s * a[None, :])  # (B, H_local)
    x32 = xs.float()
    h_new = (decay[..., None, None] * ssm
             + (dt_s[..., None] * b_h)[..., :, None] * x32[..., None, :])
    y = torch.einsum("bhn,bhnp->bhp", c_h.float(), h_new)
    y = y + d_skip.float()[None, :, None] * x32
    return y, window[:, 1:, :], h_new


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_spec(cfg: ModelConfig) -> dict:
    p = {"tok": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), cfg.param_dtype,
                          "normal", 0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"), cfg.param_dtype)
    return p


def _embed_local(tokens: torch.Tensor, table: torch.Tensor, vocab: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """Rows of the rank's slice of the ``vocab`` table; 0 for a token whose
    row another rank holds, so the ranks' results sum to the lookup."""
    v0, vl = shard_offset("vocab", vocab)
    local = tokens.long() - v0
    held = (local >= 0) & (local < vl)
    rows = F.embedding(torch.where(held, local, 0), table).to(dtype)
    return torch.where(held[..., None], rows, 0)


def embed_tokens(p: Any, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = local_region(partial(_embed_local, vocab=p["tok"].shape[0], dtype=cfg.compute_dtype),
                     (("batch", "seq"), ("vocab", "embed")),
                     (Out(("batch", "seq", "embed"), partial=("vocab",)),))(tokens, p["tok"])
    if cfg.embed_scale:
        # The reference (repro/models/layers.py:612) multiplies by
        # np.sqrt(d_model), a float64 numpy scalar, which JAX promotes with a
        # bf16 array to float32: its residual stream, and every later layer
        # (weights cast to x's dtype), then run in float32 whatever
        # compute_dtype says. torch keeps bf16 * float in bf16, so the
        # promotion is made here, for parity.
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        x = x * float(np.float32(np.sqrt(cfg.d_model)))
    return shard_activation(x, _RESIDUAL)


def unembed(p: Any, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, p["tok"].to(x.dtype))
    else:
        logits = torch.einsum("bsd,dv->bsv", x, p["unembed"].to(x.dtype))
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return shard_activation(logits, ("batch", "seq", "vocab"))
