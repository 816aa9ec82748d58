"""Encoder-decoder transformer (the seamless-m4t backbone), in PyTorch
(``repro.models.encdec``).

Encoder: bidirectional self-attention over precomputed modality frame
embeddings (the audio frontend is a stub: the caller passes (B, S_enc,
d_model) frames). Decoder: causal self-attention, cross-attention over the
encoder's output, MLP. Serving runs the encoder once at prefill and stashes
each decoder layer's cross K/V in the cache beside its self K/V; decode
steps read them from there.

The stacks are modules (``EncDec.enc_layers``, ``EncDec.dec_layers``, one
``nn.ModuleList`` of ``ParamGroup`` each, as ``transformer.LM`` builds its
stacks), with the reference's parameter names. The encoder's and the
decoder's self-attention go through ``layers.attention_forward``, and so
through ``ops.attention`` (the flash kernel on the card: non-causal in the
encoder, causal in the decoder's prefill). Cross-attention applies no RoPE
and attends over every encoder position with ``layers._masked_attention``,
plain ops, as the reference does outside its Pallas kernel.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import assign, shard_input
from repro_torch.models.transformer import ParamGroup, _positions, _stack, maybe_remat


def _require_encdec(cfg: ModelConfig) -> None:
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name} is a {cfg.family!r} model, not an encoder-decoder")


def _enc_layer_spec(cfg: ModelConfig) -> dict:
    return {
        "norm1": L.norm_spec(cfg),
        "norm2": L.norm_spec(cfg),
        "attn": L.attention_spec(cfg),
        "mlp": L.mlp_spec(cfg),
    }


def _dec_layer_spec(cfg: ModelConfig) -> dict:
    return {
        "norm1": L.norm_spec(cfg),
        "norm_x": L.norm_spec(cfg),
        "norm2": L.norm_spec(cfg),
        "attn": L.attention_spec(cfg),
        "xattn": L.attention_spec(cfg),
        "mlp": L.mlp_spec(cfg),
    }


def _enc_depth(cfg: ModelConfig) -> int:
    return cfg.enc_layers or cfg.num_layers


def abstract_params(cfg: ModelConfig) -> dict:
    """The reference's spec tree: layer stacks as ``(L, ...)`` leaves."""
    _require_encdec(cfg)
    return {
        "embed": L.embed_spec(cfg),
        "enc_layers": _stack(_enc_layer_spec(cfg), _enc_depth(cfg)),
        "enc_norm": L.norm_spec(cfg),
        "dec_layers": _stack(_dec_layer_spec(cfg), cfg.num_layers),
        "final_norm": L.norm_spec(cfg),
    }


class EncDec(nn.Module):
    """An encoder-decoder model with randomly initialized weights.

    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` for the CPU or ``"meta"`` to allocate nothing. The
    weights are drawn from a ``torch.Generator`` on the device seeded with
    ``seed``; tests that compare with the reference carry its weights across
    (``convert.lm_params_from_reference``).
    """

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        _require_encdec(cfg)
        dev = resolve_device(device)
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        self.embed = ParamGroup(L.embed_spec(cfg), dev, gen)
        self.enc_layers = nn.ModuleList(ParamGroup(_enc_layer_spec(cfg), dev, gen)
                                        for _ in range(_enc_depth(cfg)))
        self.enc_norm = ParamGroup(L.norm_spec(cfg), dev, gen)
        self.dec_layers = nn.ModuleList(ParamGroup(_dec_layer_spec(cfg), dev, gen)
                                        for _ in range(cfg.num_layers))
        self.final_norm = ParamGroup(L.norm_spec(cfg), dev, gen)

    def __getitem__(self, name: str) -> nn.Module:
        return getattr(self, name)

    def forward(self, frames: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, frames, tokens, self.cfg)[0]

    def abstract_params(self) -> dict:
        """The spec tree (``transformer.shard_params`` lays the parameters
        out by it on a mesh)."""
        return abstract_params(self.cfg)


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------
def _cross_attention(lp: Any, x: torch.Tensor, cfg: ModelConfig, xk: torch.Tensor,
                     xv: torch.Tensor) -> torch.Tensor:
    """Cross-attention against encoder K/V (B, kv, S_enc, hd): no RoPE, every
    encoder position visible."""
    q = torch.einsum("bsd,dhk->bshk", x, lp["wq"].to(x.dtype))
    mask = torch.ones((x.shape[1], xk.shape[2]), dtype=torch.bool, device=x.device)
    out = L._masked_attention(q.transpose(1, 2), xk, xv, mask, cfg, cfg.resolved_head_dim)
    return torch.einsum("bshk,hkd->bsd", out.transpose(1, 2), lp["wo"].to(x.dtype))


def _cross_kv(lp: Any, enc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    k = torch.einsum("bsd,dhk->bshk", enc, lp["wk"].to(enc.dtype))
    v = torch.einsum("bsd,dhk->bshk", enc, lp["wv"].to(enc.dtype))
    return k.transpose(1, 2), v.transpose(1, 2)


def _enc_layer(lp: Any, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    h = L.apply_norm(lp["norm1"], x, cfg)
    attn, _ = L.attention_forward(lp["attn"], h, cfg, positions, causal=False)
    x = x + attn
    return x + L.mlp_forward(lp["mlp"], L.apply_norm(lp["norm2"], x, cfg), cfg)


def _dec_layer(lp: Any, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
               enc: torch.Tensor | None, *, kv_cache=None, xkv=None, cache_pos: int = 0):
    """One decoder layer; without a cache the cross K/V come from ``enc``,
    with one from ``xkv`` and the self K/V are written into ``kv_cache``."""
    h = L.apply_norm(lp["norm1"], x, cfg)
    attn, _ = L.attention_forward(lp["attn"], h, cfg, positions, kv_cache=kv_cache,
                                  cache_pos=cache_pos if kv_cache is not None else None)
    xk, xv = _cross_kv(lp["xattn"], enc) if xkv is None else xkv
    x = x + attn
    x = x + _cross_attention(lp["xattn"], L.apply_norm(lp["norm_x"], x, cfg), cfg, xk, xv)
    return x + L.mlp_forward(lp["mlp"], L.apply_norm(lp["norm2"], x, cfg), cfg)


# ---------------------------------------------------------------------------
# Encoder, decoder stack, forward
# ---------------------------------------------------------------------------
def encode(params: Any, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames (B, S_enc, d) stub embeddings -> encoder states (B, S_enc, d)."""
    x = shard_input(frames, ("batch", "seq", "embed")).to(cfg.compute_dtype)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    layer = maybe_remat(_enc_layer, cfg)
    for lp in params["enc_layers"]:
        x = layer(lp, x, cfg, positions)
    return L.apply_norm(params["enc_norm"], x, cfg)


def _decoder_stack(params: Any, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                   enc: torch.Tensor | None, *, cache: dict | None = None,
                   pos: int | None = None) -> tuple[torch.Tensor, dict | None]:
    """The decoder's layers; ``cache`` = {"k", "v", "xk", "xv"} stacked over
    layers, its self K/V written in place from position ``pos`` (0 if None)."""
    if cache is None:
        layer = maybe_remat(_dec_layer, cfg)
        for lp in params["dec_layers"]:
            x = layer(lp, x, cfg, positions, enc)
        return x, None
    start = 0 if pos is None else int(pos)
    for i, lp in enumerate(params["dec_layers"]):
        x = _dec_layer(lp, x, cfg, positions, None, kv_cache=(cache["k"][i], cache["v"][i]),
                       xkv=(cache["xk"][i], cache["xv"][i]), cache_pos=start)
    return x, cache


def forward(params: Any, frames: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig):
    """Training forward: (encoder frames, decoder tokens) -> (logits, aux);
    aux is 0, as the reference's."""
    _require_encdec(cfg)
    enc = encode(params, frames, cfg)
    x = L.embed_tokens(params["embed"], tokens, cfg)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    x, _ = _decoder_stack(params, x, cfg, positions, enc)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg), torch.zeros((), dtype=torch.float32,
                                                           device=x.device)


# ---------------------------------------------------------------------------
# Serving: cache, prefill, decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int, dtype=None,
               device=None) -> dict:
    """Zeroed self (``k``/``v``, ``max_len``) and cross (``xk``/``xv``,
    ``enc_len``) caches, (L, B, kv, T, hd) each; ``device=None`` means the
    CUDA card."""
    _require_encdec(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    n, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim

    def zeros(length: int) -> torch.Tensor:
        return torch.zeros((n, batch, kv, length, hd), dtype=dtype, device=dev)

    return {"k": zeros(max_len), "v": zeros(max_len), "xk": zeros(enc_len),
            "xv": zeros(enc_len)}


def prefill(params: Any, frames: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
            cache: dict) -> tuple[torch.Tensor, dict]:
    """Encoder pass, then the decoder's prompt pass: fills the cross caches
    (cast to the cache's dtype) and the self caches in place; returns (logits
    of the last position (B, 1, vocab), the cache)."""
    _require_encdec(cfg)
    enc = encode(params, frames, cfg)
    if enc.shape[1] != cache["xk"].shape[3]:
        raise ValueError(f"{enc.shape[1]} encoder frames, a cross cache of "
                         f"{cache['xk'].shape[3]}")
    for i, lp in enumerate(params["dec_layers"]):
        xk, xv = _cross_kv(lp["xattn"], enc)
        assign(cache["xk"][i], xk.to(cache["xk"].dtype))
        assign(cache["xv"][i], xv.to(cache["xv"].dtype))
    x = L.embed_tokens(params["embed"], tokens, cfg)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    x, cache = _decoder_stack(params, x, cfg, positions, enc, cache=cache)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x[:, -1:], cfg), cache


def decode_step(params: Any, tokens: torch.Tensor, cfg: ModelConfig, cache: dict,
                pos: int) -> tuple[torch.Tensor, dict]:
    """One token (B, 1) at position ``pos`` against the cache; returns
    (logits (B, 1, vocab), the cache updated in place)."""
    _require_encdec(cfg)
    pos = int(pos)
    x = L.embed_tokens(params["embed"], tokens, cfg)
    positions = _positions(x.shape[0], 1, x.device, start=pos)
    x, cache = _decoder_stack(params, x, cfg, positions, None, cache=cache, pos=pos)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg), cache
