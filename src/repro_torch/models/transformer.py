"""Decoder-only LM of the hybrid family (Hymba), in PyTorch
(``repro.models.transformer``, the hybrid family only).

Structure: embed -> [global layer, SWA segment] x G -> final norm ->
unembed. ``num_global_layers`` full-attention layers sit between
contiguous segments of sliding-window layers, and every layer runs its
attention heads and its SSD heads in parallel on the same input.

The layers are modules (``HybridLM.global_layers`` and ``HybridLM.layers``,
one ``nn.ModuleList`` each) holding their parameters by the reference's
names; the functions below take the model as ``params`` and read
``params["layers"][i]["attn"]["wq"]``, as the reference reads its stacked
pytree. Caches are nested dicts of stacked tensors with the reference's
keys and shapes: sliding-window layers keep O(window) ring caches, global
layers full caches, SSD heads O(1) state. Prefill and decode update the
cache's tensors in place (no copy of the cache per step) and return it.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import ParamSpec, materialize_leaf


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
# The transformer details the port runs: Hymba's. Other values of these
# knobs belong to architectures not yet ported.
HYMBA_DETAILS = dict(mlp_kind="swiglu", norm_type="rmsnorm", qk_norm=False,
                     embed_scale=False, tie_embeddings=False, logit_softcap=None,
                     frontend=None)


def _require_hybrid(cfg: ModelConfig) -> None:
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not yet ported to repro_torch; "
            "the port runs the hybrid family")
    other = {k: getattr(cfg, k) for k, v in HYMBA_DETAILS.items() if getattr(cfg, k) != v}
    if other:
        raise NotImplementedError(
            f"{cfg.name}: {other} are not yet ported to repro_torch; the port runs "
            f"Hymba's {HYMBA_DETAILS}")


def _hybrid_layer_spec(cfg: ModelConfig) -> dict:
    return {
        "norm1": L.norm_spec(cfg),
        "norm2": L.norm_spec(cfg),
        "attn": L.attention_spec(cfg),
        "ssd": L.ssd_spec(cfg),
        "mlp": L.mlp_spec(cfg),
    }


def _stack(tree: Any, n: int) -> Any:
    if isinstance(tree, ParamSpec):
        return ParamSpec((n,) + tree.shape, ("layers",) + tree.axes, tree.dtype, tree.init,
                         tree.scale)
    return {k: _stack(v, n) for k, v in tree.items()}


def _hybrid_split(cfg: ModelConfig) -> tuple[int, int]:
    n_glob = cfg.num_global_layers
    return n_glob, cfg.num_layers - n_glob


def abstract_params(cfg: ModelConfig) -> dict:
    """The reference's spec tree: layer stacks as ``(L, ...)`` leaves."""
    _require_hybrid(cfg)
    p: dict[str, Any] = {"embed": L.embed_spec(cfg), "final_norm": L.norm_spec(cfg)}
    n_glob, n_swa = _hybrid_split(cfg)
    if n_glob:
        p["global_layers"] = _stack(_hybrid_layer_spec(cfg), n_glob)
    p["layers"] = _stack(_hybrid_layer_spec(cfg), n_swa)
    return p


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
class ParamGroup(nn.Module):
    """Parameters built from a flat ``{name: ParamSpec}`` dict; ``p[name]``
    reads one. Inference only: no parameter requires a gradient."""

    def __init__(self, specs: dict, device: torch.device, generator: torch.Generator | None):
        super().__init__()
        for name, spec in specs.items():
            self.register_parameter(name, nn.Parameter(
                materialize_leaf(spec, generator, device), requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


class HybridLayer(nn.Module):
    """One Hymba layer's parameters: norm1, norm2, attn, ssd, mlp."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: torch.Generator | None):
        super().__init__()
        for name, specs in _hybrid_layer_spec(cfg).items():
            self.add_module(name, ParamGroup(specs, device, generator))

    def __getitem__(self, name: str) -> ParamGroup:
        return getattr(self, name)


class HybridLM(nn.Module):
    """The hybrid-family LM with randomly initialized weights.

    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` for the CPU or ``"meta"`` to allocate nothing. The
    weights are drawn from a ``torch.Generator`` on the device seeded with
    ``seed`` (they cannot equal the reference's ``jax.random`` draws).
    """

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        _require_hybrid(cfg)
        dev = resolve_device(device)
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        self.embed = ParamGroup(L.embed_spec(cfg), dev, gen)
        self.final_norm = ParamGroup(L.norm_spec(cfg), dev, gen)
        n_glob, n_swa = _hybrid_split(cfg)
        self.global_layers = nn.ModuleList(HybridLayer(cfg, dev, gen) for _ in range(n_glob))
        self.layers = nn.ModuleList(HybridLayer(cfg, dev, gen) for _ in range(n_swa))

    def __getitem__(self, name: str) -> nn.Module:
        return getattr(self, name)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens, self.cfg)[0]


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------
def _hybrid_layer(
    lp: Any,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    window: int | None,
    kv_cache=None,
    cache_pos=None,
    ssm_state=None,
    decode=False,
):
    """Hymba: attention heads and SSD heads in parallel on the same input."""
    h = L.rms_norm(x, lp["norm1"]["w"])
    attn_out, new_kv = L.attention_forward(
        lp["attn"], h, cfg, positions, window=window, kv_cache=kv_cache, cache_pos=cache_pos
    )
    if decode:
        ssd_out, new_state = L.ssd_block_decode(lp["ssd"], h, cfg, ssm_state)
    else:
        ssd_out, new_state = L.ssd_block_forward(lp["ssd"], h, cfg, state=ssm_state)
    x = x + 0.5 * (attn_out + ssd_out)
    x = x + L.mlp_forward(lp["mlp"], L.rms_norm(x, lp["norm2"]["w"]))
    return x, new_kv, new_state


def _positions(b: int, s: int, device: torch.device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + s, dtype=torch.int32, device=device)[None].expand(b, s)


def _segments(n: int, g: int) -> list[tuple[int, int]]:
    """Split n layers into g contiguous segments (lengths differ by <=1)."""
    bounds = np.linspace(0, n, g + 1).astype(int)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(g)]


# ---------------------------------------------------------------------------
# Forward (scoring): full sequence, no cache
# ---------------------------------------------------------------------------
def forward(
    params: Any,
    tokens: torch.Tensor,  # (B, S) int
    cfg: ModelConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, vocab), aux_loss)."""
    _require_hybrid(cfg)
    x = L.embed_tokens(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    x = _hybrid_forward_nocache(params, x, cfg, _positions(b, s, x.device))
    x = L.rms_norm(x, params["final_norm"]["w"])
    logits = L.unembed(params["embed"], x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def _hybrid_forward_nocache(params, x, cfg, positions):
    """Global layers between contiguous SWA segments."""
    n_glob, n_swa = _hybrid_split(cfg)
    for gi, (lo, hi) in enumerate(_segments(n_swa, max(n_glob, 1))):
        if n_glob and gi < n_glob:
            x, _, _ = _hybrid_layer(params["global_layers"][gi], x, cfg, positions, window=None)
        for li in range(lo, hi):
            x, _, _ = _hybrid_layer(params["layers"][li], x, cfg, positions, window=cfg.window)
    return x


# ---------------------------------------------------------------------------
# KV / state caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device=None) -> dict:
    """Zeroed cache for decode. ``max_len`` is the KV capacity of the global
    layers; SWA layers allocate only ``cfg.window``; SSD heads O(1) state.
    ``device=None`` means the CUDA card."""
    _require_hybrid(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads

    def kv_cache(n_layers: int, length: int) -> dict:
        shape = (n_layers, batch, kv, length, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    def ssm_state(n_layers: int) -> dict:
        conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        return {
            "conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                                device=dev),
            "ssm": torch.zeros((n_layers, batch, cfg.ssm_heads, cfg.ssm_state,
                                cfg.ssm_headdim), dtype=torch.float32, device=dev),
        }

    n_glob, n_swa = _hybrid_split(cfg)
    ring = min(cfg.window or max_len, max_len)
    cache: dict[str, Any] = {
        "swa": kv_cache(n_swa, ring),
        "swa_ssm": ssm_state(n_swa),
        "slotpos": torch.full((ring,), -1, dtype=torch.int32, device=dev),
    }
    if n_glob:
        cache["global"] = kv_cache(n_glob, max_len)
        cache["global_ssm"] = ssm_state(n_glob)
    return cache


def _store_state(cache_ssm: dict, i: int, state: L.SSMState) -> None:
    cache_ssm["conv"][i] = state.conv
    cache_ssm["ssm"][i] = state.ssm


# ---------------------------------------------------------------------------
# Prefill: full prompt -> (logits, populated cache)
# ---------------------------------------------------------------------------
def prefill(
    params: Any,
    tokens: torch.Tensor,  # (B, S)
    cfg: ModelConfig,
    cache: dict,
) -> tuple[torch.Tensor, dict]:
    """Returns (logits of the last position (B, 1, vocab), the cache)."""
    _require_hybrid(cfg)
    x = L.embed_tokens(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    x, cache = _hybrid_prefill(params, x, cfg, _positions(b, s, x.device), cache)
    x = L.rms_norm(x, params["final_norm"]["w"])
    return L.unembed(params["embed"], x[:, -1:]), cache


def _hybrid_prefill(params, x, cfg, positions, cache):
    n_glob, n_swa = _hybrid_split(cfg)
    b, s, _ = x.shape
    swa_k, swa_v = cache["swa"]["k"], cache["swa"]["v"]
    w = swa_k.shape[3]
    take = min(w, s)
    ring_slots = torch.arange(s - take, s, device=x.device) % w
    kv_hd = (b, cfg.num_kv_heads, s, cfg.resolved_head_dim)
    for gi, (lo, hi) in enumerate(_segments(n_swa, max(n_glob, 1))):
        if n_glob and gi < n_glob:
            gkv = (cache["global"]["k"][gi], cache["global"]["v"][gi])  # views: written in place
            gssm = L.SSMState(conv=cache["global_ssm"]["conv"][gi],
                              ssm=cache["global_ssm"]["ssm"][gi])
            x, _, new_state = _hybrid_layer(
                params["global_layers"][gi], x, cfg, positions, window=None,
                kv_cache=gkv, cache_pos=0, ssm_state=gssm)
            _store_state(cache["global_ssm"], gi, new_state)
        for li in range(lo, hi):
            gssm = L.SSMState(conv=cache["swa_ssm"]["conv"][li], ssm=cache["swa_ssm"]["ssm"][li])
            # a full-length temporary cache so that prefill also yields the
            # k/v stream; the trailing window lands in the ring for decode
            tmp = (torch.empty(kv_hd, dtype=swa_k.dtype, device=x.device),
                   torch.empty(kv_hd, dtype=swa_v.dtype, device=x.device))
            x, new_kv, new_state = _hybrid_layer(
                params["layers"][li], x, cfg, positions, window=cfg.window,
                kv_cache=tmp, cache_pos=0, ssm_state=gssm)
            _store_state(cache["swa_ssm"], li, new_state)
            # ring[slot(p)] = kv[p] for the last `take` positions; index_copy_
            # puts the slot axis where it is (the reference's numpy-style
            # mixed indexing moves it first, which torch would not)
            swa_k[li].index_copy_(2, ring_slots, new_kv[0][:, :, s - take:, :])
            swa_v[li].index_copy_(2, ring_slots, new_kv[1][:, :, s - take:, :])
    # as the reference labels the ring: slot i holds position s - take + i,
    # which is where the positions sit only when s <= w or w divides s
    slotpos = cache["slotpos"]
    slotpos.fill_(-1)
    slotpos[:take] = torch.arange(s - take, s, dtype=torch.int32, device=x.device)
    return x, cache


# ---------------------------------------------------------------------------
# Decode: one token against the cache
# ---------------------------------------------------------------------------
def decode_step(
    params: Any,
    tokens: torch.Tensor,  # (B, 1)
    cfg: ModelConfig,
    cache: dict,
    pos: int,  # index of the new token
) -> tuple[torch.Tensor, dict]:
    """Returns (logits (B, 1, vocab), the cache updated in place)."""
    _require_hybrid(cfg)
    pos = int(pos)
    x = L.embed_tokens(params["embed"], tokens, cfg)
    positions = _positions(x.shape[0], 1, x.device, start=pos)
    x, cache = _hybrid_decode(params, x, cfg, positions, cache, pos)
    x = L.rms_norm(x, params["final_norm"]["w"])
    return L.unembed(params["embed"], x), cache


def _ring_attention_decode(lp, h, cfg, positions, ring_k, ring_v, slotpos, pos: int):
    """SWA decode against a ring cache: O(window) memory and compute.
    Writes the new k/v into the ring and the position into ``slotpos``."""
    w = ring_k.shape[2]
    q, k, v = L.qkv_project(lp["attn"], h, cfg, positions)
    slot = pos % w
    ring_k[:, :, slot:slot + 1] = k.transpose(1, 2).to(ring_k.dtype)
    ring_v[:, :, slot:slot + 1] = v.transpose(1, 2).to(ring_v.dtype)
    slotpos[slot] = pos
    valid = (slotpos >= 0) & (pos - slotpos < (cfg.window or w)) & (slotpos <= pos)
    out = L._masked_attention(q.transpose(1, 2), ring_k, ring_v, valid[None, :], cfg,
                              cfg.resolved_head_dim)
    out = out.transpose(1, 2)
    return torch.einsum("bshk,hkd->bsd", out, lp["attn"]["wo"].to(h.dtype))


def _hybrid_decode(params, x, cfg, positions, cache, pos: int):
    n_glob, n_swa = _hybrid_split(cfg)
    for gi, (lo, hi) in enumerate(_segments(n_swa, max(n_glob, 1))):
        if n_glob and gi < n_glob:
            gssm = L.SSMState(conv=cache["global_ssm"]["conv"][gi],
                              ssm=cache["global_ssm"]["ssm"][gi])
            x, _, new_state = _hybrid_layer(
                params["global_layers"][gi], x, cfg, positions, window=None,
                kv_cache=(cache["global"]["k"][gi], cache["global"]["v"][gi]),
                cache_pos=pos, ssm_state=gssm, decode=True)
            _store_state(cache["global_ssm"], gi, new_state)
        for li in range(lo, hi):
            lp = params["layers"][li]
            h = L.rms_norm(x, lp["norm1"]["w"])
            attn_out = _ring_attention_decode(
                lp, h, cfg, positions, cache["swa"]["k"][li], cache["swa"]["v"][li],
                cache["slotpos"], pos)
            ssd_out, new_state = L.ssd_block_decode(
                lp["ssd"], h, cfg,
                L.SSMState(conv=cache["swa_ssm"]["conv"][li], ssm=cache["swa_ssm"]["ssm"][li]))
            _store_state(cache["swa_ssm"], li, new_state)
            x = x + 0.5 * (attn_out + ssd_out)
            x = x + L.mlp_forward(lp["mlp"], L.rms_norm(x, lp["norm2"]["w"]))
    return x, cache
