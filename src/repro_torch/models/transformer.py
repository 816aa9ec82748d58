"""Decoder-only LM covering the dense (with the VLM backbone's patch prefix),
MoE (with MLA), SSM and hybrid families, in PyTorch
(``repro.models.transformer``).

Structure (all families): embed -> [layer stacks] -> final norm -> unembed.
Families map to stacks as:

  dense   : ``layers``, one uniform stack of (attn + mlp) layers
  moe     : ``dense_layers`` (the first ``first_k_dense``), then ``layers``
            (attn + moe); attention is GQA or MLA (``attn_kind``)
  ssm     : ``layers`` of mamba2 SSD blocks (attention-free)
  hybrid  : ``global_layers`` full-attention layers between contiguous
            segments of sliding-window ``layers``; every layer runs its
            attention heads and its SSD heads in parallel (Hymba)

The stacks are modules (``LM.layers`` and the others, one ``nn.ModuleList``
each) holding their parameters by the reference's names; the functions below
take the model as ``params`` and read ``params["layers"][i]["attn"]["wq"]``,
as the reference reads its stacked pytree. Caches are nested dicts of
stacked tensors with the reference's keys and shapes: KV caches for
attention layers (compressed ``ckv``/``kr`` for MLA), O(window) rings for
sliding-window layers, O(1) state for SSD blocks. Prefill and decode update
the cache's tensors in place (no copy of the cache per step) and return it.

On a device mesh, ``shard_params`` makes every parameter a ``DTensor`` laid
out by the reference's logical-axis rules, and the functions below run
under ``spec.activation_sharding`` with the cache laid out by
``serve.cache_shardings``; on a trivial mesh the model stays as it is.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import (
    P,
    ParamSpec,
    assign,
    empty_as,
    distribute,
    is_trivial,
    logical_to_pspec,
    materialize_leaf,
    shard_input,
    to_placements,
)

FAMILIES = ("dense", "moe", "ssm", "hybrid")  # the decoder-only families


def _require_decoder(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not yet ported to repro_torch; "
            f"the port runs {FAMILIES}")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
def _attn_layer_spec(cfg: ModelConfig, mlp: str, d_ff: int | None = None) -> dict:
    return {
        "norm1": L.norm_spec(cfg),
        "norm2": L.norm_spec(cfg),
        "attn": L.mla_spec(cfg) if cfg.attn_kind == "mla" else L.attention_spec(cfg),
        "mlp": L.moe_spec(cfg) if mlp == "moe" else L.mlp_spec(cfg, d_ff),
    }


def _ssm_layer_spec(cfg: ModelConfig) -> dict:
    return {"norm1": L.norm_spec(cfg), "ssd": L.ssd_spec(cfg)}


def _hybrid_layer_spec(cfg: ModelConfig) -> dict:
    return {
        "norm1": L.norm_spec(cfg),
        "norm2": L.norm_spec(cfg),
        "attn": L.attention_spec(cfg),
        "ssd": L.ssd_spec(cfg),
        "mlp": L.mlp_spec(cfg),
    }


def _hybrid_split(cfg: ModelConfig) -> tuple[int, int]:
    n_glob = cfg.num_global_layers
    return n_glob, cfg.num_layers - n_glob


def _stacks(cfg: ModelConfig) -> list[tuple[str, int, dict]]:
    """(stack name, layers, one layer's spec) in the reference's order."""
    _require_decoder(cfg)
    if cfg.family == "ssm":
        return [("layers", cfg.num_layers, _ssm_layer_spec(cfg))]
    if cfg.family == "hybrid":
        n_glob, n_swa = _hybrid_split(cfg)
        glob = [("global_layers", n_glob, _hybrid_layer_spec(cfg))] if n_glob else []
        return glob + [("layers", n_swa, _hybrid_layer_spec(cfg))]
    if cfg.family == "moe":
        dense = ([("dense_layers", cfg.first_k_dense,
                   _attn_layer_spec(cfg, "dense", cfg.dense_d_ff or cfg.d_ff))]
                 if cfg.first_k_dense else [])
        return dense + [("layers", cfg.num_layers - cfg.first_k_dense,
                         _attn_layer_spec(cfg, "moe"))]
    return [("layers", cfg.num_layers, _attn_layer_spec(cfg, "dense"))]


def _stack(tree: Any, n: int) -> Any:
    if isinstance(tree, ParamSpec):
        return ParamSpec((n,) + tree.shape, ("layers",) + tree.axes, tree.dtype, tree.init,
                         tree.scale)
    return {k: _stack(v, n) for k, v in tree.items()}


def abstract_params(cfg: ModelConfig) -> dict:
    """The reference's spec tree: layer stacks as ``(L, ...)`` leaves."""
    p: dict[str, Any] = {"embed": L.embed_spec(cfg), "final_norm": L.norm_spec(cfg)}
    for name, n, spec in _stacks(cfg):
        p[name] = _stack(spec, n)
    return p


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
class ParamGroup(nn.Module):
    """Parameters built from a nested ``{name: ParamSpec or dict}``; ``p[name]``
    reads a parameter or a nested group. Built with ``requires_grad=False``,
    for serving; the training path (``train.step``) turns gradients on."""

    def __init__(self, specs: dict, device: torch.device, generator: torch.Generator | None):
        super().__init__()
        for name, spec in specs.items():
            if isinstance(spec, ParamSpec):
                self.register_parameter(name, nn.Parameter(
                    materialize_leaf(spec, generator, device), requires_grad=False))
            else:
                self.add_module(name, ParamGroup(spec, device, generator))

    def __getitem__(self, name: str):
        return getattr(self, name)


class LM(nn.Module):
    """A decoder-only LM of any ported family, with randomly initialized
    weights.

    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` for the CPU or ``"meta"`` to allocate nothing. The
    weights are drawn from a ``torch.Generator`` on the device seeded with
    ``seed`` (they cannot equal the reference's ``jax.random`` draws).
    """

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        stacks = _stacks(cfg)
        dev = resolve_device(device)
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        self.embed = ParamGroup(L.embed_spec(cfg), dev, gen)
        self.final_norm = ParamGroup(L.norm_spec(cfg), dev, gen)
        for name, n, spec in stacks:
            self.add_module(name, nn.ModuleList(ParamGroup(spec, dev, gen) for _ in range(n)))

    def __getitem__(self, name: str) -> nn.Module:
        return getattr(self, name)

    def forward(self, tokens: torch.Tensor, prefix_embeds: torch.Tensor | None = None):
        return forward(self, tokens, self.cfg, prefix_embeds=prefix_embeds)[0]

    def abstract_params(self) -> dict:
        return abstract_params(self.cfg)


HybridLM = LM  # the name of the first slice, which ported the hybrid family


# ---------------------------------------------------------------------------
# Parameters on a device mesh
# ---------------------------------------------------------------------------
def _spec_leaves(tree: dict, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], ParamSpec]:
    if isinstance(tree, ParamSpec):
        return {prefix: tree}
    out: dict[tuple[str, ...], ParamSpec] = {}
    for name, sub in tree.items():
        out.update(_spec_leaves(sub, prefix + (name,)))
    return out


def param_placements(model: nn.Module, mesh, rules: dict | None = None) -> dict[str, tuple]:
    """The placements of each of ``model``'s parameters (by its
    ``named_parameters`` name) under the rule table: for each layer's tensor
    of a stacked leaf, the leaf's PartitionSpec without its layer entry."""
    specs = _spec_leaves(model.abstract_params())
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        stacked = isinstance(getattr(model, parts[0]), nn.ModuleList)
        s = specs[(parts[0], *parts[2:]) if stacked else tuple(parts)]
        ps = tuple(logical_to_pspec(s.axes, mesh, rules, shape=s.shape))
        ps += (None,) * (len(s.shape) - len(ps))
        out[name] = to_placements(P(*ps[1:]) if stacked else P(*ps), mesh)
    return out


def shard_params(model: nn.Module, mesh, rules: dict | None = None) -> nn.Module:
    """Make each parameter of ``model`` (each layer's tensor of a stacked
    leaf) a DTensor laid out by ``spec.named_shardings``, in place: every
    rank keeps its own box of the weights it holds whole (built from the
    same seed, or loaded from the same checkpoint). On a trivial mesh the
    model is returned as it is."""
    if is_trivial(mesh):
        return model
    placements = param_placements(model, mesh, rules)
    for name, p in list(model.named_parameters()):
        owner, leaf = model, name.split(".")
        for part in leaf[:-1]:
            owner = owner[int(part)] if part.isdigit() else getattr(owner, part)
        owner.register_parameter(leaf[-1], nn.Parameter(
            distribute(p.detach(), mesh, placements[name]), requires_grad=p.requires_grad))
    return model


# ---------------------------------------------------------------------------
# Rematerialisation (training)
# ---------------------------------------------------------------------------
_ATEN = torch.ops.aten


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims`` in
    torch's terms: save the output of a matrix product with no batch dims and
    recompute everything else. ``torch.einsum`` lowers every contraction to
    ``aten.bmm``; a product with no batch dims (a weight product such as
    ``bsd,dhk->bshk``) reaches it with a batch extent of 1, while attention's
    ``bhqd,bhkd->bhqk`` has B*H. Saved: ``aten.mm``, ``aten.addmm`` and
    ``aten.bmm`` at batch 1; so attention's scores and probabilities are
    recomputed, as the reference's policy recomputes them."""
    if op in (_ATEN.mm.default, _ATEN.addmm.default) or (
            op is _ATEN.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """A layer body under ``cfg.remat`` (the reference's ``_maybe_remat``):
    ``"none"`` runs it as is; ``"full"`` saves only its inputs
    (``torch.utils.checkpoint``); ``"dots"`` saves the outputs of its matrix
    products without batch dims (:func:`_save_dots`). Only while autograd
    records: serving, under ``torch.no_grad``, runs the body as is."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("dots", "full"):
        raise ValueError(f"unknown remat {cfg.remat!r} (want none, dots or full)")
    context_fn = (partial(create_selective_checkpoint_contexts, _save_dots)
                  if cfg.remat == "dots" else None)

    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        extra = {} if context_fn is None else {"context_fn": context_fn}
        return checkpoint(fn, *args, use_reentrant=False, **extra, **kwargs)

    return run


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------
def _attn_mlp_layer(lp: Any, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor, *,
                    moe: bool, window: int | None, kv_cache=None, cache_pos=None):
    h = L.apply_norm(lp["norm1"], x, cfg)
    if cfg.attn_kind == "mla":
        attn_out, new_cache = L.mla_forward(lp["attn"], h, cfg, positions, kv_cache=kv_cache,
                                            cache_pos=cache_pos)
    else:
        attn_out, new_cache = L.attention_forward(lp["attn"], h, cfg, positions, window=window,
                                                  kv_cache=kv_cache, cache_pos=cache_pos)
    x = x + attn_out
    h2 = L.apply_norm(lp["norm2"], x, cfg)
    if moe:
        mlp_out, aux = L.moe_forward(lp["mlp"], h2, cfg)
    else:
        mlp_out, aux = L.mlp_forward(lp["mlp"], h2, cfg), None
    return x + mlp_out, aux, new_cache


def _ssm_layer(lp: Any, x: torch.Tensor, cfg: ModelConfig, *, state=None, decode=False):
    h = L.apply_norm(lp["norm1"], x, cfg)
    if decode:
        out, new_state = L.ssd_block_decode(lp["ssd"], h, cfg, state)
    else:
        out, new_state = L.ssd_block_forward(lp["ssd"], h, cfg, state=state)
    return x + out, new_state


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
    h = L.apply_norm(lp["norm1"], x, cfg)
    attn_out, new_kv = L.attention_forward(
        lp["attn"], h, cfg, positions, window=window, kv_cache=kv_cache, cache_pos=cache_pos
    )
    if decode:
        ssd_out, new_state = L.ssd_block_decode(lp["ssd"], h, cfg, ssm_state)
    else:
        ssd_out, new_state = L.ssd_block_forward(lp["ssd"], h, cfg, state=ssm_state)
    x = x + 0.5 * (attn_out + ssd_out)
    x = x + L.mlp_forward(lp["mlp"], L.apply_norm(lp["norm2"], x, cfg), cfg)
    return x, new_kv, new_state


def _positions(b: int, s: int, device: torch.device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + s, dtype=torch.int32, device=device)[None].expand(b, s)


def _segments(n: int, g: int) -> list[tuple[int, int]]:
    """Split n layers into g contiguous segments (lengths differ by <=1)."""
    bounds = np.linspace(0, n, g + 1).astype(int)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(g)]


def _embed(params: Any, tokens: torch.Tensor, cfg: ModelConfig,
           prefix_embeds: torch.Tensor | None) -> torch.Tensor:
    """Token embeddings, behind the modality prefix (B, P, d) if given."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    if prefix_embeds is not None:
        prefix = shard_input(prefix_embeds.to(device=x.device, dtype=x.dtype),
                             ("batch", "res_seq", "embed"))
        x = torch.cat([prefix, x], dim=1)
    return x


def _attn_stacks(cfg: ModelConfig) -> list[tuple[str, bool]]:
    """(stack name, whether its layers are MoE) of the dense and moe families."""
    moe = cfg.family == "moe"
    return ([("dense_layers", False)] if moe and cfg.first_k_dense else []) + [("layers", moe)]


# ---------------------------------------------------------------------------
# Forward (scoring): full sequence, no cache
# ---------------------------------------------------------------------------
def forward(
    params: Any,
    tokens: torch.Tensor,  # (B, S) int
    cfg: ModelConfig,
    *,
    prefix_embeds: torch.Tensor | None = None,  # (B, P, d) modality stub
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S', vocab), aux_loss). S' = P + S with a prefix."""
    _require_decoder(cfg)
    x = _embed(params, tokens, cfg, prefix_embeds)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        layer = maybe_remat(_ssm_layer, cfg)
        for lp in params["layers"]:
            x, _ = layer(lp, x, cfg)
    elif cfg.family == "hybrid":
        x = _hybrid_forward_nocache(params, x, cfg, positions)
    else:
        layer = maybe_remat(_attn_mlp_layer, cfg)
        for stack, moe in _attn_stacks(cfg):
            for lp in params[stack]:
                x, aux, _ = layer(lp, x, cfg, positions, moe=moe, window=cfg.window)
                if moe:  # the reference sums the routed layers' losses only
                    aux_total = aux_total + aux
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg), aux_total


def _hybrid_forward_nocache(params, x, cfg, positions):
    """Global layers between contiguous SWA segments; the SWA layers under
    ``cfg.remat``, as the reference's scanned segments are."""
    n_glob, n_swa = _hybrid_split(cfg)
    swa_layer = maybe_remat(_hybrid_layer, cfg)
    for gi, (lo, hi) in enumerate(_segments(n_swa, max(n_glob, 1))):
        if n_glob and gi < n_glob:
            x, _, _ = _hybrid_layer(params["global_layers"][gi], x, cfg, positions, window=None)
        for li in range(lo, hi):
            x, _, _ = swa_layer(params["layers"][li], x, cfg, positions, window=cfg.window)
    return x


# ---------------------------------------------------------------------------
# KV / state caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device=None) -> dict:
    """Zeroed cache for decode. ``max_len`` is the KV capacity of the
    full-attention layers; SWA layers allocate only ``cfg.window``; SSD
    blocks O(1) state; MLA layers the compressed c_kv and k_rope.
    ``device=None`` means the CUDA card."""
    _require_decoder(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def kv_cache(n_layers: int, length: int) -> dict:
        return {"k": zeros(n_layers, batch, kv, length, hd),
                "v": zeros(n_layers, batch, kv, length, hd)}

    def ssm_state(n_layers: int) -> dict:
        conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        return {"conv": zeros(n_layers, batch, cfg.ssm_conv - 1, conv_dim),
                "ssm": zeros(n_layers, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim,
                             dt=torch.float32)}

    def mla_cache(n_layers: int) -> dict:
        return {"ckv": zeros(n_layers, batch, max_len, cfg.kv_lora_rank),
                "kr": zeros(n_layers, batch, max_len, cfg.qk_rope_dim)}

    if cfg.family == "ssm":
        return {"ssm": ssm_state(cfg.num_layers)}
    if cfg.family == "hybrid":
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
    make = mla_cache if cfg.attn_kind == "mla" else (lambda n: kv_cache(n, max_len))
    cache = {"layers": make(cfg.num_layers - cfg.first_k_dense)}
    if cfg.first_k_dense:
        cache["dense_layers"] = make(cfg.first_k_dense)
    return cache


def _store_state(cache_ssm: dict, i: int, state: L.SSMState) -> None:
    assign(cache_ssm["conv"][i], state.conv)
    assign(cache_ssm["ssm"][i], state.ssm)


def _layer_cache(c: dict, i: int, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer i's views of a stacked KV (or MLA) cache: written in place."""
    if cfg.attn_kind == "mla":
        return c["ckv"][i], c["kr"][i]
    return c["k"][i], c["v"][i]


def _attn_stacks_cached(params, x, cfg, positions, cache, pos: int):
    """The dense and moe families' layers against their caches, from
    position ``pos`` (0 for prefill)."""
    for stack, moe in _attn_stacks(cfg):
        for i, lp in enumerate(params[stack]):
            x, _, _ = _attn_mlp_layer(lp, x, cfg, positions, moe=moe, window=cfg.window,
                                      kv_cache=_layer_cache(cache[stack], i, cfg), cache_pos=pos)
    return x


def _ssm_stack_cached(params, x, cfg, cache, decode: bool):
    for i, lp in enumerate(params["layers"]):
        st = L.SSMState(conv=cache["ssm"]["conv"][i], ssm=cache["ssm"]["ssm"][i])
        x, new_state = _ssm_layer(lp, x, cfg, state=st, decode=decode)
        _store_state(cache["ssm"], i, new_state)
    return x


# ---------------------------------------------------------------------------
# Prefill: full prompt -> (logits, populated cache)
# ---------------------------------------------------------------------------
def prefill(
    params: Any,
    tokens: torch.Tensor,  # (B, S)
    cfg: ModelConfig,
    cache: dict,
    *,
    prefix_embeds: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """Returns (logits of the last position (B, 1, vocab), the cache)."""
    _require_decoder(cfg)
    x = _embed(params, tokens, cfg, prefix_embeds)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    if cfg.family == "ssm":
        x = _ssm_stack_cached(params, x, cfg, cache, decode=False)
    elif cfg.family == "hybrid":
        x, cache = _hybrid_prefill(params, x, cfg, positions, cache)
    else:
        x = _attn_stacks_cached(params, x, cfg, positions, cache, 0)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x[:, -1:], cfg), cache


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
            tmp = (empty_as(kv_hd, swa_k.dtype, swa_k[li]),
                   empty_as(kv_hd, swa_v.dtype, swa_v[li]))
            x, new_kv, new_state = _hybrid_layer(
                params["layers"][li], x, cfg, positions, window=cfg.window,
                kv_cache=tmp, cache_pos=0, ssm_state=gssm)
            _store_state(cache["swa_ssm"], li, new_state)
            # ring[slot(p)] = kv[p] for the last `take` positions; index_copy_
            # puts the slot axis where it is (the reference's numpy-style
            # mixed indexing moves it first, which torch would not)
            L.index_copy(swa_k[li], 2, ring_slots, new_kv[0][:, :, s - take:, :])
            L.index_copy(swa_v[li], 2, ring_slots, new_kv[1][:, :, s - take:, :])
    # as the reference labels the ring: slot i holds position s - take + i,
    # which is where the positions sit only when s <= w or w divides s
    slotpos = cache["slotpos"]
    slotpos.fill_(-1)
    assign(slotpos[:take], torch.arange(s - take, s, dtype=torch.int32, device=x.device))
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
    _require_decoder(cfg)
    pos = int(pos)
    x = L.embed_tokens(params["embed"], tokens, cfg)
    positions = _positions(x.shape[0], 1, x.device, start=pos)
    if cfg.family == "ssm":
        x = _ssm_stack_cached(params, x, cfg, cache, decode=True)
    elif cfg.family == "hybrid":
        x, cache = _hybrid_decode(params, x, cfg, positions, cache, pos)
    else:
        x = _attn_stacks_cached(params, x, cfg, positions, cache, pos)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg), cache


def _ring_attention_decode(lp, h, cfg, positions, ring_k, ring_v, slotpos, pos: int):
    """SWA decode against a ring cache: O(window) memory and compute.
    Writes the new k/v into the ring and the position into ``slotpos``."""
    w = ring_k.shape[2]
    q, k, v = L.qkv_project(lp["attn"], h, cfg, positions)
    slot = pos % w
    L.write_cache(ring_k, k.transpose(1, 2), slot, 2)
    L.write_cache(ring_v, v.transpose(1, 2), slot, 2)
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
            h = L.apply_norm(lp["norm1"], x, cfg)
            attn_out = _ring_attention_decode(
                lp, h, cfg, positions, cache["swa"]["k"][li], cache["swa"]["v"][li],
                cache["slotpos"], pos)
            ssd_out, new_state = L.ssd_block_decode(
                lp["ssd"], h, cfg,
                L.SSMState(conv=cache["swa_ssm"]["conv"][li], ssm=cache["swa_ssm"]["ssm"][li]))
            _store_state(cache["swa_ssm"], li, new_state)
            x = x + 0.5 * (attn_out + ssd_out)
            x = x + L.mlp_forward(lp["mlp"], L.apply_norm(lp["norm2"], x, cfg), cfg)
    return x, cache
