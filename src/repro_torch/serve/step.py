"""Serving substrate: cache construction and its shardings, prefill/decode
steps, and a batched generation loop (``repro.serve.step``).

``decode_*`` / ``long_*`` dry-run shapes trace these serve steps (one new
token against a populated cache), as the reference lowers them.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, spec, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import DEFAULT_RULES, P, PartitionSpec


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *, enc_len: int = 4096,
               device=None) -> dict:
    """Zeroed decode cache on ``device`` (``None``: the CUDA card); an
    encoder-decoder's also holds ``enc_len`` cross K/V positions."""
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, max_len, enc_len, device=device)
    return transformer.init_cache(cfg, batch, max_len, device=device)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, *, enc_len: int = 4096) -> dict:
    """The cache on the meta device (the dry run: nothing allocated)."""
    return make_cache(cfg, batch, max_len, enc_len=enc_len, device="meta")


def _divisible(n: int, mesh, axes) -> bool:
    sizes = spec.mesh_axes(mesh)
    names = [a for a in (axes if isinstance(axes, tuple) else (axes,)) if a in sizes]
    if not names:
        return False
    return n % math.prod(sizes[a] for a in names) == 0


def _map_with_key(fn: Callable[[str, Any], Any], tree: Any, key: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_key(fn, v, k) for k, v in tree.items()}
    return fn(key, tree)


def cache_pspecs(
    cfg: ModelConfig, cache: Any, mesh, rules=None, *, seq_shard: bool = False
) -> Any:
    """PartitionSpecs for a cache tree: batch over (pod, data), heads /
    inner dims over model where divisible.

    ``seq_shard=True`` shards the cache *sequence* dim over "model" when
    the kv-head dim cannot use it (MQA/GQA with kv < model size): decode
    attention then runs sequence-parallel (DTensor reduces the softmax
    across the shards) and per-rank cache traffic drops by the model size.
    """
    rules = rules or DEFAULT_RULES
    names = tuple(mesh.mesh_dim_names)
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp_spec = dp if len(dp) > 1 else (dp[0] if dp else None)
    tp = "model" if "model" in names else None

    def leaf_ps(key: str, leaf) -> PartitionSpec:
        shape = leaf.shape
        batch_ok = len(shape) >= 2 and _divisible(shape[1], mesh, dp)
        b = dp_spec if batch_ok else None
        if key in ("k", "v", "xk", "xv"):  # (L, B, kv, T, hd)
            if tp and _divisible(shape[2], mesh, tp):
                return P(None, b, tp, None, None)
            if seq_shard and tp and _divisible(shape[3], mesh, tp):
                return P(None, b, None, tp, None)
            return P(None, b, None, None, None)
        if key in ("ckv", "kr"):  # (L, B, T, r)
            if seq_shard and tp and _divisible(shape[2], mesh, tp):
                return P(None, b, tp, None)
            return P(None, b, None, None)
        if key == "conv":  # (L, B, ck, conv_dim)
            cd_ok = tp and _divisible(shape[3], mesh, tp)
            return P(None, b, None, tp if cd_ok else None)
        if key == "ssm":  # (L, B, H, N, P)
            h_ok = tp and _divisible(shape[2], mesh, tp)
            return P(None, b, tp if h_ok else None, None, None)
        return P()

    return _map_with_key(leaf_ps, cache)


def cache_shardings(
    cfg: ModelConfig, cache: Any, mesh, rules=None, *, seq_shard: bool = False
) -> Any:
    """The placements of every leaf of a cache tree."""
    return _map_with_key(lambda _, ps: spec.to_placements(ps, mesh),
                         cache_pspecs(cfg, cache, mesh, rules, seq_shard=seq_shard))


def shard_tree(tree: Any, mesh, placements: Any) -> Any:
    """Every tensor of a nested dict as a DTensor laid out by the matching
    placements (``spec.distribute``: each rank keeps its box of the tensor
    it holds whole); the tree as it is on a trivial mesh."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, mesh, placements[k]) for k, v in tree.items()}
    return spec.distribute(tree, mesh, placements)


def make_prefill_step(cfg: ModelConfig) -> Callable:
    if cfg.family == "encdec":
        def prefill(params, batch, cache):
            return encdec.prefill(params, batch["frames"], batch["tokens"], cfg, cache)

        return prefill

    def prefill(params, batch, cache):
        prefix = batch.get("prefix") if cfg.frontend else None
        return transformer.prefill(params, batch["tokens"], cfg, cache, prefix_embeds=prefix)

    return prefill


def make_decode_step(cfg: ModelConfig) -> Callable:
    if cfg.family == "encdec":
        def decode(params, tokens, cache, pos):
            return encdec.decode_step(params, tokens, cfg, cache, pos)

        return decode

    def decode(params, tokens, cache, pos):
        return transformer.decode_step(params, tokens, cfg, cache, pos)

    return decode


def _model_device(params: Any) -> torch.device:
    return next(params.parameters()).device


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:<current>`` name one device."""
    def index(d: torch.device):
        return torch.cuda.current_device() if d.type == "cuda" and d.index is None else d.index

    return a.type == b.type and index(a) == index(b)


@torch.no_grad()
def generate(
    params: Any,
    cfg: ModelConfig,
    prompt,  # (B, S0) int tokens: a tensor or an array
    *,
    max_new: int = 16,
    max_len: int | None = None,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    prefix=None,  # (B, frontend_len, d_model) modality embeddings: a tensor or an array
    frames=None,  # (B, S_enc, d_model) encoder frames (encdec): a tensor or an array
    device=None,
    stats: dict | None = None,
) -> torch.Tensor:
    """Prefill the prompt, then ``max_new`` decode steps; greedy, or at
    ``temperature`` > 0 each token drawn from softmax(logits / temperature)
    with ``generator`` (a ``torch.Generator`` on ``device``; without one,
    greedy, as the reference without a key).

    Runs on ``device`` (``None``: the CUDA card; raises without one), where
    ``params`` (the model) must already be. Returns (B, S0 + max_new) int32
    tokens. With a ``prefix`` (a config with a ``frontend``), the prefix sits
    before the prompt in the context: decode positions start at
    S0 + frontend_len, and the default cache holds S0 + frontend_len +
    max_new + 1 positions (the reference's default leaves out the prefix, so
    its prefill does not fit; pass ``max_len`` to compare). An
    encoder-decoder takes its encoder's input as ``frames``, and its cross
    cache holds ``frames.shape[1]`` positions. Under
    ``spec.activation_sharding`` on a mesh (the model's parameters laid out
    by ``transformer.shard_params``), the cache is laid out by
    ``cache_shardings``, and every rank draws the same tokens (the same
    prompts and seed). If ``stats`` is given, it receives ``prefill_s``
    and ``decode_s``, host times around work that ends in a device
    synchronisation.
    """
    dev = resolve_device(device)
    if not _same_device(_model_device(params), dev):
        raise ValueError(f"the model is on {_model_device(params)}, generate runs on {dev}")
    prompt = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
    b, s0 = prompt.shape
    batch = {"tokens": prompt}
    pos_offset = 0
    if prefix is not None and cfg.frontend:
        batch["prefix"] = torch.as_tensor(prefix, device=dev)
        if tuple(batch["prefix"].shape) != (b, cfg.frontend_len, cfg.d_model):
            raise ValueError(f"prefix of shape {tuple(batch['prefix'].shape)}; {cfg.name} "
                             f"takes ({b}, {cfg.frontend_len}, {cfg.d_model})")
        pos_offset = cfg.frontend_len
    enc_len = 64  # the reference's cross cache without frames
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass its encoder frames")
        batch["frames"] = torch.as_tensor(frames, device=dev)
        enc_len = batch["frames"].shape[1]
    max_len = max_len or (s0 + pos_offset + max_new + 1)

    def clock() -> float:
        if stats is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = clock()
    cache = make_cache(cfg, b, max_len, enc_len=enc_len, device=dev)
    ctx = spec.current_mesh()
    if ctx is not None:
        mesh, rules = ctx
        cache = shard_tree(cache, mesh, cache_shardings(cfg, cache, mesh, rules))
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    logits, cache = prefill(params, batch, cache)
    out = [prompt]
    tok = _sample(spec.full(logits)[:, -1], temperature, generator)
    t1 = clock()
    for i in range(max_new):
        out.append(tok)
        logits, cache = decode(params, tok, cache, s0 + pos_offset + i)
        tok = _sample(spec.full(logits)[:, -1], temperature, generator)
    t2 = clock()
    if stats is not None:
        stats["prefill_s"] = t1 - t0
        stats["decode_s"] = t2 - t1
    return torch.cat(out, dim=1)


def _sample(logits: torch.Tensor, temperature: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """(B, 1) int32 tokens. Greedy (the first index of the largest logit, as
    jnp.argmax picks) at temperature 0 or without a generator; else one draw
    a row from softmax(logits / temperature), computed in float32. The draws
    follow the reference's distribution, not its ``jax.random`` stream."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)
