"""Serving substrate: cache construction, prefill/decode steps, and a
batched greedy generation loop (``repro.serve.step`` without the sharding
half, which comes with the device mesh of a later slice)."""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *, enc_len: int = 4096,
               device=None) -> dict:
    """Zeroed decode cache on ``device`` (``None``: the CUDA card); an
    encoder-decoder's also holds ``enc_len`` cross K/V positions."""
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, max_len, enc_len, device=device)
    return transformer.init_cache(cfg, batch, max_len, device=device)


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
    prefix=None,  # (B, frontend_len, d_model) modality embeddings: a tensor or an array
    frames=None,  # (B, S_enc, d_model) encoder frames (encdec): a tensor or an array
    device=None,
    stats: dict | None = None,
) -> torch.Tensor:
    """Greedy generation: prefill the prompt, then ``max_new`` decode steps.

    Runs on ``device`` (``None``: the CUDA card; raises without one), where
    ``params`` (the model) must already be. Returns (B, S0 + max_new) int32
    tokens. With a ``prefix`` (a config with a ``frontend``), the prefix sits
    before the prompt in the context: decode positions start at
    S0 + frontend_len, and the default cache holds S0 + frontend_len +
    max_new + 1 positions (the reference's default leaves out the prefix, so
    its prefill does not fit; pass ``max_len`` to compare). An
    encoder-decoder takes its encoder's input as ``frames``, and its cross
    cache holds ``frames.shape[1]`` positions. If ``stats`` is
    given, it receives ``prefill_s`` and ``decode_s``, host times around
    work that ends in a device synchronisation.
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
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    logits, cache = prefill(params, batch, cache)
    out = [prompt]
    tok = _sample(logits[:, -1], temperature)
    t1 = clock()
    for i in range(max_new):
        out.append(tok)
        logits, cache = decode(params, tok, cache, s0 + pos_offset + i)
        tok = _sample(logits[:, -1], temperature)
    t2 = clock()
    if stats is not None:
        stats["prefill_s"] = t1 - t0
        stats["decode_s"] = t2 - t1
    return torch.cat(out, dim=1)


def _sample(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """Greedy: the first index of the largest logit, as jnp.argmax picks."""
    if temperature > 0.0:
        raise NotImplementedError(
            "sampling at temperature > 0 is not ported (jax.random's draws cannot be "
            "reproduced); use temperature 0")
    return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
