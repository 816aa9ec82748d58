"""Serving substrate: cache construction, prefill/decode steps, and a
batched greedy generation loop (``repro.serve.step`` without the sharding
half, which comes with the device mesh of a later slice)."""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None) -> dict:
    """Zeroed decode cache on ``device`` (``None``: the CUDA card)."""
    return transformer.init_cache(cfg, batch, max_len, device=device)


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill(params, batch, cache):
        return transformer.prefill(params, batch["tokens"], cfg, cache)

    return prefill


def make_decode_step(cfg: ModelConfig) -> Callable:
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
    device=None,
    stats: dict | None = None,
) -> torch.Tensor:
    """Greedy generation: prefill the prompt, then ``max_new`` decode steps.

    Runs on ``device`` (``None``: the CUDA card; raises without one), where
    ``params`` (the model) must already be. Returns (B, S0 + max_new) int32
    tokens. If ``stats`` is given, it receives ``prefill_s`` and ``decode_s``,
    host times around work that ends in a device synchronisation.
    """
    dev = resolve_device(device)
    if not _same_device(_model_device(params), dev):
        raise ValueError(f"the model is on {_model_device(params)}, generate runs on {dev}")
    prompt = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
    b, s0 = prompt.shape
    max_len = max_len or (s0 + max_new + 1)

    def clock() -> float:
        if stats is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = clock()
    cache = make_cache(cfg, b, max_len, device=dev)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    logits, cache = prefill(params, {"tokens": prompt}, cache)
    out = [prompt]
    tok = _sample(logits[:, -1], temperature)
    t1 = clock()
    for i in range(max_new):
        out.append(tok)
        logits, cache = decode(params, tok, cache, s0 + i)
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
