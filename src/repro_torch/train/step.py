"""Training step: loss, gradients, optimizer update (``repro.train.step``
without its sharding half: ``state_pspecs``, ``state_shardings``,
``batch_pspecs`` and ZeRO-1's ``_zero1_extend`` come with the device mesh
of a later slice).

One card. The state is ``{"params": model, "opt": optimizer state,
"step": int32 scalar}``; the model's parameters, built with
``requires_grad=False`` for serving, have gradients turned on here.
Gradients come from autograd through the plain versions of the kernels
(``attn_impl="torch"``), as the reference trains on its ``"xla"`` default:
no kernel has a backward yet, and a CUDA kernel refuses a tensor that
autograd records (``kernels._build.require``). Layers are rematerialised
as ``cfg.remat`` says (``transformer.maybe_remat``). Microbatches
accumulate their gradients in float32, as the reference's ``lax.scan``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.convert import LayerStack, reference_leaves
from repro_torch.models import encdec, registry, transformer
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 1e-4):
    """Mean CE over labels >= 0; logits upcast to float32; small z-loss.
    Returns (CE + z-loss, CE)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = lse - gold
    mask = (labels >= 0).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = (nll * mask).sum() / denom
    zl = z_loss * ((lse * mask) ** 2).sum() / denom
    return ce + zl, ce


def loss_fn(params: Any, batch: dict, cfg: ModelConfig):
    """(loss, metrics) of a batch {"tokens", "labels"} (+ "frames" for an
    encoder-decoder, + "prefix" for a frontend, whose logits are dropped)."""
    if cfg.family == "encdec":
        logits, aux = encdec.forward(params, batch["frames"], batch["tokens"], cfg)
    elif cfg.frontend:
        logits, aux = transformer.forward(params, batch["tokens"], cfg,
                                          prefix_embeds=batch["prefix"])
        logits = logits[:, cfg.frontend_len:]
    else:
        logits, aux = transformer.forward(params, batch["tokens"], cfg)
    total, ce = cross_entropy(logits, batch["labels"])
    return total + aux, {"loss": total + aux, "ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------
def init_state(cfg: ModelConfig, optim, *, seed: int = 0, device=None) -> dict:
    """A fresh model of ``cfg`` (random weights from ``seed``) on ``device``
    (``None``: the CUDA card), gradients on, with ``optim``'s state."""
    model = registry.build(cfg, device=device, seed=seed).requires_grad_(True)
    return {"params": model, "opt": optim.init(reference_leaves(model)),
            "step": torch.zeros((), dtype=torch.int32, device=next(model.parameters()).device)}


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
def _grads(leaves: dict, as_float: bool) -> dict:
    """The parameters' gradients by leaf (zeros where a parameter got none)."""
    def grad(p):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        return g.float() if as_float else g

    return {name: LayerStack(grad(t) for t in p) if isinstance(p, LayerStack) else grad(p)
            for name, p in leaves.items()}


def _each(p) -> tuple | LayerStack:
    """The tensors of a leaf: a LayerStack's, or the one tensor."""
    return p if isinstance(p, LayerStack) else (p,)


def _clear_grads(leaves: dict) -> None:
    for p in leaves.values():
        for t in _each(p):
            t.grad = None


def make_train_step(
    cfg: ModelConfig,
    optim,
    *,
    microbatches: int = 1,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> Callable[[dict, dict], tuple[dict, dict]]:
    """Returns ``step(state, batch) -> (state, metrics)``; the model's
    parameters and the optimizer's state are updated in place."""

    def grads_of(model, leaves, batch) -> tuple[dict, dict]:
        """Gradients in the parameter dtype (float32 when microbatched, as
        the reference's accumulator) and the detached metrics."""
        _clear_grads(leaves)
        with torch.enable_grad():
            loss, metrics = loss_fn(model, batch, cfg)
            loss.backward()
        return _grads(leaves, as_float=microbatches > 1), {k: v.detach() for k, v in
                                                           metrics.items()}

    def accumulate(model, leaves, batch) -> tuple[dict, dict]:
        if microbatches <= 1:
            return grads_of(model, leaves, batch)
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
        acc, msum = None, None
        for i in range(microbatches):
            micro = {k: v.reshape(microbatches, b // microbatches, *v.shape[1:])[i]
                     for k, v in batch.items()}
            g, m = grads_of(model, leaves, micro)
            if acc is None:
                acc, msum = g, m
                continue
            for name, gi in g.items():
                for a, x in zip(_each(acc[name]), _each(gi)):
                    a.add_(x)
            msum = {k: msum[k] + m[k] for k in msum}
        inv = 1.0 / microbatches
        for a in acc.values():
            for t in _each(a):
                t.mul_(inv)
        return acc, {k: v * inv for k, v in msum.items()}

    def step(state: dict, batch: dict) -> tuple[dict, dict]:
        model = state["params"]
        leaves = reference_leaves(model)
        grads, metrics = accumulate(model, leaves, batch)
        lr = lr_schedule(state["step"]) if lr_schedule is not None else None
        _, new_opt, opt_metrics = optim.update(grads, state["opt"], leaves, lr)
        del grads
        _clear_grads(leaves)
        metrics.update(opt_metrics)
        if lr is not None:
            metrics["lr"] = lr
        return {"params": model, "opt": new_opt, "step": state["step"] + 1}, metrics

    return step


def make_eval_step(cfg: ModelConfig) -> Callable[[Any, dict], dict]:
    @torch.no_grad()
    def step(params: Any, batch: dict) -> dict:
        _, metrics = loss_fn(params, batch, cfg)
        return metrics

    return step
