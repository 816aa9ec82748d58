"""Training step: loss, gradients, optimizer update, sharding derivation
(``repro.train.step``).

The state is ``{"params": model, "opt": optimizer state,
"step": int32 scalar}``; the model's parameters, built with
``requires_grad=False`` for serving, have gradients turned on here.
Gradients come from autograd through the plain versions of the kernels
(``attn_impl="torch"``), as the reference trains on its ``"xla"`` default:
no kernel has a backward yet, and a CUDA kernel refuses a tensor that
autograd records (``kernels._build.require``). Layers are rematerialised
as ``cfg.remat`` says (``transformer.maybe_remat``). Microbatches
accumulate their gradients in float32, as the reference's ``lax.scan``.

On a device mesh (``shard_state``, under ``spec.activation_sharding``) the
parameters are DTensors laid out by the rule table and the optimizer's
state by ``state_shardings``: AdamW's moments take the parameter's layout
plus, with **ZeRO-1**, a data-axis shard on the largest dim still
replicated; Adafactor's factored state is replicated, as the reference's.
The gradients come out of autograd as ``Partial`` sums over the data axes;
redistributing them to the parameters' layout is the data-parallel
all-reduce.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.convert import LayerStack, reference_leaves
from repro_torch.models import encdec, registry, spec, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import DEFAULT_RULES, P, PartitionSpec, logical_to_pspec


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 1e-4):
    """Mean CE over labels >= 0; logits upcast to float32; small z-loss.
    Returns (CE + z-loss, CE)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = spec.local_region(
        partial(_gold, vocab=logits.shape[-1]), (("batch", "seq", "vocab"), ("batch", "seq")),
        (spec.Out(("batch", "seq"), partial=("vocab",)),))(logits, labels)
    nll = lse - gold
    mask = (labels >= 0).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = (nll * mask).sum() / denom
    zl = z_loss * ((lse * mask) ** 2).sum() / denom
    return ce + zl, ce


def _gold(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """The logit of each label (labels < 0 read class 0) from the rank's
    slice of the ``vocab`` classes; 0 where the label lies in another
    rank's, so the ranks' results sum to the whole."""
    v0, vl = spec.shard_offset("vocab", vocab)
    local = torch.clamp(labels, min=0).long() - v0
    held = (local >= 0) & (local < vl)
    gold = torch.gather(logits, -1, torch.where(held, local, 0)[..., None])[..., 0]
    return torch.where(held, gold, 0.0)


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
    total, ce = cross_entropy(logits, spec.shard_input(batch["labels"], ("batch", "seq")))
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


def abstract_state(cfg: ModelConfig, optim) -> dict:
    """The state on the meta device (the dry run: nothing allocated)."""
    model = registry.build(cfg, device="meta").requires_grad_(True)
    return {"params": model, "opt": optim.init(reference_leaves(model)),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def _zero1_extend(pspec: PartitionSpec, shape: tuple[int, ...], mesh, rules) -> PartitionSpec:
    """Add a ('pod','data') shard on the largest still-replicated dim."""
    sizes = spec.mesh_axes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    if not dp_axes:
        return pspec
    total = math.prod(sizes[a] for a in dp_axes)
    parts = list(pspec) + [None] * (len(shape) - len(pspec))
    # pick the largest replicated dim divisible by the dp extent
    cands = [(shape[i], i) for i in range(len(shape)) if parts[i] is None and shape[i] % total == 0]
    if not cands:
        return pspec
    _, dim = max(cands)
    parts[dim] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def _leaf_specs(spec_tree: dict) -> dict[str, spec.ParamSpec]:
    """The spec tree's leaves by the reference's "/"-joined leaf names, the
    keys of the optimizers' state."""
    out: dict[str, spec.ParamSpec] = {}

    def walk(tree, prefix):
        if isinstance(tree, spec.ParamSpec):
            out["/".join(prefix)] = tree
            return
        for k in sorted(tree):
            walk(tree[k], prefix + (k,))

    walk(spec_tree, ())
    return out


def state_pspecs(cfg: ModelConfig, mesh, optim, *, zero1: bool = False, rules=None) -> dict:
    """PartitionSpecs of a train state: ``params`` as the spec tree (the
    reference's nested layout), ``opt`` as the optimizer's state (leaves by
    "/"-joined name), ``step`` replicated."""
    rules = rules or DEFAULT_RULES
    spec_tree = registry.abstract_params(cfg)

    def opt_leaf_ps(s: spec.ParamSpec) -> PartitionSpec:
        ps = logical_to_pspec(s.axes, mesh, rules, shape=s.shape)
        return _zero1_extend(ps, s.shape, mesh, rules) if zero1 else ps

    leaves = _leaf_specs(spec_tree)
    opt_struct = abstract_state(cfg, optim)["opt"]
    if "m" in opt_struct:  # AdamW
        moments = {name: opt_leaf_ps(s) for name, s in leaves.items()}
        opt_ps = {"m": moments, "v": dict(moments), "count": P()}
    else:  # Adafactor: factored states replicate (they are tiny)
        opt_ps = {"v": {name: {k: P() for k in v} for name, v in opt_struct["v"].items()},
                  "count": P()}
    return {"params": spec.partition_specs(spec_tree, mesh, rules), "opt": opt_ps, "step": P()}


def _map_pspecs(fn, tree):
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    return {k: _map_pspecs(fn, v) for k, v in tree.items()}


def state_shardings(cfg: ModelConfig, mesh, optim, *, zero1: bool = False, rules=None) -> dict:
    """The placements of every leaf of :func:`state_pspecs`."""
    return _map_pspecs(lambda ps: spec.to_placements(ps, mesh),
                       state_pspecs(cfg, mesh, optim, zero1=zero1, rules=rules))


def batch_pspecs(cfg: ModelConfig, mesh, shape_batch: int, rules=None) -> dict:
    rules = rules or DEFAULT_RULES
    dp = logical_to_pspec(("batch",), mesh, rules, shape=(shape_batch,))
    b = dp[0] if len(dp) else None
    out = {"tokens": P(b), "labels": P(b)}
    if cfg.family == "encdec":
        out["frames"] = P(b)
    if cfg.frontend:
        out["prefix"] = P(b)
    return out


def shard_state(state: dict, cfg: ModelConfig, mesh, optim, *, zero1: bool = False,
                rules=None) -> dict:
    """A train state (every rank holding it whole, as ``init_state`` makes it
    from one seed) laid out on ``mesh`` by :func:`state_shardings`: the
    model's parameters (``transformer.shard_params``), the optimizer's state
    and the step. The state as it is on a trivial mesh."""
    if spec.is_trivial(mesh):
        return state
    placements = state_shardings(cfg, mesh, optim, zero1=zero1, rules=rules)

    def lay(tree, pl):
        if isinstance(tree, dict):
            return {k: lay(v, pl[k]) for k, v in tree.items()}
        return spec.distribute(tree, mesh, pl)

    transformer.shard_params(state["params"], mesh, rules)
    return {"params": state["params"], "opt": lay(state["opt"], placements["opt"]),
            "step": lay(state["step"], placements["step"])}


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
def _grads(leaves: dict, as_float: bool) -> dict:
    """The parameters' gradients by leaf (zeros where a parameter got none);
    a DTensor's laid out as its parameter (the data-parallel all-reduce of
    its ``Partial`` sums)."""
    def grad(p):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if isinstance(g, DTensor):
            g = g.redistribute(p.device_mesh, p.placements)
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
        metrics = {k: spec.full(v) for k, v in metrics.items()}
        return {"params": model, "opt": new_opt, "step": state["step"] + 1}, metrics

    return step


def make_eval_step(cfg: ModelConfig) -> Callable[[Any, dict], dict]:
    @torch.no_grad()
    def step(params: Any, batch: dict) -> dict:
        _, metrics = loss_fn(params, batch, cfg)
        return metrics

    return step
