"""Optimizers written out by hand (``repro.train.optim``): AdamW and
Adafactor, with the reference's global-norm clip and cosine schedule.

``torch.optim.AdamW`` is a different function (decay applied to ``p``
before the step, no global-norm clip, other defaults), so the reference's
update is written here, in float32, with the new parameters cast back to
the parameter dtype (bf16 at full size) and no master copy.

The form is functional, over the model's parameters by the reference's
leaf names (``convert.reference_leaves``: a dict of name -> tensor, or a
``LayerStack`` of a stack's per-layer tensors): ``init(params) -> state``,
``update(grads, state, params, lr) -> (params, state, metrics)``. The state
mirrors the reference's: a stack's moments are one stacked ``(L, ...)``
float32 tensor, ``count`` an int32 scalar, so a checkpoint holds the
reference's layout. ``update`` writes the new parameters and moments in
place (the parameters are the model's) and returns them.

On a device mesh the parameters, gradients and state are ``DTensor`` s,
each laid out as ``train.step.state_shardings`` says (AdamW's moments with
ZeRO-1's data shard on top of the parameter's); the same arithmetic runs on
them, and the writes go through each tensor's local shard
(``spec.assign``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator

import torch

from repro_torch.convert import LayerStack
from repro_torch.models.spec import assign, unstack


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    grad_clip: float = 1.0
    min_dim_size_to_factor: int = 128


# ---------------------------------------------------------------------------
# Trees of parameters: dicts of tensors and LayerStacks
# ---------------------------------------------------------------------------
def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, LayerStack):
        yield from tree
    else:
        yield tree


def _map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves (tensors and LayerStacks) of dicts of one
    structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _shape(p: torch.Tensor | LayerStack) -> tuple[int, ...]:
    return (len(p), *p[0].shape) if isinstance(p, LayerStack) else tuple(p.shape)


def _device(tree: Any) -> torch.device:
    return next(_tensors(tree)).device


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in _tensors(tree)))


def _clip_scale(grads: Any, max_norm: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(min(1, max_norm / norm), the global norm)."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0), norm


def clip_by_global_norm(tree: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """(the tree in float32 scaled to a global norm of at most ``max_norm``,
    the norm before)."""
    scale, norm = _clip_scale(tree, max_norm)

    def clip(g):
        if isinstance(g, LayerStack):
            return LayerStack(t.float() * scale for t in g)
        return g.float() * scale

    return _map(clip, tree), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
class AdamW:
    def __init__(self, cfg: AdamWConfig | None = None) -> None:
        self.cfg = cfg or AdamWConfig()

    def init(self, params: Any) -> dict:
        def zeros(p):
            return torch.zeros(_shape(p), dtype=self.cfg.state_dtype, device=_device(p))

        return {"m": _map(zeros, params), "v": _map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=_device(params))}

    @torch.no_grad()
    def update(self, grads: Any, state: dict, params: Any, lr=None):
        c = self.cfg
        lr = c.lr if lr is None else lr
        scale, norm = _clip_scale(grads, c.grad_clip)
        count = state["count"] + 1
        b1c = 1.0 - torch.pow(c.b1, count.float())
        b2c = 1.0 - torch.pow(c.b2, count.float())

        def upd(p, g, m, v):
            """A stack's layers are stacked for the update, as its moments are."""
            stacked = isinstance(p, LayerStack)
            p32 = torch.stack([t.float() for t in p]) if stacked else p.float()
            g = (torch.stack([t.float() for t in g]) if stacked else g.float()) * scale
            m_new = c.b1 * m.float() + (1 - c.b1) * g
            v_new = c.b2 * v.float() + (1 - c.b2) * g * g
            step = (m_new / b1c) / (torch.sqrt(v_new / b2c) + c.eps) + c.weight_decay * p32
            p_new = p32 - lr * step
            for dst, src in zip(p, unstack(p_new)) if stacked else [(p, p_new)]:
                assign(dst, src.to(dst.dtype))
            assign(m, m_new.to(m.dtype))
            assign(v, v_new.to(v.dtype))

        _map(upd, params, grads, state["m"], state["v"])
        return params, {"m": state["m"], "v": state["v"], "count": count}, {"grad_norm": norm}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment: O(n+m) state for (n, m) matrices)
# ---------------------------------------------------------------------------
class Adafactor:
    """The reference's Adafactor on each of its leaves: a stack's per-layer
    tensors are stacked for the update (the factoring looks at the stacked
    shape, and the RMS clip spans the stack), and the result is written
    back layer by layer."""

    def __init__(self, cfg: AdafactorConfig | None = None) -> None:
        self.cfg = cfg or AdafactorConfig()

    def _factored(self, shape: tuple[int, ...]) -> bool:
        return (
            len(shape) >= 2
            and shape[-1] >= self.cfg.min_dim_size_to_factor
            and shape[-2] >= self.cfg.min_dim_size_to_factor
        )

    def init(self, params: Any) -> dict:
        def mk(p):
            shape = _shape(p)

            def zeros(s):
                return torch.zeros(s, dtype=torch.float32, device=_device(p))

            if self._factored(shape):
                return {"vr": zeros(shape[:-1]), "vc": zeros(shape[:-2] + shape[-1:])}
            return {"v": zeros(shape)}

        return {"v": _map(mk, params),
                "count": torch.zeros((), dtype=torch.int32, device=_device(params))}

    @torch.no_grad()
    def update(self, grads: Any, state: dict, params: Any, lr=None):
        c = self.cfg
        lr = c.lr if lr is None else lr
        scale, norm = _clip_scale(grads, c.grad_clip)
        count = state["count"] + 1
        rho = 1.0 - torch.pow(count.float(), -c.decay)

        def upd(p, g, v):
            stacked = isinstance(p, LayerStack)
            p32 = torch.stack([t.float() for t in p]) if stacked else p.float()
            g = (torch.stack([t.float() for t in g]) if stacked else g.float()) * scale
            g2 = g * g + c.eps
            if "vr" in v:
                vr = rho * v["vr"] + (1 - rho) * g2.mean(dim=-1)
                vc = rho * v["vc"] + (1 - rho) * g2.mean(dim=-2)
                denom = (vr[..., :, None]
                         / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None], min=1e-30)
                         ) * vc[..., None, :]
                update = g * torch.rsqrt(torch.clamp(denom, min=1e-30))
                assign(v["vr"], vr)
                assign(v["vc"], vc)
            else:
                vv = rho * v["v"] + (1 - rho) * g2
                update = g * torch.rsqrt(torch.clamp(vv, min=1e-30))
                assign(v["v"], vv)
            # update clipping (RMS <= 1)
            rms = torch.sqrt(torch.mean(update * update) + 1e-30)
            p_new = p32 - lr * (update / torch.clamp(rms, min=1.0))
            for dst, src in zip(p, unstack(p_new)) if stacked else [(p, p_new)]:
                assign(dst, src.to(dst.dtype))

        _map(upd, params, grads, state["v"])
        return params, {"v": state["v"], "count": count}, {"grad_norm": norm}


def cosine_lr(step, *, base: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup + cosine decay to ``floor * base``, in float32."""
    step_f = torch.as_tensor(step).float()
    warm = step_f / max(warmup, 1)
    prog = torch.clamp((step_f - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return base * torch.where(step_f < warmup, warm, cos)
