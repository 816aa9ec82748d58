"""Family dispatch + parameter accounting (``repro.models.registry``), and
``build``, which makes a model of any family."""
from __future__ import annotations

import math

from torch import nn

from repro_torch.models import encdec, spec, transformer
from repro_torch.models.config import ModelConfig


def abstract_params(cfg: ModelConfig) -> dict:
    """The spec tree of ``cfg``'s family."""
    if cfg.family == "encdec":
        return encdec.abstract_params(cfg)
    return transformer.abstract_params(cfg)


def build(cfg: ModelConfig, *, device=None, seed: int = 0) -> nn.Module:
    """The model of ``cfg``'s family, ``transformer.LM`` or
    ``encdec.EncDec``, with random weights from ``seed`` on ``device``
    (``None``: the CUDA card; ``"meta"`` allocates nothing)."""
    cls = encdec.EncDec if cfg.family == "encdec" else transformer.LM
    return cls(cfg, device=device, seed=seed)


def count_params(cfg: ModelConfig) -> int:
    """Parameter count from the spec tree; allocates nothing."""
    return int(sum(math.prod(s.shape) for s in spec.leaves(abstract_params(cfg))))


def count_active_params(cfg: ModelConfig) -> int:
    """Activated params per token (MoE: only top-k of the routed experts)."""
    total = count_params(cfg)
    if cfg.family != "moe" or not cfg.num_experts:
        return total
    routed = sum(math.prod(s.shape) for s in spec.leaves(abstract_params(cfg))
                 if "experts" in s.axes)
    return int(total - routed * (1.0 - cfg.experts_per_token / cfg.num_experts))
