"""Family dispatch + parameter accounting (``repro.models.registry``)."""
from __future__ import annotations

import math

from repro_torch.models import spec, transformer
from repro_torch.models.config import ModelConfig


def abstract_params(cfg: ModelConfig) -> dict:
    """The spec tree of ``cfg``'s family (the decoder-only families)."""
    return transformer.abstract_params(cfg)


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
