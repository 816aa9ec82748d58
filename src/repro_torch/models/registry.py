"""Family dispatch + parameter accounting (``repro.models.registry``)."""
from __future__ import annotations

import math

from repro_torch.models import spec, transformer
from repro_torch.models.config import ModelConfig


def abstract_params(cfg: ModelConfig) -> dict:
    """The spec tree of ``cfg``'s family (the hybrid family so far)."""
    return transformer.abstract_params(cfg)


def count_params(cfg: ModelConfig) -> int:
    """Parameter count from the spec tree; allocates nothing."""
    return int(sum(math.prod(s.shape) for s in spec.leaves(abstract_params(cfg))))
