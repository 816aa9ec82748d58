"""Carry the reference's parameters across to the port.

The WSI pipeline has no learned weights: its parameters are the
``WSIConfig`` fields and the 3x3 stain inverse. The reference hands them
over as plain values (``dataclasses.asdict(WSIConfig(...))`` and
``ref.stain_inverse()``), so this module needs nothing of the JAX package.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.configs.wsi import WSIConfig
from repro_torch.device import resolve_device


def from_reference(
    cfg_fields: Mapping, minv: np.ndarray, device=None
) -> tuple[WSIConfig, torch.Tensor]:
    """(reference config fields, reference stain inverse) -> (the port's
    ``WSIConfig``, the stain inverse as a float32 (3, 3) tensor on ``device``)."""
    m = np.asarray(minv, dtype=np.float32)
    if m.shape != (3, 3):
        raise ValueError(f"stain inverse must be (3, 3), got {m.shape}")
    return WSIConfig(**dict(cfg_fields)), torch.as_tensor(m, device=resolve_device(device))
