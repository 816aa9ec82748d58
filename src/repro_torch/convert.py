"""Carry the reference's parameters across to the port.

The WSI pipeline has no learned weights: its parameters are the
``WSIConfig`` fields and the 3x3 stain inverse. The LM's weights come as
the reference's parameter pytree converted to numpy leaf by leaf. The
reference hands both over as plain values, so this module needs nothing of
the JAX package.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.configs.wsi import WSIConfig
from repro_torch.core.regions import host_tensor
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import HybridLM


def from_reference(
    cfg_fields: Mapping, minv: np.ndarray, device=None
) -> tuple[WSIConfig, torch.Tensor]:
    """(reference config fields, reference stain inverse) -> (the port's
    ``WSIConfig``, the stain inverse as a float32 (3, 3) tensor on ``device``)."""
    m = np.asarray(minv, dtype=np.float32)
    if m.shape != (3, 3):
        raise ValueError(f"stain inverse must be (3, 3), got {m.shape}")
    return WSIConfig(**dict(cfg_fields)), torch.as_tensor(m, device=resolve_device(device))


def lm_params_from_reference(tree: Mapping, cfg: ModelConfig, device=None) -> HybridLM:
    """The reference's LM parameter pytree, as nested dicts of numpy arrays
    (layer stacks as ``(L, ...)`` leaves), loaded into the port's model on
    ``device`` (``None``: the CUDA card). Every leaf must be there, with the
    spec's shape; nothing else may be."""
    model = HybridLM(cfg, device="meta").to_empty(device=resolve_device(device))
    seen = set()

    def load(dst: torch.Tensor, arr, name: str) -> None:
        src = host_tensor(np.asarray(arr))  # a JAX array's numpy view: copied
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: reference shape {tuple(src.shape)}, port {tuple(dst.shape)}")
        dst.copy_(src)
        seen.add(name)

    with torch.no_grad():
        for group in ("embed", "final_norm"):
            for leaf, arr in tree[group].items():
                load(model[group][leaf], arr, f"{group}.{leaf}")
        for stack in ("global_layers", "layers"):
            for sub, leaves in tree.get(stack, {}).items():
                for leaf, arr in leaves.items():
                    arr = np.asarray(arr)
                    if arr.shape[0] != len(model[stack]):
                        raise ValueError(f"{stack}.{sub}.{leaf}: {arr.shape[0]} layers in the "
                                         f"reference, {len(model[stack])} in the port")
                    for i, layer in enumerate(model[stack]):
                        load(layer[sub][leaf], arr[i], f"{stack}.{i}.{sub}.{leaf}")
    missing = {name for name, _ in model.named_parameters()} - seen
    if missing:
        raise ValueError(f"the reference tree lacks {sorted(missing)}")
    return model
