"""Carry the reference's parameters across to the port.

The WSI pipeline has no learned weights: its parameters are the
``WSIConfig`` fields and the 3x3 stain inverse. The LM's weights come as
the reference's parameter pytree converted to numpy leaf by leaf. The
reference hands both over as plain values, so this module needs nothing of
the JAX package. :func:`reference_leaves` names the port's parameters as the
reference's tree does, for the optimizers and the checkpoints.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.configs.wsi import WSIConfig
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build
from repro_torch.models.transformer import shard_params
from repro_torch.staging import host_tensor


def from_reference(
    cfg_fields: Mapping, minv: np.ndarray, device=None
) -> tuple[WSIConfig, torch.Tensor]:
    """(reference config fields, reference stain inverse) -> (the port's
    ``WSIConfig``, the stain inverse as a float32 (3, 3) tensor on ``device``)."""
    m = np.asarray(minv, dtype=np.float32)
    if m.shape != (3, 3):
        raise ValueError(f"stain inverse must be (3, 3), got {m.shape}")
    return WSIConfig(**dict(cfg_fields)), torch.as_tensor(m, device=resolve_device(device))


def lm_params_from_reference(tree: Mapping, cfg: ModelConfig, device=None, *, mesh=None,
                             rules: dict | None = None) -> torch.nn.Module:
    """The reference's parameter pytree, as nested dicts of numpy arrays
    (layer stacks as ``(L, ...)`` leaves: ``layers``, ``dense_layers``,
    ``global_layers``, and the encoder-decoder's ``enc_layers`` and
    ``dec_layers``), loaded into the port's model of ``cfg``'s family
    (``transformer.LM`` or ``encdec.EncDec``) on ``device`` (``None``: the
    CUDA card). Every leaf must be there, with the spec's shape; nothing else
    may be. With a ``mesh``, every rank passes the whole tree and keeps its
    shards (``transformer.shard_params`` under ``rules``)."""
    model = build(cfg, device="meta").to_empty(device=resolve_device(device))
    seen = set()

    def load(dst: torch.Tensor, arr, name: str) -> None:
        src = host_tensor(np.asarray(arr))  # a JAX array's numpy view: copied
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: reference shape {tuple(src.shape)}, port {tuple(dst.shape)}")
        dst.copy_(src)
        seen.add(name)

    def child(module: torch.nn.Module, key: str, name: str):
        if (key not in dict(module.named_children())
                and key not in dict(module.named_parameters(recurse=False))):
            raise ValueError(f"{name}: not a parameter of the port's {cfg.name}")
        return getattr(module, key)

    def walk(module: torch.nn.Module, sub: Mapping, name: str, layer=None) -> None:
        """Load ``sub`` into ``module``; ``layer`` picks one slice of a stacked leaf."""
        for key, val in sub.items():
            dst = child(module, key, f"{name}.{key}")
            if isinstance(val, Mapping):
                walk(dst, val, f"{name}.{key}", layer)
            else:
                load(dst, val if layer is None else np.asarray(val)[layer], f"{name}.{key}")

    with torch.no_grad():
        for group, sub in tree.items():
            dst = child(model, group, group)
            if not isinstance(dst, torch.nn.ModuleList):
                walk(dst, sub, group)
                continue
            depth = {np.asarray(v).shape[0] for v in _leaves(sub)}
            if depth != {len(dst)}:
                raise ValueError(f"{group}: {sorted(depth)} layers in the reference, "
                                 f"{len(dst)} in the port")
            for i, layer in enumerate(dst):  # a stack: leaves carry the layer axis first
                walk(layer, sub, f"{group}.{i}", layer=i)
    missing = {name for name, _ in model.named_parameters()} - seen
    if missing:
        raise ValueError(f"the reference tree lacks {sorted(missing)}")
    return model if mesh is None else shard_params(model, mesh, rules)


class LayerStack(list):
    """The per-layer tensors of one stacked leaf of the reference's tree: the
    reference holds them as one ``(L, ...)`` array, the port one tensor a
    layer (``nn.ModuleList``). The optimizers keep their state for it
    stacked, and the checkpoints write it stacked."""


def reference_leaves(model: torch.nn.Module) -> dict[str, torch.Tensor | LayerStack]:
    """``model``'s parameters by the reference's leaf names, the "/"-joined
    paths of its tree (``embed/tok``, ``layers/attn/wq``), in the order
    ``jax.tree_util`` flattens that tree (sorted keys, level by level). A
    layer stack's leaf is a :class:`LayerStack` of its L per-layer tensors,
    in order."""
    out: dict[tuple[str, ...], torch.Tensor | LayerStack] = {}
    for group, module in model.named_children():
        layers = module if isinstance(module, torch.nn.ModuleList) else None
        for sub in layers if layers is not None else [module]:
            for name, p in sub.named_parameters():
                path = (group, *name.split("."))
                if layers is None:
                    out[path] = p
                else:
                    out.setdefault(path, LayerStack()).append(p)
    return {"/".join(path): out[path] for path in sorted(out)}


def _leaves(tree: Mapping) -> list:
    return [leaf for v in tree.values()
            for leaf in (_leaves(v) if isinstance(v, Mapping) else [v])]
