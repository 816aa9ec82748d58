"""ParamSpec machinery: one source of truth for parameter shapes and init.

``abstract_params(cfg)`` (per family) returns a tree of :class:`ParamSpec`
leaves carrying shape, dtype, logical axes and an init rule; from it come
randomly initialized tensors (``materialize``) and the parameter count.
The logical axes are kept for the sharding rules of a later slice
(``repro.models.spec``'s mesh half); nothing here reads them yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis names, len == len(shape)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | small
    scale: float | None = None  # stddev override

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} rank != shape {self.shape}")


def leaves(tree: Any) -> list[ParamSpec]:
    """The spec leaves of a nested dict, in insertion order."""
    if isinstance(tree, ParamSpec):
        return [tree]
    return [leaf for sub in tree.values() for leaf in leaves(sub)]


def materialize_leaf(
    spec: ParamSpec,
    generator: torch.Generator | None,
    device: torch.device,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """One randomly initialized tensor on ``device``; draws from
    ``generator`` (which must live on ``device``'s type). On the meta device
    nothing is drawn or allocated."""
    dtype = dtype or spec.dtype
    if device.type == "meta":
        return torch.empty(spec.shape, dtype=dtype, device=device)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    noise = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
    if spec.init == "small":
        std = 0.002
    else:
        fan_in = spec.shape[0] if spec.shape else 1
        std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return (noise * std).to(dtype)


def materialize(
    tree: Any,
    generator: torch.Generator | None,
    *,
    device: torch.device | str = "cpu",
    dtype_override: torch.dtype | None = None,
) -> Any:
    """Random-init every ParamSpec leaf of a nested dict, in insertion order.

    The draws cannot equal the reference's ``jax.random`` folding; tests that
    compare the two packages carry the reference's parameters across
    (``convert.lm_params_from_reference``).
    """
    device = torch.device(device)
    if isinstance(tree, ParamSpec):
        return materialize_leaf(tree, generator, device, dtype_override)
    return {k: materialize(v, generator, device=device, dtype_override=dtype_override)
            for k, v in tree.items()}
