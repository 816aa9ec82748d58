"""Gradient compression collectives for slow (cross-pod) links
(``repro.train.compression``).

At 2+ pods the ``pod`` axis rides the slow network between hosts;
compressing the cross-pod gradient all-reduce is the standard
distributed-optimization trick. Here each is one ``dist.all_reduce`` over
the process group of one mesh axis (``mesh.get_group(axis)``), on plain
tensors (each rank's local values):

  * ``fp32`` — plain sum (baseline);
  * ``bf16`` — cast to bf16, sum, cast back (2x bytes saved);
  * ``int8`` — each rank quantizes with its *own* per-tensor max-abs scale
               and the ranks sum the dequantized ``q * scale`` in float32.

The int8 mode computes what the reference's code computes, which is not
what its docstring says (int32 accumulators and a summed scale): the sum
runs in float32 over each rank's ``q * scale``, so its wire bytes are
float32's; ``compression_ratio`` reports the ratio the mode is named for.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


def compressed_psum(x: torch.Tensor, axis: str, mode: str = "fp32", mesh=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks along mesh axis ``axis`` (every rank
    gets it), in ``mode``; ``x`` is left as it is."""
    group = mesh.get_group(axis)
    if mode == "fp32":
        out = x.clone()
    elif mode == "bf16":
        out = x.to(torch.bfloat16)
    elif mode == "int8":
        x32 = x.float()
        scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
        out = q.to(torch.int32).float() * scale
    else:
        raise ValueError(f"unknown compression mode {mode!r}")
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


def compressed_psum_tree(tree: Any, axis: str, mode: str = "fp32", mesh=None) -> Any:
    """:func:`compressed_psum` over every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: compressed_psum_tree(v, axis, mode, mesh) for k, v in tree.items()}
    return compressed_psum(tree, axis, mode, mesh)


def compression_ratio(mode: str) -> float:
    return {"fp32": 1.0, "bf16": 2.0, "int8": 4.0}[mode]


def make_dp_allreduce(mesh, *, pod_mode: str = "bf16"):
    """Hierarchical gradient reduction: fp32 within a pod, compressed
    across pods. Returns a function of a nested dict of each rank's local
    gradients."""
    has_pod = "pod" in mesh.mesh_dim_names

    def reduce_tree(local_grads: Any) -> Any:
        g = compressed_psum_tree(local_grads, "data", "fp32", mesh)
        if has_pod:
            g = compressed_psum_tree(g, "pod", pod_mode, mesh)
        return g

    return reduce_tree
