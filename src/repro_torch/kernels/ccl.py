"""Connected component labeling on the card: wrapper of ``csrc/ccl.cu``.

Replaces ``repro.kernels.ccl.ccl_pallas`` (and its sweep kernel) with the
paper's union-find BWLabel. The labels are canonical: each component gets its
minimum flat index, the background -1, as ``ref.ccl_unionfind_host`` gives.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last reset


def ccl_cuda(mask: torch.Tensor) -> torch.Tensor:
    """(H, W) int32 mask (nonzero = foreground) -> (H, W) int32 labels."""
    global launches
    _build.require(mask, "ccl mask", torch.int32, 2)
    h, w = mask.shape
    if h * w >= 2**31:
        raise ValueError(f"ccl: {h}x{w} has flat indices beyond int32")
    labels = torch.empty_like(mask)
    with torch.cuda.device(mask.device):
        code = _build.lib().rt_ccl(mask.data_ptr(), labels.data_ptr(), h, w, _build.stream(mask))
        launches += 1
    _build.check(code, "ccl")
    return labels
