"""GLCM and histogram counts on the card: wrapper of ``csrc/glcm.cu``.

Replaces ``repro.kernels.glcm.glcm_pallas``. The counts equal
``ref.glcm_ref`` and ``ref.histogram_ref`` exactly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last reset

# Shared memory one H100 block may use (227 KB); the kernel keeps
# (NB*NB + NB) int32 counters there, so NB <= 240.
MAX_SHARED_BYTES = 232_448


def glcm_cuda(bins: torch.Tensor, num_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) int32 bins -> (glcm (B, NB, NB), hist (B, NB)) float32 counts."""
    global launches
    _build.require(bins, "glcm bins", torch.int32, 3)
    b, h, w = bins.shape
    if (num_bins * num_bins + num_bins) * 4 > MAX_SHARED_BYTES or num_bins < 1:
        raise ValueError(f"glcm: num_bins={num_bins} needs more shared memory than a block "
                         f"has ({MAX_SHARED_BYTES} bytes); the kernel takes 1..240")
    if h * w >= 2**31:
        raise ValueError(f"glcm: {h}x{w} tiles are too large")
    glcm = torch.empty((b, num_bins, num_bins), dtype=torch.float32, device=bins.device)
    hist = torch.empty((b, num_bins), dtype=torch.float32, device=bins.device)
    with torch.cuda.device(bins.device):
        code = _build.lib().rt_glcm(
            bins.data_ptr(), glcm.data_ptr(), hist.data_ptr(), b, h, w, num_bins,
            _build.stream(bins),
        )
        launches += 1
    _build.check(code, "glcm")
    return glcm, hist
