"""GLCM and histogram counts on the card: wrapper of ``csrc/glcm.cu``.

Replaces ``repro.kernels.glcm.glcm_pallas``. The counts equal
``ref.glcm_ref`` and ``ref.histogram_ref`` exactly, for any ``num_bins``.

Up to 240 bins a block counts a tile in shared memory, in a copy of the
counters per warp where 8 copies fit (NB <= 84), else in one copy. Above
that the counts go to device memory (``rt_glcm_global``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last reset

# Shared memory one H100 block may use (227 KB). The shared-memory kernel
# keeps (NB*NB + NB) int32 counters there, so it takes NB <= 240; above
# that the counts go to device memory (``rt_glcm_global``).
MAX_SHARED_BYTES = 232_448
# Float32 holds every integer below 2^24 exactly: the device-memory variant
# counts in float32, so a tile must have fewer pixels than that.
MAX_EXACT_F32 = 2**24
MAX_GRID_Y = 65_535  # the device-memory variant puts tiles on the grid's y axis


def glcm_cuda(bins: torch.Tensor, num_bins: int, *,
              events: list | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) int32 bins -> (glcm (B, NB, NB), hist (B, NB)) float32 counts.

    ``events``, if a list, receives two CUDA events recorded on the stream
    before and after the launch.
    """
    global launches
    _build.require(bins, "glcm bins", torch.int32, 3)
    b, h, w = bins.shape
    if num_bins < 1:
        raise ValueError(f"glcm: num_bins must be at least 1, got {num_bins}")
    shared = (num_bins * num_bins + num_bins) * 4 <= MAX_SHARED_BYTES
    if h * w >= (2**31 if shared else MAX_EXACT_F32):
        raise ValueError(f"glcm: {h}x{w} tiles are too large for num_bins={num_bins}")
    if not shared and b > MAX_GRID_Y:
        raise ValueError(f"glcm: at most {MAX_GRID_Y} tiles for num_bins={num_bins}, got {b}")
    glcm = torch.empty((b, num_bins, num_bins), dtype=torch.float32, device=bins.device)
    hist = torch.empty((b, num_bins), dtype=torch.float32, device=bins.device)
    marks = None
    if events is not None:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events.extend(marks)
    with torch.cuda.device(bins.device):
        entry = _build.lib().rt_glcm if shared else _build.lib().rt_glcm_global
        stream = _build.stream(bins)
        if marks:
            marks[0].record()
        code = entry(bins.data_ptr(), glcm.data_ptr(), hist.data_ptr(), b, h, w, num_bins, stream)
        if marks:
            marks[1].record()
        with _build.counter_lock:
            launches += 1
    _build.check(code, "glcm")
    return glcm, hist
