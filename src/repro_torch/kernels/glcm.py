"""GLCM and histogram counts on the card: wrapper of ``csrc/glcm.cu``.

Replaces ``repro.kernels.glcm.glcm_pallas``. The counts equal
``ref.glcm_ref`` and ``ref.histogram_ref`` exactly, for any ``num_bins``.

Up to 240 bins a block counts a tile in shared memory, in a copy of the
counters per warp where 8 copies fit (NB <= 84), else in one copy. A batch
too small to fill the card (the kernel chains' one window) is cut into row
bands, a block each, whose counts add up in the outputs (``band_rows``).
Above 240 bins the counts go to device memory (``rt_glcm_global``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last reset

# Shared memory one H100 block may use (227 KB). The shared-memory kernel
# keeps (NB*NB + NB) int32 counters there, so it takes NB <= 240; above
# that the counts go to device memory (``rt_glcm_global``).
MAX_SHARED_BYTES = 232_448
# Float32 holds every integer up to 2^24 exactly, and no count exceeds a
# tile's pixels: counts summed in float32 (the device-memory variant, and the
# bands' partial counts) are exact for tiles of at most 2^24 pixels.
MAX_EXACT_F32 = 2**24
MAX_GRID_Y = 65_535  # tiles (device memory) or bands (shared) on the grid's y axis
# Row bands: a batch of fewer than BLOCKS_PER_SM blocks an SM is cut into
# bands of at least MIN_BAND_PIXELS pixels, so that each block's counting
# outweighs adding its counters into the outputs.
BLOCKS_PER_SM = 2
MIN_BAND_PIXELS = 16_384
_sms: dict[int, int] = {}  # multiprocessors by device index


def band_rows(b: int, h: int, w: int, num_sms: int) -> int:
    """Rows of a tile that one block counts in the shared-memory kernel: the
    whole tile (``h``) when ``b`` tiles fill ``num_sms`` multiprocessors or a
    tile has more than 2^24 pixels, else bands enough to fill them."""
    want = BLOCKS_PER_SM * num_sms
    if b < 1 or b >= want or h * w == 0 or h * w > MAX_EXACT_F32:
        return h
    bands = min(h, -(-want // b), max(1, h * w // MIN_BAND_PIXELS), MAX_GRID_Y)
    return -(-h // bands)


def _num_sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def glcm_cuda(bins: torch.Tensor, num_bins: int, *, rows: int | None = None,
              events: list | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) int32 bins -> (glcm (B, NB, NB), hist (B, NB)) float32 counts.

    ``rows``: rows a block counts in the shared-memory kernel (NB <= 240);
    ``None`` picks them (``band_rows``). ``events``, if a list, receives two
    CUDA events recorded on the stream before and after the launch.
    """
    global launches
    _build.require(bins, "glcm bins", torch.int32, 3)
    b, h, w = bins.shape
    if num_bins < 1:
        raise ValueError(f"glcm: num_bins must be at least 1, got {num_bins}")
    shared = (num_bins * num_bins + num_bins) * 4 <= MAX_SHARED_BYTES
    if (h * w >= 2**31) if shared else (h * w > MAX_EXACT_F32):
        raise ValueError(f"glcm: {h}x{w} tiles are too large for num_bins={num_bins}")
    if not shared and b > MAX_GRID_Y:
        raise ValueError(f"glcm: at most {MAX_GRID_Y} tiles for num_bins={num_bins}, got {b}")
    if rows is None:
        rows = band_rows(b, h, w, _num_sms(bins.device)) if shared else h
    elif not 1 <= rows <= h or -(-h // rows) > MAX_GRID_Y or (
            rows < h and h * w > MAX_EXACT_F32):
        raise ValueError(f"glcm: cannot count {h}x{w} tiles in bands of {rows} rows")
    glcm = torch.empty((b, num_bins, num_bins), dtype=torch.float32, device=bins.device)
    hist = torch.empty((b, num_bins), dtype=torch.float32, device=bins.device)
    marks = None
    if events is not None:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events.extend(marks)
    with torch.cuda.device(bins.device):
        stream = _build.stream(bins)
        if marks:
            marks[0].record()
        args = (bins.data_ptr(), glcm.data_ptr(), hist.data_ptr(), b, h, w, num_bins)
        if shared:
            code = _build.lib().rt_glcm(*args, rows, stream)
        else:
            code = _build.lib().rt_glcm_global(*args, stream)
        if marks:
            marks[1].record()
        with _build.counter_lock:
            launches += 1
    _build.check(code, "glcm")
    return glcm, hist
