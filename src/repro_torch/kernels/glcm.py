"""GLCM and histogram counts on the card: wrapper of ``csrc/glcm.cu``.

Replaces ``repro.kernels.glcm.glcm_pallas``. The counts equal
``ref.glcm_ref`` and ``ref.histogram_ref`` exactly, for any ``num_bins``.

Three routes (:func:`route`), each bounded by the shared memory of a block:
  * ``shared``, NB <= 240: int32 counters in shared memory, a copy per warp
    where 8 copies fit (NB <= 84), else one copy (``rt_glcm``);
  * ``packed``, 241 <= NB <= 340: 16-bit counters, two to a 32-bit word
    ((NB*NB + NB) * 2 bytes, one block an SM), in bands of whole rows of at
    most 65,535 pixels so that no counter overflows (``rt_glcm_packed``,
    :func:`packed_rows`);
  * ``global``, NB > 340 or rows wider than 65,535 pixels: float32 atomics
    straight into device memory (``rt_glcm_global``).
On the first two a batch too small to fill the card (the kernel chains' one
window) is cut into row bands, a block each, whose counts add up in the
outputs (``band_rows``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0  # kernel launches since the last reset
ROUTES = ("shared", "packed", "global")
route_launches = dict.fromkeys(ROUTES, 0)  # of those, launches per route

# Shared memory one H100 block may use (227 KB). The shared-memory kernel
# keeps (NB*NB + NB) int32 counters there, so it takes NB <= 240; the packed
# kernel keeps them in 16 bits, so it takes NB <= 340.
MAX_SHARED_BYTES = 232_448
# A packed counter holds at most 65,535; a band adds at most one to a counter
# a pixel, so a packed band holds at most this many pixels.
MAX_BAND_PIXELS = 65_535
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


def route(num_bins: int, w: int) -> str:
    """The kernel that counts tiles ``w`` pixels wide at ``num_bins`` bins:
    ``"shared"`` where (NB*NB + NB) int32 counters fit one block's shared
    memory, ``"packed"`` where they fit in 16 bits and one row fits a band,
    else ``"global"``."""
    counters = num_bins * num_bins + num_bins
    if counters * 4 <= MAX_SHARED_BYTES:
        return "shared"
    if counters * 2 <= MAX_SHARED_BYTES and w <= MAX_BAND_PIXELS:
        return "packed"
    return "global"


def packed_rows(b: int, h: int, w: int, num_sms: int) -> int:
    """Rows of a tile that one block counts on the packed route:
    ``band_rows``' choice, cut so that a band holds at most
    ``MAX_BAND_PIXELS`` pixels. A packed block takes a whole SM, so bands
    run in waves of ``num_sms``; where they take more than one wave, the
    bands are made as short as the same number of waves allows, so that
    the last wave is full (the chains' 4096^2 window: 373 bands of 11 rows
    in 3 waves, not 274 of 15 whose third wave holds 10)."""
    rows = max(1, min(band_rows(b, h, w, num_sms), MAX_BAND_PIXELS // max(w, 1)))
    waves = -(-b * -(-h // rows) // num_sms)
    if waves > 1:
        rows = max(1, -(-h // (waves * num_sms // b)))
    return rows


def _num_sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def glcm_cuda(bins: torch.Tensor, num_bins: int, *, rows: int | None = None,
              events: list | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) int32 bins -> (glcm (B, NB, NB), hist (B, NB)) float32 counts.

    ``rows``: rows a block counts on the shared and packed routes; ``None``
    picks them (``band_rows``, ``packed_rows``). ``events``, if a list,
    receives two CUDA events recorded on the stream before and after the
    launch.
    """
    global launches
    _build.require(bins, "glcm bins", torch.int32, 3)
    b, h, w = bins.shape
    if num_bins < 1:
        raise ValueError(f"glcm: num_bins must be at least 1, got {num_bins}")
    which = route(num_bins, w)
    if (h * w >= 2**31) if which == "shared" else (h * w > MAX_EXACT_F32):
        raise ValueError(f"glcm: {h}x{w} tiles are too large for num_bins={num_bins}")
    if which == "global" and b > MAX_GRID_Y:
        raise ValueError(f"glcm: at most {MAX_GRID_Y} tiles for num_bins={num_bins}, got {b}")
    if rows is None:
        pick = {"shared": band_rows, "packed": packed_rows}.get(which)
        rows = pick(b, h, w, _num_sms(bins.device)) if pick else h
    elif not 1 <= rows <= h or -(-h // rows) > MAX_GRID_Y or (
            rows < h and h * w > MAX_EXACT_F32) or (
            which == "packed" and rows * w > MAX_BAND_PIXELS):
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
        if which == "shared":
            code = _build.lib().rt_glcm(*args, rows, stream)
        elif which == "packed":
            code = _build.lib().rt_glcm_packed(*args, rows, stream)
        else:
            code = _build.lib().rt_glcm_global(*args, stream)
        if marks:
            marks[1].record()
        with _build.counter_lock:
            launches += 1
            route_launches[which] += 1
    _build.check(code, f"glcm ({which})")
    return glcm, hist
