"""Morphological reconstruction on the card: wrapper of ``csrc/morph_recon.cu``.

Replaces ``repro.kernels.morph_recon.morph_recon_pallas`` (and its sweep
kernel). The kernel is a tiled wavefront: each launch is one round over a
worklist of 64x64 tiles, and the rounds run until no tile is queued. It
always reaches the fixed point, which is the converged plain version's
result bit for bit, and has no iteration cap: unlike ``ref.morph_recon_ref``
it takes no ``max_iters``.
"""
from __future__ import annotations

import torch

from repro_torch import spans
from repro_torch.kernels import _build

TILE = 64  # tile side of the kernel (kTile in the source)
ROUNDS_PER_READ = 8  # rounds launched between two host reads of the worklist count
HEADER = 5  # state: three list counts, rounds with work, tile visits

calls = 0  # wrapper calls since the last reset
launches = 0  # round launches since the last reset
rounds = 0  # of those, rounds that had work
tile_visits = 0  # tiles relaxed since the last reset


def morph_recon_cuda(marker: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(H, W) float32 marker and mask -> reconstruction by dilation, on the card.

    Reads the worklist count on the host once every ``ROUNDS_PER_READ``
    rounds (one synchronisation each).
    """
    global calls, launches, rounds, tile_visits
    _build.require(marker, "morph_recon marker", torch.float32, 2)
    _build.require(mask, "morph_recon mask", torch.float32, 2)
    if marker.shape != mask.shape or marker.device != mask.device:
        raise ValueError(f"morph_recon: marker {tuple(marker.shape)} on {marker.device}, "
                         f"mask {tuple(mask.shape)} on {mask.device}")
    h, w = mask.shape
    out = torch.empty_like(mask)
    if out.numel() == 0:
        return out
    ntiles = -(-h // TILE) * -(-w // TILE)
    state = torch.zeros(HEADER + 6 * ntiles, dtype=torch.int32, device=mask.device)
    done = 0
    with torch.cuda.device(mask.device):
        while True:
            code = _build.lib().rt_morph_recon_rounds(
                marker.data_ptr(), mask.data_ptr(), out.data_ptr(), state.data_ptr(),
                h, w, done, ROUNDS_PER_READ, _build.stream(mask),
            )
            _build.check(code, "morph_recon")
            with _build.counter_lock:
                launches += ROUNDS_PER_READ
            done += ROUNDS_PER_READ
            with spans.sync("morph_recon_worklist", mask.device):
                header = state[:HEADER].tolist()
            if header[done % 3] == 0:
                break
    with _build.counter_lock:
        calls += 1
        rounds += header[3]
        tile_visits += header[4]
    return out
