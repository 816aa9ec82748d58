"""Morphological reconstruction on the card: wrapper of ``csrc/morph_recon.cu``.

Replaces ``repro.kernels.morph_recon.morph_recon_pallas`` (and its sweep
kernel). Each launch is one 4-direction sweep; the host loop here stops at
the fixed point or after ``max_iters`` sweeps, counted as
``ref.morph_recon_ref`` counts them, so the result equals the plain version
iterate for iterate, capped or not.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0  # sweep launches (4 kernels each) since the last reset


def _sweep(marker: torch.Tensor, mask: torch.Tensor, out: torch.Tensor,
           changed: torch.Tensor) -> None:
    global launches
    h, w = mask.shape
    code = _build.lib().rt_morph_recon_sweep(
        marker.data_ptr(), mask.data_ptr(), out.data_ptr(), changed.data_ptr(),
        h, w, _build.stream(mask),
    )
    launches += 1
    _build.check(code, "morph_recon")


def morph_recon_cuda(
    marker: torch.Tensor, mask: torch.Tensor, max_iters: int = 128
) -> torch.Tensor:
    """(H, W) float32 marker and mask -> reconstruction by dilation, on the card.

    Reads a device flag once per sweep (one host synchronisation a sweep).
    """
    _build.require(marker, "morph_recon marker", torch.float32, 2)
    _build.require(mask, "morph_recon mask", torch.float32, 2)
    if marker.shape != mask.shape or marker.device != mask.device:
        raise ValueError(f"morph_recon: marker {tuple(marker.shape)} on {marker.device}, "
                         f"mask {tuple(mask.shape)} on {mask.device}")
    out = torch.empty_like(mask)
    changed = torch.empty(1, dtype=torch.int32, device=mask.device)
    with torch.cuda.device(mask.device):
        _sweep(marker, mask, out, changed)
        it = 1
        while it < max_iters and bool(changed.item()):
            _sweep(out, mask, out, changed)
            it += 1
    return out
