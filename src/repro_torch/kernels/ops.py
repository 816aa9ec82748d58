"""Public wrappers for the port's kernels, with dispatch on the device.

The WSI main path's four (color deconvolution, reconstruction, connected
components, GLCM) and the LM path's two (flash attention, SSD scan).

``impl`` selects:
  * ``"auto"``  — the tensor's device decides: a CUDA tensor launches the
                  hand-written kernel, a CPU tensor takes the plain version;
  * ``"cuda"``  — the kernel; a CPU tensor is an error;
  * ``"torch"`` — the plain PyTorch version (``ref``) on any device, the
                  comparison that ``chip_smoke.py`` holds each kernel against;
  * ``"chunked"`` — attention and the SSD scan only: the reference's plain
                  chunked route on any device (``ref.attention_chunked``,
                  online softmax over key chunks that never builds the
                  (Tq, Tk) scores; ``ref.ssd_scan_chunked``, float32
                  throughout). It launches no kernel.
An impl that an op does not take raises ``ValueError``: the four WSI ops
refuse ``"chunked"`` (the reference's ``_resolve`` treats any string but
``"pallas"`` as its plain path; the port names what each op takes).
A kernel that fails to build or launch raises; nothing falls back. The
kernels have no backward: a CUDA route refuses a tensor that autograd is
recording (``_build.require``), so training runs the plain versions
(``attn_impl="torch"``) and no gradient is dropped in silence.

Names, argument order and defaults follow ``repro.kernels.ops``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ccl import ccl_cuda
from repro_torch.kernels.color_deconv import color_deconv_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.glcm import glcm_cuda
from repro_torch.kernels.morph_recon import morph_recon_cuda
from repro_torch.kernels.ssd_scan import ssd_scan_cuda

IMPLS = ("auto", "cuda", "torch")  # every op; attention and the SSD scan also "chunked"


def _use_kernel(impl: str, x: torch.Tensor) -> bool:
    """Whether this call launches the CUDA kernel for a tensor ``x``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (want one of {IMPLS})")
    if impl == "torch":
        return False
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors, got one on {x.device}")
    return x.is_cuda


# -- color deconvolution ------------------------------------------------------
def color_deconv(rgb: torch.Tensor, minv: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """(3, H, W) float in [0,1] -> (3, H, W) stain densities."""
    minv = minv.to(device=rgb.device, dtype=torch.float32)
    if _use_kernel(impl, rgb):
        return color_deconv_cuda(rgb, minv.contiguous())
    return ref.color_deconv_ref(rgb, minv)


# -- morphological reconstruction ----------------------------------------------
def morph_recon(
    marker: torch.Tensor, mask: torch.Tensor, impl: str = "auto", max_iters: int = 128
) -> torch.Tensor:
    """Reconstruction by dilation of ``marker`` under ``mask`` (4-connected).

    The CUDA kernel (a tiled wavefront) always reaches the fixed point and
    does not read ``max_iters``; the plain version stops after ``max_iters``
    sweeps.
    """
    if _use_kernel(impl, mask):
        return morph_recon_cuda(marker, mask)
    return ref.morph_recon_ref(marker, mask, max_iters=max_iters)


def fill_holes(mask01: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Border-seeded reconstruction of the complement, on the reconstruction
    kernel (to the fixed point) for a CUDA tensor; the plain version is capped
    as ``ref.fill_holes_ref`` is."""
    if not _use_kernel(impl, mask01):
        return ref.fill_holes_ref(mask01)
    marker, inv = ref.fill_holes_seed(mask01)
    return 1.0 - morph_recon_cuda(marker, inv)


# -- connected components ----------------------------------------------------------
def connected_components(
    mask: torch.Tensor, impl: str = "auto", max_iters: int = 128
) -> torch.Tensor:
    """Labels: min flat index per 4-connected component; background -1.

    The CUDA kernel (union-find) always reaches the fixed point and does not
    read ``max_iters``; the plain version stops after ``max_iters`` sweeps.
    """
    if not _use_kernel(impl, mask):
        return ref.ccl_ref(mask, max_iters=max_iters)
    if mask.dtype != torch.int32:
        mask = (mask != 0).to(torch.int32)
    return ccl_cuda(mask)


# -- GLCM / histogram features -------------------------------------------------------
def glcm_histogram(
    bins: torch.Tensor, num_bins: int, impl: str = "auto"
) -> tuple[torch.Tensor, torch.Tensor]:
    if _use_kernel(impl, bins):
        return glcm_cuda(bins, num_bins)
    return ref.glcm_ref(bins, num_bins), ref.histogram_ref(bins, num_bins)


def texture_features(bins: torch.Tensor, num_bins: int, impl: str = "auto") -> torch.Tensor:
    """(B, H, W) int bins -> (B, 9) [5 GLCM + 4 histogram] features."""
    g, h = glcm_histogram(bins, num_bins, impl=impl)
    return torch.cat([ref.glcm_features_ref(g), ref.histogram_features_ref(h)], dim=-1)


# -- attention -----------------------------------------------------------------------
def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    impl: str = "auto",
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D) -> (B, Hq, Tq, D).

    ``block_q`` and ``block_k`` are the Pallas kernel's tile sizes, kept for
    the reference's signature; the CUDA kernels tile 64 queries by 64 keys
    (tensor cores, bf16 at D = 64 and 128; CUDA cores, float32 from D = 64
    up), 32 keys (tensor cores, bf16 at D = 192 and 256, where registers and
    shared memory bound the tile) or 32 keys (CUDA cores, D <= 32).
    ``impl="chunked"`` scans key chunks of ``4 * block_k``, as the
    reference's chunked route does.
    """
    if impl == "chunked":
        return ref.attention_chunked(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                     chunk=4 * block_k)
    if _use_kernel(impl, q):
        return flash_attention_cuda(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return ref.attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)


# -- mamba2 SSD ---------------------------------------------------------------------
def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_: torch.Tensor,
    c_: torch.Tensor,
    d_: torch.Tensor | None = None,
    *,
    impl: str = "auto",
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, H, P), final state (B, H, N, P) float32); ``chunk`` is the
    kernel's chunk length (the plain version steps one position at a time).
    On the meta device (the dry run) the plain version is the chunked one,
    ``ref.ssd_scan_chunked``, the same function: stepping would trace T
    steps in Python and compute nothing. ``impl="chunked"`` takes
    ``ref.ssd_scan_chunked`` on any device, float32 throughout."""
    if impl == "chunked":
        return ref.ssd_scan_chunked(x, dt, a, b_, c_, d_, chunk=chunk)
    if _use_kernel(impl, x):
        return ssd_scan_cuda(x, dt, a, b_, c_, d_, chunk=chunk)
    if x.device.type == "meta":
        return ref.ssd_scan_chunked(x, dt, a, b_, c_, d_, chunk=chunk)
    return ref.ssd_scan_ref(x, dt, a, b_, c_, d_)
