"""The paper's example application, plain-function form: segmentation +
feature computation on one tile (``repro.pipeline.wsi`` lines 37-100).

Every step runs on one device, from deconvolution to features: the CUDA
card unless the caller passes ``device="cpu"``. ``impl`` is passed to
``kernels.ops`` (``"auto"``: the kernels on the card, the plain versions on
the CPU; ``"torch"``: the plain versions anywhere).
"""
from __future__ import annotations

import torch

from repro_torch.configs.wsi import WSIConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref


def _stain_inverse(minv, device: torch.device) -> torch.Tensor:
    m = ref.stain_inverse() if minv is None else minv
    return torch.as_tensor(m, dtype=torch.float32, device=device)


def segment_mask(raw: torch.Tensor, impl: str = "auto") -> dict:
    """Thresholded (H, W) float 0/1 mask -> {"mask", "labels"}: fill holes,
    reconstruction opening, connected components."""
    filled = ops.fill_holes(raw, impl=impl)
    # morphological reconstruction opening: erode-ish marker then rebuild
    # (torch.roll wraps around the tile edge, as jnp.roll does)
    marker = torch.minimum(
        filled,
        torch.roll(filled, 1, -1) * torch.roll(filled, -1, -1)
        * torch.roll(filled, 1, -2) * torch.roll(filled, -1, -2),
    )
    opened = ops.morph_recon(marker, filled, impl=impl)
    mask = (opened > 0.5).to(torch.int32)
    labels = ops.connected_components(mask, impl=impl)
    return {"mask": mask, "labels": labels}


def segment_tile(
    rgb, cfg: WSIConfig, impl: str = "auto", device=None, minv=None
) -> dict:
    """RGB (3, H, W) -> {"mask", "labels", "hematoxylin"}.

    ``minv`` is the 3x3 stain inverse (default ``ref.stain_inverse()``).
    """
    dev = resolve_device(device)
    rgb = torch.as_tensor(rgb, dtype=torch.float32, device=dev)
    stains = ops.color_deconv(rgb, _stain_inverse(minv, dev), impl=impl)
    hema = stains[0]  # hematoxylin density (nuclei stain)
    # normalize to [0,1] for thresholding
    h_lo, h_hi = ref.percentile(hema, (5.0, 99.5))
    hema_n = torch.clamp((hema - h_lo) / torch.clamp(h_hi - h_lo, min=1e-6), 0.0, 1.0)
    raw = (hema_n > cfg.seg_threshold).to(torch.float32)
    return {**segment_mask(raw, impl=impl), "hematoxylin": hema_n}


def extract_object_rois(
    labels, intensity, cfg: WSIConfig, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-object fixed-size ROI batch (replaces dynamic GPU block assignment).

    Returns (rois (K, R, R) float32 intensity crops, boxes (K, 4) int32),
    equal to the reference's: objects in ascending label order, the first
    ``max_objects_per_tile``, each crop centred on its bounding box and
    clipped into the tile, zero-padded where the tile is smaller than R.
    """
    dev = resolve_device(device)
    labels = torch.as_tensor(labels, device=dev)
    intensity = torch.as_tensor(intensity, dtype=torch.float32, device=dev)
    r = cfg.nucleus_roi
    h, w = labels.shape
    flat = labels.reshape(-1)
    pix = torch.nonzero(flat >= 0).squeeze(1)
    ids, slot = torch.unique(flat[pix], sorted=True, return_inverse=True)
    n = ids.numel()
    ys, xs = pix // w, pix % w

    def reduce(init: int, vals: torch.Tensor, how: str) -> torch.Tensor:
        out = torch.full((n,), init, dtype=vals.dtype, device=dev)
        return out.scatter_reduce_(0, slot, vals, how)

    k = min(n, cfg.max_objects_per_tile)
    y0, y1 = reduce(h, ys, "amin")[:k], reduce(-1, ys, "amax")[:k] + 1
    x0, x1 = reduce(w, xs, "amin")[:k], reduce(-1, xs, "amax")[:k] + 1
    cy, cx = (y0 + y1) // 2, (x0 + x1) // 2
    y0 = torch.clamp(cy - r // 2, 0, max(h - r, 0))
    x0 = torch.clamp(cx - r // 2, 0, max(w - r, 0))
    boxes = torch.stack(
        [y0, x0, torch.clamp(y0 + r, max=h), torch.clamp(x0 + r, max=w)], dim=1
    ).to(torch.int32)
    off = torch.arange(r, device=dev)
    rows, cols = y0[:, None] + off, x0[:, None] + off  # (K, R) each
    inside = (rows < h)[:, :, None] & (cols < w)[:, None, :]
    crop = intensity[rows.clamp(max=h - 1)[:, :, None], cols.clamp(max=w - 1)[:, None, :]]
    rois = torch.where(inside, crop, torch.zeros((), dtype=crop.dtype, device=dev))
    return rois, boxes


def compute_features(rois, cfg: WSIConfig, impl: str = "auto", device=None) -> torch.Tensor:
    """(K, R, R) intensity crops -> (K, 9) texture features."""
    dev = resolve_device(device)
    rois = torch.as_tensor(rois, dtype=torch.float32, device=dev)
    if len(rois) == 0:
        return torch.zeros((0, 9), dtype=torch.float32, device=dev)
    bins = ref.quantize_ref(rois, cfg.num_bins)
    return ops.texture_features(bins, cfg.num_bins, impl=impl)


def analyze_tile(
    rgb, cfg: WSIConfig, impl: str = "auto", device=None, minv=None
) -> dict:
    seg = segment_tile(rgb, cfg, impl, device=device, minv=minv)
    rois, boxes = extract_object_rois(seg["labels"], seg["hematoxylin"], cfg, device=device)
    feats = compute_features(rois, cfg, impl, device=device)
    return {**seg, "rois": rois, "boxes": boxes, "features": feats}

