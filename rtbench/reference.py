"""The plain reference that decides ``correct``.

What the paper's whole-slide analysis computes, written again from its
description: Ruifrok-Johnston colour deconvolution, percentile
normalisation and a threshold, holes filled from the border, a
reconstruction opening, 4-connected components labelled by their least flat
index, one fixed-size ROI an object, and GLCM and histogram texture
features. Floating-point steps run in plain PyTorch in ``dtype``
(float64 for the reference, bfloat16 for its control); the binary steps run
exactly on the host with ``scipy.ndimage``.

It imports nothing of the program and takes nothing the program made: it
works the hematoxylin plane out again from the RGB that both sides were
given.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

# Ruifrok & Johnston's H&E-DAB stain vectors (rows: stains; columns: RGB
# optical density), each normalised to unit length before inverting.
STAIN_OD = np.array([[0.650, 0.704, 0.286], [0.072, 0.990, 0.105], [0.268, 0.570, 0.776]])
OD_FLOOR = 1e-6  # RGB clamped to [OD_FLOOR, 1] before -log10
PERCENTILES = (5.0, 99.5)
SPAN_FLOOR = 1e-6
FOUR = ndimage.generate_binary_structure(2, 1)  # 4-connectivity


def stain_inverse() -> np.ndarray:
    m = STAIN_OD / np.linalg.norm(STAIN_OD, axis=1, keepdims=True)
    return np.linalg.inv(m)


def deconv(rgb: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(3, H, W) RGB in [0, 1] -> (3, H, W) stain optical densities."""
    x = rgb.to(dtype)
    od = -torch.log10(torch.clamp(x, OD_FLOOR, 1.0))
    minv = torch.as_tensor(stain_inverse(), device=x.device).to(dtype)
    return torch.einsum("chw,cs->shw", od, minv)


def percentiles(x: torch.Tensor, qs=PERCENTILES) -> list[torch.Tensor]:
    """Linear interpolation between the order statistics at q/100 (n - 1)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    out = []
    for q in qs:
        pos = q / 100.0 * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        w = pos - lo
        out.append(s[lo] * (1.0 - w) + s[hi] * w)
    return out


def normalize(x: torch.Tensor) -> torch.Tensor:
    lo, hi = percentiles(x)
    return torch.clamp((x - lo) / torch.clamp(hi - lo, min=SPAN_FLOOR), 0.0, 1.0)


def fill_holes(mask: np.ndarray) -> np.ndarray:
    """Background components (4-connected) that do not touch the border
    become foreground."""
    lab, n = ndimage.label(~mask, structure=FOUR)
    outside = np.zeros(n + 1, bool)
    outside[np.concatenate([lab[0], lab[-1], lab[:, 0], lab[:, -1]])] = True
    outside[0] = False
    return ~outside[lab]


def open_by_reconstruction(filled: np.ndarray) -> np.ndarray:
    """The components of ``filled`` that hold a pixel whose four neighbours
    (wrapping at the tile's edge) are all foreground."""
    core = filled.copy()
    for shift, axis in ((1, 1), (-1, 1), (1, 0), (-1, 0)):
        core &= np.roll(filled, shift, axis=axis)
    lab, n = ndimage.label(filled, structure=FOUR)
    keep = np.zeros(n + 1, bool)
    keep[lab[core]] = True
    keep[0] = False
    return keep[lab]


def label(mask: np.ndarray) -> np.ndarray:
    """int32 labels: each 4-connected component's least flat index; -1 off it."""
    lab, n = ndimage.label(mask, structure=FOUR)
    out = np.full(mask.shape, -1, np.int32)
    if n == 0:
        return out
    flat = np.arange(mask.size, dtype=np.int64).reshape(mask.shape)
    least = np.asarray(ndimage.minimum(flat, lab, np.arange(1, n + 1)), np.int64)
    table = np.concatenate([[-1], least]).astype(np.int32)
    return table[lab]


def boxes_of(labels: np.ndarray, roi: int, max_objects: int) -> np.ndarray:
    """(K, 4) int32 [y0, x0, y1, x1]: one roi x roi box an object, centred on
    its bounding box and kept inside the tile, objects in ascending label
    order, the first ``max_objects``."""
    h, w = labels.shape
    lab, n = ndimage.label(labels >= 0, structure=FOUR)
    if n == 0:
        return np.zeros((0, 4), np.int32)
    ids = np.asarray(ndimage.minimum(labels, lab, np.arange(1, n + 1)), np.int64)
    slices = ndimage.find_objects(lab)
    order = np.argsort(ids, kind="stable")[:max_objects]
    out = np.zeros((len(order), 4), np.int64)
    for row, k in enumerate(order):
        ys, xs = slices[k]
        cy, cx = (ys.start + ys.stop) // 2, (xs.start + xs.stop) // 2
        y0 = min(max(cy - roi // 2, 0), max(h - roi, 0))
        x0 = min(max(cx - roi // 2, 0), max(w - roi, 0))
        out[row] = (y0, x0, min(y0 + roi, h), min(x0 + roi, w))
    return out.astype(np.int32)


def quantize(x: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Intensity in [0, 1] -> int64 bins in [0, num_bins) (truncation)."""
    return torch.clamp(torch.trunc(x * num_bins), 0, num_bins - 1).to(torch.int64)


def texture(bins: torch.Tensor, num_bins: int, dtype: torch.dtype) -> torch.Tensor:
    """(K, H, W) bins -> (K, 9): contrast, energy, homogeneity, entropy and
    correlation of the horizontal-neighbour GLCM, then mean, standard
    deviation, skewness and kurtosis of the histogram (in bin units)."""
    k = bins.shape[0]
    nb = num_bins
    dev = bins.device
    base = torch.arange(k, device=dev)[:, None] * (nb * nb)
    pairs = (bins[:, :, :-1] * nb + bins[:, :, 1:]).reshape(k, -1) + base
    glcm = torch.bincount(pairs.reshape(-1), minlength=k * nb * nb).reshape(k, nb, nb)
    hbase = torch.arange(k, device=dev)[:, None] * nb
    hist = torch.bincount((bins.reshape(k, -1) + hbase).reshape(-1), minlength=k * nb)
    hist = hist.reshape(k, nb)
    glcm, hist = glcm.to(dtype), hist.to(dtype)
    i = torch.arange(nb, device=dev).to(dtype)[:, None]
    j = torch.arange(nb, device=dev).to(dtype)[None, :]
    p = glcm / torch.clamp(glcm.sum(dim=(1, 2), keepdim=True), min=1e-12)
    both = (1, 2)
    contrast = (p * (i - j) ** 2).sum(dim=both)
    energy = (p * p).sum(dim=both)
    homogeneity = (p / (1.0 + torch.abs(i - j))).sum(dim=both)
    entropy = -(p * torch.log(torch.clamp(p, 1e-12, 1.0))).sum(dim=both)
    mi, mj = (p * i).sum(dim=both), (p * j).sum(dim=both)
    di, dj = i - mi[:, None, None], j - mj[:, None, None]
    vi, vj = (p * di * di).sum(dim=both), (p * dj * dj).sum(dim=both)
    corr = (p * di * dj).sum(dim=both) / torch.clamp(torch.sqrt(vi * vj), min=1e-12)
    q = hist / torch.clamp(hist.sum(dim=1, keepdim=True), min=1e-12)
    x = torch.arange(nb, device=dev).to(dtype)[None, :]
    mean = (q * x).sum(dim=1)
    sd = torch.sqrt(torch.clamp((q * (x - mean[:, None]) ** 2).sum(dim=1), min=1e-12))
    z = (x - mean[:, None]) / sd[:, None]
    skew, kurt = (q * z**3).sum(dim=1), (q * z**4).sum(dim=1)
    return torch.stack([contrast, energy, homogeneity, entropy, corr, mean, sd, skew, kurt], 1)


# ---------------------------------------------------------------------------
# The whole-slide analysis of one tile
# ---------------------------------------------------------------------------
def analyze(rgb: np.ndarray, cfg: dict, device, dtype=torch.float64) -> dict:
    """(3, H, W) host RGB -> {"labels", "boxes", "features"} on the host."""
    hema = normalize(deconv(torch.as_tensor(rgb, device=device), dtype)[0])
    mask = (hema > cfg["seg_threshold"]).cpu().numpy()
    nuclei = open_by_reconstruction(fill_holes(mask))
    labels = label(nuclei)
    boxes = boxes_of(labels, cfg["nucleus_roi"], cfg["max_objects_per_tile"])
    r = cfg["nucleus_roi"]
    crops = torch.zeros((len(boxes), r, r), dtype=hema.dtype, device=hema.device)
    for row, (y0, x0, y1, x1) in enumerate(boxes.tolist()):
        crops[row, :y1 - y0, :x1 - x0] = hema[y0:y1, x0:x1]
    nb = cfg["num_bins"]
    feats = texture(quantize(crops, nb), nb, dtype) if len(boxes) else crops.new_zeros((0, 9))
    return {"labels": labels, "boxes": boxes, "features": feats.double().cpu().numpy()}
