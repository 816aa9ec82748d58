"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each function here computes what ``repro.kernels.ref`` computes, on any
device. The kernel wrappers take these for CPU tensors, the CPU tests hold
them against the JAX package, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.

Reconstruction and min-label propagation are written as the sequential
1-D recurrences that the reference evaluates with ``associative_scan``.
min and max only select values and never round, so every directional pass,
and so every sweep, equals the reference's bit for bit, and ``max_iters``
counts the same sweeps. The CUDA kernels of both run to the fixed point
without a cap, so they equal these only where the cap did not bind.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import spans

# Fixed-point cap of the plain reconstruction and labeling (the reference's
# defaults; ``fill_holes`` reconstructs under this cap too).
REF_MAX_ITERS = 256

# --------------------------------------------------------------------------
# Color deconvolution (stain unmixing)
# --------------------------------------------------------------------------
# Ruifrok & Johnston H&E+DAB stain matrix (rows: stains, cols: RGB OD).
RUIFROK_HED = np.array(
    [
        [0.650, 0.704, 0.286],  # hematoxylin
        [0.072, 0.990, 0.105],  # eosin
        [0.268, 0.570, 0.776],  # DAB
    ],
    dtype=np.float32,
)


def stain_inverse(stain_matrix: np.ndarray = RUIFROK_HED) -> np.ndarray:
    m = np.asarray(stain_matrix, dtype=np.float64)
    m = m / np.linalg.norm(m, axis=1, keepdims=True)
    return np.linalg.inv(m).astype(np.float32)


def color_deconv_ref(rgb: torch.Tensor, minv: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(..., 3, H, W) float in [0,1] -> (..., 3, H, W) stain densities."""
    od = -torch.log10(torch.clamp(rgb, eps, 1.0))
    # channels-first planar: out[s] = sum_c minv[c, s] * od[c]
    return torch.einsum("...chw,cs->...shw", od, minv.to(od))


# --------------------------------------------------------------------------
# Morphological reconstruction by dilation (ReconToNuclei / FillHoles core)
# --------------------------------------------------------------------------
def _recon_scan_1d(j: torch.Tensor, mask: torch.Tensor, dim: int, reverse: bool) -> torch.Tensor:
    """m_i = min(mask_i, max(j_i, m_{i-1})) along ``dim``, m_{-1} = -inf."""
    out = torch.empty_like(j)
    n = j.shape[dim]
    prev = None
    for i in range(n - 1, -1, -1) if reverse else range(n):
        oi = out.select(dim, i)
        if prev is None:
            torch.minimum(mask.select(dim, i), j.select(dim, i), out=oi)
        else:
            torch.maximum(j.select(dim, i), prev, out=oi)
            torch.minimum(mask.select(dim, i), oi, out=oi)
        prev = oi
    return out


def morph_recon_sweep_ref(marker: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One 4-direction sweep (down, up, right, left) of reconstruction."""
    j = torch.minimum(marker, mask)
    j = _recon_scan_1d(j, mask, dim=-2, reverse=False)
    j = _recon_scan_1d(j, mask, dim=-2, reverse=True)
    j = _recon_scan_1d(j, mask, dim=-1, reverse=False)
    j = _recon_scan_1d(j, mask, dim=-1, reverse=True)
    return j


def morph_recon_ref(
    marker: torch.Tensor, mask: torch.Tensor, max_iters: int = REF_MAX_ITERS
) -> torch.Tensor:
    """Grayscale reconstruction by dilation to fixed point (4-connectivity).

    Stops when a sweep changes nothing or after ``max_iters`` sweeps, the
    first sweep included.
    """
    prev = torch.minimum(marker, mask)
    j = morph_recon_sweep_ref(prev, mask)
    it = 1
    while it < max_iters and bool((j != prev).any()):
        prev, j = j, morph_recon_sweep_ref(j, mask)
        it += 1
    return j


def fill_holes_seed(mask01: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(marker, mask) of the border-seeded reconstruction of the complement."""
    inv = 1.0 - mask01
    border = torch.zeros_like(mask01)
    border[..., 0, :] = 1.0
    border[..., -1, :] = 1.0
    border[..., :, 0] = 1.0
    border[..., :, -1] = 1.0
    return torch.minimum(border, inv), inv


def fill_holes_ref(mask01: torch.Tensor) -> torch.Tensor:
    """Binary fill-holes via border-seeded reconstruction of the complement."""
    marker, inv = fill_holes_seed(mask01)
    return 1.0 - morph_recon_ref(marker, inv)


# --------------------------------------------------------------------------
# Connected component labeling
# --------------------------------------------------------------------------
_BIG = torch.iinfo(torch.int32).max


def ccl_unionfind_host(mask: np.ndarray) -> np.ndarray:
    """The paper's BWLabel: union-find forest over 4-neighbors (host oracle).

    Returns int32 labels; background = -1; each component labeled by the
    minimum flat index it contains (canonical form).
    """
    mask = np.asarray(mask) != 0
    h, w = mask.shape
    parent = np.arange(h * w, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:  # path compression
            parent[x], x = root, parent[x]
        return root

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            if ra < rb:
                parent[rb] = ra
            else:
                parent[ra] = rb

    for i in range(h):
        for j in range(w):
            if not mask[i, j]:
                continue
            idx = i * w + j
            if i > 0 and mask[i - 1, j]:
                union(idx, idx - w)
            if j > 0 and mask[i, j - 1]:
                union(idx, idx - 1)
    labels = np.full((h, w), -1, dtype=np.int32)
    for i in range(h):
        for j in range(w):
            if mask[i, j]:
                labels[i, j] = find(i * w + j)
    return labels


def _unite_steps(parent: list, a: int, b: int):
    """One union as ``csrc/ccl.cu`` runs it, yielding after every access to
    ``parent``: find both roots, hang the larger under the smaller with an
    atomicMin, and retry from the old parent if that root had moved."""
    while True:
        p = parent[a]
        yield
        while p != a:
            a, p = p, parent[p]
            yield
        p = parent[b]
        yield
        while p != b:
            b, p = p, parent[p]
            yield
        if a == b:
            return
        if a < b:
            a, b = b, a
        old = parent[a]  # atomicMin: read and write in one access
        parent[a] = min(old, b)
        yield
        if old == a:
            return
        a = old


def _unite_interleaved(parent: list, pairs: list, rng: np.random.Generator, lanes: int) -> None:
    """Run the unions of ``pairs`` in a random order, ``lanes`` at a time in
    flight, a random one advancing by one access at each step: the card's
    threads race on the forest the same way."""
    order = rng.permutation(len(pairs))
    queue = iter(order.tolist())
    active: list = []
    while True:
        while len(active) < lanes:
            k = next(queue, None)
            if k is None:
                break
            active.append(_unite_steps(parent, *pairs[k]))
        if not active:
            return
        j = int(rng.integers(len(active)))
        try:
            next(active[j])
        except StopIteration:
            active[j] = active[-1]
            active.pop()


def _find(parent: list, x: int) -> int:
    while parent[x] != x:
        x = parent[x]
    return x


def ccl_blocked_local(mask: np.ndarray, tile: tuple[int, int] = (32, 32), seed: int = 0,
                      lanes: int = 32) -> np.ndarray:
    """Phase 1 of ``csrc/ccl.cu``: each tile labelled on its own.

    A tile's forest lives in tile-local raster indices (stride ``tile[1]``).
    Every set pixel starts linked to the first pixel of its run along the
    row; each row unites with the one above where a run of pixels set in
    both rows begins; then each run's first pixel takes its root. Returns
    (H, W) int64 provisional labels: the global flat index of each pixel's
    local root (its local component's minimum), -1 off the mask.
    """
    m = (np.asarray(mask) != 0).tolist()
    h, w = len(m), len(m[0]) if m else 0
    th, tw = tile
    rng = np.random.default_rng(seed)
    labels = np.full((h, w), -1, dtype=np.int64)

    for ty0 in range(0, h, th):
        for tx0 in range(0, w, tw):
            def on(ly: int, lx: int) -> bool:
                y, x = ty0 + ly, tx0 + lx
                return y < h and x < w and m[y][x]

            s = [-1] * (th * tw)
            starts = []  # each run's first pixel
            for ly in range(th):
                first = -1
                for lx in range(tw):
                    if on(ly, lx):
                        if first < 0:
                            first = ly * tw + lx
                            starts.append(first)
                        s[ly * tw + lx] = first
                    else:
                        first = -1
            pairs = [
                (ly * tw + lx, (ly - 1) * tw + lx)
                for ly in range(1, th) for lx in range(tw)
                if on(ly, lx) and on(ly - 1, lx)
                and not (lx > 0 and on(ly, lx - 1) and on(ly - 1, lx - 1))
            ]
            _unite_interleaved(s, pairs, rng, lanes)
            for i in starts:
                s[i] = _find(s, i)
            for ly in range(min(th, h - ty0)):
                for lx in range(min(tw, w - tx0)):
                    if on(ly, lx):
                        r = s[s[ly * tw + lx]]  # the run's first pixel holds the root
                        labels[ty0 + ly, tx0 + lx] = (ty0 + r // tw) * w + tx0 + r % tw
    return labels


def ccl_blocked_border_pairs(mask: np.ndarray, tile: tuple[int, int] = (32, 32)) -> list:
    """Phase 2's unions: (pixel, neighbour) flat indices across each tile's
    top row and left column, less those that a neighbour's union already
    joins (left and up-left set on a top row, up and up-left on a left
    column, inside one tile)."""
    m = np.asarray(mask) != 0
    h, w = m.shape
    th, tw = tile
    pairs = []
    for y in range(th, h, th):
        for x in range(w):
            if not (m[y, x] and m[y - 1, x]):
                continue
            if x % tw and m[y, x - 1] and m[y - 1, x - 1]:
                continue
            pairs.append((y * w + x, (y - 1) * w + x))
    for x in range(tw, w, tw):
        for y in range(h):
            if not (m[y, x] and m[y, x - 1]):
                continue
            if y % th and m[y - 1, x] and m[y - 1, x - 1]:
                continue
            pairs.append((y * w + x, y * w + x - 1))
    return pairs


def ccl_blocked(mask: np.ndarray, tile: tuple[int, int] = (32, 32), seed: int = 0,
                lanes: int = 32) -> np.ndarray:
    """Plain mirror of ``csrc/ccl.cu``'s three phases, for the tests.

    1. local: :func:`ccl_blocked_local`;
    2. border: the unions of :func:`ccl_blocked_border_pairs` on the label
       array as a forest of global flat indices, interleaved as threads race
       (``lanes`` in flight, order and steps drawn from ``seed``); each marks
       the tiles of its two pixels;
    3. compress: in the marked tiles only, every label set to its root, the
       root written over each parent on the chain walked, pixels in a random
       order. An unmarked tile keeps its local labels.
    Returns (H, W) int32 canonical labels, as :func:`ccl_unionfind_host`.
    """
    rng = np.random.default_rng(seed + 1)
    local = ccl_blocked_local(mask, tile, seed, lanes)
    h, w = local.shape
    th, tw = tile
    parent = local.reshape(-1).tolist()
    pairs = ccl_blocked_border_pairs(mask, tile)
    _unite_interleaved(parent, pairs, rng, lanes)
    marked = {(i // w // th, i % w // tw) for pair in pairs for i in pair}
    for i in rng.permutation(len(parent)).tolist():
        l = parent[i]
        if l < 0 or (i // w // th, i % w // tw) not in marked:
            continue
        r = _find(parent, l)
        while l != r:
            parent[l], l = r, parent[l]
        parent[i] = r
    return np.asarray(parent, dtype=np.int32).reshape(local.shape)


def _ccl_scan_1d(labels: torch.Tensor, mask: torch.Tensor, dim: int, reverse: bool) -> torch.Tensor:
    """Min-label propagation along ``dim`` within mask runs.

    v_i = min(l_i, v_{i-1} if mask_i else +inf), v_{-1} = +inf. Off the mask
    v_i = l_i, so v is also the pass's output.
    """
    out = torch.empty_like(labels)
    big = torch.full_like(labels.select(dim, 0), _BIG)
    prev = big
    for i in range(labels.shape[dim] - 1, -1, -1) if reverse else range(labels.shape[dim]):
        oi = out.select(dim, i)
        torch.minimum(labels.select(dim, i), torch.where(mask.select(dim, i), prev, big), out=oi)
        prev = oi
    return out


def ccl_sweep_ref(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    l = _ccl_scan_1d(labels, mask, dim=-2, reverse=False)
    l = _ccl_scan_1d(l, mask, dim=-2, reverse=True)
    l = _ccl_scan_1d(l, mask, dim=-1, reverse=False)
    l = _ccl_scan_1d(l, mask, dim=-1, reverse=True)
    return l


def ccl_ref(mask: torch.Tensor, max_iters: int = REF_MAX_ITERS) -> torch.Tensor:
    """Min-label propagation to fixed point; canonical (min flat index)."""
    mask_b = mask != 0
    h, w = mask.shape[-2], mask.shape[-1]
    init = torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(h, w)
    init = init.expand(mask.shape)
    prev = torch.where(mask_b, init, torch.full_like(init, _BIG))
    l = ccl_sweep_ref(prev, mask_b)
    it = 1
    while it < max_iters and bool((l != prev).any()):
        prev, l = l, ccl_sweep_ref(l, mask_b)
        it += 1
    return torch.where(mask_b, l, torch.full_like(l, -1))


# --------------------------------------------------------------------------
# GLCM + histogram texture features (feature computation stage)
# --------------------------------------------------------------------------
def quantize_ref(tile: torch.Tensor, num_bins: int) -> torch.Tensor:
    """float [0,1] -> int32 bins [0, num_bins); ``.to(int32)`` truncates."""
    return torch.clamp((tile * num_bins).to(torch.int32), 0, num_bins - 1)


def _one_hot(x: torch.Tensor, num_bins: int) -> torch.Tensor:
    """float32 one-hot; out-of-range values give an all-zero row."""
    iota = torch.arange(num_bins, dtype=x.dtype, device=x.device)
    return (x.unsqueeze(-1) == iota).to(torch.float32)


def glcm_ref(bins: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Horizontal-neighbor co-occurrence counts: (..., NB, NB) float32."""
    lead = bins.shape[:-2]
    lhot = _one_hot(bins[..., :, :-1].reshape(*lead, -1), num_bins)
    rhot = _one_hot(bins[..., :, 1:].reshape(*lead, -1), num_bins)
    return torch.einsum("...pa,...pb->...ab", lhot, rhot)


def glcm_bands_ref(
    bins: torch.Tensor, num_bins: int, rows: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The partial counts of the GLCM kernel's row bands: the tiles of
    ``bins`` (..., H, W) cut into bands of ``rows`` rows (the last may be
    shorter) -> (glcm (..., bands, NB, NB), hist (..., bands, NB)). Pairs are
    horizontal, so summed over the bands they are ``glcm_ref`` and
    ``histogram_ref`` of the whole tiles."""
    parts = [bins[..., y:y + rows, :] for y in range(0, bins.shape[-2], rows)]
    return (torch.stack([glcm_ref(p, num_bins) for p in parts], dim=-3),
            torch.stack([histogram_ref(p, num_bins) for p in parts], dim=-2))


def glcm_features_ref(glcm: torch.Tensor) -> torch.Tensor:
    """Haralick features from a GLCM: (contrast, energy, homogeneity,
    entropy, correlation) -> (..., 5)."""
    nb = glcm.shape[-1]
    dims = (-2, -1)
    p = glcm / torch.clamp(glcm.sum(dim=dims, keepdim=True), min=1e-12)
    i = torch.arange(nb, dtype=torch.float32, device=glcm.device)[:, None]
    j = torch.arange(nb, dtype=torch.float32, device=glcm.device)[None, :]
    contrast = (p * (i - j) ** 2).sum(dim=dims)
    energy = (p**2).sum(dim=dims)
    homogeneity = (p / (1.0 + torch.abs(i - j))).sum(dim=dims)
    entropy = -(p * torch.log(torch.clamp(p, 1e-12, 1.0))).sum(dim=dims)
    mu_i = (p * i).sum(dim=dims)
    mu_j = (p * j).sum(dim=dims)
    var_i = (p * (i - mu_i[..., None, None]) ** 2).sum(dim=dims)
    var_j = (p * (j - mu_j[..., None, None]) ** 2).sum(dim=dims)
    cov = (p * (i - mu_i[..., None, None]) * (j - mu_j[..., None, None])).sum(dim=dims)
    corr = cov / torch.clamp(torch.sqrt(var_i * var_j), min=1e-12)
    return torch.stack([contrast, energy, homogeneity, entropy, corr], dim=-1)


def histogram_ref(bins: torch.Tensor, num_bins: int) -> torch.Tensor:
    return _one_hot(bins.reshape(*bins.shape[:-2], -1), num_bins).sum(dim=-2)


def histogram_features_ref(hist: torch.Tensor) -> torch.Tensor:
    """(mean, std, skewness, kurtosis) of the quantized intensity dist."""
    nb = hist.shape[-1]
    n = torch.clamp(hist.sum(dim=-1, keepdim=True), min=1e-12)
    p = hist / n
    x = torch.arange(nb, dtype=torch.float32, device=hist.device)
    mean = (p * x).sum(dim=-1)
    var = (p * (x - mean[..., None]) ** 2).sum(dim=-1)
    std = torch.sqrt(torch.clamp(var, min=1e-12))
    skew = (p * ((x - mean[..., None]) / std[..., None]) ** 3).sum(dim=-1)
    kurt = (p * ((x - mean[..., None]) / std[..., None]) ** 4).sum(dim=-1)
    return torch.stack([mean, std, skew, kurt], dim=-1)


# --------------------------------------------------------------------------
# Percentile (threshold normalisation)
# --------------------------------------------------------------------------
def percentile(x: torch.Tensor, q) -> torch.Tensor:
    """``jnp.percentile(x, q)`` over all elements, default "linear" method.

    One ``torch.sort`` serves every quantile in ``q`` (a number or a
    sequence). ``torch.quantile`` is not used: it refuses inputs above 2**24
    elements. The positions and weights follow jnp's float32 arithmetic.
    """
    s = torch.sort(x.reshape(-1)).values
    qs = np.atleast_1d(np.asarray(q, np.float32)) / np.float32(100)
    nf = np.float32(s.numel())
    pos = qs * (nf - np.float32(1))
    low, high = np.floor(pos), np.ceil(pos)
    hw = (pos - low).astype(np.float32)
    lw = (np.float32(1) - hw).astype(np.float32)
    low = np.clip(low, 0, nf - 1).astype(np.int64)
    high = np.clip(high, 0, nf - 1).astype(np.int64)

    def dev(a):
        with spans.sync("percentile", s.device):
            return torch.as_tensor(a, device=s.device)

    out = s[dev(low)] * dev(lw) + s[dev(high)] * dev(hw)
    return out if np.ndim(q) else out[0]


# --------------------------------------------------------------------------
# Attention (LM path)
# --------------------------------------------------------------------------
def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Softmax attention with GQA + causal + sliding window, materialized.

    q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D); returns (B, Hq, Tq, D) in q's
    dtype. Queries sit at absolute positions ``q_offset + arange(Tq)``. A
    query with no visible key gives 0.
    """
    _, hq, tq, d = q.shape
    tk = k.shape[2]
    group = hq // k.shape[1]
    kr = torch.repeat_interleave(k, group, dim=1)
    vr = torch.repeat_interleave(v, group, dim=1)
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    qpos = q_offset + torch.arange(tq, device=q.device)[:, None]
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.nan_to_num(torch.softmax(logits, dim=-1), nan=0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vr.float()).to(q.dtype)


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int = 0,
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over key chunks (``repro.kernels.ref.
    attention_chunked_ref``): the (Tq, Tk) scores are never built, only a
    (Tq, chunk) block at a time, with the running max, sum and accumulator
    carried in float32 from chunk to chunk.

    q/k: (B, Hq|Hkv, T, D); v: (B, Hkv, Tk, Dv); returns (B, Hq, Tq, Dv) in
    q's dtype. GQA is a grouped einsum (no repeated K/V in memory). K and V
    are padded with zeros to whole chunks and the padded keys masked. The
    fill is -1e30, not -inf, and a row with no visible key gives 0 by the
    ``l > 0`` guard, as in the reference. One difference: the accumulator
    takes v's head dim, not q's, so MLA's v runs under a wider q/k (the
    reference reshapes v with q's head dim and raises there).
    """
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    dv = v.shape[-1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    chunk = min(chunk, tk)
    n_chunks = -(-tk // chunk)
    pad = n_chunks * chunk - tk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    f32 = torch.float32
    qg = q.reshape(b, hkv, g, tq, d).to(f32)
    qpos = q_offset + torch.arange(tq, device=q.device)
    m = torch.full((b, hkv, g, tq), -1e30, dtype=f32, device=q.device)
    l = torch.zeros((b, hkv, g, tq), dtype=f32, device=q.device)
    acc = torch.zeros((b, hkv, g, tq, dv), dtype=f32, device=q.device)
    for ci in range(n_chunks):
        kb = k[:, :, ci * chunk:(ci + 1) * chunk].to(f32)
        vb = v[:, :, ci * chunk:(ci + 1) * chunk].to(f32)
        s = torch.einsum("bkgqd,bkcd->bkgqc", qg, kb) * scale
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        mask = (kpos < tk)[None, :]
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        if window is not None:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqc,bkcd->bkgqd", p, vb)
        m = m_new
    out = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return out.reshape(b, hq, tq, dv).to(q.dtype)


# --------------------------------------------------------------------------
# Mamba2 SSD scan (LM path)
# --------------------------------------------------------------------------
def ssd_scan_ref(
    x: torch.Tensor,  # (B, T, H, P)
    dt: torch.Tensor,  # (B, T, H)        softplus-ed step sizes
    a: torch.Tensor,  # (H,)              negative decay rates (A = -exp(a_log))
    b_: torch.Tensor,  # (B, T, G, N)
    c_: torch.Tensor,  # (B, T, G, N)
    d_: torch.Tensor | None = None,  # (H,) skip
    h0: torch.Tensor | None = None,  # (B, H, N, P) initial state
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential state-space-duality scan, one step per position:

    h_t = exp(dt_t * a) * h_{t-1} + dt_t * B_t x_t^T ;  y_t = C_t^T h_t (+ D x).
    Returns (y: (B,T,H,P) in x's dtype, h_final: (B,H,N,P) float32).
    """
    bsz, t, h, p = x.shape
    g, n = b_.shape[2], b_.shape[3]
    rep = h // g
    f32 = torch.float32
    bh = torch.repeat_interleave(b_.to(f32), rep, dim=2)  # (B, T, H, N)
    ch = torch.repeat_interleave(c_.to(f32), rep, dim=2)
    dt32 = dt.to(f32)
    decay = torch.exp(dt32 * a.to(f32)[None, None, :])  # (B, T, H)
    dtb = dt32[..., None] * bh  # (B, T, H, N)
    x32 = x.to(f32)
    hcur = (torch.zeros((bsz, h, n, p), dtype=f32, device=x.device) if h0 is None
            else h0.to(f32))
    ys = []
    for i in range(t):
        hcur = decay[:, i, :, None, None] * hcur + dtb[:, i, :, :, None] * x32[:, i, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", ch[:, i], hcur))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(x32)
    if d_ is not None:
        y = y + d_.to(f32)[None, None, :, None] * x32
    return y.to(x.dtype), hcur


# The chunked form, in the three phases of ``csrc/ssd_scan.cu``: a plain
# mirror of the kernel's decomposition, for the tests (``ops.ssd_scan`` keeps
# the sequential recurrence above as the plain version). T is padded with
# zeros to whole chunks: a padded step has dt = 0, so it neither decays the
# state nor adds to it, and its cum repeats the chunk's total.
def _to_chunks(v: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, T, H, ...) float32 -> (B, H, nc, L, ...), zero-padded along T."""
    t = v.shape[1]
    nc = -(-t // chunk)
    pad = torch.zeros((v.shape[0], nc * chunk - t, *v.shape[2:]), dtype=v.dtype,
                      device=v.device)
    v = torch.cat([v, pad], dim=1).reshape(v.shape[0], nc, chunk, *v.shape[2:])
    return v.permute(0, 3, 1, 2, *range(4, v.dim())).float()


def _split(v: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """v as the tensor-core kernels multiply it: two parts of ``dtype`` (v
    rounded, and what the rounding left, rounded again), summed in float32;
    v itself where ``dtype`` is None."""
    if dtype is None:
        return v
    hi = v.to(dtype).float()
    return hi + (v - hi).to(dtype).float()


def ssd_chunk_state_ref(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_: torch.Tensor, chunk: int,
    split_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase 1: (cum, dt, S), each chunk's inclusive cumsum of dt*a and its
    dt, (B, H, nc, L), and its own state S_c = sum_j exp(total - cum_j) dt_j
    B_j x_j^T, (B, H, nc, N, P), all float32. ``split_dtype`` splits the
    weighted w_j B_j into two parts of that dtype (``_split``) before the
    product with x, as the tensor-core instance does with bf16."""
    rep = x.shape[2] // b_.shape[2]
    dth = _to_chunks(dt[..., None], chunk)[..., 0]
    cum = torch.cumsum(dth * a.float()[None, :, None, None], dim=-1)
    w = torch.exp(cum[..., -1:] - cum) * dth
    bh = _to_chunks(torch.repeat_interleave(b_, rep, dim=2), chunk)
    wb = _split(bh * w[..., None], split_dtype)
    states = torch.einsum("bhcln,bhclp->bhcnp", wb, _to_chunks(x, chunk))
    return cum, dth, states


def ssd_state_passing_ref(
    states: torch.Tensor, cum: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 2: (the state entering each chunk (B, H, nc, N, P), the final
    state (B, H, N, P)), by H_c = exp(total_{c-1}) H_{c-1} + S_{c-1}."""
    entering = torch.empty_like(states)
    hcur = torch.zeros_like(states[:, :, 0])
    for c in range(states.shape[2]):
        entering[:, :, c] = hcur
        hcur = torch.exp(cum[:, :, c, -1])[..., None, None] * hcur + states[:, :, c]
    return entering, hcur


def ssd_chunk_scan_ref(
    x: torch.Tensor,
    b_: torch.Tensor,
    c_: torch.Tensor,
    cum: torch.Tensor,
    dth: torch.Tensor,
    entering: torch.Tensor,
    d_: torch.Tensor | None,
    chunk: int,
    split_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Phase 3: y (B, T, H, P) in x's dtype,
    y_i = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i.H_c + D x_i.

    exp is taken of -inf above the diagonal, never of the positive exponent
    there. ``split_dtype`` splits the scaled C B^T into two parts of that
    dtype (S rounded, and what the rounding left, rounded again) before the
    product with x, and H_c so before the product with C, as the
    tensor-core instance does with bf16.
    """
    bsz, t, h, p = x.shape
    rep = h // b_.shape[2]
    xh = _to_chunks(x, chunk)
    bh = _to_chunks(torch.repeat_interleave(b_, rep, dim=2), chunk)
    ch = _to_chunks(torch.repeat_interleave(c_, rep, dim=2), chunk)
    live = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    seg = torch.exp(torch.where(live, cum[..., :, None] - cum[..., None, :],
                                torch.tensor(float("-inf"), device=x.device)))
    s = torch.einsum("bhcln,bhcmn->bhclm", ch, bh) * seg * dth[..., None, :]
    y = torch.einsum("bhclm,bhcmp->bhclp", _split(s, split_dtype), xh)
    inter = torch.einsum("bhcln,bhcnp->bhclp", ch, _split(entering, split_dtype))
    y = y + torch.exp(cum)[..., None] * inter
    if d_ is not None:
        y = y + d_.float()[None, :, None, None, None] * xh
    y = y.permute(0, 2, 3, 1, 4).reshape(bsz, -1, h, p)[:, :t]
    return y.to(x.dtype)


def ssd_scan_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_: torch.Tensor,
    c_: torch.Tensor,
    d_: torch.Tensor | None = None,
    *,
    chunk: int = 128,
    split_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The three phases chained: (y (B,T,H,P) in x's dtype, final state
    (B,H,N,P) float32), for any T (the last chunk may be short).
    ``split_dtype`` is the phases' hi/lo split of every operand the
    tensor-core instance splits (``ssd_chunk_state_ref``,
    ``ssd_chunk_scan_ref``); no served path sets it."""
    chunk = max(1, min(chunk, x.shape[1]))
    cum, dth, states = ssd_chunk_state_ref(x, dt, a, b_, chunk, split_dtype)
    entering, hf = ssd_state_passing_ref(states, cum)
    y = ssd_chunk_scan_ref(x, b_, c_, cum, dth, entering, d_, chunk, split_dtype)
    return y, hf
