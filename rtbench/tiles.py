"""Synthetic H&E tiles made on the device from a seed.

The data model is the one the program's own generator uses
(``pipeline/synth.py``): dark, roughly elliptical nuclei (radii 6-18
pixels, about 40 per 512^2) filled near-solid with a soft rim, over a
pinkish background with Gaussian stain noise. It is written again here in
PyTorch so that a 4096^2 tile takes milliseconds on the card instead of
half a minute of NumPy on the host.

The same seed gives the same tiles bit for bit on one device: the nuclei
are summed in fixed point (int64 atomics add in any order to the same sum)
and every random draw comes from one ``torch.Generator`` a tile.
"""
from __future__ import annotations

import numpy as np
import torch

NUCLEI_PER_512 = 40
RADIUS = (6, 18)  # ry, rx drawn from [6, 18)
REACH = 48  # half-width of the window a nucleus is drawn in; its rim is < 1e-10 beyond
FIXED_POINT = float(1 << 24)
BACKGROUND = (0.92, 0.78, 0.86)
NUCLEUS_COLOR = (0.35, 0.22, 0.55)


def tile_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for tile ``index`` of the run seeded ``seed``."""
    mask = 2**64 - 1
    ss = np.random.SeedSequence([int(seed) & mask, (int(seed) >> 64) & mask, int(index)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_tile(seed: int, size: int, device, nuclei: int | None = None) -> torch.Tensor:
    """One (3, size, size) float32 RGB tile in [0.01, 1] on ``device``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    n = NUCLEI_PER_512 * size * size // (512 * 512) if nuclei is None else nuclei
    n = max(n, 4)
    cy = torch.randint(0, size, (n,), generator=g, device=dev)
    cx = torch.randint(0, size, (n,), generator=g, device=dev)
    ry = torch.randint(RADIUS[0], RADIUS[1], (n,), generator=g, device=dev).to(torch.float32)
    rx = torch.randint(RADIUS[0], RADIUS[1], (n,), generator=g, device=dev).to(torch.float32)
    theta = torch.rand((n,), generator=g, device=dev) * np.float32(np.pi)
    off = torch.arange(-REACH, REACH + 1, device=dev)
    yy = cy[:, None, None] + off[None, :, None]  # (n, P, 1)
    xx = cx[:, None, None] + off[None, None, :]  # (n, 1, P)
    dy, dx = (yy - cy[:, None, None]).to(torch.float32), (xx - cx[:, None, None]).to(torch.float32)
    ca, sa = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    u = (ca * dx + sa * dy) / rx[:, None, None]
    v = (-sa * dx + ca * dy) / ry[:, None, None]
    r2 = u * u + v * v
    contrib = torch.where(r2 < 1.0, torch.full_like(r2, 0.85), torch.exp(-4.0 * (r2 - 1.0)) * 0.25)
    inside = (yy >= 0) & (yy < size) & (xx >= 0) & (xx < size)
    flat = (yy.clamp(0, size - 1) * size + xx.clamp(0, size - 1)).expand_as(contrib)
    fixed = torch.where(inside, torch.round(contrib * FIXED_POINT), torch.zeros_like(contrib))
    acc = torch.zeros(size * size, dtype=torch.int64, device=dev)
    acc.index_add_(0, flat.reshape(-1), fixed.to(torch.int64).reshape(-1))
    density = torch.clamp(acc.to(torch.float32) / FIXED_POINT, 0.0, 1.0).reshape(1, size, size)
    del u, v, r2, contrib, fixed, flat, acc
    bg = torch.tensor(BACKGROUND, device=dev)[:, None, None] + 0.04 * torch.randn(
        (3, size, size), generator=g, device=dev)
    nuc = torch.tensor(NUCLEUS_COLOR, device=dev)[:, None, None]
    rgb = bg * (1.0 - density) + nuc * density
    noise = 0.01 * torch.randn((3, size, size), generator=g, device=dev)
    return torch.clamp(rgb + noise, 0.01, 1.0).contiguous()


def make_pool(seed: int, count: int, size: int, device) -> list[np.ndarray]:
    """``count`` distinct tiles made on ``device`` and handed over as host
    arrays, as users hand the program host tiles."""
    return [make_tile(tile_seed(seed, i), size, device).cpu().numpy() for i in range(count)]
