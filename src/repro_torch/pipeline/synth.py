"""Synthetic WSI tile generator (nuclei-like blobs).

The paper's brain-tumor images are not redistributable; tiles here have
the same geometry (NxN, 3-channel) and the statistics the pipeline needs:
dark roughly-elliptical nuclei over a bright eosin-ish background, with
ground-truth masks for pipeline validation.

A copy of ``repro.pipeline.synth`` (numpy only), kept so the port loads
no module of the JAX package.
"""
from __future__ import annotations

import numpy as np


def make_tile(
    size: int = 512,
    *,
    num_nuclei: int = 40,
    radius: tuple[int, int] = (6, 18),
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (rgb (3, H, W) float32 in [0,1], mask (H, W) uint8)."""
    rng = np.random.default_rng(seed)
    h = w = size
    yy, xx = np.mgrid[0:h, 0:w]
    mask = np.zeros((h, w), np.uint8)
    density = np.zeros((h, w), np.float32)
    for _ in range(num_nuclei):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        ry = rng.integers(radius[0], radius[1])
        rx = rng.integers(radius[0], radius[1])
        theta = rng.uniform(0, np.pi)
        ca, sa = np.cos(theta), np.sin(theta)
        dy, dx = yy - cy, xx - cx
        u = (ca * dx + sa * dy) / rx
        v = (-sa * dx + ca * dy) / ry
        r2 = u * u + v * v
        blob = r2 < 1.0
        mask |= blob.astype(np.uint8)
        # near-solid fill inside the ellipse (nuclei stain densely), soft rim
        density += np.where(blob, 0.85, np.exp(-4.0 * (r2 - 1.0)) * 0.25).astype(
            np.float32
        )
    density = np.clip(density, 0, 1)
    # H&E-ish render: background pinkish, nuclei purple-dark
    bg = np.stack(
        [
            0.92 + 0.04 * rng.standard_normal((h, w)),
            0.78 + 0.04 * rng.standard_normal((h, w)),
            0.86 + 0.04 * rng.standard_normal((h, w)),
        ]
    ).astype(np.float32)
    nucleus_color = np.array([0.35, 0.22, 0.55], np.float32)[:, None, None]
    rgb = bg * (1.0 - density[None]) + nucleus_color * density[None]
    rgb = np.clip(rgb + 0.01 * rng.standard_normal(rgb.shape).astype(np.float32), 0.01, 1.0)
    return rgb.astype(np.float32), mask


def make_slide(
    tiles_y: int,
    tiles_x: int,
    tile: int = 256,
    *,
    seed: int = 0,
    num_nuclei: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """A small multi-tile 'whole slide': (3, Y*tile, X*tile) + mask.

    Nuclei density scales with tile area (default ~40 per 512x512) so
    small demo tiles stay realistically sparse instead of merging.
    """
    if num_nuclei is None:
        num_nuclei = max(4, int(40 * (tile / 512.0) ** 2))
    rgb = np.zeros((3, tiles_y * tile, tiles_x * tile), np.float32)
    mask = np.zeros((tiles_y * tile, tiles_x * tile), np.uint8)
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            t_rgb, t_mask = make_tile(
                tile, num_nuclei=num_nuclei, seed=seed * 1000 + ty * tiles_x + tx
            )
            rgb[:, ty * tile : (ty + 1) * tile, tx * tile : (tx + 1) * tile] = t_rgb
            mask[ty * tile : (ty + 1) * tile, tx * tile : (tx + 1) * tile] = t_mask
    return rgb, mask
