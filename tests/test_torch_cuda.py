"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where no CUDA device is present. Run on a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.wsi import WSIConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.glcm import glcm_cuda
from repro_torch.pipeline import analyze_tile, make_tile

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev):
    return torch.as_tensor(a, device=dev)


@pytest.mark.parametrize("h,w", [(32, 128), (48, 96), (257, 131)])
def test_color_deconv_cuda(dev, h, w):
    rng = np.random.default_rng(h * w)
    rgb = _t(rng.random((3, h, w), dtype=np.float32), dev)
    minv = _t(ref.stain_inverse(), dev)
    got = ops.color_deconv(rgb, minv, impl="cuda")
    torch.testing.assert_close(got, ops.color_deconv(rgb, minv, impl="torch"),
                               rtol=2e-5, atol=2e-5)
    white = ops.color_deconv(torch.ones((3, 8, 128), device=dev), minv, impl="cuda")
    assert float(white.abs().max()) <= 1e-5


@pytest.mark.parametrize("max_iters", [1, 2, 128])
@pytest.mark.parametrize("h,w", [(32, 48), (97, 64), (200, 333)])
def test_morph_recon_cuda_iterate_for_iterate(dev, h, w, max_iters):
    rng = np.random.default_rng(h + w + max_iters)
    mask = (rng.random((h, w)) > 0.35).astype(np.float32)
    marker = (rng.random((h, w)) * (rng.random((h, w)) > 0.97)).astype(np.float32) * mask
    mk, ms = _t(marker, dev), _t(mask, dev)
    got = ops.morph_recon(mk, ms, impl="cuda", max_iters=max_iters)
    want = ops.morph_recon(mk, ms, impl="torch", max_iters=max_iters)
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fill_holes_cuda(dev, seed):
    rng = np.random.default_rng(seed)
    m = (rng.random((128, 160)) < 0.55).astype(np.float32)
    m[40:80, 40:80] = 1.0
    m[55:65, 55:65] = 0.0  # a hole
    x = _t(m, dev)
    got = ops.fill_holes(x, impl="cuda")
    assert torch.equal(got, ops.fill_holes(x, impl="torch"))
    assert float(got[60, 60]) == 1.0


def _snake(h, w):
    m = np.zeros((h, w), bool)
    m[::2, :] = True
    for r in range(1, h, 2):
        m[r, -1 if (r // 2) % 2 == 0 else 0] = True
    return m


@pytest.mark.parametrize("case", ["d0.2", "d0.4", "d0.6", "snake", "d0.6-big", "d0.5-big"])
def test_ccl_cuda_matches_plain(dev, case):
    if case == "snake":
        m = _snake(63, 70)
    else:
        density = float(case.split("-")[0][1:])
        size = (1024, 1536) if case.endswith("big") else (48, 80)
        m = np.random.default_rng(len(case)).random(size) < density
    x = _t(m.astype(np.int32), dev)
    got = ops.connected_components(x, impl="cuda")
    torch.cuda.synchronize()
    if m.size <= 48 * 80 or case == "snake":
        np.testing.assert_array_equal(got.cpu().numpy(), ref.ccl_unionfind_host(m))
    else:  # the sweep version needs few sweeps on random masks; check canonical form
        want = ops.connected_components(x, impl="torch", max_iters=10_000)
        assert torch.equal(got, want)


@pytest.mark.parametrize("h,w", [(4095, 4096), (1023, 3000)])
def test_ccl_cuda_long_snake_is_one_component(dev, h, w):
    """A snake through the whole image: union chains as long as the image,
    one component, labelled 0 (its first pixel) everywhere on the mask."""
    m = torch.as_tensor(_snake(h, w).astype(np.int32), device=dev)
    got = ops.connected_components(m, impl="cuda")
    want = torch.where(m != 0, torch.zeros_like(m), torch.full_like(m, -1))
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,h,w,nb", [(2, 16, 16, 8), (4, 24, 32, 16), (512, 64, 64, 32),
                                      (3, 20, 20, 240)])
def test_glcm_cuda_exact(dev, b, h, w, nb):
    rng = np.random.default_rng(b * nb)
    bins = _t(rng.integers(-1, nb + 1, (b, h, w), dtype=np.int32), dev)
    g, hist = ops.glcm_histogram(bins, nb, impl="cuda")
    g_ref, h_ref = ops.glcm_histogram(bins, nb, impl="torch")
    assert torch.equal(g, g_ref)
    assert torch.equal(hist, h_ref)


def test_glcm_cuda_refuses_oversized_bins(dev):
    with pytest.raises(ValueError, match="shared memory"):
        glcm_cuda(torch.zeros((1, 8, 8), dtype=torch.int32, device=dev), 241)


def test_analyze_tile_cuda_matches_plain(dev):
    rgb, _ = make_tile(256, num_nuclei=20, seed=7)
    cfg = WSIConfig(seg_threshold=0.5, nucleus_roi=32)
    got = analyze_tile(rgb, cfg)
    want = analyze_tile(rgb, cfg, impl="torch")
    torch.testing.assert_close(got["hematoxylin"], want["hematoxylin"], rtol=0, atol=1e-4)
    if torch.equal(got["mask"], want["mask"]):
        assert torch.equal(got["labels"], want["labels"])
        assert torch.equal(got["boxes"], want["boxes"])
        torch.testing.assert_close(got["features"], want["features"], rtol=1e-4, atol=1e-4)
