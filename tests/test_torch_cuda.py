"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where no CUDA device is present. Run on a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.wsi import WSIConfig
from repro_torch.kernels import ccl, flash_attention, glcm, ops, ref, ssd_scan
from repro_torch.kernels.glcm import glcm_cuda
from repro_torch.models import HybridLM, ModelConfig
from repro_torch.pipeline import analyze_tile, make_tile
from repro_torch.serve import generate

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


def _converged_plain(marker, mask):
    """The plain reconstruction run to its fixed point, checked to be one."""
    want = ops.morph_recon(marker, mask, impl="torch", max_iters=100_000)
    converged = torch.equal(ref.morph_recon_sweep_ref(want, mask), want)
    assert converged, "the plain version did not converge"
    return want


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("h,w", [(32, 48), (97, 64), (200, 333), (257, 131)])
def test_morph_recon_cuda_reaches_the_fixed_point(dev, h, w, seed):
    """The wavefront kernel equals the converged plain version bit for bit,
    on sizes that are no multiple of its 64x64 tile, and is itself a fixed
    point of the plain sweep."""
    rng = np.random.default_rng(h + w + seed)
    mask = (rng.random((h, w)) > 0.35).astype(np.float32) * rng.random((h, w), dtype=np.float32)
    marker = (rng.random((h, w)) * (rng.random((h, w)) > 0.97)).astype(np.float32)
    mk, ms = _t(marker, dev), _t(mask, dev)
    got = ops.morph_recon(mk, ms, impl="cuda")
    assert torch.equal(got, _converged_plain(mk, ms))
    assert torch.equal(ref.morph_recon_sweep_ref(got, ms), got)


def test_morph_recon_cuda_ignores_max_iters(dev):
    """The kernel has no cap: max_iters changes the plain result, not the card's."""
    rng = np.random.default_rng(5)
    mask = (rng.random((97, 64)) > 0.3).astype(np.float32)
    marker = np.zeros_like(mask)
    marker[-1, -1] = 1.0
    mk, ms = _t(marker, dev), _t(mask, dev)
    capped = ops.morph_recon(mk, ms, impl="torch", max_iters=1)
    full = _converged_plain(mk, ms)
    assert not torch.equal(capped, full)  # one sweep does not reach the fixed point here
    for max_iters in (1, 2, 128):
        assert torch.equal(ops.morph_recon(mk, ms, impl="cuda", max_iters=max_iters), full)


def _serpentine_path(h, w):
    """Pixels of the serpentine corridor (``_snake``) in order along it."""
    ys, xs = [], []
    for r in range(0, h, 2):
        cols = np.arange(w) if (r // 2) % 2 == 0 else np.arange(w - 1, -1, -1)
        ys.append(np.full(w, r))
        xs.append(cols)
        if r + 1 < h:
            ys.append(np.array([r + 1]))
            xs.append(np.array([w - 1 if (r // 2) % 2 == 0 else 0]))
    return np.concatenate(ys), np.concatenate(xs)


def test_morph_recon_cuda_serpentine_corridor(dev):
    """The worst case: a 1-pixel corridor that crosses some 24,000 tile edges
    from one end to the other. Seeded at its start, the reconstruction along
    it is the running minimum of the mask, and zero off it."""
    h, w = 1023, 3000
    ys, xs = _serpentine_path(h, w)
    vals = (0.5 + 0.5 * np.random.default_rng(9).random(ys.size)).astype(np.float32)
    mask = np.zeros((h, w), np.float32)
    mask[ys, xs] = vals
    assert np.array_equal(mask != 0, _snake(h, w))
    marker = np.zeros_like(mask)
    marker[0, 0] = 1.0
    want = np.zeros_like(mask)
    want[ys, xs] = np.minimum.accumulate(vals)
    ms = _t(mask, dev)
    got = ops.morph_recon(_t(marker, dev), ms, impl="cuda")
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert torch.equal(ref.morph_recon_sweep_ref(got, ms), got)


def test_fill_holes_cuda_full_tile(dev):
    """Fill-holes at the main path's 4096^2 against the converged plain version."""
    rng = np.random.default_rng(4096)
    x = _t((rng.random((4096, 4096)) < 0.55).astype(np.float32), dev)
    got = ops.fill_holes(x, impl="cuda")
    seed, inv = ref.fill_holes_seed(x)
    assert torch.equal(got, 1.0 - _converged_plain(seed, inv))


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


def _canonical_labels(m):
    """Canonical labels (minimum flat index, -1 off the mask) of a large mask
    from scipy's raster-order labelling: a component's first pixel in raster
    order is its minimum flat index."""
    from scipy import ndimage

    lab, _ = ndimage.label(m)  # 4-connected by default in 2-D
    _, first = np.unique(lab.reshape(-1), return_index=True)
    return np.where(lab > 0, first.astype(np.int64)[lab], -1).astype(np.int32)


def test_canonical_labels_helper_matches_union_find():
    m = np.random.default_rng(3).random((40, 57)) < 0.55
    np.testing.assert_array_equal(_canonical_labels(m), ref.ccl_unionfind_host(m))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ccl_cuda_components_cross_tile_corners(dev, seed):
    """Shapes centred on 32x32 tile corners and edges: diagonal staircases,
    plus signs, rings and random blobs that join four tiles at one point."""
    rng = np.random.default_rng(seed)
    h, w = 137, 170
    m = rng.random((h, w)) < 0.3
    for cy in range(32, h - 4, 32):
        for cx in range(32, w - 5, 32):
            m[cy - 3:cy + 3, cx] = True  # a plus across the corner
            m[cy, cx - 3:cx + 3] = True
            for d in range(-4, 4):  # a staircase through the corner
                m[cy + d, cx + d] = m[cy + d, cx + d + 1] = True
            m[cy - 6:cy - 4, cx - 1:cx + 1] = True  # a 2x2 block split four ways
    m[0:32, 31:33] = True  # a bar along a tile column border
    got = ops.connected_components(_t(m.astype(np.int32), dev), impl="cuda")
    np.testing.assert_array_equal(got.cpu().numpy(), ref.ccl_unionfind_host(m))


@pytest.mark.parametrize("h,w", [(4096, 4096), (4095, 4097), (1, 5000), (5000, 1)])
def test_ccl_cuda_full_mask_is_all_zero(dev, h, w):
    """One component through every tile: the worst contention on one root
    (one border union per tile edge, every compression to 0)."""
    got = ops.connected_components(torch.ones((h, w), dtype=torch.int32, device=dev),
                                   impl="cuda")
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("h,w", [(4096, 4096), (67, 93)])
def test_ccl_cuda_checkerboard_is_one_label_a_pixel(dev, h, w):
    """Every set pixel is its own component: label = own flat index."""
    yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    m = ((yy + xx) % 2 == 0).to(torch.int32)
    flat = (yy * w + xx).to(torch.int32)
    got = ops.connected_components(m, impl="cuda")
    assert torch.equal(got, torch.where(m != 0, flat, torch.full_like(flat, -1)))


@pytest.mark.parametrize("density", [0.4, 0.6])
def test_ccl_cuda_ragged_large_mask(dev, density):
    """4095x4097: neither side a multiple of the 32x32 tile and W odd, so the
    local and compress phases take their scalar loads."""
    m = np.random.default_rng(int(density * 10)).random((4095, 4097)) < density
    got = ops.connected_components(_t(m.astype(np.int32), dev), impl="cuda")
    np.testing.assert_array_equal(got.cpu().numpy(), _canonical_labels(m))


def test_ccl_cuda_unaligned_mask_takes_scalar_loads(dev):
    """W % 4 == 0 but the mask starts 4 bytes into its buffer: the 16-byte
    path does not apply and the result is the same."""
    h, w = 96, 128
    m = np.random.default_rng(11).random((h, w)) < 0.55
    buf = torch.zeros(h * w + 1, dtype=torch.int32, device=dev)
    x = buf[1:].view(h, w)
    x.copy_(_t(m.astype(np.int32), dev))
    assert x.data_ptr() % 16 != 0
    got = ops.connected_components(x, impl="cuda")
    np.testing.assert_array_equal(got.cpu().numpy(), ref.ccl_unionfind_host(m))


def test_ccl_cuda_counts_one_call_three_launches_and_times_phases(dev):
    m = torch.ones((100, 100), dtype=torch.int32, device=dev)
    calls, kernels = ccl.launches, ccl.kernel_launches
    events = []
    got = ccl.ccl_cuda(m, events=events)
    events[-1].synchronize()
    assert (ccl.launches - calls, ccl.kernel_launches - kernels) == (1, len(ccl.PHASES))
    assert len(events) == len(ccl.PHASES) + 1
    assert all(e0.elapsed_time(e1) >= 0 for e0, e1 in zip(events, events[1:]))
    assert torch.equal(got, torch.zeros_like(got))


# 8 copies of the counters at NB = 32 (the WSI path's), one at NB = 85, 16-bit
# counters at NB = 256
@pytest.mark.parametrize("nb", [32, 85, 256])
@pytest.mark.parametrize("b,h,w", [(512, 64, 64), (3, 20, 21), (2, 7, 1)])
def test_glcm_cuda_one_bin_everywhere(dev, nb, b, h, w):
    """Every bin the same: every lane of every warp hits one counter."""
    bins = torch.full((b, h, w), 3, dtype=torch.int32, device=dev)
    g, hist = glcm_cuda(bins, nb)
    want_h = torch.zeros((b, nb), device=dev)
    want_h[:, 3] = h * w
    want_g = torch.zeros((b, nb, nb), device=dev)
    want_g[:, 3, 3] = h * (w - 1)
    assert torch.equal(hist, want_h)
    assert torch.equal(g, want_g)


@pytest.mark.parametrize("nb", [32, 85, 256])
@pytest.mark.parametrize("b,h,w", [(512, 64, 64), (6, 16, 32), (7, 33, 47), (4, 20, 21),
                                   (5, 50, 1), (3, 9, 2)])
def test_glcm_cuda_out_of_range_bins_and_widths(dev, nb, b, h, w):
    """Bins -1 and NB (count nowhere) mixed with a few popular bins, on the
    16-byte path (W % 4 == 0) and the scalar one (W % 4 != 0, W = 1)."""
    rng = np.random.default_rng(b * h * w)
    vals = np.array([-1, nb, 0, 0, 0, 1, 1, 2, 3, nb - 1, 17], dtype=np.int32)
    bins = _t(vals[rng.integers(0, vals.size, (b, h, w))], dev)
    g, hist = glcm_cuda(bins, nb)
    g_ref, h_ref = ops.glcm_histogram(bins, nb, impl="torch")
    assert torch.equal(g, g_ref)
    assert torch.equal(hist, h_ref)


def test_glcm_cuda_unaligned_batch_and_events(dev):
    """A batch that starts 4 bytes into its buffer takes the scalar loads;
    events bracket the launch."""
    b, h, w, nb = 9, 16, 16, 32
    buf = torch.randint(-1, nb + 1, (b * h * w + 1,), dtype=torch.int32, device=dev)
    bins = buf[1:].view(b, h, w)
    events = []
    g, hist = glcm_cuda(bins, nb, events=events)
    events[-1].synchronize()
    assert len(events) == 2 and events[0].elapsed_time(events[1]) >= 0
    g_ref, h_ref = ops.glcm_histogram(bins, nb, impl="torch")
    assert torch.equal(g, g_ref) and torch.equal(hist, h_ref)


@pytest.mark.parametrize("b,h,w,nb", [(2, 16, 16, 8), (4, 24, 32, 16), (512, 64, 64, 32),
                                      (3, 20, 20, 240), (3, 20, 20, 241), (5, 33, 47, 256),
                                      (512, 64, 64, 256), (7, 33, 47, 300), (3, 20, 20, 340),
                                      (3, 20, 20, 341)])
def test_glcm_cuda_exact(dev, b, h, w, nb):
    rng = np.random.default_rng(b * nb)
    bins = _t(rng.integers(-1, nb + 1, (b, h, w), dtype=np.int32), dev)
    g, hist = ops.glcm_histogram(bins, nb, impl="cuda")
    g_ref, h_ref = ops.glcm_histogram(bins, nb, impl="torch")
    assert torch.equal(g, g_ref)
    assert torch.equal(hist, h_ref)


def test_glcm_cuda_refuses_oversized_bins(dev):
    """Above 240 bins the bands' counts (16-bit counters up to 340 bins) and
    the device-memory counts (above) add up in float32, exact up to 2^24 a
    count: a tile of more than 2^24 pixels is refused there; a 4096^2 tile,
    exactly 2^24, is counted, at 241, 340 and 341 bins as at 240. A packed
    band of more than 65,535 pixels is refused."""
    with pytest.raises(ValueError, match="too large"):
        glcm_cuda(torch.zeros((1, 4097, 4096), dtype=torch.int32, device=dev), 241)
    with pytest.raises(ValueError, match="too large"):
        glcm_cuda(torch.zeros((1, 4097, 4096), dtype=torch.int32, device=dev), 341)
    with pytest.raises(ValueError, match="bands"):
        glcm_cuda(torch.zeros((1, 32, 4096), dtype=torch.int32, device=dev), 256, rows=16)
    with pytest.raises(ValueError, match="at least 1"):
        glcm_cuda(torch.zeros((1, 8, 8), dtype=torch.int32, device=dev), 0)
    with pytest.raises(ValueError, match="bands"):
        glcm_cuda(torch.zeros((1, 4097, 4096), dtype=torch.int32, device=dev), 32, rows=8)
    for nb in (240, 241, 340, 341):
        g, h = glcm_cuda(torch.zeros((1, 4096, 4096), dtype=torch.int32, device=dev), nb)
        assert float(h[0, 0]) == 4096 * 4096 and float(g[0, 0, 0]) == 4096 * 4095


def _plain_glcm_by_bands(bins, nb, rows=64):
    """The plain counts of large tiles, band by band and summed (the whole
    tile's one-hot matrices would not fit the card at 256 bins); the CPU
    tests show that the band sums equal the whole."""
    g, h = ref.glcm_bands_ref(bins, nb, rows)
    return g.sum(dim=-3), h.sum(dim=-2)


# B = 1, the kernel chains' one window: row bands spread it over the card
@pytest.mark.parametrize("h,w,nb", [(4096, 4096, 32), (4096, 4096, 240), (4096, 4096, 241),
                                    (4096, 4096, 256), (4096, 4095, 256), (4095, 4096, 32),
                                    (1000, 37, 32), (4096, 4096, 340), (4096, 4096, 341),
                                    (1000, 37, 256)])
def test_glcm_cuda_one_window(dev, h, w, nb):
    gen = torch.Generator(device=dev).manual_seed(h + w + nb)
    bins = torch.randint(-1, nb + 1, (1, h, w), generator=gen, dtype=torch.int32, device=dev)
    bins[0, : h // 2, : w // 2] = nb // 3  # a popular bin: many blocks add into one counter
    which = glcm.route(nb, w)
    assert which == ("shared" if nb <= 240 else "packed" if nb <= 340 else "global")
    before = glcm.route_launches[which]
    g, hist = glcm_cuda(bins, nb)
    assert glcm.route_launches[which] == before + 1
    g_ref, h_ref = _plain_glcm_by_bands(bins, nb)
    assert torch.equal(g, g_ref)
    assert torch.equal(hist, h_ref)
    assert float(hist.sum()) == float(((bins >= 0) & (bins < nb)).sum())


@pytest.mark.parametrize("rows", [1, 7, 8, 64])
@pytest.mark.parametrize("nb", [32, 85, 256])
def test_glcm_cuda_bands_equal_one_block_a_tile(dev, rows, nb):
    """The band split against the one-block-a-tile launch (the WSI path's,
    on its 512 x 64^2 batch), on the 16-byte path and the scalar one."""
    gen = torch.Generator(device=dev).manual_seed(rows * nb)
    for w in (64, 63):
        bins = torch.randint(-1, nb + 1, (512, 64, w), generator=gen, dtype=torch.int32,
                             device=dev)
        g1, h1 = glcm_cuda(bins, nb, rows=64)
        gb, hb = glcm_cuda(bins, nb, rows=rows)
        assert torch.equal(g1, gb) and torch.equal(h1, hb)
        g_ref, h_ref = ops.glcm_histogram(bins, nb, impl="torch")
        assert torch.equal(g1, g_ref) and torch.equal(h1, h_ref)


@pytest.mark.parametrize("value", [2, 3])  # the low and the high half of a word
@pytest.mark.parametrize("h,w", [(3, 65_535), (15, 4369), (2, 65_532)])
def test_glcm_cuda_packed_band_full_to_the_last_count(dev, value, h, w):
    """One bin everywhere in bands of exactly 65,535 pixels (3 bands of one
    row; one band of 15 rows, stored without atomics), and of 65,532 on the
    16-byte path: the histogram counter of a band reaches 65,535, the most a
    16-bit half holds, and carries nothing into its neighbour. The bands the
    wrapper picks count the same."""
    nb = 256
    assert glcm.route(nb, w) == "packed"
    bins = torch.full((1, h, w), value, dtype=torch.int32, device=dev)
    want_h = torch.zeros((1, nb), device=dev)
    want_h[0, value] = h * w
    want_g = torch.zeros((1, nb, nb), device=dev)
    want_g[0, value, value] = h * (w - 1)
    for rows in (glcm.MAX_BAND_PIXELS // w, None):
        before = glcm.route_launches["packed"]
        g, hist = glcm_cuda(bins, nb, rows=rows)
        assert glcm.route_launches["packed"] == before + 1
        assert torch.equal(hist, want_h)
        assert torch.equal(g, want_g)


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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize(
    "b,hq,hkv,tq,tk,d,causal,window,qoff",
    [
        (2, 4, 2, 64, 64, 32, True, None, 0),
        (1, 8, 1, 32, 32, 16, True, 8, 0),
        (2, 4, 4, 1, 96, 32, True, None, 95),
        (1, 2, 2, 48, 48, 64, False, None, 0),
        (1, 4, 2, 40, 40, 24, True, None, 0),  # ragged tiles
        (2, 25, 5, 300, 300, 64, True, 100, 0),  # Hymba's GQA, a window
        (1, 4, 2, 70, 130, 128, True, 50, 60),  # query offset, ragged Tk
        (1, 2, 1, 33, 77, 64, False, 20, 0),  # window without the causal mask
        (1, 2, 2, 4, 8, 16, True, None, -3),  # rows with no visible key
        (1, 8, 1, 300, 300, 256, True, None, 0),  # gemma-2b's MQA, ragged tiles
        (1, 2, 1, 33, 77, 256, False, 20, 0),  # D = 256, window without the causal mask
        (2, 16, 16, 256, 256, 192, True, None, 0),  # MLA's scoring head_dim
        (1, 4, 4, 70, 130, 192, True, 50, 60),  # D = 192, query offset, ragged Tk
        (1, 2, 2, 4, 8, 192, True, None, -3),  # D = 192, rows with no visible key
    ],
)
def test_flash_attention_cuda_matches_plain(dev, dtype, tol, b, hq, hkv, tq, tk, d, causal,
                                            window, qoff):
    g = torch.Generator(device=dev).manual_seed(tq * tk + d)
    q = torch.randn((b, hq, tq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, hkv, tk, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, hkv, tk, d), generator=g, device=dev).to(dtype)
    which = flash_attention.instance(dtype, d)
    assert which == "cuda_core" or dtype == torch.bfloat16  # float32 stays on the CUDA cores
    before = (flash_attention.launches, flash_attention.swa_launches,
              flash_attention.instance_launches[which])
    got = ops.attention(q, k, v, causal=causal, window=window, q_offset=qoff, impl="cuda")
    assert flash_attention.launches == before[0] + 1 and got.dtype == dtype
    assert flash_attention.swa_launches == before[1] + (window is not None)
    assert flash_attention.instance_launches[which] == before[2] + 1
    want = ops.attention(q, k, v, causal=causal, window=window, q_offset=qoff, impl="torch")
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "b,hq,hkv,tq,tk,d,causal,window,qoff",
    [
        (2, 25, 5, 300, 300, 64, True, 100, 0),  # Hymba's GQA, a window, ragged tiles
        (1, 25, 5, 256, 256, 64, True, None, 0),  # whole tiles: the unmasked path
        (1, 4, 4, 256, 320, 128, True, None, 64),  # D = 128, whole tiles, an offset
        (1, 4, 2, 70, 130, 128, True, 50, 60),  # D = 128, query offset, ragged Tk
        (1, 2, 1, 33, 77, 64, False, 20, 0),  # window without the causal mask
        (1, 4, 2, 100, 200, 64, False, None, 0),  # neither mask
        (1, 2, 2, 70, 40, 64, True, None, -50),  # 50 rows with no visible key
        (1, 2, 2, 9, 9, 128, True, 4, -6),  # offset and window: rows see 0 to 3 keys
        (2, 25, 5, 1, 2049, 64, True, 1024, 2048),  # Tq = 1 behind a full window
        (1, 5, 1, 1, 77, 128, True, None, 76),  # Tq = 1, D = 128
        # D = 192 and 256: Q in shared memory, 32-key tiles
        (2, 16, 16, 256, 256, 192, True, None, 0),  # MLA's scoring head_dim, whole tiles
        (1, 8, 2, 300, 300, 192, True, 100, 0),  # GQA, causal and a window, ragged tiles
        (1, 4, 2, 70, 130, 192, True, 50, 60),  # query offset, ragged Tk
        (1, 2, 2, 70, 40, 192, True, None, -50),  # 50 rows with no visible key
        (1, 4, 2, 100, 200, 192, False, None, 0),  # not causal
        (1, 16, 16, 1, 2049, 192, True, None, 2048),  # Tq = 1
        (1, 8, 1, 300, 300, 256, True, None, 0),  # gemma-2b's MQA, ragged tiles
        (1, 8, 2, 300, 300, 256, True, 100, 0),  # GQA, causal and a window
        (1, 4, 2, 70, 130, 256, True, 50, 60),  # query offset, ragged Tk
        (1, 2, 2, 9, 9, 256, True, 4, -6),  # offset and window: rows see 0 to 3 keys
        (1, 2, 1, 33, 77, 256, False, 20, 0),  # window without the causal mask
        (1, 4, 2, 100, 200, 256, False, None, 0),  # not causal
        (1, 8, 1, 1, 77, 256, True, None, 76),  # Tq = 1
    ],
)
def test_flash_attention_tensor_cores_match_plain(dev, b, hq, hkv, tq, tk, d, causal, window,
                                                   qoff):
    """bf16 at D = 64, 128, 192 and 256 runs on the tensor-core instance,
    held at the LM path's bf16 tolerance; rows that see no key give 0."""
    g = torch.Generator(device=dev).manual_seed(tq * tk + d + hq)
    q, k, v = (torch.randn((b, h, t, d), generator=g, device=dev).to(torch.bfloat16)
               for h, t in ((hq, tq), (hkv, tk), (hkv, tk)))
    before = dict(flash_attention.instance_launches)
    got = ops.attention(q, k, v, causal=causal, window=window, q_offset=qoff, impl="cuda")
    assert flash_attention.instance_launches == {
        **before, "tensor_core": before["tensor_core"] + 1}
    want = ops.attention(q, k, v, causal=causal, window=window, q_offset=qoff, impl="torch")
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3, atol=8e-3)
    qpos = qoff + torch.arange(tq, device=dev)
    blind = qpos < 0 if causal else torch.zeros_like(qpos, dtype=torch.bool)
    assert bool((got[:, :, blind] == 0).all())


# the cases of the CUDA-core grid: (tq, tk, causal, window, q_offset)
CUDA_CORE_CASES = {
    "causal_ragged": (70, 130, True, None, 60),  # Tq not a multiple of 64, ragged Tk, an offset
    "not_causal": (100, 200, False, None, 0),
    "window": (300, 300, True, 100, 0),  # causal and a window, ragged tiles
    "blind_rows": (70, 40, True, None, -50),  # 50 rows with no live key
}


@pytest.mark.parametrize("case", sorted(CUDA_CORE_CASES))
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.float32, 128),
                                     (torch.float32, 192), (torch.float32, 256),
                                     (torch.float32, 16), (torch.bfloat16, 16),
                                     (torch.bfloat16, 24), (torch.bfloat16, 32)])
def test_flash_attention_cuda_core_grid(dev, dtype, d, group, case):
    """The CUDA-core instance (float32 at every D: register-tiled products from
    D = 64 up; float32 and bf16 one thread a query at D <= 32) over GQA groups
    of 1, 2 and 8 query heads a KV head, held at float32's 3e-4 (bf16's 3e-2);
    rows that see no key give 0."""
    tq, tk, causal, window, qoff = CUDA_CORE_CASES[case]
    hkv = 2
    g = torch.Generator(device=dev).manual_seed(d * 1000 + group * 10 + tq)
    q, k, v = (torch.randn((1, h, t, d), generator=g, device=dev).to(dtype)
               for h, t in ((hkv * group, tq), (hkv, tk), (hkv, tk)))
    assert flash_attention.instance(dtype, d) == "cuda_core"
    before = dict(flash_attention.instance_launches)
    got = ops.attention(q, k, v, causal=causal, window=window, q_offset=qoff, impl="cuda")
    assert flash_attention.instance_launches == {**before, "cuda_core": before["cuda_core"] + 1}
    want = ops.attention(q, k, v, causal=causal, window=window, q_offset=qoff, impl="torch")
    tol = 3e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    qpos = qoff + torch.arange(tq, device=dev)
    blind = qpos < 0 if causal else torch.zeros_like(qpos, dtype=torch.bool)
    assert bool((got[:, :, blind] == 0).all())


def test_flash_attention_float32_at_gemmas_full_shape(dev):
    """gemma-2b's prefill attention, (2, 8 over 1, 2048, 256) float32, causal:
    32 q-blocks of 64 a head, the heaviest launched first."""
    g = torch.Generator(device=dev).manual_seed(256)
    q = torch.randn((2, 8, 2048, 256), generator=g, device=dev)
    k, v = (torch.randn((2, 1, 2048, 256), generator=g, device=dev) for _ in range(2))
    got = ops.attention(q, k, v, impl="cuda")
    want = ops.attention(q, k, v, impl="torch")
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)


def test_flash_attention_cuda_refuses_what_it_does_not_take(dev):
    q = torch.zeros((1, 2, 4, 48), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        ops.attention(q, q, q, impl="cuda")
    q = torch.zeros((1, 3, 4, 16), device=dev)
    k = torch.zeros((1, 2, 4, 16), device=dev)
    with pytest.raises(ValueError, match="group"):
        ops.attention(q, k, k, impl="cuda")
    flat = torch.zeros(2 * 4 * 64 + 1, dtype=torch.bfloat16, device=dev)
    q = flat[1:].view(1, 2, 4, 64)  # 2 bytes off the allocation
    with pytest.raises(ValueError, match="aligned"):
        ops.attention(q, q, q, impl="cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize(
    "b,t,h,p,g,n,chunk",
    [(2, 64, 4, 16, 2, 8, 16), (1, 32, 2, 8, 1, 4, 8), (1, 128, 8, 32, 1, 16, 32),
     (2, 40, 4, 16, 2, 8, 16),  # ragged: T no multiple of the chunk
     (2, 300, 50, 64, 1, 16, 128),  # Hymba's heads, ragged last chunk
     (1, 1, 2, 8, 1, 4, 128),
     (1, 300, 4, 64, 1, 128, 128),  # mamba2's N = 128, a ragged last chunk
     (2, 2048, 80, 64, 1, 128, 128)],  # mamba2-2.7b's full prefill shape
)
def test_ssd_scan_cuda_matches_plain(dev, dtype, tol, b, t, h, p, g, n, chunk):
    gen = torch.Generator(device=dev).manual_seed(t * h + p)
    x = torch.randn((b, t, h, p), generator=gen, device=dev).to(dtype)
    dt = torch.rand((b, t, h), generator=gen, device=dev) * 0.1
    a = -torch.exp(torch.randn((h,), generator=gen, device=dev))
    bm = torch.randn((b, t, g, n), generator=gen, device=dev).to(dtype)
    cm = torch.randn((b, t, g, n), generator=gen, device=dev).to(dtype)
    d = torch.randn((h,), generator=gen, device=dev)
    before = ssd_scan.launches
    y, hf = ops.ssd_scan(x, dt, a, bm, cm, d, impl="cuda", chunk=chunk)
    assert ssd_scan.launches == before + 1 and y.dtype == dtype
    yr, hr = ops.ssd_scan(x, dt, a, bm, cm, d, impl="torch")
    torch.testing.assert_close(y.float(), yr.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(hf, hr, rtol=3e-4, atol=3e-4)


def test_ssd_scan_cuda_strong_decay_does_not_overflow(dev):
    """exp(cum_i - cum_j) above the diagonal would overflow to inf here."""
    b, t, h, p, g, n = 1, 128, 2, 16, 1, 8
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((b, t, h, p), generator=gen, device=dev)
    dt = torch.full((b, t, h), 2.0, device=dev)
    a = torch.full((h,), -20.0, device=dev)
    bm = torch.randn((b, t, g, n), generator=gen, device=dev)
    cm = torch.randn((b, t, g, n), generator=gen, device=dev)
    y, hf = ops.ssd_scan(x, dt, a, bm, cm, None, impl="cuda", chunk=128)
    yr, hr = ops.ssd_scan(x, dt, a, bm, cm, None, impl="torch")
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y, yr, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(hf, hr, rtol=3e-4, atol=3e-4)


def _ssd_inputs(dev, dtype, b, t, h, p, g, n, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, t, h, p), generator=gen, device=dev).to(dtype)
    dt = torch.rand((b, t, h), generator=gen, device=dev) * 0.1
    a = -torch.exp(torch.randn((h,), generator=gen, device=dev))
    bm = torch.randn((b, t, g, n), generator=gen, device=dev).to(dtype)
    cm = torch.randn((b, t, g, n), generator=gen, device=dev).to(dtype)
    d = torch.randn((h,), generator=gen, device=dev)
    return x, dt, a, bm, cm, d


@pytest.mark.parametrize(
    "b,t,h,p,g,n,chunk",
    [(2, 2048, 50, 64, 1, 16, 128),  # Hymba's full SSD shape: 16 chunks to pass the state across
     (1, 256, 8, 32, 2, 16, 64),  # G = 2, N = 16, P = 32
     (2, 200, 4, 16, 2, 32, 48),  # N = 32 (two k-steps), a chunk of 48, a ragged last chunk
     (1, 130, 2, 128, 1, 16, 128)],  # P = 128, a last chunk of 2
)
def test_ssd_scan_tensor_cores_match_plain(dev, b, t, h, p, g, n, chunk):
    """bf16 with N a multiple of 16 runs the chunk scan on the tensor cores;
    y is held at bf16's 3e-2 and the float32 state at 3e-4."""
    args = _ssd_inputs(dev, torch.bfloat16, b, t, h, p, g, n, seed=t + p + n)
    assert ssd_scan.instance(torch.bfloat16, n, p) == "tensor_core"
    before = dict(ssd_scan.instance_launches)
    y, hf = ops.ssd_scan(*args, impl="cuda", chunk=chunk)
    assert ssd_scan.instance_launches == {**before, "tensor_core": before["tensor_core"] + 1}
    yr, hr = ops.ssd_scan(*args, impl="torch")
    torch.testing.assert_close(y.float(), yr.float(), rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(hf, hr, rtol=3e-4, atol=3e-4)


def test_ssd_scan_tensor_cores_strong_decay(dev):
    """dt = 2, a = -20 in bf16 on the tensor cores: the segment decay spans
    exp(-5080) within a chunk, and y stays finite and equal to the plain one."""
    b, t, h, p, g, n = 1, 256, 2, 16, 1, 16
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((b, t, h, p), generator=gen, device=dev).to(torch.bfloat16)
    dt = torch.full((b, t, h), 2.0, device=dev)
    a = torch.full((h,), -20.0, device=dev)
    bm, cm = (torch.randn((b, t, g, n), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    assert ssd_scan.instance(torch.bfloat16, n, p) == "tensor_core"
    y, hf = ops.ssd_scan(x, dt, a, bm, cm, None, impl="cuda", chunk=128)
    yr, hr = ops.ssd_scan(x, dt, a, bm, cm, None, impl="torch")
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y.float(), yr.float(), rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(hf, hr, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize(
    "b,t,h,p,g,n,decay",
    [(1, 300, 4, 64, 1, 128, False),  # mamba2's head, a ragged last chunk of 44
     (2, 256, 4, 64, 2, 128, False),  # two B/C groups
     (1, 256, 2, 64, 1, 128, True),  # dt = 2, a = -20: exp(-5080) within a chunk
     (1, 200, 4, 32, 2, 64, False),  # N = 64, P = 32, G = 2, ragged
     (1, 130, 2, 128, 1, 128, False)],  # P = 128 at N = 128, a last chunk of 2
)
def test_ssd_scan_tensor_cores_at_state_size_128(dev, b, t, h, p, g, n, decay):
    """The tensor-core chunk state and chunk scan at mamba2-2.7b's N = 128 (and
    N = 64): y at bf16's 3e-2 and the float32 state at 3e-4 against the plain
    recurrence; under strong decay nothing overflows."""
    args = list(_ssd_inputs(dev, torch.bfloat16, b, t, h, p, g, n, seed=t + n + g))
    if decay:
        args[1] = torch.full((b, t, h), 2.0, device=dev)
        args[2] = torch.full((h,), -20.0, device=dev)
    assert ssd_scan.instance(torch.bfloat16, n, p) == "tensor_core"
    before = dict(ssd_scan.instance_launches)
    y, hf = ops.ssd_scan(*args, impl="cuda", chunk=128)
    assert ssd_scan.instance_launches == {**before, "tensor_core": before["tensor_core"] + 1}
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(hf).all())
    yr, hr = ops.ssd_scan(*args, impl="torch")
    torch.testing.assert_close(y.float(), yr.float(), rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(hf, hr, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("dtype,n,p", [(torch.bfloat16, 16, 64), (torch.bfloat16, 8, 16),
                                       (torch.float32, 16, 64)])
def test_ssd_scan_cuda_counts_one_call_three_launches(dev, dtype, n, p):
    args = _ssd_inputs(dev, dtype, 1, 100, 4, p, 2, n, seed=n + p)
    which = ssd_scan.instance(dtype, n, p)
    before = (ssd_scan.launches, ssd_scan.kernel_launches, dict(ssd_scan.instance_launches))
    events = []
    ops.ssd_scan(*args, impl="cuda", chunk=32)
    assert ssd_scan.launches == before[0] + 1
    assert ssd_scan.kernel_launches == before[1] + len(ssd_scan.PHASES) == before[1] + 3
    assert ssd_scan.instance_launches == {**before[2], which: before[2][which] + 1}
    ssd_scan.ssd_scan_cuda(*args, chunk=32, events=events)
    events[-1].synchronize()
    assert len(events) == 4
    assert all(e0.elapsed_time(e1) >= 0.0 for e0, e1 in zip(events, events[1:]))


def test_hybrid_generate_cuda_matches_plain(dev):
    cfg = ModelConfig(name="h", family="hybrid", num_layers=3, d_model=64, num_heads=4,
                      num_kv_heads=2, head_dim=16, d_ff=128, vocab=128, window=8,
                      num_global_layers=1, ssm_state=8, ssm_headdim=16, ssm_chunk=8,
                      param_dtype=torch.float32, compute_dtype=torch.float32)
    model = HybridLM(cfg, device=dev, seed=0)
    prompt = torch.randint(0, cfg.vocab, (2, 21), generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32)
    before = (flash_attention.launches, flash_attention.swa_launches, ssd_scan.launches)
    got = generate(model, cfg, prompt, max_new=8)
    assert flash_attention.launches == before[0] + 3 and ssd_scan.launches == before[2] + 3
    assert flash_attention.swa_launches == before[1] + 2  # the two SWA layers
    want = generate(model, cfg.replace(attn_impl="torch"), prompt, max_new=8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma-2b", "mamba2-2.7b",
                                  "deepseek-v2-lite-16b", "internvl2-1b"])
def test_family_generate_cuda_matches_plain(dev, arch):
    """Each decoder-only family, scaled down in float32, generates the same
    greedy tokens on the kernels as on the plain versions, prefix and all."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config(arch).scaled_down()
    model = LM(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (2, 21)).astype(np.int32)
    prefix = None
    if cfg.frontend:
        prefix = (rng.standard_normal((2, cfg.frontend_len, cfg.d_model)) * 0.1).astype(np.float32)
    got = generate(model, cfg, prompt, max_new=8, prefix=prefix)
    want = generate(model, cfg.replace(attn_impl="torch"), prompt, max_new=8, prefix=prefix)
    assert torch.equal(got, want)


def test_flash_attention_encoder_shape_not_causal(dev):
    """seamless's encoder self-attention at its served shape: 2 x 2048
    frames, 16 heads at D = 64, bf16, no causal mask, on the tensor cores."""
    g = torch.Generator(device=dev).manual_seed(19)
    q, k, v = (torch.randn((2, 16, 2048, 64), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    before = dict(flash_attention.instance_launches)
    got = ops.attention(q, k, v, causal=False, impl="cuda")
    assert flash_attention.instance_launches == {
        **before, "tensor_core": before["tensor_core"] + 1}
    want = ops.attention(q, k, v, causal=False, impl="torch")
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3, atol=8e-3)


def test_encdec_generate_cuda_matches_plain(dev):
    """seamless scaled down in float32: the same greedy tokens on the
    kernels as on the plain versions; a prefill launches attention once an
    encoder layer (not causal) and once a decoder layer (causal)."""
    from repro_torch.configs import get_config
    from repro_torch.models import EncDec

    cfg = get_config("seamless-m4t-large-v2").scaled_down()
    model = EncDec(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (2, 21)).astype(np.int32)
    frames = (rng.standard_normal((2, 37, cfg.d_model)) * 0.1).astype(np.float32)
    before = flash_attention.launches
    got = generate(model, cfg, prompt, max_new=8, frames=frames)
    assert flash_attention.launches == before + cfg.enc_layers + cfg.num_layers
    want = generate(model, cfg.replace(attn_impl="torch"), prompt, max_new=8, frames=frames)
    assert torch.equal(got, want)


def test_train_step_on_the_card_matches_the_cpu(dev):
    """qwen3-0.6b at full width, 2 layers, float32: one train step on the
    card from the CPU's weights. The loss within 1e-4 and the gradient norm
    within 1e-3 relative (the card's embedding gradient sums with atomics,
    in no fixed order)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.convert import reference_leaves
    from repro_torch.data import SyntheticTokens
    from repro_torch.train import AdamW, init_state, make_train_step

    cfg = get_config("qwen3-0.6b").replace(num_layers=2, param_dtype=torch.float32,
                                           compute_dtype=torch.float32, attn_impl="torch")
    optim = AdamW()
    cpu = init_state(cfg, optim, seed=0, device="cpu")
    model = copy.deepcopy(cpu["params"]).to(dev)
    card = {"params": model, "opt": optim.init(reference_leaves(model)),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}
    batch = SyntheticTokens(cfg.vocab, 128, 2, seed=0).batch_at(0)
    step = make_train_step(cfg, optim)
    _, m_cpu = step(cpu, {k: torch.from_numpy(v) for k, v in batch.items()})
    _, m_card = step(card, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) <= 1e-4
    assert abs(float(m_card["grad_norm"]) / float(m_cpu["grad_norm"]) - 1.0) <= 1e-3
    on_kernels = make_train_step(cfg.replace(attn_impl="auto"), optim)
    with pytest.raises(RuntimeError, match="attn_impl='torch'"):  # the kernel route refuses
        on_kernels(card, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})


def test_rt_two_stage_pipeline_cuda_matches_analyze_tile(dev):
    """Segmentation -> Features under the runtime, on the card at 512^2: the
    labels read back from DMS2 equal ``analyze_tile``'s bit for bit."""
    from repro_torch.core import BoundingBox, Intent, RegionTemplate
    from repro_torch.pipeline import FeatureStage, SegmentationStage, make_wsi_storage
    from repro_torch.runtime import SysEnv

    rgb, _ = make_tile(512, num_nuclei=40, seed=4)
    cfg = WSIConfig(nucleus_roi=32)
    want = analyze_tile(rgb, cfg)
    dom3, dom2 = BoundingBox((0, 0, 0), (3, 512, 512)), BoundingBox((0, 0), (512, 512))
    reg = make_wsi_storage(512, 512)
    rt = RegionTemplate("Patient")
    rgb_region = rt.new_region("RGB", dom3, np.float32, input_storage="DMS3", lazy=True)
    reg.get("DMS3").put(rgb_region.key, dom3, rgb)
    env = SysEnv(num_workers=1, cpus_per_worker=2, accels_per_worker=1, registry=reg)
    seg, feat = SegmentationStage(cfg), FeatureStage(cfg)
    seg.add_region_template(rt, "RGB", dom3, Intent.INPUT, read_storage="DMS3")
    for name in ("Mask", "Hema"):
        seg.add_region_template(rt, name, dom2, Intent.OUTPUT, storage="DMS2")
        feat.add_region_template(rt, name, dom2, Intent.INPUT, read_storage="DMS2")
    feat.add_dependency(seg)
    env.execute_component(seg)
    env.execute_component(feat)
    env.startup_execution()
    env.finalize_system()
    labels = reg.get("DMS2").get(seg.templates["Patient"].get("Mask").key, dom2)
    np.testing.assert_array_equal(labels, want["labels"].cpu().numpy())
    got = feat.templates["Patient"].get("Features").data
    np.testing.assert_allclose(got["features"], want["features"].cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_data_region_to_device_cuda(dev):
    """An upload from pinned memory, marked by an event that ``ready``
    queries and ``block_until_ready`` waits on."""
    from repro_torch.core import BoundingBox, RegionTemplate

    data = np.random.default_rng(0).random((2048, 2048), dtype=np.float32)
    region = RegionTemplate("P").new_region("X", BoundingBox((0, 0), data.shape), np.float32,
                                            data=data)
    assert region.location == "host" and region.ready()
    arr = region.to_device()
    assert arr.is_cuda and region.location == "device"
    region.block_until_ready()
    assert region.ready()
    np.testing.assert_array_equal(arr.cpu().numpy(), data)
    np.testing.assert_array_equal(region.to_host(), data)
    assert region.location == "host"
    bf = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3).cuda()
    region.set_data(bf)
    assert region.location == "device"
    assert torch.equal(region.to_device(blocking=True), bf)


def test_device_pipeline_cuda_matches_direct_calls(dev):
    from repro_torch.runtime import DevicePipeline

    minv = _t(ref.stain_inverse(), dev)
    rng = np.random.default_rng(5)
    tiles = [rng.random((3, 256, 384), dtype=np.float32) for _ in range(6)]
    pipe = DevicePipeline(lambda t: ops.color_deconv(t, minv), window=2)
    outs = list(pipe.map(tiles))
    assert pipe.stats == {"uploaded": 6, "computed": 6, "downloaded": 6}
    for t, got in zip(tiles, outs):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, ops.color_deconv(_t(t, dev), minv).cpu().numpy())


@pytest.mark.parametrize("chain_name", ["deconv|threshold|fill", "deconv|threshold|ccl|count",
                                        "glcm"])
def test_gateway_compute_on_the_card_equals_a_local_chain(dev, chain_name):
    """A gateway's near-data chain runs on the card (the kernels launch) and
    equals the same chain run locally on the same ROI, bit for bit; its
    repeat is a derived-cache hit that launches nothing."""
    from repro_torch.core import BoundingBox, ElementType, RegionKey
    from repro_torch.kernels import color_deconv, glcm
    from repro_torch.kernels.chains import resolve_chain
    from repro_torch.serve import RegionGateway
    from repro_torch.storage import DistributedMemoryStorage, Tier, TieredStore

    rgb, _ = make_tile(256, num_nuclei=20, seed=7)
    chain = resolve_chain(chain_name)
    data = rgb if 3 in chain.in_ranks else resolve_chain("deconv")(rgb, device=dev)
    dom = BoundingBox((0,) * data.ndim, data.shape)
    store = TieredStore([Tier("DMS", DistributedMemoryStorage(dom, data.shape, 2))], name="ND")
    key = RegionKey("nd", "X", ElementType.FLOAT32)
    store.put(key, dom, data)
    gw = RegionGateway(store)
    assert gw.device.type == "cuda"
    roi = BoundingBox((0,) * (data.ndim - 2) + (16, 40), data.shape[:-2] + (240, 256))
    try:
        before = (color_deconv.launches, glcm.launches)
        got = gw.compute(key, roi, chain_name)
        moved = (color_deconv.launches - before[0], glcm.launches - before[1])
        assert moved == (int(chain_name.startswith("deconv")), int(chain_name == "glcm"))
        want = chain(store.get(key, roi), device=dev)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        before = (color_deconv.launches, glcm.launches)
        np.testing.assert_array_equal(gw.compute(key, roi, chain_name), want)
        assert (color_deconv.launches, glcm.launches) == before
        assert gw.stats.compute_cache_hits == 1 and gw.stats.compute_failed == 0
    finally:
        gw.close()
