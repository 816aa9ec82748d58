"""The port's plain kernel versions against the JAX package, on the CPU.

The same numpy inputs go through ``repro`` (the jnp references and the
Pallas kernels in interpret mode, as tests/test_kernels.py runs them) and
through ``repro_torch`` (``ops`` with CPU tensors, which takes the plain
versions). Reconstruction, labeling and counting compare exactly: min and
max select values and never round, and counts are integers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ccl import ccl_pallas
from repro.kernels.color_deconv import color_deconv_pallas
from repro.kernels.glcm import glcm_pallas
from repro.kernels.morph_recon import morph_recon_pallas
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.ccl import ccl_cuda
from repro_torch.kernels.color_deconv import color_deconv_cuda
from repro_torch.kernels.glcm import glcm_cuda
from repro_torch.kernels.morph_recon import morph_recon_cuda


# The jnp references, jitted: run eagerly, their associative scans dispatch
# op by op and take seconds per call.
j_morph_recon_ref = jax.jit(jref.morph_recon_ref, static_argnames="max_iters")
j_morph_recon_sweep_ref = jax.jit(jref.morph_recon_sweep_ref)
j_fill_holes_ref = jax.jit(jref.fill_holes_ref)
j_ccl_ref = jax.jit(jref.ccl_ref, static_argnames="max_iters")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# color deconvolution
# ---------------------------------------------------------------------------
def test_stain_inverse_is_bit_identical():
    np.testing.assert_array_equal(ref.stain_inverse(), jref.stain_inverse())
    np.testing.assert_array_equal(ref.RUIFROK_HED, jref.RUIFROK_HED)


@pytest.mark.parametrize("h,w,bh,bw", [(32, 128, 16, 128), (64, 256, 64, 128), (48, 96, 32, 96)])
def test_color_deconv_matches_reference(h, w, bh, bw):
    rgb = np.random.default_rng(h * w).random((3, h, w), dtype=np.float32)
    minv = ref.stain_inverse()
    got = ops.color_deconv(_t(rgb), _t(minv)).numpy()
    np.testing.assert_allclose(
        got, jref.color_deconv_ref(jnp.asarray(rgb), jnp.asarray(minv)), rtol=2e-5, atol=2e-5
    )
    pallas = color_deconv_pallas(
        jnp.asarray(rgb), jnp.asarray(minv), block_h=bh, block_w=bw, interpret=True
    )
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)


def test_color_deconv_white_is_zero_density():
    out = ops.color_deconv(torch.ones((3, 8, 128)), _t(ref.stain_inverse()))
    np.testing.assert_allclose(out.numpy(), np.zeros((3, 8, 128)), atol=1e-5)


# ---------------------------------------------------------------------------
# morphological reconstruction + fill holes
# ---------------------------------------------------------------------------
def _recon_inputs(h, w, seed):
    r = np.random.default_rng(seed)
    mask = (r.random((h, w)) > 0.35).astype(np.float32)
    marker = (r.random((h, w)) * (r.random((h, w)) > 0.9)).astype(np.float32) * mask
    return marker, mask


@pytest.mark.parametrize("max_iters", [1, 2, None])
@pytest.mark.parametrize("h,w", [(32, 48), (40, 24), (64, 64)])
def test_morph_recon_iterate_for_iterate(h, w, max_iters):
    """Each capped iterate equals the reference's: the sequential pass is the
    associative scan's recurrence."""
    marker, mask = _recon_inputs(h, w, h * w)
    kw = {} if max_iters is None else {"max_iters": max_iters}
    got = ref.morph_recon_ref(_t(marker), _t(mask), **kw).numpy()
    want = j_morph_recon_ref(jnp.asarray(marker), jnp.asarray(mask), **kw)
    np.testing.assert_array_equal(got, want)
    got_ops = ops.morph_recon(_t(marker), _t(mask), **kw).numpy()
    want_ops = jops.morph_recon(jnp.asarray(marker), jnp.asarray(mask), impl="xla", **kw)
    np.testing.assert_array_equal(got_ops, want_ops)


@pytest.mark.parametrize("h,w", [(32, 48), (48, 32)])
def test_morph_recon_matches_pallas_at_fixed_point(h, w):
    """The Pallas fixed-point loop relaxes tiles with a halo exchange between calls, so
    its capped iterates are not the reference's; the fixed point is."""
    marker, mask = _recon_inputs(h, w, 7)
    got = ops.morph_recon(_t(marker), _t(mask)).numpy()
    pallas = morph_recon_pallas(
        jnp.asarray(marker), jnp.asarray(mask), block_h=16, block_w=16, interpret=True
    )
    np.testing.assert_array_equal(got, pallas)


def serpentine(h, w):
    """A 1-pixel corridor that runs along every even row and turns at
    alternate ends: one path through the whole image."""
    m = np.zeros((h, w), bool)
    m[::2, :] = True
    for r in range(1, h, 2):
        m[r, -1 if (r // 2) % 2 == 0 else 0] = True
    return m


@pytest.mark.parametrize("block", [32, 48])
def test_morph_recon_long_corridor_fixed_point(block):
    """A front that must walk a 96x96 serpentine from one end: the plain
    version run to convergence equals the JAX reference and the Pallas
    kernel at their fixed point. This is the card tests' worst-case oracle."""
    rng = np.random.default_rng(block)
    corridor = serpentine(96, 96)
    mask = corridor.astype(np.float32) * (0.5 + 0.5 * rng.random((96, 96), dtype=np.float32))
    marker = np.zeros_like(mask)
    marker[0, 0] = 1.0
    got = ref.morph_recon_ref(_t(marker), _t(mask), max_iters=10_000)
    assert torch.equal(ref.morph_recon_sweep_ref(got, _t(mask)), got)  # converged
    assert bool((got.numpy()[corridor] > 0).all())  # the front reached the far end
    want = j_morph_recon_ref(jnp.asarray(marker), jnp.asarray(mask), max_iters=10_000)
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = morph_recon_pallas(jnp.asarray(marker), jnp.asarray(mask), max_iters=10_000,
                                block_h=block, block_w=block, interpret=True)
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_morph_recon_sweep_matches_reference():
    marker, mask = _recon_inputs(24, 40, 3)
    got = ref.morph_recon_sweep_ref(_t(marker), _t(mask)).numpy()
    np.testing.assert_array_equal(
        got, j_morph_recon_sweep_ref(jnp.asarray(marker), jnp.asarray(mask))
    )


def test_fill_holes_closes_a_donut():
    m = np.zeros((32, 32), np.float32)
    m[8:24, 8:24] = 1.0
    m[14:18, 14:18] = 0.0  # the hole
    filled = ops.fill_holes(_t(m)).numpy()
    assert filled[15, 15] == 1.0
    assert filled[0, 0] == 0.0
    np.testing.assert_array_equal(filled, j_fill_holes_ref(jnp.asarray(m)))


@pytest.mark.parametrize("seed", [0, 1])
def test_fill_holes_matches_reference(seed):
    m = (np.random.default_rng(seed).random((40, 56)) < 0.55).astype(np.float32)
    got = ops.fill_holes(_t(m)).numpy()
    np.testing.assert_array_equal(got, j_fill_holes_ref(jnp.asarray(m)))
    np.testing.assert_array_equal(got, jops.fill_holes(jnp.asarray(m), impl="xla"))


# ---------------------------------------------------------------------------
# connected components
# ---------------------------------------------------------------------------
def _snake(h, w):
    m = np.zeros((h, w), bool)
    m[::2, :] = True
    for r in range(1, h, 2):
        m[r, -1 if (r // 2) % 2 == 0 else 0] = True
    return m


@pytest.mark.parametrize(
    "h,w,density", [(24, 32, 0.4), (48, 48, 0.6), (16, 64, 0.2), (21, 30, "snake")]
)
def test_ccl_matches_reference(h, w, density):
    if density == "snake":
        m = _snake(h, w)
    else:
        m = np.random.default_rng(h * w).random((h, w)) < density
    want = jref.ccl_unionfind_host(m)
    np.testing.assert_array_equal(ref.ccl_unionfind_host(m), want)
    got = ops.connected_components(_t(m.astype(np.int32)), max_iters=10_000).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, j_ccl_ref(jnp.asarray(m), max_iters=10_000)
    )
    np.testing.assert_array_equal(
        got, ccl_pallas(jnp.asarray(m), max_iters=10_000, block_h=16, block_w=16, interpret=True)
    )


@pytest.mark.parametrize("max_iters", [1, 2])
def test_ccl_capped_iterates_match_reference(max_iters):
    m = _snake(15, 12)
    got = ref.ccl_ref(_t(m), max_iters=max_iters).numpy()
    np.testing.assert_array_equal(got, j_ccl_ref(jnp.asarray(m), max_iters=max_iters))


# ---------------------------------------------------------------------------
# GLCM / histogram / features
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,w,nb", [(2, 16, 16, 8), (4, 24, 32, 16), (1, 64, 64, 32)])
def test_glcm_histogram_exact(b, h, w, nb):
    bins = np.random.default_rng(b * h * nb).integers(0, nb, (b, h, w), dtype=np.int32)
    g, hist = ops.glcm_histogram(_t(bins), nb)
    np.testing.assert_array_equal(g.numpy(), jref.glcm_ref(jnp.asarray(bins), nb))
    np.testing.assert_array_equal(hist.numpy(), jref.histogram_ref(jnp.asarray(bins), nb))
    pg, ph = glcm_pallas(jnp.asarray(bins), nb, interpret=True)
    np.testing.assert_array_equal(g.numpy(), pg)
    np.testing.assert_array_equal(hist.numpy(), ph)


def test_glcm_out_of_range_bins_count_nowhere():
    bins = np.random.default_rng(1).integers(-2, 10, (3, 12, 12), dtype=np.int32)
    g, hist = ops.glcm_histogram(_t(bins), 8)
    np.testing.assert_array_equal(g.numpy(), jref.glcm_ref(jnp.asarray(bins), 8))
    np.testing.assert_array_equal(hist.numpy(), jref.histogram_ref(jnp.asarray(bins), 8))


@pytest.mark.parametrize("nb", [8, 32])
def test_texture_features_match_reference(nb):
    tiles = np.random.default_rng(nb).random((6, 24, 24), dtype=np.float32)
    tiles[0] = 0.5  # constant tile: energy 1, correlation guarded
    bins = ref.quantize_ref(_t(tiles), nb)
    jbins = jref.quantize_ref(jnp.asarray(tiles), nb)
    np.testing.assert_array_equal(bins.numpy(), jbins)
    g, h = ops.glcm_histogram(bins, nb)
    np.testing.assert_allclose(
        ref.glcm_features_ref(g).numpy(), jref.glcm_features_ref(jnp.asarray(g.numpy())),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        ref.histogram_features_ref(h).numpy(),
        jref.histogram_features_ref(jnp.asarray(h.numpy())), rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        ops.texture_features(bins, nb).numpy(),
        jops.texture_features(jbins, nb, impl="xla"), rtol=1e-5, atol=1e-5,
    )


def test_quantize_truncates_like_astype():
    x = np.array([[0.0, 0.0312, 0.03125, 0.999, 1.0, 1.7, -0.2]], np.float32)
    np.testing.assert_array_equal(
        ref.quantize_ref(_t(x), 32).numpy(), jref.quantize_ref(jnp.asarray(x), 32)
    )


# ---------------------------------------------------------------------------
# percentile
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(64, 64), (37, 53), (1000,)])
def test_percentile_matches_jnp(shape):
    x = np.random.default_rng(len(shape)).random(shape, dtype=np.float32) * 3 - 1
    lo, hi = ref.percentile(_t(x), (5.0, 99.5))
    assert abs(float(lo) - float(jnp.percentile(jnp.asarray(x), 5.0))) <= 2e-6
    assert abs(float(hi) - float(jnp.percentile(jnp.asarray(x), 99.5))) <= 2e-6
    assert abs(float(ref.percentile(_t(x), 50.0)) - float(jnp.percentile(x, 50.0))) <= 2e-6


# ---------------------------------------------------------------------------
# wrapper rules
# ---------------------------------------------------------------------------
def test_impl_cuda_on_a_cpu_tensor_raises():
    x2 = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ops.color_deconv(torch.zeros((3, 8, 8)), _t(ref.stain_inverse()), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.morph_recon(x2, x2, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.fill_holes(x2, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.connected_components(x2.int(), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.glcm_histogram(torch.zeros((1, 8, 8), dtype=torch.int32), 8, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.morph_recon(x2, x2, impl="pallas")


def test_kernel_wrappers_refuse_cpu_tensors_before_building():
    with pytest.raises(ValueError, match="CUDA tensor"):
        color_deconv_cuda(torch.zeros((3, 4, 4)), torch.zeros((3, 3)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        morph_recon_cuda(torch.zeros((4, 4)), torch.zeros((4, 4)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ccl_cuda(torch.zeros((4, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        glcm_cuda(torch.zeros((1, 4, 4), dtype=torch.int32), 8)
    assert _build._lib is None  # nothing was compiled or loaded


def test_four_sources_and_their_entry_points():
    names = sorted(p.name for p in _build.sources())
    assert names == ["ccl.cu", "color_deconv.cu", "flash_attention.cu", "glcm.cu",
                     "morph_recon.cu", "ssd_scan.cu"]
    text = "".join(p.read_text() for p in _build.sources())
    for entry in _build.SIGNATURES:
        assert f'extern "C" int {entry}(' in text
