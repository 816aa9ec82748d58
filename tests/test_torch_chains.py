"""The port's named kernel chains (``repro_torch.kernels.chains``) against
the JAX package's, on the CPU.

The same numpy tile goes through ``repro``'s chain (``impl="xla"``, the jnp
references under ``jit``) and the port's (``impl="torch"`` on the CPU, the
plain versions). The tile is bimodal, built through the forward stain model
as ``tests/test_compute.py`` builds it, so the threshold sits far from any
pixel and an ulp of difference in the deconvolution cannot flip a mask bit:
masks, labels and counts compare exactly, the deconvolution within 2e-5, the
features within 1e-5. Chain names, parameters, digests and errors are the
reference's. Also here: the GLCM kernel's row bands, whose partial counts
must sum to the whole tile's.
"""
import numpy as np
import pytest
import torch

from repro.kernels import chains as jchains
from repro_torch.kernels import chains as tchains
from repro_torch.kernels import glcm as glcm_mod
from repro_torch.kernels import ref

DECONV_TOL = 2e-5
FEATURE_TOL = 1e-5
SHAPES = [(64, 64), (96, 136)]  # a square tile and a ragged one


def _stain_rgb(h, w, seed=0) -> np.ndarray:
    """H&E-like tile from the forward Ruifrok model: blobs of hematoxylin
    density 0.85 on 0.15, so the deconvolved plane is bimodal."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    blobs = np.zeros((h, w), bool)
    for _ in range(6):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = rng.integers(6, 14)
        blobs |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    density = np.where(blobs, 0.85, 0.15).astype(np.float32)
    stains = np.stack([density, np.full_like(density, 0.05), np.full_like(density, 0.02)])
    m = ref.RUIFROK_HED / np.linalg.norm(ref.RUIFROK_HED, axis=1, keepdims=True)
    od = np.einsum("shw,sc->chw", stains, m)
    return (10.0 ** -od).astype(np.float32)


def _input(chain, h, w, seed):
    rgb = _stain_rgb(h, w, seed)
    if 3 in chain.in_ranks:
        return rgb
    # rank-2 chains take one plane: the hematoxylin density, in [0, 1]
    hema = tchains.resolve_chain("deconv")(rgb, impl="torch", device="cpu")
    return np.clip(hema, 0.0, 1.0).astype(np.float32)


def _assert_same(got, want, name):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if name.split("|")[-1] == "deconv":
        np.testing.assert_allclose(got, want, rtol=DECONV_TOL, atol=DECONV_TOL)
    elif name.split("|")[-1] == "glcm":
        np.testing.assert_allclose(got, want, rtol=FEATURE_TOL, atol=FEATURE_TOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("name", tchains.STANDARD_CHAINS)
def test_standard_chain_matches_the_reference(name, h, w):
    tchain, jchain = tchains.resolve_chain(name), jchains.resolve_chain(name)
    x = _input(tchain, h, w, seed=h + w)
    got = tchain(x, impl="torch", device="cpu")
    _assert_same(got, jchain(x, impl="xla"), name)
    if name.endswith("ccl"):
        assert got.max() >= 0  # the blobs are labelled
    np.testing.assert_array_equal(tchain(x, device="cpu"), got)  # "auto" on the CPU


@pytest.mark.parametrize("num_bins", [2, 32, 241, 256])
def test_glcm_chain_at_every_bin_range(num_bins):
    params = {"num_bins": num_bins}
    tchain = tchains.resolve_chain("glcm", params)
    x = _input(tchain, 64, 72, seed=num_bins)
    got = tchain(x, impl="torch", device="cpu")
    _assert_same(got, jchains.resolve_chain("glcm", params)(x, impl="xla"), "glcm")


PARAM_SETS = [
    ("deconv", {"stain": -1}), ("deconv", {"stain": 2}),
    ("deconv|threshold", {"thr": 0.4}), ("deconv|threshold", {"thr": 0.5, "norm": True}),
    ("deconv|threshold", {"norm": False}), ("threshold|ccl", {"thr": 0.25}),
    ("glcm", {"num_bins": 256}), (" deconv | threshold |ccl", None),
]


@pytest.mark.parametrize("name,params", [(n, None) for n in tchains.STANDARD_CHAINS]
                         + PARAM_SETS)
def test_digest_and_resolution_are_the_references(name, params):
    t, j = tchains.resolve_chain(name, params), jchains.resolve_chain(name, params)
    assert t.digest() == j.digest()
    assert (t.name, t.params, t.in_ranks, t.out_rank, t.reduces) == (
        j.name, j.params, j.in_ranks, j.out_rank, j.reduces)
    assert [s.name for s in t.stages] == [s.name for s in j.stages]


@pytest.mark.parametrize("chain,params", [
    ("deconv|nope", None), ("", None), ("deconv|threshold", {"thr": 1.5}),
    ("deconv", {"bogus": 1}), ("deconv|threshold|ccl|count|threshold", None),
    ("deconv|threshold", {"stain": -1}), ("glcm", {"num_bins": 1}), ("glcm", {"num_bins": 3.0}),
    ("threshold", {"norm": 1}), (None, None),
])
def test_typed_errors_are_the_references(chain, params):
    with pytest.raises(jchains.ChainError) as want:
        jchains.resolve_chain(chain, params)
    with pytest.raises(tchains.ChainError) as got:
        tchains.resolve_chain(chain, params)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_rank_check_and_registry_are_the_references():
    t, j = tchains.resolve_chain("deconv"), jchains.resolve_chain("deconv")
    with pytest.raises(jchains.ChainParamError) as want:
        j.check_input_rank(2)
    with pytest.raises(tchains.ChainParamError) as got:
        t.check_input_rank(2)
    assert str(got.value) == str(want.value)
    assert tchains.STANDARD_CHAINS == jchains.STANDARD_CHAINS
    assert set(tchains.list_stages()) == set(jchains.list_stages())
    with pytest.raises(ValueError, match="already registered"):
        tchains.register_stage(tchains.list_stages()["ccl"])


def test_chain_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tchains.resolve_chain("deconv")(_stain_rgb(16, 16))


# ---------------------------------------------------------------------------
# GLCM row bands: what the kernel's banded launch sums
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,w,nb,rows", [
    (1, 64, 64, 32, 16), (1, 64, 64, 32, 7), (1, 63, 36, 8, 64), (1, 50, 1, 4, 3),
    (3, 40, 24, 241, 9), (2, 33, 17, 256, 1),
])
def test_glcm_band_counts_sum_to_the_whole_tile(b, h, w, nb, rows):
    """Rows are independent for horizontal pairs, so the bands' counts, as
    the banded kernel adds them into its outputs, equal the whole tile's,
    for band heights that divide H and that do not."""
    rng = np.random.default_rng(b * h * w + nb + rows)
    bins = torch.from_numpy(rng.integers(-1, nb + 1, (b, h, w), dtype=np.int32))
    g, hist = ref.glcm_bands_ref(bins, nb, rows)
    assert g.shape == (b, -(-h // rows), nb, nb) and hist.shape == (b, -(-h // rows), nb)
    assert torch.equal(g.sum(dim=1), ref.glcm_ref(bins, nb))
    assert torch.equal(hist.sum(dim=1), ref.histogram_ref(bins, nb))


def test_glcm_band_rows():
    """One block a tile where the batch fills the card (the WSI path's 512
    ROIs) or a tile exceeds 2^24 pixels; bands that fill it otherwise."""
    sms = 132
    assert glcm_mod.band_rows(512, 64, 64, sms) == 64
    assert glcm_mod.band_rows(264, 64, 64, sms) == 64
    rows = glcm_mod.band_rows(1, 4096, 4096, sms)
    assert rows == 16 and -(-4096 // rows) == 256
    assert glcm_mod.band_rows(1, 4097, 4096, sms) == 4097  # float32 partial sums not exact
    assert glcm_mod.band_rows(1, 4096, 4095, sms) == 16
    assert glcm_mod.band_rows(4, 64, 64, sms) == 64  # 4096 pixels: too few to split
    assert glcm_mod.band_rows(2, 1024, 64, sms) == 256  # 4 bands of 16384 pixels
    assert glcm_mod.band_rows(0, 64, 64, sms) == 64
    assert glcm_mod.band_rows(1, 0, 64, sms) == 0
    for b, h, w in ((1, 4096, 4096), (3, 1000, 37), (1, 7, 100_000)):
        rows = glcm_mod.band_rows(b, h, w, sms)
        bands = -(-h // rows)
        assert 1 <= rows <= h and bands <= glcm_mod.MAX_GRID_Y
        assert b * bands <= 2 * glcm_mod.BLOCKS_PER_SM * sms
