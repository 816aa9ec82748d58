"""The port's WSI main path against ``repro.pipeline.analyze_tile(impl="xla")``.

Both packages get the same numpy tile and the same parameters, carried
across by ``repro_torch.convert.from_reference``; the port runs on the CPU.
Deconvolution agrees to float rounding, so a thresholded pixel may flip only
on the threshold's knife edge; the later stages are held exactly by feeding
them the reference's own intermediate results.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.wsi import WSIConfig as JWSIConfig
from repro.kernels import ref as jref
from repro.pipeline import analyze_tile as j_analyze_tile
from repro.pipeline import compute_features as j_compute_features
from repro.pipeline import extract_object_rois as j_extract_object_rois
from repro.pipeline import make_slide as j_make_slide
from repro.pipeline import make_tile as j_make_tile
from repro_torch.convert import from_reference
from repro_torch.pipeline import (
    analyze_tile,
    compute_features,
    extract_object_rois,
    make_slide,
    make_tile,
    segment_mask,
)

SEEDS = [3, 5, 11]
J_CFG = JWSIConfig(seg_threshold=0.5, nucleus_roi=32)


@pytest.fixture(scope="module", params=SEEDS)
def case(request):
    rgb, _ = j_make_tile(128, num_nuclei=8, seed=request.param)
    want = j_analyze_tile(jnp.asarray(rgb), J_CFG, impl="xla")
    cfg, minv = from_reference(dataclasses.asdict(J_CFG), jref.stain_inverse(), device="cpu")
    got = analyze_tile(rgb, cfg, device="cpu", minv=minv)
    want = {k: np.asarray(v) for k, v in want.items()}
    return rgb, cfg, want, got


def test_synth_copy_is_identical():
    for got, want in zip(make_tile(64, num_nuclei=5, seed=2), j_make_tile(64, num_nuclei=5, seed=2)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(make_slide(2, 2, 32, seed=1), j_make_slide(2, 2, 32, seed=1)):
        np.testing.assert_array_equal(got, want)


def test_from_reference_carries_config_and_stain_inverse():
    cfg, minv = from_reference(dataclasses.asdict(J_CFG), jref.stain_inverse(), device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(J_CFG)
    assert minv.dtype == torch.float32 and minv.device.type == "cpu"
    np.testing.assert_array_equal(minv.numpy(), jref.stain_inverse())
    with pytest.raises(ValueError):
        from_reference({}, np.zeros((2, 3)), device="cpu")


def test_hematoxylin_matches(case):
    _, _, want, got = case
    np.testing.assert_allclose(got["hematoxylin"].numpy(), want["hematoxylin"], atol=1e-4, rtol=0)


def test_threshold_flips_only_on_the_knife_edge(case):
    _, cfg, want, got = case
    thr = cfg.seg_threshold
    flips = (got["hematoxylin"].numpy() > thr) != (want["hematoxylin"] > thr)
    assert (np.abs(want["hematoxylin"][flips] - thr) <= 1e-4).all()
    if not flips.any():  # same thresholded mask: the whole segmentation agrees
        np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
        np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])


def test_labels_exact_from_the_reference_mask(case):
    _, cfg, want, _ = case
    raw = (want["hematoxylin"] > cfg.seg_threshold).astype(np.float32)
    seg = segment_mask(torch.from_numpy(raw))
    np.testing.assert_array_equal(seg["mask"].numpy(), want["mask"])
    np.testing.assert_array_equal(seg["labels"].numpy(), want["labels"])


def test_rois_and_boxes_exact(case):
    _, cfg, want, got = case
    rois, boxes = extract_object_rois(want["labels"], want["hematoxylin"], cfg, device="cpu")
    np.testing.assert_array_equal(rois.numpy(), want["rois"])
    np.testing.assert_array_equal(boxes.numpy(), want["boxes"])
    assert rois.dtype == torch.float32 and boxes.dtype == torch.int32
    if np.array_equal(got["labels"].numpy(), want["labels"]):
        np.testing.assert_array_equal(got["boxes"].numpy(), want["boxes"])
        np.testing.assert_allclose(got["rois"].numpy(), want["rois"], atol=1e-4, rtol=0)


def test_features_match(case):
    _, cfg, want, got = case
    feats = compute_features(want["rois"], cfg, device="cpu")
    np.testing.assert_allclose(feats.numpy(), want["features"], rtol=1e-4, atol=1e-4)
    assert got["features"].shape == want["features"].shape
    assert np.isfinite(got["features"].numpy()).all()


@pytest.mark.parametrize(
    "h,w,r,cap",
    [(64, 64, 16, 512), (64, 64, 16, 1), (12, 20, 16, 512), (40, 90, 32, 3)],
)
def test_extract_object_rois_matches_reference(h, w, r, cap):
    """Crop centring, clipping into the tile, zero padding when the tile is
    smaller than R, and the object cap."""
    labels = np.full((h, w), -1, np.int32)
    rng = np.random.default_rng(h * w + r)
    for _ in range(6):
        y, x = rng.integers(0, h - 3), rng.integers(0, w - 3)
        labels[y : y + rng.integers(1, 4), x : x + rng.integers(1, 4)] = y * w + x
    intensity = rng.random((h, w)).astype(np.float32)
    cfg = JWSIConfig(nucleus_roi=r, max_objects_per_tile=cap)
    want_rois, want_boxes = j_extract_object_rois(labels, intensity, cfg)
    got_rois, got_boxes = extract_object_rois(
        labels, intensity, from_reference(dataclasses.asdict(cfg), jref.stain_inverse(),
                                          device="cpu")[0], device="cpu",
    )
    np.testing.assert_array_equal(got_rois.numpy(), want_rois)
    np.testing.assert_array_equal(got_boxes.numpy(), want_boxes)


def test_no_objects_gives_empty_batches():
    cfg = from_reference(dataclasses.asdict(J_CFG), jref.stain_inverse(), device="cpu")[0]
    rois, boxes = extract_object_rois(np.full((16, 16), -1, np.int32),
                                      np.zeros((16, 16), np.float32), cfg, device="cpu")
    assert rois.shape == (0, 32, 32) and boxes.shape == (0, 4)
    feats = compute_features(rois, cfg, device="cpu")
    assert feats.shape == (0, 9)
    np.testing.assert_array_equal(
        feats.numpy(), j_compute_features(np.zeros((0, 32, 32), np.float32), J_CFG)
    )
