"""The port's WSI pipeline in its region-template form (``SegmentationStage``
-> ``FeatureStage`` under ``SysEnv``, data through the DMS and tiered
stores), on the CPU, against the port's plain ``analyze_tile`` and against
the JAX package's RT stages (``impl="xla"``), which get the same numpy
tile.

The RT form runs the plain form's steps on the same device, so its labels
equal ``analyze_tile``'s bit for bit. Against the JAX package the
deconvolution agrees to float rounding, so a thresholded pixel may flip
only on the threshold's knife edge; the labels are held exactly whenever
the thresholded masks agree, and the features are held on the reference's
own ROIs (as ``tests/test_torch_wsi.py`` does for the plain form).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.pipeline as jpipe
import repro.runtime as jruntime
import repro.storage as jstorage
import repro_torch.core as tcore
import repro_torch.pipeline as tpipe
import repro_torch.runtime as truntime
import repro_torch.storage as tstorage
from repro.configs.wsi import WSIConfig as JWSIConfig
from repro_torch.configs.wsi import WSIConfig

FEATURE_TOL = 1e-4
J_CFG = JWSIConfig(seg_threshold=0.5, nucleus_roi=32)
CFG = WSIConfig(**dataclasses.asdict(J_CFG))
PACKAGES = {
    "jax": (jcore, jpipe, jruntime, jstorage, J_CFG, {"impl": "xla"}),
    "torch": (tcore, tpipe, truntime, tstorage, CFG, {"device": "cpu"}),
}


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_threads():
    """The first large parallel op of a process may split its work over the
    CPU threads differently from every later one, and torch's vectorised
    log10 then differs by an ulp on a few pixels of the plain
    deconvolution. One such op before the comparisons keeps the plain path
    bit-reproducible between the two forms."""
    torch.log10(torch.rand(1 << 20))


@pytest.fixture(scope="module")
def tile():
    return tpipe.make_tile(128, num_nuclei=8, seed=3)


def _iou(a, b):
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return inter / max(union, 1)


def run_rt(pkg: str, rgb: np.ndarray, part: int | None = None, mode: str = "dms",
           num_workers: int = 1) -> dict:
    """Segmentation -> Features through one package's runtime, one stage
    pair per ``part``-sized partition (the whole tile by default); returns
    the labels read back from DMS2, the hematoxylin, and each partition's
    features and boxes in partition order."""
    core, pipe, runtime, _, cfg, kw = PACKAGES[pkg]
    h, w = rgb.shape[1:]
    part = part or h
    dom3 = core.BoundingBox((0, 0, 0), (3, h, w))
    dom2 = core.BoundingBox((0, 0), (h, w))
    reg = pipe.make_wsi_storage(h, w, mode=mode, tile=part, num_servers=2)
    rt = core.RegionTemplate("Patient")
    rgb_region = rt.new_region("RGB", dom3, np.float32, input_storage="DMS3", lazy=True)
    reg.get("DMS3").put(rgb_region.key, dom3, rgb)
    env = runtime.SysEnv(num_workers=num_workers, cpus_per_worker=2, accels_per_worker=1,
                         registry=reg)
    pairs = []
    for part2 in dom2.tiles((part, part)):
        part3 = core.BoundingBox((0,) + part2.lo, (3,) + part2.hi)
        seg = pipe.SegmentationStage(cfg, **kw)
        seg.add_region_template(rt, "RGB", part3, core.Intent.INPUT, read_storage="DMS3")
        seg.add_region_template(rt, "Mask", part2, core.Intent.OUTPUT, storage="DMS2")
        seg.add_region_template(rt, "Hema", part2, core.Intent.OUTPUT, storage="DMS2")
        feat = pipe.FeatureStage(cfg, **kw)
        feat.add_region_template(rt, "Mask", part2, core.Intent.INPUT, read_storage="DMS2")
        feat.add_region_template(rt, "Hema", part2, core.Intent.INPUT, read_storage="DMS2")
        feat.add_dependency(seg)
        env.execute_component(seg)
        env.execute_component(feat)
        pairs.append((part2, seg, feat))
    env.startup_execution()
    env.finalize_system()
    seg_rt = pairs[0][1].templates["Patient"]
    dms2 = reg.get("DMS2")
    out = {
        "labels": dms2.get(seg_rt.get("Mask").key, dom2),
        "hema": dms2.get(seg_rt.get("Hema").key, dom2),
        "parts": [p for p, _, _ in pairs],
        "features": [f.templates["Patient"].get("Features").data["features"]
                     for _, _, f in pairs],
        "boxes": [f.templates["Patient"].get("Features").data["boxes"] for _, _, f in pairs],
        "stores": reg,
    }
    if mode == "tiered":
        for name in ("DMS3", "DMS2"):
            reg.get(name).close()
    return out


@pytest.fixture(scope="module")
def rt_runs(tile):
    rgb, _ = tile
    return {pkg: run_rt(pkg, rgb) for pkg in PACKAGES}


def test_segmentation_recovers_nuclei(tile):
    rgb, gt = tile
    seg = tpipe.segment_tile(rgb, CFG, device="cpu")
    mask = seg["mask"].numpy() > 0
    assert _iou(mask, gt > 0) > 0.5
    labels = seg["labels"].numpy()
    n_objects = len(np.unique(labels[labels >= 0]))
    assert 3 <= n_objects <= 24  # ballpark of 8 seeded nuclei (some merge)


def test_full_tile_analysis_features(tile):
    rgb, _ = tile
    out = tpipe.analyze_tile(rgb, CFG, device="cpu")
    k = out["features"].shape[0]
    assert k == out["boxes"].shape[0] == out["rois"].shape[0]
    assert out["features"].shape[1] == 9
    assert torch.isfinite(out["features"]).all()


def test_object_roi_extraction_fixed_size():
    labels = np.full((64, 64), -1, np.int32)
    labels[10:20, 10:20] = 0
    labels[40:50, 30:44] = 1
    intensity = np.random.default_rng(0).random((64, 64)).astype(np.float32)
    rois, boxes = tpipe.extract_object_rois(labels, intensity, WSIConfig(nucleus_roi=16),
                                            device="cpu")
    assert tuple(rois.shape) == (2, 16, 16)
    assert tuple(boxes.shape) == (2, 4)
    assert (boxes[:, 2] <= 64).all() and (boxes[:, 3] <= 64).all()


def test_rt_two_stage_pipeline_matches_plain(tile, rt_runs):
    """RT-based Segmentation->Features == plain function pipeline (the
    precondition for the Fig. 11 overhead comparison): the same steps on
    the same device, so the labels are equal bit for bit."""
    rgb, _ = tile
    plain = tpipe.analyze_tile(rgb, CFG, device="cpu")
    got = rt_runs["torch"]
    np.testing.assert_array_equal(got["labels"], plain["labels"].numpy())
    np.testing.assert_array_equal(got["hema"], plain["hematoxylin"].numpy())
    np.testing.assert_allclose(got["features"][0], plain["features"].numpy(),
                               rtol=FEATURE_TOL, atol=FEATURE_TOL)
    np.testing.assert_array_equal(got["boxes"][0], plain["boxes"].numpy())


def test_rt_two_stage_pipeline_matches_the_reference_rt(rt_runs):
    want, got = rt_runs["jax"], rt_runs["torch"]
    thr = CFG.seg_threshold
    np.testing.assert_allclose(got["hema"], want["hema"], atol=FEATURE_TOL, rtol=0)
    flips = (got["hema"] > thr) != (want["hema"] > thr)
    assert (np.abs(want["hema"][flips] - thr) <= FEATURE_TOL).all()
    if not flips.any():  # same thresholded mask: the whole segmentation agrees
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_array_equal(got["boxes"][0], want["boxes"][0])
    # the features on the reference's own ROIs
    j_rois, _ = jpipe.extract_object_rois(want["labels"], want["hema"], J_CFG)
    feats = tpipe.compute_features(j_rois, CFG, device="cpu").numpy()
    np.testing.assert_allclose(feats, want["features"][0], rtol=FEATURE_TOL, atol=FEATURE_TOL)


def test_rt_tiered_partitions_match_plain_on_each_crop(tile):
    """Tiered stores, four partitions over two workers: each partition's
    labels equal the plain path on that crop."""
    rgb, _ = tile
    got = run_rt("torch", rgb, part=64, mode="tiered", num_workers=2)
    assert len(got["parts"]) == 4
    for part, feats in zip(got["parts"], got["features"]):
        (y0, x0), (y1, x1) = part.lo, part.hi
        plain = tpipe.analyze_tile(rgb[:, y0:y1, x0:x1], CFG, device="cpu")
        np.testing.assert_array_equal(got["labels"][y0:y1, x0:x1], plain["labels"].numpy())
        np.testing.assert_allclose(feats, plain["features"].numpy(),
                                   rtol=FEATURE_TOL, atol=FEATURE_TOL)
    stats = got["stores"].get("DMS2").tier_stats()
    assert stats["MEM"].hits > 0


def test_rt_stages_and_storage_refuse_what_is_missing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for stage in (tpipe.SegmentationStage, tpipe.FeatureStage):
        with pytest.raises(RuntimeError, match="CUDA"):
            stage(CFG)
        with pytest.raises(RuntimeError, match="CUDA"):
            stage(CFG, device="cuda")
        assert stage(CFG, device="cpu").device.type == "cpu"
    # the gateways run their chains on the card unless given the CPU
    for kw in ({"serve": True}, {"compute": True}):
        with pytest.raises(RuntimeError, match="CUDA"):
            tpipe.make_wsi_storage(8, 8, **kw)
    # the reference's refusals: settings that in-process shards would ignore
    for kw in ({"endpoints": ["h:1"]}, {"wire_codec": "zlib"}):
        with pytest.raises(ValueError, match="transport='socket'"):
            tpipe.make_wsi_storage(8, 8, **kw)
    with pytest.raises(TypeError, match="serve="):
        tpipe.make_wsi_storage(8, 8, serve="yes", device="cpu")
    with pytest.raises(ValueError):
        tpipe.make_wsi_storage(8, 8, transport="carrier-pigeon")
    with pytest.raises(ValueError):
        tpipe.make_wsi_storage(8, 8, mode="flat")
