"""The port's spans (``repro_torch.spans``): recorded only while a torch
profiler records, nested by tile, on the profiler's clock, and never drawn
into the profiler's trace. The test marked ``cuda`` skips where no card is
present: on the card it counts one tile's host-device synchronisations,
span by span and against ``torch.cuda.set_sync_debug_mode``. The last tests
hold the region-template runtime's spans (``rt.stage.*``, ``rt.dispatch``)
and the stores' (``dms.*``) on one image at one GPU's share of a node, the
tiered stores' (``tiers.*``, ``disk.get``) on the same image over a DISK
tier, and the benchmark's readers of them.
"""
import shutil
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs.wsi import WSIConfig
from repro_torch.core import BoundingBox, Intent, RegionTemplate
from repro_torch.kernels import morph_recon
from repro_torch.pipeline import (
    FeatureStage,
    SegmentationStage,
    analyze_tile,
    make_tile,
    make_wsi_storage,
)
from repro_torch.runtime import SysEnv

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the benchmark's readers

CFG = WSIConfig(tile=256, max_objects_per_tile=32)
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture
def rgb():
    spans.reset()
    yield make_tile(256, seed=11)[0]
    spans.reset()


def by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_without_a_profiler_nothing_is_recorded_and_no_event_made(rgb, monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(1))
    analyze_tile(rgb, CFG, device="cpu")
    cuda = torch.device("cuda")
    with spans.span("wsi.segment_tile", cuda), spans.sync("percentile", cuda):
        pass
    assert spans.span("x", cuda) is spans.span("y") is spans.sync("z", cuda)
    assert spans.records() == [] and made == []


def test_a_tile_nests_under_its_root_with_one_root_id(rgb):
    plain = analyze_tile(rgb, CFG, device="cpu")
    with torch.profiler.profile(activities=CPU):
        traced = analyze_tile(rgb, CFG, device="cpu")
        analyze_tile(rgb, CFG, device="cpu")
    for key in ("labels", "boxes", "features"):
        assert torch.equal(plain[key], traced[key]), key
    recs = spans.records()
    names = by_name(recs)
    assert sorted(names) == ["wsi.analyze_tile", "wsi.extract_object_rois", "wsi.segment_tile"]
    roots = names["wsi.analyze_tile"]
    assert len(roots) == 2 and roots[0].id != roots[1].id
    for root in roots:
        assert root.parent is None and root.root == root.id
        kids = [r for r in recs if r.root == root.id and r is not root]
        assert sorted(k.name for k in kids) == ["wsi.extract_object_rois", "wsi.segment_tile"]
        for k in kids:
            assert k.parent == root.id
            assert root.start_ns <= k.start_ns <= k.end_ns <= root.end_ns
            assert k.device_ms is None  # no card: no events
    seg, rois = (next(k for k in recs if k.root == roots[0].id and k.name == n)
                 for n in ("wsi.segment_tile", "wsi.extract_object_rois"))
    assert seg.end_ns <= rois.start_ns
    assert recs.index(seg) < recs.index(roots[0])  # a span closes after its children


def test_spans_share_the_profilers_clock_and_stay_out_of_its_trace(rgb):
    with torch.profiler.profile(activities=CPU) as prof:
        with torch.autograd.profiler.record_function("probe.warm"):
            pass  # a process's first range opens about 1 ms late
        with torch.autograd.profiler.record_function("probe.tile"):
            analyze_tile(rgb, CFG, device="cpu")
    (root,) = [r for r in spans.records() if r.name == "wsi.analyze_tile"]
    (probe,) = [e for e in prof.events() if e.name == "probe.tile"]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    start_ns = t0 + 1000 * probe.time_range.start
    end_ns = t0 + 1000 * probe.time_range.end
    assert abs(root.start_ns - start_ns) < 1_000_000
    assert abs(root.end_ns - end_ns) < 1_000_000
    assert start_ns <= root.start_ns + 1_000 and root.end_ns <= end_ns + 1_000
    named = {r.name for r in spans.records()}
    assert not [e.name for e in prof.events() if e.name in named or e.name.startswith("sync.")]


def test_the_cpu_path_records_no_upload_and_no_sync(rgb):
    with torch.profiler.profile(activities=CPU):
        analyze_tile(rgb, CFG, device="cpu")
    names = [r.name for r in spans.records()]
    assert names and not [n for n in names if n == "wsi.upload" or n.startswith("sync.")]


def test_spans_on_another_thread_record_with_their_own_stack(rgb):
    got = []

    def work():
        with spans.span("thread.outer"):
            with spans.span("thread.inner"):
                got.append(threading.get_ident())

    with torch.profiler.profile(activities=CPU):
        with spans.span("main.outer"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive() and got
    names = by_name(spans.records())
    (outer,), (inner,), (main,) = names["thread.outer"], names["thread.inner"], names["main.outer"]
    assert outer.parent is None and outer.root == outer.id  # not under the main thread's span
    assert inner.parent == outer.id and inner.root == outer.id
    assert main.parent is None
    spans.reset()
    assert spans.records() == []


@pytest.mark.cuda
def test_one_card_tile_counts_its_host_syncs():
    """One 256^2 tile on the card: one RGB upload, the stain inverse's and the
    percentile's four index uploads, one worklist read every
    ``ROUNDS_PER_READ`` reconstruction rounds, ``nonzero`` and ``unique``;
    as many as ``torch.cuda.set_sync_debug_mode("warn")`` reports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rgb = make_tile(256, seed=11)[0]
    analyze_tile(rgb, CFG)  # builds the kernels
    torch.cuda.synchronize()
    spans.reset()
    before = morph_recon.launches
    with torch.profiler.profile(activities=CPU):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                analyze_tile(rgb, CFG)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    reads = (morph_recon.launches - before) // morph_recon.ROUNDS_PER_READ
    recs = spans.records()
    spans.reset()
    counts = {n: len(v) for n, v in by_name(recs).items()}
    assert counts == {"wsi.analyze_tile": 1, "wsi.segment_tile": 1, "wsi.extract_object_rois": 1,
                      "wsi.upload": 1, "sync.stain_inverse": 1, "sync.percentile": 4,
                      "sync.morph_recon_worklist": reads, "sync.rois_nonzero": 1,
                      "sync.rois_unique": 1}
    syncs = sum(v for n, v in counts.items() if n == "wsi.upload" or n.startswith("sync."))
    reported = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(reported) == syncs, [f"{w.filename}:{w.lineno}" for w in reported]
    for name in ("wsi.segment_tile", "wsi.extract_object_rois"):
        (rec,) = by_name(recs)[name]
        assert rec.device_ms is not None and rec.device_ms > 0


# -- the region-template runtime and stores ---------------------------------------------
NODE_CFG = WSIConfig(tile=128, max_objects_per_tile=16)


def rt_image(n: int = 4, tiered: bool = False) -> dict:
    """One image of ``n`` 128^2 tiles through the RT stages at one GPU's share
    of a node (3 CPU threads, 1 accelerator thread, 4 stages active), the
    tiles through the in-process DMS, or with ``tiered`` through tiered
    stores whose placement pins the RGB to the DISK tier; returns the stages
    by tile."""
    size = NODE_CFG.tile
    if not tiered:
        reg = make_wsi_storage(size, n * size, tile=size)
        return _rt_image(reg, n)
    from repro_torch.storage.placement import PlacementPolicy, when

    root = tempfile.mkdtemp(prefix="spans_tiers_")
    pin = when(lambda key, bb, nbytes, dtype: key.name == "RGB", "DISK", pinned=True)
    reg = make_wsi_storage(size, n * size, mode="tiered", tile=size, root=root,
                           policy=PlacementPolicy([pin]))
    try:
        return _rt_image(reg, n)
    finally:
        for name in ("DMS3", "DMS2"):
            reg.get(name).close()
        shutil.rmtree(root, ignore_errors=True)


def _rt_image(reg, n: int) -> dict:
    size = NODE_CFG.tile
    rt = RegionTemplate("Patient")
    dom3 = BoundingBox((0, 0, 0), (3, size, n * size))
    rgb = rt.new_region("RGB", dom3, np.float32, input_storage="DMS3", lazy=True)
    env = SysEnv(num_workers=1, cpus_per_worker=3, accels_per_worker=1, max_active=4,
                 registry=reg)
    stages = []
    try:
        for j in range(n):
            part3 = BoundingBox((0, 0, j * size), (3, size, (j + 1) * size))
            part2 = BoundingBox((0, j * size), (size, (j + 1) * size))
            reg.get("DMS3").put(rgb.key, part3, make_tile(size, num_nuclei=4, seed=j)[0])
            seg = SegmentationStage(NODE_CFG, device="cpu")
            seg.add_region_template(rt, "RGB", part3, Intent.INPUT, read_storage="DMS3")
            seg.add_region_template(rt, "Mask", part2, Intent.OUTPUT, storage="DMS2")
            seg.add_region_template(rt, "Hema", part2, Intent.OUTPUT, storage="DMS2")
            feat = FeatureStage(NODE_CFG, device="cpu")
            feat.add_region_template(rt, "Mask", part2, Intent.INPUT, read_storage="DMS2")
            feat.add_region_template(rt, "Hema", part2, Intent.INPUT, read_storage="DMS2")
            feat.add_dependency(seg)
            env.execute_component(seg)
            env.execute_component(feat)
            stages.append((seg, feat))
        env.startup_execution()
    finally:
        env.finalize_system()
    return stages


def test_an_image_records_each_stage_and_its_dispatch_with_its_tasks_under_it():
    spans.reset()
    with torch.profiler.profile(activities=CPU):
        rt_image()
    recs = spans.records()
    spans.reset()
    names = by_name(recs)
    assert len(names["rt.stage.SegmentationStage"]) == 4
    assert len(names["rt.stage.FeatureStage"]) == 4
    assert len(names["rt.dispatch"]) == 8
    stage_spans = names["rt.stage.SegmentationStage"] + names["rt.stage.FeatureStage"]
    for d in names["rt.dispatch"]:
        assert d.parent is None and d.start_ns <= d.end_ns
    # each dispatch closes before its stage opens, on the stage's own thread
    starts = sorted(s.start_ns for s in stage_spans)
    ends = sorted(d.end_ns for d in names["rt.dispatch"])
    assert all(e <= s for e, s in zip(ends, starts))
    by_id = {r.id: r for r in recs}
    for rois in names["wsi.extract_object_rois"]:  # on a WRM thread, under its stage
        assert by_id[rois.parent].name == "rt.stage.FeatureStage"
        assert rois.root == rois.parent
    feats = names["rt.stage.FeatureStage"]
    segs = names["rt.stage.SegmentationStage"]
    assert min(f.start_ns for f in feats) >= min(s.end_ns for s in segs)


def test_the_stores_record_get_and_put_with_the_assembly_inside_get():
    spans.reset()
    with torch.profiler.profile(activities=CPU):
        rt_image(2)
    recs = spans.records()
    spans.reset()
    names = by_name(recs)
    by_id = {r.id: r for r in recs}
    # per tile: the RGB, the mask and the hematoxylin put; the three read back
    assert len(names["dms.put"]) == 6 and len(names["dms.get"]) == 6
    assert len(names["dms.assemble"]) == 6
    for a in names["dms.assemble"]:
        outer = by_id[a.parent]
        assert outer.name == "dms.get" and outer.start_ns <= a.start_ns <= a.end_ns <= outer.end_ns
    for rec in names["dms.get"]:
        assert by_id[rec.parent].name.startswith("rt.stage.")


def test_the_tiered_stores_record_their_puts_and_gets_under_the_stages():
    spans.reset()
    with torch.profiler.profile(activities=CPU):
        rt_image(2, tiered=True)
    recs = spans.records()
    spans.reset()
    names = by_name(recs)
    by_id = {r.id: r for r in recs}

    def parent(rec) -> str | None:
        return by_id[rec.parent].name if rec.parent is not None else None

    # per tile: the RGB put (the caller's), the mask and the hematoxylin put
    # (the segmentation's); the RGB read from DISK, the two read back from memory
    puts, gets = names["tiers.put"], names["tiers.get"]
    assert len(puts) == 6 and len(gets) == 6
    assert sorted(map(str, map(parent, puts))) == ["None"] * 2 + ["rt.stage.SegmentationStage"] * 4
    assert sorted(map(parent, gets)) == (["rt.stage.FeatureStage"] * 4
                                         + ["rt.stage.SegmentationStage"] * 2)
    (d1, d2) = names["disk.get"]  # the RGB reads alone: the stage data stays in memory
    for d in (d1, d2):
        outer = by_id[d.parent]
        assert outer.name == "tiers.get" and parent(outer) == "rt.stage.SegmentationStage"
        assert outer.start_ns <= d.start_ns <= d.end_ns <= outer.end_ns
    # every put is written through to the DMS tier, inside the tiered put
    assert len(names["dms.put"]) == 6 and {parent(r) for r in names["dms.put"]} == {"tiers.put"}
    assert "dms.get" not in names


def test_without_a_profiler_the_tiered_stores_record_nothing():
    spans.reset()
    stages = rt_image(1, tiered=True)
    assert spans.records() == []
    assert all(s.ready_ns is None for pair in stages for s in pair)


def test_without_a_profiler_the_runtime_and_stores_record_nothing():
    spans.reset()
    stages = rt_image(1)
    assert spans.records() == []
    assert all(s.ready_ns is None for pair in stages for s in pair)
    spans.record("rt.dispatch", 0, 1)
    assert spans.records() == [] and spans.current() is None
    assert spans.within(None) is spans.span("x")


def test_record_keeps_a_span_started_elsewhere_under_the_open_span():
    spans.reset()
    with torch.profiler.profile(activities=CPU):
        t0 = time.time_ns()
        with spans.span("outer"):
            outer = spans.current()
            spans.record("waited", t0, time.time_ns())
        spans.record("alone", t0, t0 + 5)
    recs = by_name(spans.records())
    spans.reset()
    (waited,), (alone,), (o,) = recs["waited"], recs["alone"], recs["outer"]
    assert waited.parent == o.id == outer.id and waited.root == o.id
    assert alone.parent is None and alone.end_ns - alone.start_ns == 5


@pytest.mark.parametrize("metric", ["dispatch_ms.rt", "assemble_ms.rt", "store_copied_mb.rt",
                                    "disk_read_ms.tiered", "tier_put_ms.tiered",
                                    "disk_read_mb.tiered"])
def test_the_runtime_and_store_readers_read_none_on_a_run_that_recorded_nothing(metric):
    from rtbench import harness

    from repro_torch.storage import copies

    spans.reset()
    copies.reset_stats()
    run = SimpleNamespace(tally=SimpleNamespace(completed=4), counters={},
                          traffic={"warm_images": 1, "tiles_per_image": 4})
    assert harness.load_reader(metric)(run) is None
