"""The port's spans (``repro_torch.spans``): recorded only while a torch
profiler records, nested by tile, on the profiler's clock, and never drawn
into the profiler's trace. The last test is marked ``cuda`` and skips where
no card is present: on the card it counts one tile's host-device
synchronisations, span by span and against ``torch.cuda.set_sync_debug_mode``.
"""
import threading
import warnings

import pytest
import torch

from repro_torch import spans
from repro_torch.configs.wsi import WSIConfig
from repro_torch.kernels import morph_recon
from repro_torch.pipeline import analyze_tile, make_tile

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
