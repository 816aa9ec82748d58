"""The readers of the program's own spans (``program_spans.py`` and the five
metrics that read it), on the CPU: per-tile division, nothing read without
records, the drain that keeps two runs of one process apart, a program
without the span recorder, and a traced run of plain-4k at 256^2."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from repro_torch import spans  # noqa: E402
from rtbench import harness, program_spans  # noqa: E402

METRICS = ("upload_ms.wsi", "host_syncs.wsi", "sync_wait_ms.wsi", "segment_device_ms.plain",
           "rois_device_ms.wsi")
MS = 1_000_000  # nanoseconds


def fake_run(completed: int, records=None):
    run = SimpleNamespace(tally=SimpleNamespace(completed=completed))
    if records is not None:
        vars(run)[program_spans.KEY] = records
    return run


def tile(root: int, t0: int, upload_ms: float, seg_dev, rois_dev, worklist_reads=2):
    """The records of one tile as the program writes them."""
    s = lambda i, name, a, b, parent=root, dev=None: spans.Span(  # noqa: E731
        root + i, parent, root, name, t0 + int(a * MS), t0 + int(b * MS), dev)
    recs = [s(2, "wsi.upload", 0, upload_ms, root + 1),
            s(3, "sync.stain_inverse", 40, 40.5, root + 1)]
    recs += [s(4 + i, "sync.percentile", 41 + i, 41.25 + i, root + 1) for i in range(4)]
    recs += [s(8 + i, "sync.morph_recon_worklist", 50 + i, 51 + i, root + 1)
             for i in range(worklist_reads)]
    recs += [s(1, "wsi.segment_tile", 0, 60, dev=seg_dev),
             s(20, "sync.rois_nonzero", 61, 62, root + 19),
             s(21, "sync.rois_unique", 62, 64, root + 19),
             s(19, "wsi.extract_object_rois", 60, 66, dev=rois_dev),
             spans.Span(root, None, root, "wsi.analyze_tile", t0, t0 + 70 * MS, None)]
    return recs


def read_all(run) -> dict:
    return {m: harness.load_reader(m)(run) for m in METRICS}


def test_the_readers_divide_by_the_completed_tiles():
    recs = tile(1, 0, 30.0, 38.0, 2.0, worklist_reads=2) + tile(100, 10**9, 34.0, 40.0, 2.5,
                                                                 worklist_reads=4)
    got = read_all(fake_run(2, recs))
    assert got["upload_ms.wsi"] == pytest.approx((30.0 + 34.0) / 2)
    # upload, stain inverse, 4 percentile uploads, worklist reads, nonzero, unique
    assert got["host_syncs.wsi"] == pytest.approx(((1 + 1 + 4 + 2 + 2) + (1 + 1 + 4 + 4 + 2)) / 2)
    one = 0.5 + 4 * 0.25 + 1 + 2  # the sync.* spans of a tile, less the worklist reads
    assert got["sync_wait_ms.wsi"] == pytest.approx((one + 2 + one + 4) / 2)
    assert got["segment_device_ms.plain"] == pytest.approx(39.0)  # a call
    assert got["rois_device_ms.wsi"] == pytest.approx(2.25)


def test_nothing_recorded_reads_none():
    assert all(v is None for v in read_all(fake_run(3, [])).values())
    no_tiles = read_all(fake_run(0, tile(1, 0, 30.0, 38.0, 2.0)))
    assert no_tiles["upload_ms.wsi"] is None and no_tiles["host_syncs.wsi"] is None
    cpu = read_all(fake_run(1, tile(1, 0, 30.0, None, None)))  # no card: no events
    assert cpu["segment_device_ms.plain"] is None and cpu["rois_device_ms.wsi"] is None
    assert cpu["host_syncs.wsi"] == 10


def test_the_first_read_drains_the_program_so_two_runs_stay_apart():
    spans.reset()
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=cpu):
        for _ in range(3):
            with spans.span("wsi.analyze_tile"), spans.span("wsi.upload"):
                pass
    first = fake_run(3)
    assert harness.load_reader("host_syncs.wsi")(first) == 1.0
    assert spans.records() == []  # taken by the first run's first read
    with torch.profiler.profile(activities=cpu):
        with spans.span("wsi.analyze_tile"), spans.span("sync.percentile"):
            pass
    second = fake_run(1)
    assert harness.load_reader("host_syncs.wsi")(second) == 1.0
    assert [r.name for r in program_spans.records(second)] == ["sync.percentile",
                                                               "wsi.analyze_tile"]
    assert len(program_spans.records(first)) == 6  # still its own records
    assert harness.load_reader("upload_ms.wsi")(second) == 0.0


def test_a_program_without_the_span_recorder_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)  # the import fails
    assert all(v is None for v in read_all(fake_run(2)).values())


@pytest.fixture(scope="module")
def small(tmp_path_factory) -> Path:
    """plain-4k at 256^2 tiles, as the other CPU tests of the cells run it."""
    root = tmp_path_factory.mktemp("small")
    shutil.copytree(ROOT / "rtbench", root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    m = harness.load_manifest()
    for c in m["configs"]:
        d = json.loads((ROOT / c["file"]).read_text())
        d["wsi"].update(tile=256, max_objects_per_tile=32)
        (root / c["file"]).write_text(json.dumps(d))
    t = json.loads((ROOT / "rtbench/traffic/tiles-4k.json").read_text())
    t.update(pool_tiles=4)
    (root / "rtbench/traffic/tiles-4k.json").write_text(json.dumps(t))
    return root


def test_a_traced_cpu_run_reports_the_host_metrics(small):
    spans.reset()
    traced = harness.run_cell("plain-4k", 2**31 + 27, 1.0, True, device="cpu", root=small)
    assert traced["correct"], traced["checks"]
    got = traced["metrics"]
    # no card: no upload and no synchronisation, and no CUDA events to read
    assert got["upload_ms.wsi"] == {"value": 0.0, "unit": "ms"}
    assert got["host_syncs.wsi"] == {"value": 0.0, "unit": "syncs"}
    assert got["sync_wait_ms.wsi"] == {"value": 0.0, "unit": "ms"}
    assert "segment_device_ms.plain" not in got and "rois_device_ms.wsi" not in got
    assert spans.records() == []  # drained by the run's readers
    untraced = harness.run_cell("plain-4k", 2**31 + 27, 0.5, False, device="cpu", root=small)
    assert not set(METRICS) & set(untraced["metrics"]) and spans.records() == []
