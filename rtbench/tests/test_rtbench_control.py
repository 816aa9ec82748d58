"""The comparison that decides ``correct`` must fail what it exists to
catch, here on the CPU at a size a test run holds (the cells' own sizes run
on the card through ``rtbench/control.py``):

* the control, the reference computed in bfloat16 in the program's place,
  comes out as not correct on every configuration;
* a run whose timed path is broken underneath (an answer altered where it is
  produced, half of a batch left out) comes out as not correct, with the
  harness driving the rest of the run as usual.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from rtbench import control, harness  # noqa: E402


@pytest.fixture(scope="module")
def small(tmp_path_factory) -> Path:
    """A copy of the cells at 256^2 tiles, with the RT form's cell, whose
    files are kept for its return (PERF.md §7), added to its manifest."""
    root = tmp_path_factory.mktemp("small")
    shutil.copytree(ROOT / "rtbench", root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = harness.load_manifest()
    if not any(w["name"] == "rt-dms-4k" for w in m["workloads"]):
        m["workloads"].append({"name": "rt-dms-4k", "config": "wsi-paper-4k",
                               "traffic": "images-4k", "chips": 1, "why": "the RT form"})
        harness.find(m, "end_to_end", "tiles_per_s")["workloads"].append("rt-dms-4k")
    for c in m["configs"]:
        d = json.loads((ROOT / c["file"]).read_text())
        d["wsi"].update(tile=256, max_objects_per_tile=32)
        (root / c["file"]).write_text(json.dumps(d))
    for t in (ROOT / "rtbench/traffic").glob("*.json"):
        d = json.loads(t.read_text())
        d.update(pool_tiles=4)
        (root / "rtbench/traffic" / t.name).write_text(json.dumps(d))
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


@pytest.mark.parametrize("cell", ["plain-4k", "rt-dms-4k"])
@pytest.mark.parametrize("seed", [2**31 + 1, 2**32 + 3, 5])
def test_the_control_is_not_correct(small, cell, seed):
    got = control.readings(cell, seed, "cpu", root=small)
    assert got["dtype"] == "torch.bfloat16"
    assert not got["correct"], got["checks"]


def alter_one_object(fn):
    def broken(mask, *args, **kwargs):
        labels = fn(mask, *args, **kwargs).clone()
        ids = torch.unique(labels[labels >= 0])
        if len(ids):
            labels[labels == ids[len(ids) // 2]] = -1  # one nucleus lost
        return labels
    return broken


def half_of_the_batch(fn):
    def broken(bins, *args, **kwargs):
        out = fn(bins, *args, **kwargs).clone()
        out[len(out) // 2:] = out[: len(out) - len(out) // 2].mean(dim=0)
        return out
    return broken


FAULTS = {
    "ccl answer altered": ("plain-4k", "connected_components", alter_one_object),
    "ccl answer altered, RT form": ("rt-dms-4k", "connected_components", alter_one_object),
    "half of the ROI batch left out": ("plain-4k", "texture_features", half_of_the_batch),
    "half of the ROI batch left out, RT form": ("rt-dms-4k", "texture_features",
                                                half_of_the_batch),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(small, monkeypatch, fault):
    cell, target, breaker = FAULTS[fault]

    def hook(form):
        from repro_torch.kernels import ops

        monkeypatch.setattr(ops, target, breaker(getattr(ops, target)))

    sound = harness.run_cell(cell, 2**31 + 11, 1.0, False, device="cpu", root=small)
    assert sound["correct"], sound["checks"]
    broken = harness.run_cell(cell, 2**31 + 11, 1.0, False, device="cpu", root=small,
                              form_hook=hook)
    assert not broken["correct"], broken["checks"]
