"""The cell rt-tiered-4k on the CPU at 256^2, through the harness as a run
drives it: correct, with its per-layer metrics in a traced run and its
DISK tier's files gone after the run; the control (the reference and the
stores' data in bfloat16) not correct; and a run whose DISK tier or memory
tier does not give back what it acknowledged not correct, by the number
that reads that tier."""
from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from rtbench import control, harness  # noqa: E402

CELL = "rt-tiered-4k"
NEW = ("disk_read_ms.tiered", "tier_put_ms.tiered", "disk_read_mb.tiered")


@pytest.fixture(scope="module")
def small(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("small")
    shutil.copytree(ROOT / "rtbench", root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    c = harness.find(harness.load_manifest(), "configs", "wsi-rt-tiered-node-4k")
    d = json.loads((ROOT / c["file"]).read_text())
    d["wsi"].update(tile=256, max_objects_per_tile=32)
    (root / c["file"]).write_text(json.dumps(d))
    return root


def test_a_run_is_correct_reports_its_metrics_and_removes_its_disk_tier(small):
    roots = []

    def hook(form) -> None:
        assert os.path.isdir(form.root)
        roots.append(form.root)

    plain = harness.run_cell(CELL, 2**31 + 101, 1.0, False, device="cpu", root=small,
                             form_hook=hook)
    assert plain["correct"], plain["checks"]
    assert {"disk_rgb_off_share", "mem_mask_off_share"} <= set(plain["checks"])
    assert plain["metrics"]["tiles_per_s"]["value"] > 0
    traced = harness.run_cell(CELL, 2**31 + 102, 1.0, True, device="cpu", root=small,
                              form_hook=hook)
    assert traced["correct"], traced["checks"]
    got = traced["metrics"]
    assert set(NEW) <= set(got)
    assert got["disk_read_mb.tiered"]["value"] == pytest.approx(3 * 256 * 256 * 4 * 1e-6)
    assert {"store_ms.rt", "dispatch_ms.rt", "tile_mfu"} <= set(got)
    assert len(roots) == 2 and not any(os.path.exists(r) for r in roots)


@pytest.mark.parametrize("seed", [2**31 + 1, 5])
def test_the_control_is_not_correct(small, seed):
    got = control.readings(CELL, seed, "cpu", root=small)
    assert not got["correct"], got["checks"]
    assert got["checks"]["disk_rgb_off_share"]["value"] > 0
    assert got["checks"]["mem_mask_off_share"]["value"] > 0


def corrupt_the_slides_files(form) -> None:
    """One element of every tile's file, overwritten in place after set-up."""
    disk = {t.name: t.backend for t in form.reg.get("DMS3").tiers}["DISK"]
    for entry in os.scandir(disk.root):
        if entry.name.startswith("chunk-"):
            with open(entry.path, "r+b") as f:
                f.write(np.float32(0.5).tobytes())


def memory_keeps_another_mask(form) -> None:
    """The memory tier of "DMS2" keeps a mask other than the one put (and
    written through to the DMS tier)."""
    mem = {t.name: t.backend for t in form.reg.get("DMS2").tiers}["MEM"]
    put = mem.put

    def altered(key, bb, array):
        if key.name == "Mask":
            array = np.array(array, copy=True)
            array.flat[0] += 1
        put(key, bb, array)

    mem.put = altered


@pytest.mark.parametrize("fault, number", [(corrupt_the_slides_files, "disk_rgb_off_share"),
                                           (memory_keeps_another_mask, "mem_mask_off_share")])
def test_a_store_that_does_not_give_back_what_it_acknowledged_is_not_correct(small, fault,
                                                                             number):
    broken = harness.run_cell(CELL, 2**31 + 103, 1.0, False, device="cpu", root=small,
                              form_hook=fault)
    assert not broken["correct"], broken["checks"]
    assert broken["checks"][number]["value"] > 0
