"""BENCHMARK.json against the benchmark's contract, on the CPU: names and
units, every file found by name, what each metric moves, and a cell added
as new files only."""
from __future__ import annotations

import json
import math
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from rtbench import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape_and_limits_of_the_file(manifest):
    assert set(manifest) == KEYS["top"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16 and all(PATH.match(p) for p in manifest["paths"])
    assert 1 <= len(manifest["command"]) <= 32 and all(one_line(w) for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[key]:
            extra = {"workloads"} if key == "end_to_end" else set()
            assert KEYS[key] <= set(entry) <= KEYS[key] | extra, (key, entry["name"])


def test_names_and_units_use_only_the_allowed_characters(manifest):
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[key]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((key, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert one_line(entry[text]), (entry["name"], text)
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in manifest["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    metric_names = [n for k, n in names if k in ("end_to_end", "per_layer")]
    assert len(metric_names) == len(set(metric_names))
    for key in ("configs", "workloads"):
        got = [n for k, n in names if k == key]
        assert len(got) == len(set(got))


def test_every_cell_finds_its_files_by_name(manifest):
    used = set()
    pairs = set()
    for w in manifest["workloads"]:
        cell = harness.load_cell(w["name"])
        used.add(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4)
        form = cell["traffic_data"]["form"]
        assert (ROOT / "rtbench" / "forms" / f"{form}.py").is_file(), form
        assert "limits" in cell["config_data"] and "failed_share" in cell["config_data"]["limits"]
    assert used == {c["name"] for c in manifest["configs"]}
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith(tuple(p + "/" for p in manifest["paths"]))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert (ROOT / "rtbench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert callable(harness.load_reader(m["name"]))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(manifest):
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)
    for w in manifest["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(manifest, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert harness.cell_metrics(manifest, w["name"], "per_layer"), w["name"]
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    setup = harness.find(manifest, "end_to_end", "setup_s")
    assert "workloads" not in setup


def test_each_layer_metric_moves_an_end_to_end_metric_its_cells_report(manifest):
    for m in manifest["per_layer"]:
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            harness.find(manifest, "workloads", cell)
            e2e = {e["name"] for e in harness.cell_metrics(manifest, cell, "end_to_end")}
            assert m["moves"] in e2e, (m["name"], cell)
        assert m["moves"] != "setup_s"
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"


def test_a_cell_added_as_new_files_only_runs(tmp_path):
    """A later change adds a configuration, a traffic mix and a metric as new
    files and one entry each in BENCHMARK.json; no file of the benchmark is
    edited, and the new cell runs."""
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "rtbench").rglob("*") if p.is_file()}
    m = harness.load_manifest()
    cfg = json.loads((ROOT / "rtbench/configs/wsi-paper-4k.json").read_text())
    cfg["wsi"].update(tile=128, max_objects_per_tile=16)
    (tmp_path / "rtbench/configs/wsi-tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "rtbench/traffic/tiles-tiny.json").write_text(json.dumps(
        {"form": "plain", "pool_tiles": 2, "warm_tiles": 1, "check_tiles": 2}))
    (tmp_path / "rtbench/metrics/tiny_tiles.py").write_text(
        "def read(run):\n    return run.tally.completed\n")
    m["configs"].append({"name": "wsi-tiny", "source": "https://arxiv.org/abs/1405.7958",
                         "file": "rtbench/configs/wsi-tiny.json", "reduced": ["tile"],
                         "why": "a tiny tile"})
    m["workloads"].append({"name": "plain-tiny", "config": "wsi-tiny", "traffic": "tiles-tiny",
                           "chips": 1, "why": "a tiny tile through analyze_tile"})
    harness.find(m, "end_to_end", "tiles_per_s")["workloads"].append("plain-tiny")
    m["per_layer"].append({"name": "tiny_tiles", "unit": "tiles", "better": "higher",
                           "source": "host_clock", "layer": "Whole tile", "moves": "tiles_per_s",
                           "workloads": ["plain-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = harness.load_cell("plain-tiny", tmp_path)
    assert cell["traffic_data"]["form"] == "plain"
    result = harness.run_cell("plain-tiny", 7, 0.5, False, device="cpu", root=tmp_path)
    assert result["correct"] and result["metrics"]["tiles_per_s"]["value"] > 0
    assert math.isfinite(result["metrics"]["setup_s"]["value"])
    traced = harness.run_cell("plain-tiny", 8, 0.5, True, device="cpu", root=tmp_path)
    assert traced["metrics"]["tiny_tiles"]["value"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data, p
