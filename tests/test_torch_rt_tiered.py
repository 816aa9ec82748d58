"""The paper's region-template analysis over the tiered store, on the CPU at
256^2 with a 4 x 4-tile slide: the benchmark's ``rt_tiered`` form
(``rtbench/forms/rt_tiered.py``, configuration
``rtbench/configs/wsi-rt-tiered-node-4k.json``) drives it. The slide's RGB
is pinned to the DISK tier as files; the stages' Mask and Hema go to the
memory tier and through to the DMS tier; PATS prices each task's input by
the tier that holds it.

Labels and boxes equal ``analyze_tile``'s and the DMS form's bit for bit;
the answers pass the benchmark's plain reference at the configuration's
limits; the DISK tier gives the slide back bit for bit; the memory tier's
Mask equals the DMS tier's write-through copy after the stores' spares
have been reused; a window of several images demotes nothing and writes
nothing to DISK; the locality function names DISK for the RGB and MEM for
the stage data; and the DISK tier's files go with ``release()``.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.wsi import WSIConfig
from repro_torch.core import BoundingBox, RegionKey
from repro_torch.core.regions import ElementType
from repro_torch.pipeline import analyze_tile
from repro_torch.storage import MemoryTier, copies

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from rtbench import compare, reference  # noqa: E402
from rtbench.forms import rt, rt_tiered  # noqa: E402
from rtbench.harness import Ctx  # noqa: E402

SIZE, SEED, WINDOW = 256, 2**31 + 41, 3  # images in the window, after the warm one


def config(name: str) -> dict:
    c = json.loads((ROOT / f"rtbench/configs/{name}.json").read_text())
    c["wsi"].update(tile=SIZE, max_objects_per_tile=32)
    return c


TIERED = config("wsi-rt-tiered-node-4k")
TRAFFIC = json.loads((ROOT / "rtbench/traffic/slide-16x4k.json").read_text())
CFG = WSIConfig(**TIERED["wsi"])
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_threads():
    """The first large parallel op of a process may split its work over the
    CPU threads differently from every later one (an ulp of torch's log10
    on a few pixels); one such op first keeps the two forms bit for bit."""
    torch.log10(torch.rand(1 << 20))


def form(traffic: dict | None = None) -> rt_tiered.Form:
    return rt_tiered.Form(Ctx("rt-tiered-4k", TIERED, traffic or TRAFFIC, SEED, CPU))


@pytest.fixture(scope="module")
def run():
    """The form set up (the slide written, one warm image), then a window
    of ``WINDOW`` images with the stores' counters read on each side."""
    f = form()
    f.setup()
    before = f.counters()
    answers = [a for _ in range(WINDOW) for a in f.image()]
    after = f.counters()
    yield f, answers, {k: after[k] - before.get(k, 0) for k in after}
    f.release()


def tiers(f, store: str) -> dict:
    return {t.name: t.backend for t in f.reg.get(store).tiers}


def test_the_configuration_is_rt_node_4k_over_the_tiered_store():
    node = json.loads((ROOT / "rtbench/configs/wsi-rt-node-4k.json").read_text())
    mine = json.loads((ROOT / "rtbench/configs/wsi-rt-tiered-node-4k.json").read_text())
    assert mine["wsi"] == node["wsi"] and mine["worker"] == node["worker"]
    assert {k: v for k, v in mine["limits"].items() if k in node["limits"]} == node["limits"]
    assert mine["storage"]["mode"] == "tiered" and mine["storage"]["pin"] == {"RGB": "DISK"}
    assert mine["storage"]["mem_capacity_bytes"] == 8 << 30
    assert mine["sched"]["data_locality"] and mine["slide_tiles"] == 16
    assert mine["source"] != node["source"]


def test_labels_and_boxes_equal_analyze_tile_and_the_dms_form_bit_for_bit(run):
    f, answers, _ = run
    assert len(answers) == WINDOW * TRAFFIC["tiles_per_image"]
    assert len({k for k, _ in answers}) == len(answers)  # distinct tiles of the slide
    dms = rt.Form(Ctx("rt-node-4k", config("wsi-rt-node-4k"),
                      {"form": "rt", "pool_tiles": TIERED["slide_tiles"], "tiles_per_image": 4,
                       "warm_images": 0, "check_tiles": 4}, SEED, CPU))
    dms.setup()
    try:
        assert dms.order == f.order and all(np.array_equal(a, b) for a, b in zip(dms.pool, f.pool))
        flat = dict(a for _ in range(WINDOW + 1) for a in dms.image())
    finally:
        dms.release()
    for k, got in answers:
        want = analyze_tile(f.pool[k], CFG, device="cpu")
        np.testing.assert_array_equal(got["labels"], want["labels"].numpy())
        np.testing.assert_array_equal(got["boxes"], want["boxes"].numpy())
        np.testing.assert_array_equal(got["features"], want["features"].numpy())
        for key in ("labels", "boxes", "features"):
            np.testing.assert_array_equal(got[key], flat[k][key])
        assert len(got["boxes"]) > 0


def test_the_answers_pass_the_plain_reference_at_the_configurations_limits(run):
    f, answers, _ = run
    readings = [compare.tile_numbers(got, reference.analyze(f.pool[k], TIERED["wsi"], "cpu"))
                for k, got in answers[:4]]
    limits = {k: v for k, v in TIERED["limits"].items() if k in compare.worst(readings)}
    assert len(limits) == 5
    correct, checks = compare.judge(compare.worst(readings), limits)
    assert correct, checks


def test_the_disk_tier_gives_the_slide_back_bit_for_bit(run):
    f, _, _ = run
    disk = tiers(f, "DMS3")["DISK"]
    for k, (part3, _) in enumerate(f.boxes):
        got = disk.get(f.rgb_key, part3)
        assert got.view(np.uint32).tobytes() == f.pool[k].view(np.uint32).tobytes()
        assert not got.flags.writeable  # the file's bytes, as read


DTYPES = {"Mask": np.int32, "Hema": np.float32}


def stage_key(f, region: str) -> RegionKey:
    """The key of the stages' ``region`` (the template's namespace)."""
    return RegionKey(f.rgb_key.namespace, region, ElementType.from_dtype(DTYPES[region]))


@pytest.mark.parametrize("region", sorted(DTYPES))
def test_the_memory_tiers_data_equals_the_dms_tiers_write_through_copy(run, region):
    """After the window the stores' download spares have served several
    images; each box the window wrote reads the same from both tiers, and
    the Mask is the labels the tile gives."""
    f, answers, _ = run
    two = tiers(f, "DMS2")
    key = stage_key(f, region)
    for k in sorted({k for k, _ in answers}):
        part2 = f.boxes[k][1]
        mine, durable = two["MEM"].get(key, part2), two["DMS"].get(key, part2)
        assert mine.dtype == durable.dtype and mine.tobytes() == durable.tobytes()
        if region == "Mask":
            want = analyze_tile(f.pool[k], CFG, device="cpu")["labels"].numpy()
            np.testing.assert_array_equal(mine, want)


def test_a_window_demotes_nothing_and_writes_nothing_to_disk(run):
    f, answers, window = run
    assert window and all(window[k] == 0 for k in window if k.endswith(".demotions"))
    assert window["DMS3.DISK.bytes_written"] == window["DMS2.DISK.bytes_written"] == 0
    rgb = 3 * SIZE * SIZE * 4
    assert window["DMS3.DISK.bytes_read"] == len(answers) * rgb  # one RGB read a tile
    assert window["DMS2.DISK.bytes_read"] == 0
    # the stage data: two planes a tile into memory, and through to the DMS
    assert window["DMS2.MEM.puts"] == window["DMS2.DMS.puts"] == 2 * len(answers)
    assert window["DMS2.MEM.hits"] == 3 * len(answers)  # the mask and hema read back, the labels
    cap = TIERED["storage"]["mem_capacity_bytes"]
    assert 0 < f.reg.get("DMS2").used_bytes("MEM") <= 2 * 16 * SIZE * SIZE * 4 < cap


def test_the_locality_function_names_disk_for_the_rgb_and_memory_for_stage_data(run):
    f, _, _ = run
    assert f.locality(f.rgb_key) == "DISK"
    mask, hema = (stage_key(f, r) for r in DTYPES)
    assert f.mask_key == mask and f.locality(mask) == f.locality(hema) == "MEM"
    assert f.locality(RegionKey(f.rgb_key.namespace, "Nowhere", ElementType.FLOAT32)) is None
    assert f.sched.data_locality and f.sched.locality_fn == f.locality


def test_the_memory_tier_keeps_an_acknowledged_write_whatever_the_caller_does():
    mem = MemoryTier()
    key = RegionKey("Patient", "Mask", ElementType.from_dtype(np.int32))
    bb = BoundingBox((0, 0), (64, 64))
    mine = np.arange(64 * 64, dtype=np.int32).reshape(64, 64)
    copies.reset_stats()
    mem.put(key, bb, mine)
    mine[:] = -1  # the caller's array, reused
    got = mem.get(key, bb)
    np.testing.assert_array_equal(got, np.arange(64 * 64, dtype=np.int32).reshape(64, 64))
    assert not got.flags.writeable  # the chunk's own view: no copy
    kept = copies.Spares().copy(got)  # a read-only block in a spare is kept as it is
    mem.put(key, bb, kept)
    assert np.shares_memory(mem.get(key, bb), kept)
    stats = copies.stats()
    assert stats["put_copies"] == 1 and stats["get_copies"] == 0 and stats["get_views"] == 2
    assert mem.pinned_bytes == 0  # no CUDA context here: nothing page-locked


def test_release_checks_what_the_run_acknowledged_and_removes_the_disk_tier():
    f = form({**TRAFFIC, "warm_images": 0})
    f.setup()
    root = f.root
    assert os.path.isdir(root) and any(os.scandir(root))
    for k, answer in f.image():
        f.keep(k, answer)
    f.release()
    assert not os.path.exists(root) and f.reg is None
    assert f.acknowledged == {"disk_rgb_off_share": 0.0, "mem_mask_off_share": 0.0}
    numbers = f.check(CPU)
    assert numbers["disk_rgb_off_share"] == numbers["mem_mask_off_share"] == 0.0
    f.release()  # a second release is harmless
