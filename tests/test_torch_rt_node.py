"""The paper's region-template deployment at one GPU's share of a Keeneland
node, on the CPU at 256^2: ``SegmentationStage`` -> ``FeatureStage`` a tile
under ``SysEnv`` with one worker of 3 CPU threads and 1 accelerator thread
and 4 stages active (``rtbench/configs/wsi-rt-node-4k.json``), the tiles
through the in-process DMS, images of 4 tiles one ``SysEnv`` run each, as
the benchmark's ``rt`` form drives them.

The stages run the plain form's steps on the same device, so labels and
boxes equal ``analyze_tile``'s bit for bit; labels, boxes and features pass
the benchmark's plain reference at the configuration's limits; one stage at
a time gives the same answers; and no tile-sized tensor outlives its image
while the garbage collector is off (what held device memory from image to
image on the card)."""
import gc
import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.wsi import WSIConfig
from repro_torch.core import BoundingBox, Intent, RegionTemplate
from repro_torch.pipeline import (
    FeatureStage,
    SegmentationStage,
    analyze_tile,
    make_tile,
    make_wsi_storage,
)
from repro_torch.runtime import SysEnv

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from rtbench import compare, reference  # noqa: E402

NODE = json.loads((ROOT / "rtbench/configs/wsi-rt-node-4k.json").read_text())
SIZE, PER_IMAGE, IMAGES = 256, 4, 2
WSI = {**NODE["wsi"], "tile": SIZE, "max_objects_per_tile": 32}
CFG = WSIConfig(**WSI)


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_threads():
    """The first large parallel op of a process may split its work over the
    CPU threads differently from every later one (an ulp of torch's log10
    on a few pixels); one such op first keeps the two forms bit for bit."""
    torch.log10(torch.rand(1 << 20))


@pytest.fixture(scope="module")
def tiles():
    return [make_tile(SIZE, num_nuclei=10, seed=40 + i)[0] for i in range(PER_IMAGE * IMAGES)]


class Node:
    """The deployment: the stores of one image's domains, and one ``SysEnv``
    run an image at the worker shape ``worker``."""

    def __init__(self, worker: dict) -> None:
        self.worker = worker
        self.reg = make_wsi_storage(SIZE, PER_IMAGE * SIZE, tile=SIZE)
        self.dom3 = BoundingBox((0, 0, 0), (3, SIZE, PER_IMAGE * SIZE))
        self.parts = [(BoundingBox((0, 0, j * SIZE), (3, SIZE, (j + 1) * SIZE)),
                       BoundingBox((0, j * SIZE), (SIZE, (j + 1) * SIZE)))
                      for j in range(PER_IMAGE)]

    def image(self, rgbs: list[np.ndarray]) -> list[dict]:
        w = self.worker
        rt = RegionTemplate("Patient")
        rgb = rt.new_region("RGB", self.dom3, np.float32, input_storage="DMS3", lazy=True)
        dms3, dms2 = self.reg.get("DMS3"), self.reg.get("DMS2")
        env = SysEnv(num_workers=w["workers"], cpus_per_worker=w["cpus"],
                     accels_per_worker=w["accels"], max_active=w["max_active"],
                     registry=self.reg)
        try:
            stages = []
            for x, (part3, part2) in zip(rgbs, self.parts):
                dms3.put(rgb.key, part3, x)
                seg = SegmentationStage(CFG, device="cpu")
                seg.add_region_template(rt, "RGB", part3, Intent.INPUT, read_storage="DMS3")
                seg.add_region_template(rt, "Mask", part2, Intent.OUTPUT, storage="DMS2")
                seg.add_region_template(rt, "Hema", part2, Intent.OUTPUT, storage="DMS2")
                feat = FeatureStage(CFG, device="cpu")
                feat.add_region_template(rt, "Mask", part2, Intent.INPUT, read_storage="DMS2")
                feat.add_region_template(rt, "Hema", part2, Intent.INPUT, read_storage="DMS2")
                feat.add_dependency(seg)
                env.execute_component(seg)
                env.execute_component(feat)
                stages.append((seg, feat))
            env.startup_execution()
            out = []
            for (seg, feat), (_, part2) in zip(stages, self.parts):
                key = seg.templates["Patient"].get("Mask").key
                objs = feat.templates["Patient"].get("Features").data
                out.append({"labels": dms2.get(key, part2), "boxes": objs["boxes"],
                            "features": objs["features"]})
            return out
        finally:
            env.finalize_system()

    def run(self, tiles: list[np.ndarray]) -> list[dict]:
        return [a for i in range(0, len(tiles), PER_IMAGE)
                for a in self.image(tiles[i:i + PER_IMAGE])]


@pytest.fixture(scope="module")
def node_answers(tiles):
    return Node(NODE["worker"]).run(tiles)


def test_the_configuration_is_the_papers_analysis_at_one_gpus_share_of_a_node():
    paper = json.loads((ROOT / "rtbench/configs/wsi-paper-4k.json").read_text())
    assert NODE["wsi"] == paper["wsi"] and NODE["limits"] == paper["limits"]
    assert NODE["worker"] == {"workers": 1, "cpus": 3, "accels": 1, "max_active": 4,
                              "policy": "PATS"}
    assert NODE["storage"] == {"mode": "dms", "transport": "inproc"}


def test_labels_and_boxes_equal_analyze_tiles_bit_for_bit(tiles, node_answers):
    assert len(node_answers) == len(tiles)
    for rgb, got in zip(tiles, node_answers):
        want = analyze_tile(rgb, CFG, device="cpu")
        np.testing.assert_array_equal(got["labels"], want["labels"].numpy())
        np.testing.assert_array_equal(got["boxes"], want["boxes"].numpy())
        np.testing.assert_array_equal(got["features"], want["features"].numpy())
        assert len(got["boxes"]) > 0


def test_the_answers_pass_the_plain_reference_at_the_configurations_limits(tiles,
                                                                           node_answers):
    readings = [compare.tile_numbers(got, reference.analyze(rgb, WSI, "cpu"))
                for rgb, got in zip(tiles, node_answers)]
    limits = {k: v for k, v in NODE["limits"].items() if k != "failed_share"}
    correct, checks = compare.judge(compare.worst(readings), limits)
    assert correct, checks


def test_one_stage_at_a_time_gives_the_same_answers(tiles, node_answers):
    serial = Node({**NODE["worker"], "max_active": 1}).run(tiles)
    for got, want in zip(serial, node_answers):
        for key in ("labels", "boxes", "features"):
            np.testing.assert_array_equal(got[key], want[key])


def test_no_tile_sized_tensor_outlives_its_image_without_the_collector(tiles):
    node = Node(NODE["worker"])
    node.image(tiles[:PER_IMAGE])  # the stores' blocks and the tile path's first calls

    def tile_tensors() -> int:
        with warnings.catch_warnings():  # isinstance on torch's deprecated aliases
            warnings.simplefilter("ignore", FutureWarning)
            return sum(1 for o in gc.get_objects()
                       if isinstance(o, torch.Tensor) and o.numel() >= SIZE * SIZE)

    gc.collect()
    before = tile_tensors()
    gc.disable()
    try:
        for i in range(2):
            node.image(tiles[PER_IMAGE * i:PER_IMAGE * (i + 1)])
            assert tile_tensors() == before, i
    finally:
        gc.enable()
