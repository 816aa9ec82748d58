"""Form ``rt_tiered``: the region-template form over the tiered store. The
slide's ``slide_tiles`` tiles (a square of them) are put once, at set-up,
into "DMS3" as one RGB region over the slide's domain; the configuration's
placement pins that region to the DISK tier, files written once, as a
scanner's output sits on disk. An image of ``tiles_per_image`` of the
slide's tiles, in a seed-drawn order, is one ``SysEnv`` execution of a
``SegmentationStage`` -> ``FeatureStage`` pair a tile, under PATS with
data locality priced by the tier that holds a task's input: each tile's
RGB is read from the DISK tier, its Mask and Hema are written at the
tile's box of "DMS2" into the memory tier and through to the DMS, and read
back from memory. The labels are read back from "DMS2" and the features
from the "Features" region, on the host.

Two numbers of what the run acknowledged join the reference's, each the
share of elements whose bits differ: each sampled tile's RGB read back
from the DISK tier against the tile put (``disk_rgb_off_share``), and its
Mask in the memory tier against the copy written through to the DMS tier
(``mem_mask_off_share``). They are read as the run releases its stores,
which the harness does before the check; the DISK tier's files go then.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import shutil
import tempfile

import numpy as np
import torch

from rtbench import compare, reference
from rtbench.forms import TileForm, closed_loop

STORES = ("DMS3", "DMS2")


def _off(got: np.ndarray, want: np.ndarray) -> int:
    """Elements of ``got`` whose bits differ from ``want``'s (all of them
    where the shapes or types differ)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        return want.size
    bits = np.dtype(f"u{want.dtype.itemsize}")
    return int(np.count_nonzero(got.view(bits) != want.view(bits)))


def _held_in(a: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """``a`` stored in ``dtype`` and read back in its own type."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype).to(t.dtype).numpy()


def _named(name: str):
    def match(key, bb, nbytes, dtype) -> bool:
        return key.name == name

    return match


class Form(TileForm):
    def __init__(self, ctx) -> None:
        # the tile pool is the slide, which the configuration sizes
        traffic = {**ctx.traffic, "pool_tiles": ctx.config["slide_tiles"]}
        super().__init__(dataclasses.replace(ctx, traffic=traffic))
        self.reg = self.root = None
        self.acknowledged: dict[str, float] = {}

    def setup(self) -> None:
        from repro_torch.configs.wsi import WSIConfig
        from repro_torch.core import BoundingBox, RegionTemplate
        from repro_torch.pipeline import make_wsi_storage
        from repro_torch.runtime import SchedulerConfig
        from repro_torch.storage.placement import PlacementPolicy, when

        c, t = self.ctx.config, self.ctx.traffic
        st, sc = c["storage"], c["sched"]
        self.cfg = WSIConfig(**c["wsi"])
        self.n = t["tiles_per_image"]
        size, side = self.cfg.tile, math.isqrt(c["slide_tiles"])
        self.dom3 = BoundingBox((0, 0, 0), (3, side * size, side * size))
        self.boxes = [(BoundingBox((0, r * size, q * size), (3, (r + 1) * size, (q + 1) * size)),
                       BoundingBox((r * size, q * size), ((r + 1) * size, (q + 1) * size)))
                      for r in range(side) for q in range(side)]
        rules = [when(_named(name), tier, pinned=True, label=f"{name}->{tier}")
                 for name, tier in st["pin"].items()]
        self.root = tempfile.mkdtemp(prefix="rtbench_tiers_")
        self.reg = make_wsi_storage(side * size, side * size, mode=st["mode"],
                                    transport=st["transport"], tile=size, root=self.root,
                                    mem_capacity_bytes=st["mem_capacity_bytes"],
                                    write_policy=st["write_policy"],
                                    policy=PlacementPolicy(rules))
        self.sched = SchedulerConfig(policy=c["worker"]["policy"],
                                     data_locality=sc["data_locality"],
                                     transfer_impact=sc["transfer_impact"],
                                     locality_fn=self.locality,
                                     tier_bandwidth=dict(sc["tier_bandwidth"]))
        self.make_inputs()
        self.rgb_key = RegionTemplate("Patient").new_region("RGB", self.dom3, np.float32).key
        with self.phase("slide_s"):
            dms3 = self.reg.get("DMS3")
            for k, (part3, _) in enumerate(self.boxes):
                dms3.put(self.rgb_key, part3, self.pool[k])
        self.images = itertools.cycle(self.order)
        with self.phase("warm_s"):
            for _ in range(t["warm_images"]):
                self.image()

    def locality(self, key):
        """The tier that holds ``key`` in either store: the scheduler's
        ``locality_fn``."""
        for name in STORES:
            tier = self.reg.get(name).locality(key)
            if tier is not None:
                return tier
        return None

    def image(self) -> list[tuple[int, dict]]:
        from repro_torch.core import Intent, RegionTemplate
        from repro_torch.pipeline import FeatureStage, SegmentationStage
        from repro_torch.runtime import SysEnv

        w = self.ctx.config["worker"]
        ks = [next(self.images) for _ in range(self.n)]
        rt = RegionTemplate("Patient")
        rt.new_region("RGB", self.dom3, np.float32, input_storage="DMS3", lazy=True)
        dms2 = self.reg.get("DMS2")
        env = SysEnv(num_workers=w["workers"], cpus_per_worker=w["cpus"],
                     accels_per_worker=w["accels"], max_active=w["max_active"],
                     sched=self.sched, registry=self.reg)
        try:
            stages = []
            for k in ks:
                part3, part2 = self.boxes[k]
                seg = SegmentationStage(self.cfg, device=self.ctx.device)
                seg.add_region_template(rt, "RGB", part3, Intent.INPUT, read_storage="DMS3")
                seg.add_region_template(rt, "Mask", part2, Intent.OUTPUT, storage="DMS2")
                seg.add_region_template(rt, "Hema", part2, Intent.OUTPUT, storage="DMS2")
                feat = FeatureStage(self.cfg, device=self.ctx.device)
                feat.add_region_template(rt, "Mask", part2, Intent.INPUT, read_storage="DMS2")
                feat.add_region_template(rt, "Hema", part2, Intent.INPUT, read_storage="DMS2")
                feat.add_dependency(seg)
                env.execute_component(seg)
                env.execute_component(feat)
                stages.append((seg, feat))
            env.startup_execution()  # raises if a stage failed for good
            out = []
            for k, (seg, feat) in zip(ks, stages):
                self.mask_key = seg.templates["Patient"].get("Mask").key
                objs = feat.templates["Patient"].get("Features").data
                out.append((k, {"labels": dms2.get(self.mask_key, self.boxes[k][1]),
                                "boxes": objs["boxes"], "features": objs["features"]}))
            return out
        finally:
            env.finalize_system()

    def run(self, seconds: float):
        def unit() -> None:
            for k, answer in self.image():
                self.keep(k, answer)

        closed_loop(seconds, unit, self.tally, units=self.n)
        return self.tally

    def counters(self) -> dict:
        """Each store's counters (``TieredStore.counters``: the tiers' hits,
        misses, bytes in and out, promotions, demotions, DISK's bytes read
        and written), prefixed by the store's name; none from a program
        without them."""
        out = {}
        for name in STORES:
            snapshot = getattr(self.reg.get(name), "counters", None)
            if callable(snapshot):
                out.update({f"{name}.{k}": v for k, v in snapshot().items()})
        return out

    def install(self, tracer) -> None:
        from repro_torch.kernels import ops

        tracer.wrap_ops(ops)
        for name in STORES:
            store = self.reg.get(name)
            tracer.wrap(store, "get", "store.get")
            tracer.wrap(store, "put", "store.put")

    def _read_acknowledged(self) -> dict:
        """The two numbers of what the run acknowledged, over the sampled
        tiles; a copy that a tier no longer holds reads as all differing."""
        disk = {t.name: t.backend for t in self.reg.get("DMS3").tiers}["DISK"]
        tiers2 = {t.name: t.backend for t in self.reg.get("DMS2").tiers}
        rgb = [0, 0]
        mask = [0, 0]
        for k in sorted({k for k, _ in self.sample.items}):
            part3, part2 = self.boxes[k]
            rgb[0] += _off(disk.get(self.rgb_key, part3), self.pool[k])
            rgb[1] += self.pool[k].size
            try:
                mine = tiers2["MEM"].get(self.mask_key, part2)
            except KeyError:
                mine = None
            durable = tiers2["DMS"].get(self.mask_key, part2)
            mask[0] += durable.size if mine is None else _off(mine, durable)
            mask[1] += durable.size
        return {"disk_rgb_off_share": rgb[0] / max(rgb[1], 1),
                "mem_mask_off_share": mask[0] / max(mask[1], 1)}

    def release(self) -> None:
        try:
            if self.reg is not None and self.sample.items:
                self.acknowledged = self._read_acknowledged()
        finally:
            if self.reg is not None:
                for name in STORES:
                    self.reg.get(name).close()
                self.reg = None
            if self.root is not None:
                shutil.rmtree(self.root, ignore_errors=True)
                self.root = None
            super().release()

    def check(self, device) -> dict:
        return {**super().check(device), **self.acknowledged}

    def control(self, device, dtype) -> dict:
        """The reference in ``dtype`` in the program's place, and the stores'
        two numbers with the tile and its labels held in ``dtype``."""
        wsi = self.ctx.config["wsi"]
        readings = []
        rgb = [0, 0]
        mask = [0, 0]
        for k in self.order[: self.ctx.traffic["check_tiles"]]:
            want = reference.analyze(self.pool[k], wsi, device)
            got = reference.analyze(self.pool[k], wsi, device, dtype)
            readings.append(compare.tile_numbers(got, want))
            labels = np.asarray(want["labels"])
            rgb[0] += _off(_held_in(self.pool[k], dtype), self.pool[k])
            rgb[1] += self.pool[k].size
            mask[0] += _off(_held_in(labels, dtype), labels)
            mask[1] += labels.size
        return {**compare.worst(readings), "disk_rgb_off_share": rgb[0] / max(rgb[1], 1),
                "mem_mask_off_share": mask[0] / max(mask[1], 1)}
