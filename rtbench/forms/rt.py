"""Form ``rt``: the paper's region-template form. An image of
``tiles_per_image`` tiles side by side is one ``SysEnv`` execution of a
``SegmentationStage`` -> ``FeatureStage`` pair a tile (Fig. 11 groups tiles
into images). Each tile's RGB is put into "DMS3" as part of its own work;
its labels are read back from "DMS2" and its features from the "Features"
region, on the host."""
from __future__ import annotations

import itertools

import numpy as np

from rtbench.forms import TileForm, closed_loop


class Form(TileForm):
    def setup(self) -> None:
        from repro_torch.configs.wsi import WSIConfig
        from repro_torch.core import BoundingBox
        from repro_torch.pipeline import make_wsi_storage

        c, t = self.ctx.config, self.ctx.traffic
        self.cfg = WSIConfig(**c["wsi"])
        self.n = t["tiles_per_image"]
        size = self.cfg.tile
        self.reg = make_wsi_storage(size, self.n * size, mode=c["storage"]["mode"],
                                    transport=c["storage"]["transport"], tile=size)
        self.parts = [(BoundingBox((0, 0, j * size), (3, size, (j + 1) * size)),
                       BoundingBox((0, j * size), (size, (j + 1) * size)))
                      for j in range(self.n)]
        self.dom3 = BoundingBox((0, 0, 0), (3, size, self.n * size))
        self.make_inputs()
        self.images = itertools.cycle(self.order)
        with self.phase("warm_s"):
            for _ in range(t["warm_images"]):
                self.image()

    def image(self) -> list[tuple[int, dict]]:
        from repro_torch.core import Intent, RegionTemplate
        from repro_torch.pipeline import FeatureStage, SegmentationStage
        from repro_torch.runtime import SysEnv

        w = self.ctx.config["worker"]
        ks = [next(self.images) for _ in range(self.n)]
        rt = RegionTemplate("Patient")
        rgb = rt.new_region("RGB", self.dom3, np.float32, input_storage="DMS3", lazy=True)
        dms3, dms2 = self.reg.get("DMS3"), self.reg.get("DMS2")
        env = SysEnv(num_workers=w["workers"], cpus_per_worker=w["cpus"],
                     accels_per_worker=w["accels"], max_active=w["max_active"],
                     registry=self.reg)
        try:
            stages = []
            for k, (part3, part2) in zip(ks, self.parts):
                dms3.put(rgb.key, part3, self.pool[k])
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
            for k, (seg, feat), (_, part2) in zip(ks, stages, self.parts):
                key = seg.templates["Patient"].get("Mask").key
                objs = feat.templates["Patient"].get("Features").data
                out.append((k, {"labels": dms2.get(key, part2), "boxes": objs["boxes"],
                                "features": objs["features"]}))
            return out
        finally:
            env.finalize_system()

    def run(self, seconds: float):
        def unit() -> None:
            for k, answer in self.image():
                self.keep(k, answer)

        closed_loop(seconds, unit, self.tally, units=self.n)
        return self.tally

    def install(self, tracer) -> None:
        from repro_torch.kernels import ops

        tracer.wrap_ops(ops)
        for name in ("DMS3", "DMS2"):
            store = self.reg.get(name)
            tracer.wrap(store, "get", "store.get")
            tracer.wrap(store, "put", "store.put")

    def release(self) -> None:
        if getattr(self, "reg", None) is not None:
            for name in ("DMS3", "DMS2"):
                self.reg.get(name).close()
            self.reg = None
        super().release()
