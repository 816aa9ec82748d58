"""Form ``plain``: one tile at a time through ``pipeline/wsi.py::analyze_tile``,
host numpy RGB in, labels, boxes and features taken to the host: the
paper's non-RT baseline (Fig. 11), numpy to numpy."""
from __future__ import annotations

import itertools

from rtbench.forms import TileForm, closed_loop


class Form(TileForm):
    def setup(self) -> None:
        from repro_torch.configs.wsi import WSIConfig
        from repro_torch.pipeline import wsi

        self.wsi = wsi
        self.cfg = WSIConfig(**self.ctx.config["wsi"])
        self.make_inputs()
        with self.phase("warm_s"):
            for rgb in self.pool[: self.ctx.traffic["warm_tiles"]]:
                self.analyze(rgb)

    def analyze(self, rgb) -> dict:
        out = self.wsi.analyze_tile(rgb, self.cfg, device=self.ctx.device)
        return {"labels": out["labels"].cpu().numpy(), "boxes": out["boxes"].cpu().numpy(),
                "features": out["features"].cpu().numpy()}

    def run(self, seconds: float):
        order = itertools.cycle(self.order)

        def unit() -> None:
            k = next(order)
            self.keep(k, self.analyze(self.pool[k]))

        closed_loop(seconds, unit, self.tally)
        return self.tally

    def install(self, tracer) -> None:
        from repro_torch.kernels import ops

        tracer.wrap_ops(ops)
        tracer.wrap(self.wsi, "segment_tile", "segment_tile", sync=True)
        tracer.wrap(self.wsi, "extract_object_rois", "extract_object_rois", sync=True)
