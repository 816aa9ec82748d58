"""Quickstart: region templates in 60 lines.

Creates a region template over a synthetic slide, stages it into the
distributed memory storage (DMS), runs the paper's segmentation ->
feature-computation dataflow over 4 partitions on the Manager/Worker
runtime with PATS scheduling, and reads the results back.

The PyTorch/CUDA port's form of ``examples/quickstart.py``: the stages
run on the CUDA card unless ``--device cpu`` asks for the CPU.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs.wsi import WSIConfig
from repro_torch.core import BoundingBox, Intent, RegionTemplate, StorageRegistry
from repro_torch.pipeline import FeatureStage, SegmentationStage, make_slide
from repro_torch.runtime import SchedulerConfig, SysEnv
from repro_torch.storage import DistributedMemoryStorage


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    device = ap.parse_args(argv).device
    tile = 96
    rgb, _ = make_slide(2, 2, tile, seed=0)  # (3, 192, 192) synthetic WSI
    h, w = rgb.shape[1:]
    cfg = WSIConfig(seg_threshold=0.5, nucleus_roi=16)

    # --- storage backends (the paper's "global data storage") ---
    registry = StorageRegistry()
    dom3 = BoundingBox((0, 0, 0), (3, h, w))
    dom2 = BoundingBox((0, 0), (h, w))
    dms3 = registry.register(DistributedMemoryStorage(dom3, (3, tile, tile), 4, name="DMS3"))
    dms2 = registry.register(DistributedMemoryStorage(dom2, (tile, tile), 4, name="DMS2"))

    # --- a region template holding the input image ---
    rt = RegionTemplate("Patient")
    rgb_region = rt.new_region("RGB", dom3, np.float32, input_storage="DMS3", lazy=True)
    dms3.put(rgb_region.key, dom3, rgb)

    # --- the two-stage analysis dataflow over 4 partitions ---
    env = SysEnv(num_workers=2, cpus_per_worker=2, accels_per_worker=1,
                 sched=SchedulerConfig(policy="PATS", data_locality=True),
                 registry=registry)
    feats = []
    for part2 in dom2.tiles((tile, tile)):
        part3 = BoundingBox((0,) + part2.lo, (3,) + part2.hi)
        seg = SegmentationStage(cfg, device=device)
        seg.add_region_template(rt, "RGB", part3, Intent.INPUT, read_storage="DMS3")
        seg.add_region_template(rt, "Mask", part2, Intent.OUTPUT, storage="DMS2")
        seg.add_region_template(rt, "Hema", part2, Intent.OUTPUT, storage="DMS2")
        feat = FeatureStage(cfg, device=device)
        feat.add_region_template(rt, "Mask", part2, Intent.INPUT, read_storage="DMS2")
        feat.add_region_template(rt, "Hema", part2, Intent.INPUT, read_storage="DMS2")
        feat.add_dependency(seg)
        env.execute_component(seg)
        env.execute_component(feat)
        feats.append(feat)
    env.startup_execution()
    env.finalize_system()

    mask_key = feats[0].templates["Patient"].get("Mask").key
    mask = dms2.get(mask_key, dom2)
    objects = sum(f.templates["Patient"].get("Features").num_objects for f in feats)
    print(f"segmented {objects} nuclei over a {h}x{w} slide "
          f"({(mask >= 0).mean():.1%} foreground)")
    print(f"DMS moved {dms2.transport.stats.bytes_put/1e6:.1f} MB of masks between stages")


if __name__ == "__main__":
    main()
