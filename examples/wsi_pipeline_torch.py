"""The paper's full scenario at demo scale: a multi-tile slide analyzed by
the hierarchical dataflow with PATS + DL + prefetch, masks persisted to
the DISK store (I/O groups) for downstream analysis, and a fault injected
mid-run to show checkpoint-free recovery via stage re-execution.

  PYTHONPATH=src python examples/wsi_pipeline_torch.py [dms|tiered] [inproc|socket|shm] \
      [--device cpu]

The PyTorch/CUDA port's form of ``examples/wsi_pipeline.py``: the stages
run on the CUDA card (the hand-written kernels) unless ``--device cpu``
asks for the plain versions on the CPU.  Passing ``tiered`` swaps the
flat DMS backends for TieredStore stacks (bounded RAM -> DISK -> DMS)
under the same names — the stage wiring below does not change at all.
Passing ``socket`` additionally puts the DMS servers in real subprocesses
behind the TCP transport, and ``shm`` adds the shared-memory data plane
(co-located fetches by arena reference) — again with zero wiring changes.
"""
import argparse
import shutil
import tempfile
import threading
import time

import numpy as np

from repro_torch.configs.wsi import WSIConfig
from repro_torch.core import BoundingBox, Intent, RegionTemplate
from repro_torch.pipeline import FeatureStage, SegmentationStage, make_slide, make_wsi_storage
from repro_torch.runtime import SchedulerConfig, SysEnv
from repro_torch.storage import DiskStorage


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", nargs="?", default="dms", choices=("dms", "tiered"))
    ap.add_argument("transport", nargs="?", default="inproc",
                    choices=("inproc", "socket", "shm"))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    mode, transport = args.mode, args.transport
    tile = 96
    ty = tx = 3
    rgb, _ = make_slide(ty, tx, tile, seed=7)
    h, w = rgb.shape[1:]
    cfg = WSIConfig(seg_threshold=0.5, nucleus_roi=16)
    tmp = tempfile.mkdtemp(prefix="wsi_disk_")
    tiers_root = tempfile.mkdtemp(prefix="wsi_tiers_")  # owned + cleaned here

    registry = make_wsi_storage(h, w, mode=mode, transport=transport,
                                tile=tile, root=tiers_root)
    if transport != "inproc":
        print(f"DMS servers: {len(registry.server_group.procs)} processes, "
              f"endpoints {registry.server_group.endpoints}")
    dom3 = BoundingBox((0, 0, 0), (3, h, w))
    dom2 = BoundingBox((0, 0), (h, w))
    dms3 = registry.get("DMS3")
    dms2 = registry.get("DMS2")
    disk = registry.register(DiskStorage(tmp, transport="aggregated", io_group_size=2,
                                         queue_threshold=4, name="DISK"))

    rt = RegionTemplate("Patient")
    rgb_region = rt.new_region("RGB", dom3, np.float32, input_storage="DMS3", lazy=True)
    dms3.put(rgb_region.key, dom3, rgb)

    def tier_locality(key):
        """region key -> tier name, across both tiered stacks."""
        for name in ("DMS3", "DMS2"):
            loc = getattr(registry.get(name), "locality", None)
            if callable(loc):
                tier = loc(key)
                if tier is not None:
                    return tier
        return None

    sched = SchedulerConfig(policy="PATS", data_locality=True, transfer_impact=0.3,
                            locality_fn=tier_locality if mode == "tiered" else None)
    env = SysEnv(num_workers=3, cpus_per_worker=2, accels_per_worker=1,
                 sched=sched, registry=registry, heartbeat_timeout=10.0)
    feats = []
    t0 = time.time()
    for part2 in dom2.tiles((tile, tile)):
        part3 = BoundingBox((0,) + part2.lo, (3,) + part2.hi)
        seg = SegmentationStage(cfg, device=args.device)
        seg.add_region_template(rt, "RGB", part3, Intent.INPUT, read_storage="DMS3")
        seg.add_region_template(rt, "Mask", part2, Intent.OUTPUT, storage="DMS2")
        seg.add_region_template(rt, "Hema", part2, Intent.OUTPUT, storage="DMS2")
        feat = FeatureStage(cfg, device=args.device)
        feat.add_region_template(rt, "Mask", part2, Intent.INPUT, read_storage="DMS2")
        feat.add_region_template(rt, "Hema", part2, Intent.INPUT, read_storage="DMS2")
        feat.add_dependency(seg)
        env.execute_component(seg)
        env.execute_component(feat)
        feats.append(feat)

    # inject a node failure shortly after start: the Manager requeues its
    # in-flight stages (outputs are idempotent — last staged wins)
    def killer():
        time.sleep(0.5)
        env.workers[0].kill()
        print("!! worker 0 killed mid-run (simulated node failure)")

    threading.Thread(target=killer, daemon=True).start()
    env.startup_execution()
    wall = time.time() - t0

    mask_key = feats[0].templates["Patient"].get("Mask").key
    mask = dms2.get(mask_key, dom2)
    objects = sum(f.templates["Patient"].get("Features").num_objects for f in feats)
    # persist masks for downstream analysis (paper: DISK staging)
    disk.put(mask_key, dom2, mask)
    disk.flush()
    env.finalize_system()

    requeues = sum(1 for ev, _ in env.manager.events if ev == "requeue")
    print(f"analyzed {ty*tx} tiles ({h}x{w}) in {wall:.1f}s despite a node "
          f"failure ({requeues} stage(s) requeued)")
    print(f"{objects} nuclei; masks persisted to DISK "
          f"({disk.stats.files_written} files, {disk.stats.bytes_written/1e6:.1f} MB)")
    if mode == "tiered":
        dms2.drain()
        for name in ("DMS3", "DMS2"):
            store = registry.get(name)
            mem = store.tier_stats()["MEM"]
            print(f"[{name}] MEM hit_rate={mem.hit_rate:.2f} "
                  f"promotions={mem.promotions} demotions={mem.demotions}")
            store.close()
    elif transport != "inproc":
        for name in ("DMS3", "DMS2"):
            registry.get(name).close()
    group = getattr(registry, "server_group", None)
    if group is not None:
        group.close()
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(tiers_root, ignore_errors=True)


if __name__ == "__main__":
    main()
