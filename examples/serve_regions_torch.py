"""Region-serving gateway demo: many clients hammering one tiered store.

Builds the paper-shaped hierarchy (bounded RAM -> DISK -> DMS), stages a
synthetic slide into it, then runs two rounds of multi-threaded clients
reading overlapping ROI windows:

  1. naive   — every client calls the store directly (per-client reads);
  2. gateway — the same read mix through a ``RegionGateway`` (bounded
     queue, coalesced windows, one scatter-gather fetch per window).

Prints bit-exactness, the DMS transport round-trip counts for both
rounds, the gateway's coalescing/admission stats, and a load-shedding
demonstration against a deliberately tiny admission queue.

A final round demonstrates near-data compute: a ``deconv|threshold``
kernel chain runs *server-side* via ``gateway.compute()`` over an RGB
store, so only the uint8 segmentation mask crosses back to the client —
the example prints raw-vs-derived egress bytes and the cached-repeat
timing.

  PYTHONPATH=src python examples/serve_regions_torch.py [--device cpu]
  PYTHONPATH=src python examples/serve_regions_torch.py --clients 16 --reads 40

The PyTorch/CUDA port's form of ``examples/serve_regions.py``: the gateways
run their kernel chains on the CUDA card (the hand-written kernels) unless
``--device cpu`` asks for the plain versions on the CPU.
"""
import argparse
import os
import shutil
import tempfile
import threading
import time

import numpy as np

from repro_torch.core import BoundingBox, ElementType, RegionKey
from repro_torch.serve.gateway import GatewayConfig, Overloaded, RegionGateway
from repro_torch.storage import DistributedMemoryStorage, Tier, TieredStore

SIDE = 1024
TILE = 128
WINDOW = 160  # client read window (overlaps tile grid + neighbours)


def build_store(root: str) -> TieredStore:
    dom = BoundingBox((0, 0), (SIDE, SIDE))
    store = TieredStore.standard(
        dom,
        (TILE, TILE),
        root=root,
        mem_capacity_bytes=2 * TILE * TILE * 4,  # tiny RAM tier: real churn
        num_servers=4,
    )
    return store


def stage_slide(store: TieredStore, key: RegionKey) -> np.ndarray:
    rng = np.random.default_rng(0)
    slide = rng.random((SIDE, SIDE)).astype(np.float32)
    dom = BoundingBox((0, 0), (SIDE, SIDE))
    for tile in dom.tiles((TILE, TILE)):
        store.put(key, tile, slide[tile.slices()])
    store.drain()  # everything reaches the DMS tier
    return slide


def client_rois(clients: int, reads: int) -> list[list[BoundingBox]]:
    """Per-client read mixes with heavy cross-client overlap (a hot band
    of the slide plus a private scatter)."""
    rng = np.random.default_rng(1)
    mixes = []
    for c in range(clients):
        rois = []
        for r in range(reads):
            if r % 2 == 0:  # hot band shared by everyone
                y = (r * 32) % (SIDE - WINDOW)
                x = 64
            else:  # private scatter
                y = int(rng.integers(0, SIDE - WINDOW))
                x = int(rng.integers(0, SIDE - WINDOW))
            rois.append(BoundingBox((y, x), (y + WINDOW, x + WINDOW)))
        mixes.append(rois)
    return mixes


def dms_round_trips(store: TieredStore) -> int:
    stats = store.tiers[-1].backend.transport.stats
    return stats.gets + stats.meta_msgs


def run_round(read_fn, mixes, slide) -> float:
    errors: list[Exception] = []

    def client(rois):
        try:
            for roi in rois:
                got = read_fn(roi)
                if not np.array_equal(got, slide[roi.slices()]):
                    raise AssertionError(f"mismatch at {roi}")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(m,)) for m in mixes]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--reads", type=int, default=20, help="ROI reads per client")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    root = tempfile.mkdtemp(prefix="serve_regions_")
    key = RegionKey("slide", "RGB", ElementType.FLOAT32)
    try:
        store = build_store(os.path.join(root, "tiers"))
        slide = stage_slide(store, key)
        mixes = client_rois(args.clients, args.reads)
        total = args.clients * args.reads

        transport = store.tiers[-1].backend.transport
        transport.reset()
        naive_wall = run_round(lambda roi: store.get(key, roi), mixes, slide)
        naive_rtts = dms_round_trips(store)

        gw = RegionGateway(
            store,
            config=GatewayConfig(workers=args.workers, batch_window=64),
            device=args.device,
        )
        transport.reset()
        gw_wall = run_round(lambda roi: gw.get(key, roi), mixes, slide)
        gw_rtts = dms_round_trips(store)

        s = gw.stats
        print(f"clients={args.clients} reads/client={args.reads} "
              f"window={WINDOW}x{WINDOW} slide={SIDE}x{SIDE}")
        print(f"naive   : {naive_wall:.2f}s  {naive_rtts} DMS round-trips")
        print(f"gateway : {gw_wall:.2f}s  {gw_rtts} DMS round-trips "
              f"({naive_rtts / max(gw_rtts, 1):.1f}x fewer)")
        print(f"gateway stats: {s.served}/{total} served, "
              f"{s.windows} windows for {s.requests} requests "
              f"({s.coalesced} coalesced), queue peak {s.queue_peak}")

        # load shedding: a tiny queue + paused workers -> Overloaded, fast
        gw.pause()
        small = RegionGateway(
            store,
            name="TINY",
            config=GatewayConfig(workers=1, max_queue=4, admit_timeout=0.2),
            device=args.device,
        )
        small.pause()
        rejected = 0
        for i in range(12):
            try:
                small.submit(key, BoundingBox((0, 0), (TILE, TILE)))
            except Overloaded:
                rejected += 1
        print(f"admission control: {rejected}/12 burst requests shed "
              f"(queue bound 4, bounded wait 0.2s) — no deadlock")
        small.resume()
        small.close(close_store=False)
        gw.resume()
        gw.close()  # closes the tiered store too

        # -- near-data compute: deconv+segment server-side ------------------
        rgb_side = 512
        rgb_dom = BoundingBox((0, 0, 0), (3, rgb_side, rgb_side))
        rgb_dms = DistributedMemoryStorage(rgb_dom, (3, TILE, TILE), 4)
        rgb_store = TieredStore([Tier("DMS", rgb_dms)], name="RGB")
        rgb_key = RegionKey("slide", "HE", ElementType.FLOAT32)
        rng = np.random.default_rng(2)
        rgb = rng.random((3, rgb_side, rgb_side)).astype(np.float32)
        for tile in rgb_dom.tiles((3, TILE, TILE)):
            rgb_store.put(rgb_key, tile, rgb[tile.slices()])
        cgw = RegionGateway(rgb_store, config=GatewayConfig(workers=args.workers),
                            device=args.device)
        roi = BoundingBox((0, 0, 0), (3, rgb_side, rgb_side))
        raw_bytes = rgb[roi.slices()].nbytes

        t0 = time.perf_counter()
        mask = cgw.compute(rgb_key, roi, "deconv|threshold")
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = cgw.compute(rgb_key, roi, "deconv|threshold")
        warm = time.perf_counter() - t0
        assert np.array_equal(mask, again) and mask.dtype == np.uint8

        cs = cgw.storage_stats()["compute"]
        row = cs["chains"]["deconv|threshold"]
        print(f"near-data compute: deconv|threshold over {roi.shape} ROI")
        print(f"  raw read would move {raw_bytes:,} B; derived mask is "
              f"{mask.nbytes:,} B ({raw_bytes / mask.nbytes:.0f}x less egress)")
        print(f"  cold {cold * 1e3:.0f}ms, cached repeat {warm * 1e3:.1f}ms "
              f"({cs['cache']['hits']} cache hit); server fetched "
              f"{row['raw_bytes']:,} B, returned {row['derived_bytes']:,} B")
        cgw.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
