"""The port's region-serving gateway (``repro_torch.serve.gateway``) on the
CPU: the cases of ``tests/test_gateway.py`` — bit-exactness under
concurrency, coalescing (asserted via transport frame counts), TierStats
admission control, clean shutdown, and the make_wsi_storage(serve=...)
wiring, with every gateway on ``device="cpu"``; then one coalesced burst
through the JAX package's gateway and the port's, frame for frame."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import BoundingBox, ElementType, RegionKey
from repro_torch.serve.gateway import (
    GatewayClosed,
    GatewayConfig,
    Overloaded,
    RegionGateway,
)
from repro_torch.storage import (
    DistributedMemoryStorage,
    MemoryTier,
    Tier,
    TieredStore,
    TransportError,
)

DOM = BoundingBox((0, 0), (128, 128))
TILE = 32
TILE_BYTES = TILE * TILE * 4


def _key(name="Slide", ts=0):
    return RegionKey("g", name, ElementType.FLOAT32, ts)


def _dms_store() -> tuple[TieredStore, np.ndarray]:
    """Single DMS tier (every read pays the transport) + a staged slide."""
    dms = DistributedMemoryStorage(DOM, (TILE, TILE), 4)
    store = TieredStore([Tier("DMS", dms)], name="GWT")
    slide = np.random.default_rng(0).random((128, 128)).astype(np.float32)
    for tile in DOM.tiles((TILE, TILE)):
        store.put(_key(), tile, slide[tile.slices()])
    return store, slide


def test_concurrent_clients_bit_exact_vs_direct_reads():
    store, slide = _dms_store()
    gw = RegionGateway(store, config=GatewayConfig(workers=3), device="cpu")
    rois = [
        BoundingBox((y, x), (min(y + 48, 128), min(x + 48, 128)))
        for y in range(0, 112, 16)
        for x in range(0, 112, 16)
    ]
    errors = []

    def client(sub):
        try:
            for roi in sub:
                got = gw.get(_key(), roi)
                want = store.get(_key(), roi)  # direct, bypassing the gateway
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(got, slide[roi.slices()])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(rois[i::6],)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert gw.stats.served == gw.stats.requests > 0
    gw.close()


def test_coalescing_merges_overlapping_rois_fewer_transport_frames():
    store, slide = _dms_store()
    transport = store.tiers[0].backend.transport
    # an overlapping horizontal band: 7 reads, stride 16, window 32
    rois = [BoundingBox((0, x), (32, x + 32)) for x in range(0, 97, 16)]

    transport.reset()
    naive = [store.get(_key(), roi) for roi in rois]
    naive_frames = transport.stats.gets + transport.stats.meta_msgs

    gw = RegionGateway(store, config=GatewayConfig(workers=2, batch_window=16), device="cpu")
    gw.pause()  # queue the whole burst so one drain serves it
    tickets = [gw.submit(_key(), roi) for roi in rois]
    transport.reset()
    gw.resume()
    outs = [t.result(30.0) for t in tickets]
    gw_frames = transport.stats.gets + transport.stats.meta_msgs

    for roi, out, base in zip(rois, outs, naive):
        np.testing.assert_array_equal(out, base)
        np.testing.assert_array_equal(out, slide[roi.slices()])
    # the band merges into one window -> one store read instead of seven
    assert gw_frames < naive_frames, (gw_frames, naive_frames)
    assert gw.stats.windows < len(rois)
    assert gw.stats.coalesced >= len(rois)
    assert gw.stats.window_fallbacks == 0
    gw.close()


def test_duplicate_rois_dedup_into_one_window():
    store, slide = _dms_store()
    gw = RegionGateway(store, config=GatewayConfig(workers=1), device="cpu")
    roi = BoundingBox((16, 16), (64, 64))
    gw.pause()
    tickets = [gw.submit(_key(), roi) for _ in range(5)]
    gw.resume()
    outs = [t.result(30.0) for t in tickets]
    for out in outs:
        np.testing.assert_array_equal(out, slide[roi.slices()])
    # callers never alias the shared window payload (or each other)
    assert not any(np.shares_memory(a, b) for a in outs for b in outs if a is not b)
    assert gw.stats.windows == 1 and gw.stats.coalesced == 5
    gw.close()


def test_cancelled_ticket_does_not_poison_the_batch():
    """A client cancelling its queued ticket must not fail other
    requests drained into the same batch."""
    store, slide = _dms_store()
    gw = RegionGateway(store, config=GatewayConfig(workers=1), device="cpu")
    far_a = BoundingBox((0, 0), (16, 16))
    far_b = BoundingBox((96, 96), (128, 128))  # too far to coalesce
    gw.pause()
    doomed = gw.submit(_key(), far_a)
    kept = gw.submit(_key(), far_b)
    assert doomed.cancel()
    gw.resume()
    np.testing.assert_array_equal(kept.result(30.0), slide[far_b.slices()])
    assert gw.stats.served == 1
    gw.close()


def test_duplicate_rois_do_not_inflate_the_waste_budget():
    """The waste bound counts distinct requested cells: duplicated ROIs
    must not let diagonally-touching windows merge into one oversized
    (and hole-doomed) fetch."""
    store, slide = _dms_store()
    a = BoundingBox((0, 0), (32, 32))
    b = BoundingBox((32, 32), (64, 128))  # touches a only at one corner
    gw = RegionGateway(store, config=GatewayConfig(workers=1), device="cpu")
    gw.pause()
    tickets = [gw.submit(_key(), a) for _ in range(4)] + [gw.submit(_key(), b)]
    gw.resume()
    for t in tickets:
        np.testing.assert_array_equal(t.result(30.0), slide[t.roi.slices()])
    # one window for the 4 duplicates of a, one for b — never a merged
    # (0,0)-(64,128) window that is 2x the requested cells
    assert gw.stats.windows == 2
    assert gw.stats.window_fallbacks == 0
    gw.close()


def test_window_hole_falls_back_to_per_request_reads():
    """Two touching ROIs merge into a window whose corners were never
    written; the window fetch fails with KeyError and the gateway must
    degrade to per-request reads, still bit-exact."""
    dms = DistributedMemoryStorage(DOM, (TILE, TILE), 4)
    store = TieredStore([Tier("DMS", dms)], name="HOLE")
    rng = np.random.default_rng(1)
    a_box = BoundingBox((0, 0), (32, 32))
    b_box = BoundingBox((32, 16), (64, 48))
    a = rng.random((32, 32)).astype(np.float32)
    b = rng.random((32, 32)).astype(np.float32)
    store.put(_key("holey"), a_box, a)
    store.put(_key("holey"), b_box, b)

    gw = RegionGateway(store, config=GatewayConfig(workers=1), device="cpu")
    gw.pause()
    ta = gw.submit(_key("holey"), a_box)
    tb = gw.submit(_key("holey"), b_box)
    gw.resume()
    np.testing.assert_array_equal(ta.result(30.0), a)
    np.testing.assert_array_equal(tb.result(30.0), b)
    assert gw.stats.window_fallbacks == 1
    assert gw.stats.served == 2
    gw.close()


def test_timed_out_get_abandons_ticket():
    """A get() that times out must cancel its ticket — the worker then
    skips it instead of fetching a window for a caller that gave up and
    counting the orphan as served."""
    store, _ = _dms_store()
    gw = RegionGateway(
        store, config=GatewayConfig(workers=1, request_timeout=0.15),
        device="cpu"
    )
    gw.pause()  # the ticket stays queued past the request timeout
    with pytest.raises(TimeoutError):
        gw.get(_key(), BoundingBox((0, 0), (TILE, TILE)))
    assert gw.stats.abandoned == 1
    gw.resume()
    deadline = time.monotonic() + 10.0
    while gw.queue_depth() > 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert gw.queue_depth() == 0
    assert gw.stats.served == 0  # the abandoned ticket was never "served"
    gw.close()


class _PartialOutageStore:
    """StorageBackend where only one ROI survives a transport outage —
    the shape of a TieredStore whose RAM tier still holds some members
    while the DMS tier is down (gateway TransportError-path fixture)."""

    name = "OUTAGESTORE"

    def __init__(self, alive_roi, payload) -> None:
        self.alive_roi = alive_roi
        self.payload = payload
        self.gets = 0

    def get(self, key, roi):
        self.gets += 1
        if roi == self.alive_roi:
            return self.payload.copy()  # e.g. served from the RAM tier
        raise TransportError("every replica down")

    def put(self, key, bb, array) -> None:
        pass

    def query(self, namespace, name):
        return []

    def delete(self, key) -> None:
        pass


def test_window_transport_error_degrades_per_request():
    """A TransportError on the merged window is an infrastructure
    failure (counted under window_failures, not window_fallbacks) but
    still degrades to per-request reads: a member whose ROI an upper
    tier can serve succeeds, the others fail with the real error."""
    a = BoundingBox((0, 0), (32, 32))
    b = BoundingBox((0, 16), (32, 48))  # overlaps a -> one merged window
    alive = np.full((32, 32), 3.0, np.float32)
    store = _PartialOutageStore(a, alive)
    gw = RegionGateway(store, config=GatewayConfig(workers=1), device="cpu")
    gw.pause()
    ta = gw.submit(_key(), a)
    tb = gw.submit(_key(), b)
    gw.resume()
    np.testing.assert_array_equal(ta.result(30.0), alive)  # survived outage
    with pytest.raises(TransportError, match="every replica down"):
        tb.result(30.0)
    assert store.gets == 3  # 1 failed window + 2 per-request reads
    assert gw.stats.window_failures == 1
    assert gw.stats.window_fallbacks == 0
    assert gw.stats.served == 1 and gw.stats.failed == 1
    gw.close(close_store=False)


def test_admission_rejects_under_tiny_ram_tier_pressure():
    """A full bounded RAM tier shrinks the admission queue and turns the
    bounded wait into immediate load shedding."""
    dms = DistributedMemoryStorage(DOM, (TILE, TILE), 4)
    store = TieredStore(
        [Tier("MEM", MemoryTier(), TILE_BYTES), Tier("DMS", dms)],
        name="TINY",
    )
    tile0 = BoundingBox((0, 0), (TILE, TILE))
    payload = np.ones((TILE, TILE), np.float32)
    store.put(_key("hot"), tile0, payload)  # MEM now exactly at capacity
    gw = RegionGateway(
        store,
        config=GatewayConfig(
            workers=1, max_queue=8, shed_queue_factor=0.25, admit_timeout=10.0
        ),
        device="cpu",
    )
    assert gw.pressure() == pytest.approx(1.0)
    gw.pause()
    admitted = [gw.submit(_key("hot"), tile0) for _ in range(2)]  # 8 * 0.25
    t0 = time.monotonic()
    with pytest.raises(Overloaded, match="shedding"):
        gw.submit(_key("hot"), tile0)
    # shedding is immediate, not a 10s bounded wait (never deadlocks)
    assert time.monotonic() - t0 < 2.0
    assert gw.stats.rejected == 1
    gw.resume()
    for t in admitted:
        np.testing.assert_array_equal(t.result(30.0), payload)
    gw.close()


def test_admission_bounded_wait_then_rejects_without_pressure():
    store, _ = _dms_store()
    gw = RegionGateway(
        store, config=GatewayConfig(workers=1, max_queue=2, admit_timeout=0.2),
        device="cpu"
    )
    assert gw.pressure() == 0.0  # single unbounded tier: no RAM signal
    gw.pause()
    roi = BoundingBox((0, 0), (TILE, TILE))
    admitted = [gw.submit(_key(), roi) for _ in range(2)]
    t0 = time.monotonic()
    with pytest.raises(Overloaded, match="bounded wait"):
        gw.submit(_key(), roi)
    waited = time.monotonic() - t0
    assert 0.15 <= waited < 5.0  # waited for the slot, then shed
    gw.resume()
    for t in admitted:
        assert t.result(30.0) is not None
    gw.close()


def test_clean_shutdown_completes_inflight_requests():
    store, slide = _dms_store()
    gw = RegionGateway(store, config=GatewayConfig(workers=2), device="cpu")
    roi = BoundingBox((0, 0), (64, 64))
    gw.pause()  # pile up in-flight work, then close while it is queued
    tickets = [gw.submit(_key(), roi) for _ in range(6)]
    closer = threading.Thread(target=gw.close)
    closer.start()
    for t in tickets:
        np.testing.assert_array_equal(t.result(30.0), slide[roi.slices()])
    closer.join(timeout=30)
    assert not closer.is_alive()
    with pytest.raises(GatewayClosed):
        gw.submit(_key(), roi)
    assert gw.stats.served == 6


def test_gateway_is_a_transparent_storage_backend():
    """StorageBackend protocol + delegation: the gateway registers under
    the store's name and passes writes/queries/locality through."""
    store, _ = _dms_store()
    gw = RegionGateway(store, device="cpu")
    assert gw.name == store.name
    key = _key("w")
    bb = BoundingBox((0, 0), (TILE, TILE))
    arr = np.full((TILE, TILE), 7.0, np.float32)
    gw.put(key, bb, arr)
    assert [k for k, _ in gw.query("g", "w")] == [key]
    np.testing.assert_array_equal(gw.get(key, bb), arr)
    assert gw.locality(key) == "DMS"  # delegated to the TieredStore
    assert "DMS" in gw.tier_stats()
    gw.delete(key)
    assert gw.query("g", "w") == []
    gw.close()


def test_storage_stats_surfaces_dms_availability_counters():
    """Operators polling the gateway see the replica failover / repair
    activity of the DMS tier below it in one structured view."""
    store, slide = _dms_store()
    gw = RegionGateway(store, device="cpu")
    roi = BoundingBox((0, 0), (TILE, TILE))
    np.testing.assert_array_equal(gw.get(_key(), roi), slide[roi.slices()])
    stats = gw.storage_stats()
    assert stats["gateway"]["served"] >= 1
    assert "DMS" in stats["tiers"]
    dms_entry = stats["dms"]["DMS"]
    assert set(dms_entry["dms"]) >= {
        "failover_fetches",
        "balanced_fetches",
        "put_failovers",
        "put_rollbacks",
        "repaired_blocks",
    }
    assert dms_entry["transport"]["bytes_get"] > 0
    # the sweep itself is reachable through the facade too
    report = gw.store.tiers[0].backend.repair()
    assert report["lost"] == 0
    gw.close()


def test_custom_pressure_fn_overrides_tier_accounting():
    store, _ = _dms_store()
    level = {"p": 0.0}
    gw = RegionGateway(
        store,
        config=GatewayConfig(workers=1, max_queue=4, shed_queue_factor=0.25),
        pressure_fn=lambda: level["p"],
        device="cpu",
    )
    gw.pause()
    roi = BoundingBox((0, 0), (TILE, TILE))
    gw.submit(_key(), roi)
    level["p"] = 1.0  # external signal: shed everything beyond 1 slot
    with pytest.raises(Overloaded):
        gw.submit(_key(), roi)
    level["p"] = 0.0
    gw.resume()
    gw.close()


def test_make_wsi_storage_serve_wraps_stores_in_gateways():
    from repro_torch.pipeline import make_wsi_storage

    reg = make_wsi_storage(64, 64, mode="tiered", serve=True, tile=32, device="cpu")
    gw3 = reg.get("DMS3")
    assert isinstance(gw3, RegionGateway)
    assert gw3.name == "DMS3"
    key = RegionKey("t", "RGB", ElementType.FLOAT32)
    dom3 = BoundingBox((0, 0, 0), (3, 64, 64))
    rgb = np.random.default_rng(2).random((3, 64, 64)).astype(np.float32)
    gw3.put(key, dom3, rgb)
    np.testing.assert_array_equal(gw3.get(key, dom3), rgb)
    gw3.drain()  # delegated through to the tiered store
    assert not gw3.dirty(key)
    # a custom config rides through serve=
    reg2 = make_wsi_storage(
        64, 64, mode="tiered", serve=GatewayConfig(workers=1, max_queue=3), tile=32,
        device="cpu"
    )
    assert reg2.get("DMS2").config.max_queue == 3
    for r in (reg, reg2):
        for name in ("DMS3", "DMS2"):
            r.get(name).close()  # closes gateway AND the tiered store


def test_stats_snapshot_is_atomic_under_hammer():
    """as_dict() must snapshot all counters under the stats lock: with
    writers always bumping (requests, served) together via add(), every
    snapshot a reader takes must show the two counters equal — a torn
    read (pre-lock as_dict built the dict field by field) shows skew."""
    from repro_torch.serve.gateway import GatewayStats

    stats = GatewayStats()
    rounds, writers = 2000, 4
    stop = threading.Event()
    skews = []

    def writer():
        for _ in range(rounds):
            stats.add(requests=1, served=1)
            stats.peak("queue_peak", stats.as_dict()["requests"] % 97)

    def reader():
        while not stop.is_set():
            snap = stats.as_dict()
            if snap["requests"] != snap["served"]:
                skews.append(snap)

    readers = [threading.Thread(target=reader) for _ in range(2)]
    threads = [threading.Thread(target=writer) for _ in range(writers)]
    for t in readers + threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    for t in readers:
        t.join(timeout=10)
    assert not skews, skews[:3]
    final = stats.as_dict()
    assert final["requests"] == final["served"] == rounds * writers
    with pytest.raises(AttributeError):
        stats.add(not_a_counter=1)  # typo'd counter names must not pass silently


def test_coalesced_burst_equals_the_reference_gateway():
    """Duplicate, overlapping and disjoint ROIs queued while paused, then one
    drain: both packages' gateways return the same payloads from the same
    windows, in the same transport frames, with the same counters; a
    gateway without a card refuses to start unless given the CPU."""
    import repro.core as jcore
    import repro.serve as jserve
    import repro.storage as jstorage
    import repro_torch.core as tcore
    import repro_torch.serve as tserve
    import repro_torch.storage as tstorage

    slide = np.random.default_rng(5).random((128, 128)).astype(np.float32)
    boxes = [((0, 0), (40, 40)), ((0, 0), (40, 40)), ((20, 20), (60, 60)),
             ((96, 96), (128, 128)), ((33, 0), (64, 31))]
    runs = {}
    for pkg, (core, serve, storage, kw) in {
        "jax": (jcore, jserve, jstorage, {}),
        "torch": (tcore, tserve, tstorage, {"device": "cpu"}),
    }.items():
        dom = core.BoundingBox((0, 0), (128, 128))
        dms = storage.DistributedMemoryStorage(dom, (TILE, TILE), 4)
        store = storage.TieredStore([storage.Tier("DMS", dms)], name="GWT")
        key = core.RegionKey("g", "Slide", core.ElementType.FLOAT32, 0)
        for tile in dom.tiles((TILE, TILE)):
            store.put(key, tile, slide[tile.slices()])
        gw = serve.RegionGateway(store, config=serve.GatewayConfig(
            workers=1, batch_window=16, response_cache_bytes=0), **kw)
        gw.pause()
        dms.transport.reset()
        tickets = [gw.submit(key, core.BoundingBox(*b)) for b in boxes]
        gw.resume()
        out = [t.result(30) for t in tickets]
        tstats = dms.transport.stats
        runs[pkg] = (out, gw.stats.as_dict(), (tstats.gets, tstats.meta_msgs))
        gw.close()
    (t_out, t_stats, t_frames), (j_out, j_stats, j_frames) = runs["torch"], runs["jax"]
    for got, want, b in zip(t_out, j_out, boxes):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, slide[BoundingBox(*b).slices()])
    assert t_stats == j_stats and t_frames == j_frames
    assert t_stats["windows"] < len(boxes)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            RegionGateway(_dms_store()[0])
