"""The port's staged serving tier (``repro_torch.serve``) on the CPU: the
cases of ``tests/test_serving_tier.py`` — response-cache semantics
(generation-validated, bit-exact), fairness scheduling, per-client pacing,
write coalescing, prefetch (its pipeline on ``device="cpu"``), the merged
stats namespace, and fleet mode (N gateways over one DMS fleet with
cross-gateway invalidation); then one scripted workload through the JAX
package's gateway and the port's, answer for answer and counter for
counter."""
import threading
import time

import numpy as np
import pytest

from repro_torch.core import BoundingBox, ElementType, RegionKey
from repro_torch.serve.fair import ClientPacer, FairScheduler
from repro_torch.serve.gateway import (
    GatewayConfig,
    Overloaded,
    ReadTicket,
    RegionGateway,
)
from repro_torch.serve.rcache import GenerationTracker, ResponseCache
from repro_torch.storage import DistributedMemoryStorage, Tier, TieredStore
from repro_torch.storage.dms import InProcTransport

DOM = BoundingBox((0, 0), (128, 128))
TILE = 32


def _key(name="Slide", ts=0):
    return RegionKey("g", name, ElementType.FLOAT32, ts)


def _dms_store(transport=None) -> tuple[TieredStore, np.ndarray]:
    dms = DistributedMemoryStorage(DOM, (TILE, TILE), transport=transport)
    store = TieredStore([Tier("DMS", dms)], name="SRV")
    slide = np.random.default_rng(7).random((128, 128)).astype(np.float32)
    for tile in DOM.tiles((TILE, TILE)):
        store.put(_key(), tile, slide[tile.slices()])
    return store, slide


# -- response cache ---------------------------------------------------------------


def test_hot_read_repeats_served_from_response_cache_without_tier_fetch():
    store, slide = _dms_store()
    transport = store.tiers[0].backend.transport
    gw = RegionGateway(store, config=GatewayConfig(workers=2), device="cpu")
    roi = BoundingBox((16, 16), (64, 64))
    first = gw.get(_key(), roi)
    np.testing.assert_array_equal(first, slide[roi.slices()])
    transport.reset()
    for _ in range(5):
        repeat = gw.get(_key(), roi)
        np.testing.assert_array_equal(repeat, slide[roi.slices()])
    # the repeats cost slices of the cached window, not tier fetches
    assert transport.stats.gets == 0
    assert gw.stats.response_cache_hits == 5
    assert gw.storage_stats()["gateway"]["response_cache"]["hits"] == 5
    gw.close()


def test_sub_roi_served_from_containing_cached_window():
    store, slide = _dms_store()
    transport = store.tiers[0].backend.transport
    gw = RegionGateway(store, config=GatewayConfig(workers=1), device="cpu")
    window = BoundingBox((0, 0), (64, 64))
    gw.get(_key(), window)
    transport.reset()
    sub = BoundingBox((8, 8), (40, 40))
    got = gw.get(_key(), sub)
    np.testing.assert_array_equal(got, slide[sub.slices()])
    assert transport.stats.gets == 0
    assert gw.stats.response_cache_hits == 1
    gw.close()


def test_cached_reads_stay_bit_exact_across_gateway_put_invalidation():
    store, slide = _dms_store()
    gw = RegionGateway(store, config=GatewayConfig(workers=2), device="cpu")
    roi = BoundingBox((0, 0), (32, 32))
    np.testing.assert_array_equal(gw.get(_key(), roi), slide[roi.slices()])
    fresh = np.full((32, 32), 9.5, np.float32)
    gw.put(_key(), roi, fresh)  # facade write: invalidates + bumps gen
    got = gw.get(_key(), roi)
    np.testing.assert_array_equal(got, fresh)
    np.testing.assert_array_equal(got, store.get(_key(), roi))
    gw.close()


def test_direct_store_put_bypassing_gateway_still_invalidates():
    store, slide = _dms_store()
    gw = RegionGateway(store, config=GatewayConfig(workers=2), device="cpu")
    roi = BoundingBox((32, 0), (64, 32))
    gw.get(_key(), roi)  # fills the response cache
    fresh = np.full((32, 32), -3.0, np.float32)
    store.put(_key(), roi, fresh)  # bypasses the gateway entirely
    # TieredStore.generation moved, so the cached window is a stale miss
    got = gw.get(_key(), roi)
    np.testing.assert_array_equal(got, fresh)
    gw.close()


def test_put_then_read_generation_race_is_a_spurious_miss_never_stale():
    """An entry recorded under a pre-write generation must not be
    served after the write, even if it lands in the cache afterwards
    (the fetch raced the put)."""
    store, _ = _dms_store()
    roi = BoundingBox((0, 0), (32, 32))
    cache = ResponseCache(1 << 20)
    gens = GenerationTracker(store)
    gen_before = gens.current(_key())
    stale_payload = store.get(_key(), roi)
    store.put(_key(), roi, np.zeros((32, 32), np.float32))  # racing write
    # the racing fetch completes and fills the cache under the old gen
    cache.put((_key(), roi), gen_before, stale_payload)
    assert cache.lookup_window(_key(), roi, gens.current(_key())) is None
    assert cache.misses == 1 and cache.hits == 0


def test_response_cache_client_mutation_cannot_corrupt_future_hits():
    store, slide = _dms_store()
    gw = RegionGateway(store, config=GatewayConfig(workers=1), device="cpu")
    roi = BoundingBox((64, 64), (96, 96))
    first = gw.get(_key(), roi)
    first[:] = -1.0  # hostile client scribbles on its result
    np.testing.assert_array_equal(gw.get(_key(), roi), slide[roi.slices()])
    gw.close()


def test_response_cache_disabled_with_zero_budget():
    store, _ = _dms_store()
    transport = store.tiers[0].backend.transport
    gw = RegionGateway(
        store, config=GatewayConfig(workers=1, response_cache_bytes=0),
        device="cpu"
    )
    roi = BoundingBox((0, 0), (32, 32))
    gw.get(_key(), roi)
    transport.reset()
    gw.get(_key(), roi)
    assert transport.stats.gets > 0  # every read pays the tier
    assert gw.stats.response_cache_hits == 0
    assert "response_cache" not in gw.storage_stats()["gateway"]
    gw.close()


# -- fairness + pacing ------------------------------------------------------------


def _ticket(priority, name="Slide"):
    t = ReadTicket(_key(name), BoundingBox((0, 0), (8, 8)))
    t.priority = priority
    return t


def test_fair_scheduler_serves_classes_in_weight_proportion():
    sched = FairScheduler((("hi", 3), ("lo", 1)))
    for i in range(12):
        sched.push(_ticket("hi", f"H{i}"))
        sched.push(_ticket("lo", f"L{i}"))
    first8 = [sched.pop_head().priority for _ in range(8)]
    # DRR with weights 3:1 -> each full round serves 3 hi then 1 lo
    assert first8 == ["hi", "hi", "hi", "lo"] * 2
    assert len(sched) == 16


def test_fair_scheduler_unknown_class_degrades_to_default():
    sched = FairScheduler((("interactive", 4), ("default", 2)))
    assert sched.resolve("no-such-class") == "default"
    assert sched.resolve(None) == "default"
    assert sched.resolve("interactive") == "interactive"


def test_drain_matching_stays_within_the_heads_class():
    sched = FairScheduler((("hi", 2), ("lo", 1)))
    for i in range(3):
        sched.push(_ticket("hi"))
        sched.push(_ticket("lo"))
    head = sched.pop_head()
    assert head.priority == "hi"
    batch = sched.drain_matching(head, limit=16, coalesce=True)
    # same key, same group, but only hi's own queue drains
    assert [t.priority for t in batch] == ["hi", "hi", "hi"]
    assert len(sched) == 3  # the lo backlog is untouched


def test_low_priority_hog_cannot_starve_interactive_requests():
    store, _ = _dms_store()
    gw = RegionGateway(store, config=GatewayConfig(workers=1, max_queue=256), device="cpu")
    gw.pause()
    hog = [
        gw.submit(_key(), tile, priority="batch")
        for tile in DOM.tiles((TILE, TILE))
        for _ in range(4)
    ]
    vip = gw.submit(_key(), BoundingBox((0, 0), (16, 16)), priority="interactive")
    # count the finished hogs when the vip resolves, in the worker that
    # resolves it (set_result runs the callback before the worker moves on):
    # counted after result() returns, the worker may have drained the rest
    # of the backlog while this thread woke up
    done_hogs = []
    counted = threading.Event()

    def count(_):
        done_hogs.append(sum(1 for t in hog if t.done()))
        counted.set()

    vip.add_done_callback(count)
    gw.resume()
    vip.result(30.0)  # resolves long before the hog's 64-deep backlog
    assert counted.wait(30.0) and len(done_hogs) == 1
    assert done_hogs[0] < len(hog), "interactive request waited out the whole backlog"
    for t in hog:
        t.result(30.0)
    classes = gw.storage_stats()["gateway"]["classes"]
    assert classes["interactive"]["served"] >= 1
    assert classes["batch"]["served"] >= 1
    gw.close()


def test_client_pacer_throttles_only_the_hog():
    now = [0.0]
    waited = []

    def clock():
        return now[0]

    def sleep(dt):
        waited.append(dt)
        now[0] += dt

    pacer = ClientPacer(1.0, 1.0, clock=clock, sleep=sleep)
    assert pacer.take("hog") == 0.0  # burst token
    assert pacer.take("hog") > 0.0  # over rate: waits on its OWN bucket
    assert pacer.take("polite") == 0.0  # other client untouched
    assert pacer.clients() == 2
    assert waited and all(w > 0 for w in waited)


def test_gateway_counts_throttled_submissions():
    store, _ = _dms_store()
    gw = RegionGateway(
        store,
        config=GatewayConfig(workers=1, client_rate=1000.0, client_burst=1.0),
        device="cpu",
    )
    roi = BoundingBox((0, 0), (16, 16))
    for _ in range(3):
        gw.get(_key(), roi)
    assert gw.stats.throttled >= 1  # burst=1 -> the repeats paid the bucket
    gw.close()


def test_shed_mode_rejects_immediately_with_class_attribution():
    store, _ = _dms_store()
    gw = RegionGateway(
        store,
        config=GatewayConfig(workers=1, max_queue=8, admit_timeout=30.0),
        pressure_fn=lambda: 0.99,  # RAM tier past the highwater,
        device="cpu"
    )
    gw.pause()
    with pytest.raises(Overloaded):
        for _ in range(8):  # shed limit = max(1, 8 * 0.25) = 2
            gw.submit(_key(), BoundingBox((0, 0), (8, 8)), priority="batch")
    assert gw.stats.rejected >= 1
    assert gw.storage_stats()["gateway"]["classes"]["batch"]["shed"] >= 1
    gw.resume()
    gw.close()


# -- write coalescing -------------------------------------------------------------


def test_put_coalescing_last_writer_wins_one_store_put():
    store, _ = _dms_store()
    transport = store.tiers[0].backend.transport
    gw = RegionGateway(
        store, config=GatewayConfig(workers=1, coalesce_puts=True),
        device="cpu"
    )
    roi = BoundingBox((0, 0), (32, 32))
    versions = [np.full((32, 32), float(i), np.float32) for i in range(4)]
    gw.pause()
    tickets = [gw.submit_put(_key(), roi, v) for v in versions]
    transport.reset()
    gw.resume()
    for t in tickets:
        assert t.result(30.0) is None  # superseded writes still resolve
    np.testing.assert_array_equal(store.get(_key(), roi), versions[-1])
    assert gw.stats.writes == 4
    assert gw.stats.writes_applied == 1  # last-writer-wins: one flush
    assert gw.stats.write_coalesced == 3
    assert transport.stats.puts <= 1
    gw.close()


def test_put_coalescing_distinct_rois_all_flush():
    store, _ = _dms_store()
    gw = RegionGateway(
        store, config=GatewayConfig(workers=1, coalesce_puts=True),
        device="cpu"
    )
    rois = [BoundingBox((0, x), (32, x + 32)) for x in (0, 32, 64)]
    payloads = [np.full((32, 32), float(i) + 0.5, np.float32) for i in range(3)]
    gw.pause()
    tickets = [gw.submit_put(_key(), r, p) for r, p in zip(rois, payloads)]
    gw.resume()
    for t in tickets:
        t.result(30.0)
    for r, p in zip(rois, payloads):
        np.testing.assert_array_equal(store.get(_key(), r), p)
    assert gw.stats.writes_applied == 3 and gw.stats.write_coalesced == 0
    gw.close()


def test_facade_put_blocks_until_applied_when_coalescing():
    store, _ = _dms_store()
    gw = RegionGateway(
        store, config=GatewayConfig(workers=2, coalesce_puts=True),
        device="cpu"
    )
    roi = BoundingBox((32, 32), (64, 64))
    fresh = np.full((32, 32), 4.25, np.float32)
    gw.put(_key(), roi, fresh)  # returns only after the flush
    np.testing.assert_array_equal(store.get(_key(), roi), fresh)
    np.testing.assert_array_equal(gw.get(_key(), roi), fresh)
    gw.close()


# -- prefetch ---------------------------------------------------------------------


def test_sequential_scan_feeds_the_window_prefetcher():
    store, slide = _dms_store()
    gw = RegionGateway(
        store, config=GatewayConfig(workers=1, prefetch=True, prefetch_depth=2),
        device="cpu"
    )
    windows = [BoundingBox((0, x), (32, x + 32)) for x in range(0, 97, 32)]
    gw.get(_key(), windows[0])
    gw.get(_key(), windows[1])  # stride observed -> windows[2] predicted
    deadline = time.monotonic() + 10.0
    while gw.stats.prefetch_issued < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert gw.stats.prefetch_issued >= 1
    # give the pipeline a beat to land the payload in the cache
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        got = gw.get(_key(), windows[2])
        np.testing.assert_array_equal(got, slide[windows[2].slices()])
        if gw.stats.prefetch_hits >= 1:
            break
        time.sleep(0.01)
    assert gw.stats.prefetch_hits >= 1
    gw.close()


# -- stats namespace --------------------------------------------------------------


def test_gateway_stats_namespace_merges_compute_with_alias():
    store, _ = _dms_store()
    gw = RegionGateway(store, config=GatewayConfig(workers=1), device="cpu")
    out = gw.storage_stats()
    assert "compute" not in out["gateway"]  # engine not built yet
    gw.compute(_key(), BoundingBox((0, 0), (32, 32)), "threshold")
    out = gw.storage_stats()
    assert out["gateway"]["compute"]["chains"]["threshold"]["served"] == 1
    # deprecated top-level alias, kept for one release
    assert out["compute"] == out["gateway"]["compute"]
    assert out["gateway"]["served"] == 0 and out["gateway"]["compute_served"] == 1
    for row in out["gateway"]["classes"].values():
        assert set(row) == {"requests", "admitted", "shed", "served", "cache_hits"}
    gw.close()


def test_unknown_stats_counters_still_raise():
    store, _ = _dms_store()
    gw = RegionGateway(store, config=GatewayConfig(workers=1), device="cpu")
    with pytest.raises(AttributeError):
        gw.stats.add(no_such_counter=1)
    with pytest.raises(AttributeError):
        gw.stats.class_add("default", no_such_counter=1)
    gw.close()


# -- fleet mode -------------------------------------------------------------------


def _fleet_pair():
    """Two gateways over one DMS fleet (one shared transport)."""
    transport = InProcTransport(4)
    store_a, slide = _dms_store(transport)
    dms_b = DistributedMemoryStorage(DOM, (TILE, TILE), transport=transport)
    store_b = TieredStore([Tier("DMS", dms_b)], name="SRVB")
    cfg = GatewayConfig(workers=2, fleet_generations=True)
    gw_a = RegionGateway(store_a, name="GWA", config=cfg, device="cpu")
    gw_b = RegionGateway(store_b, name="GWB", config=cfg, device="cpu")
    return gw_a, gw_b, slide


def test_cross_gateway_put_invalidates_sibling_response_cache():
    gw_a, gw_b, slide = _fleet_pair()
    roi = BoundingBox((0, 0), (32, 32))
    # both gateways cache the hot window
    np.testing.assert_array_equal(gw_a.get(_key(), roi), slide[roi.slices()])
    np.testing.assert_array_equal(gw_b.get(_key(), roi), slide[roi.slices()])
    fresh = np.full((32, 32), 11.0, np.float32)
    gw_b.put(_key(), roi, fresh)  # gossips the generation bump
    # A's cached window is stale the moment B's put returns: the very
    # next read through A must see B's bytes, not A's cache
    got = gw_a.get(_key(), roi)
    np.testing.assert_array_equal(got, fresh)
    np.testing.assert_array_equal(got, gw_a.store.get(_key(), roi))
    # and the new payload re-caches under the advanced generation
    transport = gw_a.store.tiers[0].backend.transport
    gets_before = transport.stats.gets
    np.testing.assert_array_equal(gw_a.get(_key(), roi), fresh)
    assert transport.stats.gets == gets_before
    gw_a.close(close_store=False)
    gw_b.close()


class _FakeFleetStore:
    """A backend with gossip hooks but no generation() of its own."""

    def __init__(self):
        self.val = 0

    def pull_generation(self, key):
        return self.val

    def push_generation(self, key):
        self.val += 1
        return self.val


def test_generation_tracker_floors_fleet_pull_regressions():
    """A pull that regresses (the member holding the max is unreachable)
    must never resurrect a stale cache entry: the observed fleet value
    is floored per key."""
    backend = _FakeFleetStore()
    gens = GenerationTracker(backend, fleet=True)
    assert gens.fleet_enabled
    k = _key()
    assert gens.current(k) == 0
    backend.val = 5  # remote writes observed
    assert gens.current(k) == 5
    backend.val = 2  # regression: the max-holder dropped out of the pull
    assert gens.current(k) == 5  # floored — monotone, no stale revival
    gens.note_write(k)  # local write: base line +1, fleet push -> 3 < floor
    assert gens.current(k) == 6


def test_manual_generation_bump_drops_cached_responses():
    """TieredStore.bump_generation: out-of-band invalidation without a
    write — the next gateway read pays the tier again."""
    store, slide = _dms_store()
    transport = store.tiers[0].backend.transport
    gw = RegionGateway(store, config=GatewayConfig(workers=1), device="cpu")
    roi = BoundingBox((96, 96), (128, 128))
    gw.get(_key(), roi)
    transport.reset()
    np.testing.assert_array_equal(gw.get(_key(), roi), slide[roi.slices()])
    assert transport.stats.gets == 0  # cached
    store.bump_generation(_key())
    np.testing.assert_array_equal(gw.get(_key(), roi), slide[roi.slices()])
    assert transport.stats.gets > 0  # cache dropped, tier re-fetched
    gw.close()


def test_fleet_reads_stay_bit_exact_under_concurrent_cross_writes():
    gw_a, gw_b, _ = _fleet_pair()
    roi = BoundingBox((64, 64), (96, 96))
    stop = threading.Event()
    errors = []
    # replace the staged random tile with version 0 so every read is a
    # uniform plane and the version ordering below is well-defined
    gw_b.put(_key(), roi, np.zeros((32, 32), np.float32))

    def writer():
        try:
            i = 1
            while not stop.is_set():
                gw_b.put(_key(), roi, np.full((32, 32), float(i), np.float32))
                i += 1
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def reader():
        try:
            while not stop.is_set():
                got = gw_a.get(_key(), roi)
                direct = gw_a.store.get(_key(), roi)
                # every read is SOME written version, uniform per-plane
                assert got.min() == got.max()
                assert direct.min() == direct.max()
                assert got.max() <= direct.max()  # never newer than now...
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=writer), threading.Thread(target=reader)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    gw_a.close(close_store=False)
    gw_b.close()


def test_scripted_workload_equals_the_reference_gateway():
    """Reads (coalesced while paused, cached, prefetched), a coalesced write
    batch and a cache invalidation, in one order through both packages'
    gateways over the same tiles: the same payloads and the same counters."""
    import repro.core as jcore
    import repro.serve as jserve
    import repro.storage as jstorage
    import repro_torch.core as tcore
    import repro_torch.serve as tserve
    import repro_torch.storage as tstorage

    slide = np.random.default_rng(17).random((128, 128)).astype(np.float32)
    patch = np.full((TILE, TILE), 0.5, np.float32)
    runs = {}
    for pkg, (core, serve, storage, kw) in {
        "jax": (jcore, jserve, jstorage, {}),
        "torch": (tcore, tserve, tstorage, {"device": "cpu"}),
    }.items():
        dom = core.BoundingBox((0, 0), (128, 128))
        store = storage.TieredStore(
            [storage.Tier("DMS", storage.DistributedMemoryStorage(dom, (TILE, TILE), 4))],
            name="SRV")
        key = core.RegionKey("g", "Slide", core.ElementType.FLOAT32, 0)
        for tile in dom.tiles((TILE, TILE)):
            store.put(key, tile, slide[tile.slices()])
        gw = serve.RegionGateway(store, config=serve.GatewayConfig(
            workers=1, batch_window=16, coalesce_puts=True), **kw)
        out = []
        gw.pause()
        tickets = [gw.submit(key, core.BoundingBox((y, x), (y + 40, x + 40)))
                   for y in (0, 24, 48) for x in (0, 30)]
        gw.resume()
        out += [t.result(30) for t in tickets]
        out.append(gw.get(key, core.BoundingBox((4, 4), (20, 30))))  # inside a cached window
        gw.pause()
        writes = [gw.submit_put(key, core.BoundingBox((0, 0), (TILE, TILE)), patch * i)
                  for i in (1, 2)]
        gw.resume()
        for t in writes:
            t.result(30)
        out.append(gw.get(key, core.BoundingBox((0, 0), (64, 64))))
        runs[pkg] = (out, gw.stats.as_dict(), gw.storage_stats()["gateway"]["response_cache"])
        gw.close()
    (t_out, t_stats, t_rc), (j_out, j_stats, j_rc) = runs["torch"], runs["jax"]
    for got, want in zip(t_out, j_out):
        np.testing.assert_array_equal(got, want)
    assert t_stats == j_stats and t_rc == j_rc
    assert t_stats["coalesced"] > 0 and t_stats["write_coalesced"] == 1
