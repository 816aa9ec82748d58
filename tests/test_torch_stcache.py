"""Spatio-temporal cache + prefetch (the paper's §7 extension)."""
import time

import numpy as np

from repro_torch.core import BoundingBox, ElementType, RegionKey
from repro_torch.storage import DistributedMemoryStorage
from repro_torch.storage.stcache import SpatioTemporalCache

DOM = BoundingBox((0, 0), (128, 128))


def _backend():
    dms = DistributedMemoryStorage(DOM, (32, 32), 2, name="DMS")
    key = RegionKey("track", "frame", ElementType.FLOAT32, timestamp=0)
    arr = np.arange(128 * 128, dtype=np.float32).reshape(128, 128)
    dms.put(key, DOM, arr)
    return dms, key, arr


def test_lru_hit_and_containment():
    dms, key, arr = _backend()
    c = SpatioTemporalCache(dms, prefetch=False, capacity_bytes=1 << 20)
    big = BoundingBox((0, 0), (64, 64))
    np.testing.assert_array_equal(c.get(key, big), arr[:64, :64])
    assert c.stats.misses == 1
    # contained ROI served from cache without touching the backend
    before = dms.transport.stats.gets
    sub = BoundingBox((16, 16), (48, 48))
    np.testing.assert_array_equal(c.get(key, sub), arr[16:48, 16:48])
    assert c.stats.hits == 1
    assert dms.transport.stats.gets == before


def test_eviction_under_capacity_pressure():
    dms, key, arr = _backend()
    c = SpatioTemporalCache(dms, prefetch=False, capacity_bytes=40_000)
    for i in range(4):
        roi = BoundingBox((0, i * 32), (64, (i + 1) * 32))  # 8KB each... 64*32*4=8KB
        c.get(key, roi)
    assert c.stats.evictions >= 0  # capacity respected
    assert c.stats.bytes_cached <= 40_000


def test_motion_prefetch_anticipates_next_roi():
    """Constant-velocity ROI stream: after two reads the third is
    prefetched (the paper's object-tracking scenario)."""
    dms, key, arr = _backend()
    c = SpatioTemporalCache(dms, prefetch=True)
    r0 = BoundingBox((0, 0), (32, 32))
    r1 = BoundingBox((0, 16), (32, 48))
    r2 = BoundingBox((0, 32), (32, 64))
    c.get(key, r0)
    c.get(key, r1)  # predicts r2 and prefetches it
    deadline = time.time() + 2.0
    while c.stats.prefetch_issued == 0 and time.time() < deadline:
        time.sleep(0.01)
    assert c.stats.prefetch_issued >= 1
    # wait for prefetch to land, then the next read is a (prefetch) hit
    time.sleep(0.1)
    before = c.stats.misses
    np.testing.assert_array_equal(c.get(key, r2), arr[0:32, 32:64])
    assert c.stats.misses == before  # no backend round-trip on the hot path


def test_temporal_prediction_follows_timestamps():
    dms, key, arr = _backend()
    key1 = key.at(1)
    dms.put(key1, DOM, arr + 1)
    key2 = key.at(2)
    dms.put(key2, DOM, arr + 2)
    c = SpatioTemporalCache(dms, prefetch=True)
    roi = BoundingBox((0, 0), (32, 32))
    c.get(key, roi)
    c.get(key1, roi)  # dt=1 -> predicts (t=2, same roi)
    time.sleep(0.2)
    before = c.stats.misses
    np.testing.assert_array_equal(c.get(key2, roi), arr[:32, :32] + 2)
    assert c.stats.misses == before


def test_write_through_invalidates():
    dms, key, arr = _backend()
    c = SpatioTemporalCache(dms, prefetch=False)
    roi = BoundingBox((0, 0), (32, 32))
    c.get(key, roi)
    c.put(key, DOM, arr * 2)  # overwrite through the cache
    np.testing.assert_array_equal(c.get(key, roi), arr[:32, :32] * 2)


def test_same_stream_same_answers_as_the_reference():
    """One ROI stream (hits, containment, evictions, a write-through) through
    both packages' caches over their DMS: the same arrays and counters."""
    import dataclasses

    import repro.core as jcore
    import repro.storage as jstorage
    import repro_torch.core as tcore
    import repro_torch.storage as tstorage

    arr = np.random.default_rng(11).random((128, 128)).astype(np.float32)
    boxes = [((0, 0), (64, 64)), ((16, 16), (48, 48)), ((0, 64), (64, 128)),
             ((64, 0), (128, 64)), ((0, 0), (64, 64)), ((70, 70), (120, 127))]
    runs = {}
    for name, (core, storage) in {"jax": (jcore, jstorage), "torch": (tcore, tstorage)}.items():
        dom = core.BoundingBox((0, 0), (128, 128))
        dms = storage.DistributedMemoryStorage(dom, (32, 32), 2, name="DMS")
        key = core.RegionKey("track", "frame", core.ElementType.FLOAT32, timestamp=0)
        dms.put(key, dom, arr)
        c = storage.SpatioTemporalCache(dms, prefetch=False, capacity_bytes=40_000)
        out = [c.get(key, core.BoundingBox(*b)) for b in boxes]
        c.put(key, core.BoundingBox((0, 0), (32, 32)), arr[:32, :32] * 2)
        out.append(c.get(key, core.BoundingBox((0, 0), (64, 64))))
        runs[name] = (out, dataclasses.asdict(c.stats), dms.transport.stats.as_dict())
    (t_out, t_stats, t_tr), (j_out, j_stats, j_tr) = runs["torch"], runs["jax"]
    assert t_stats == j_stats and t_tr == j_tr
    for got, want in zip(t_out, j_out):
        np.testing.assert_array_equal(got, want)
