"""The port's region store (``repro_torch.storage``) against the JAX
package's (``repro.storage``): the same numpy arrays and the same sequence
of operations go to both packages' stores, and every read, placement,
statistic and ring answer must be equal. Both packages' storage modules
hold no JAX; the port's are copies, so equality here is exact."""
import numpy as np
import pytest

import repro.core as jcore
import repro.storage as jstorage
import repro_torch.core as tcore
import repro_torch.storage as tstorage
from repro.storage import codec as jcodec
from repro_torch.storage import codec as tcodec

PACKAGES = {"jax": (jcore, jstorage), "torch": (tcore, tstorage)}
DOM = (64, 64)


def _arrays(n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(7)
    return [rng.random(DOM, dtype=np.float32) for _ in range(n)]


def _faulty(storage):
    """In-process transport of ``storage`` whose servers in ``down`` fail
    every request: a dead server, as ``tests/test_dms.py`` injects it."""

    class Faulty(storage.InProcTransport):
        def __init__(self, num_servers: int):
            super().__init__(num_servers)
            self.down: set[int] = set()

        def _check(self, server: int) -> None:
            if server in self.down:
                raise storage.TransportError(f"server {server} is down (injected)")

    for op in ("store", "fetch", "fetch_many", "put_meta", "put_meta_batch", "lookup",
               "keys", "drop", "drop_block"):
        def checked(self, server, *a, _op=op):
            self._check(server)
            return getattr(storage.InProcTransport, _op)(self, server, *a)
        setattr(Faulty, op, checked)
    return Faulty


def _dms_script(pkg: str, replication: int) -> list:
    core, storage = PACKAGES[pkg]
    dom = core.BoundingBox((0, 0), DOM)
    tr = _faulty(storage)(4)
    dms = storage.DistributedMemoryStorage(dom, (16, 16), transport=tr,
                                           replication=replication)
    key = core.RegionKey("t", "X", core.ElementType.FLOAT32)
    a, b = _arrays(2)
    out = []
    dms.put(key, dom, a)
    out.append(dms.get(key, dom))
    roi = core.BoundingBox((16, 16), (48, 64))
    dms.put(key, roi, b[roi.slices()])  # a partial overwrite, whole blocks
    out.append(dms.get(key, dom))
    out.append(dms.get(key, core.BoundingBox((9, 3), (37, 50))))
    out.append(list(dms.server_load()))
    if replication > 1:
        tr.down.add(2)  # a dead server: puts re-home, reads fail over
        key2 = key.bump()
        dms.put(key2, dom, b)
        out.append(dms.get(key2, dom))
        out.append(dms.get(key, dom))
    homes = {bc: storage.decode_homes(h) for bc, (_, h) in tr.lookup(0, key).items()}
    out.append(sorted(homes.items()))
    out.append(sorted((k.name, k.version, bb.lo, bb.hi) for k, bb in dms.query("t", "X")))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("replication", [1, 2])
def test_dms_reads_and_homes_equal(replication):
    _assert_same(_dms_script("torch", replication), _dms_script("jax", replication))


def _tiered_script(pkg: str, write_policy: str, root) -> list:
    core, storage = PACKAGES[pkg]
    dom = core.BoundingBox((0, 0), DOM)
    block = 64 * 64 * 4
    ts = storage.TieredStore.standard(dom, (32, 32), root=str(root / pkg), name="T",
                                      mem_capacity_bytes=2 * block, num_servers=2,
                                      write_policy=write_policy)
    keys = [core.RegionKey("t", f"K{i}", core.ElementType.FLOAT32) for i in range(4)]
    arrs = _arrays(len(keys))
    out = []
    try:
        for k, a in zip(keys, arrs):  # four regions through a RAM tier that holds two
            ts.put(k, dom, a)
            # the write-back flusher races the demotions to the bottom tier:
            # a flush after each put fixes the order, so the stats compare
            ts.flush()
        ts.drain()
        for k in (keys[0], keys[0], keys[3], keys[1], keys[0]):  # repeat reads promote
            out.append(ts.get(k, dom))
        out.append(ts.get(keys[2], core.BoundingBox((10, 20), (50, 64))))
        ts.drain()
        out.append([ts.locality(k) for k in keys])
        out.append({name: st.as_dict() for name, st in ts.tier_stats().items()})
    finally:
        ts.close()
    return out


@pytest.mark.parametrize("write_policy", ["write_through", "write_back", "lazy"])
def test_tiered_reads_stats_and_locality_equal(tmp_path, write_policy):
    _assert_same(_tiered_script("torch", write_policy, tmp_path),
                 _tiered_script("jax", write_policy, tmp_path))


def _disk_script(pkg: str, root) -> list:
    core, storage = PACKAGES[pkg]
    dom = core.BoundingBox((0, 0), DOM)
    store = storage.DiskStorage(str(root / pkg), transport="aggregated", io_group_size=2,
                                queue_threshold=3)
    key = core.RegionKey("t", "D", core.ElementType.FLOAT32)
    (a,) = _arrays(1)
    try:
        for tile in dom.tiles((16, 32)):
            store.put(key, tile, a[tile.slices()])
        store.flush()
        return [store.get(key, dom), store.get(key, core.BoundingBox((5, 7), (61, 33)))]
    finally:
        store.close()


def test_disk_reads_equal(tmp_path):
    _assert_same(_disk_script("torch", tmp_path), _disk_script("jax", tmp_path))


def _ring(storage) -> list:
    view = storage.RingView.genesis(4)
    out = []
    for step in ("join", "join", "leave", "leave"):
        if step == "join":
            view = view.join(max(view.servers) + 1)
        else:
            view = view.leave(view.servers[1])
        out.append((view.epoch, view.arcs, [view.owner(r, 1000) for r in range(0, 1000, 37)],
                    view.checksum()))
    return out


def test_ring_view_join_leave_equal():
    assert _ring(tstorage) == _ring(jstorage)


@pytest.mark.parametrize("codec", [None, "raw", "zlib", "bf16", "int8"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8])
def test_codec_round_trips_equal(codec, dtype):
    rng = np.random.default_rng(3)
    arr = (rng.random((32, 48)) * 200).astype(dtype)
    t_meta, t_payload = tcodec.encode_block(arr, codec)
    j_meta, j_payload = jcodec.encode_block(arr, codec)
    assert t_meta == j_meta and bytes(t_payload) == bytes(j_payload)
    got, want = tcodec.decode_block(t_meta, t_payload), jcodec.decode_block(j_meta, j_payload)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if tcodec.is_lossless(t_meta):
        np.testing.assert_array_equal(got, arr)


def test_the_ported_store_is_not_the_reference_and_refuses_what_is_missing():
    """Every name of the reference's store is ported, the checkpoint
    manager too: each is the port's own; a name neither has raises."""
    assert tstorage.DistributedMemoryStorage is not jstorage.DistributedMemoryStorage
    with pytest.raises(AttributeError):
        tstorage.NoSuchStore
    for name in ("SocketTransport", "ServerGroup", "ServerProcess", "ShmTransport", "ShmArena",
                 "ShmWindow", "spawn_servers", "SpatioTemporalCache", "STCacheStats",
                 "IOConfig", "TuneResult", "autotune_io", "CheckpointManager"):
        assert getattr(tstorage, name) is not getattr(jstorage, name), name
        assert getattr(tstorage, name).__module__.startswith("repro_torch.storage."), name
    assert set(tstorage.__all__) == set(jstorage.__all__)
