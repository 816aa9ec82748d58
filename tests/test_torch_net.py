"""The port's multi-host DMS transport (``repro_torch.storage.net``, a
copy of ``repro.storage.net``): wire codec, Transport conformance, live
ServerProcess round-trips, the shm zero-copy data plane, tiered staging and
the WSI stages over sockets; the single-host cases of ``tests/test_net.py``
on one module-scoped fleet of port servers (each server process imports
torch, so the cases that kill, restart or spawn their own servers stay in
that file). Then the wire between the packages: the port's client against
a ``repro.storage.net`` server and the JAX client against the port's, byte
for byte."""
import os
import threading
import time

import numpy as np
import pytest

from repro_torch.core import BoundingBox, ElementType, RegionKey
from repro_torch.storage import (
    DistributedMemoryStorage,
    InProcTransport,
    MemoryTier,
    ShmTransport,
    SocketTransport,
    Tier,
    TieredStore,
    Transport,
    TransportError,
    decode_homes,
    spawn_servers,
)
from repro_torch.storage.net import ServerProcess, decode_array, encode_array

# every test here spawns (or attaches to) real server processes — the
# fast unit CI leg deselects the whole module via `-m "not net"`
pytestmark = pytest.mark.net

# nightly chaos runs scale the kill/restart/hammer loops up without
# code changes (see .github/workflows/ci.yml chaos-nightly)
CHAOS_ITERS = max(1, int(os.environ.get("REPRO_CHAOS_ITERS", "1")))

DOM = BoundingBox((0, 0), (64, 64))


def _key(name="R", ts=0):
    return RegionKey("t", name, ElementType.FLOAT32, ts)


# ---------------------------------------------------------------------------
# shared fleet: 4 shards across 2 real server processes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def group():
    g = spawn_servers(4, processes=2)
    assert len(g.procs) == 2 and g.num_servers == 4
    yield g
    g.close()


@pytest.fixture(params=["inproc", "socket", "shm"])
def transport(request, group):
    if request.param == "inproc":
        tr = InProcTransport(4)
        yield tr
    else:
        # "shm" runs the identical conformance suite over the negotiated
        # shared-memory data plane (fetches map the server arena instead
        # of riding the socket payload)
        tr = group.transport() if request.param == "socket" else group.transport(shm="require")
        # module-scoped servers: isolate tests by dropping our keys
        yield tr
        for sid in range(tr.num_servers):
            for key in tr.keys(sid):
                tr.drop(sid, key)
        tr.close()


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "arr",
    [
        np.arange(12, dtype=np.float32).reshape(3, 4),
        np.arange(12, dtype=np.float16).reshape(3, 4),
        np.zeros((0, 5), np.float64),
        np.arange(24, dtype=np.int64).reshape(2, 3, 4)[:, :, ::2],  # non-contiguous
        np.asarray(np.random.default_rng(0).random((4, 4)) > 0.5),  # bool
        np.arange(6, dtype=np.uint8).reshape(6, 1, 1),  # trailing dims
    ],
    ids=["f32", "f16", "empty", "noncontig", "bool", "trailing"],
)
def test_array_codec_roundtrip(arr):
    meta, buf = encode_array(arr)
    back = decode_array(meta, bytearray(buf))
    assert back.dtype == arr.dtype
    assert back.shape == arr.shape
    np.testing.assert_array_equal(back, arr)


def test_array_codec_bfloat16():
    import jax.numpy as jnp

    arr = np.asarray(jnp.arange(8, dtype=jnp.bfloat16).reshape(2, 4))
    meta, buf = encode_array(arr)
    back = decode_array(meta, bytearray(buf))
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back.astype(np.float32), arr.astype(np.float32))


# ---------------------------------------------------------------------------
# Transport conformance: InProcTransport and SocketTransport obey the same
# message API (the drop-in-swap guarantee under DistributedMemoryStorage)
# ---------------------------------------------------------------------------
def test_transport_protocol_conformance(transport):
    assert isinstance(transport, Transport)
    assert transport.num_servers == 4
    key = _key("conf")
    box = BoundingBox((0, 0), (8, 8))
    payload = np.random.default_rng(1).random((8, 8)).astype(np.float32)

    # store/fetch round-trip on every server
    for sid in range(transport.num_servers):
        transport.store(sid, key, (sid, 0), box, payload)
        got = transport.fetch(sid, key, (sid, 0))
        assert got.dtype == payload.dtype and got.shape == payload.shape
        np.testing.assert_array_equal(got, payload)

    # fetch of an absent block raises KeyError (not a transport failure)
    with pytest.raises(KeyError):
        transport.fetch(0, _key("absent"), (9, 9))

    # metadata: propagate to all, any directory answers, home preserved
    for sid in range(transport.num_servers):
        transport.put_meta(sid, key, (1, 2), box, home=3)
    looked = transport.lookup(2, key)
    assert looked[(1, 2)] == (box, 3)
    assert key in transport.keys(2)

    # batched metadata (what DMS.put sends): same directory semantics
    box2 = BoundingBox((8, 8), (16, 16))
    for sid in range(transport.num_servers):
        had = transport.put_meta_batch(
            sid, [(key, (3, 4), box, 1), (key, (5, 6), box2, 2)]
        )
        assert had == []  # fresh coords: empty pre-image
    looked = transport.lookup(0, key)
    assert looked[(3, 4)] == (box, 1) and looked[(5, 6)] == (box2, 2)
    # re-sending reports the coords that already existed (the pre-image
    # a failed put's rollback consults before dropping anything)
    assert transport.put_meta_batch(0, [(key, (3, 4), box, 1)]) == [(3, 4)]

    # byte accounting is real on every transport: the *_raw fields count
    # decoded array bytes regardless of data plane (shm fetches and
    # codec'd frames move fewer wire bytes, never fewer raw bytes)
    assert transport.stats.puts == 4
    assert transport.stats.gets >= 4
    assert transport.stats.bytes_put_raw >= 4 * payload.nbytes
    assert transport.stats.bytes_get_raw >= 4 * payload.nbytes
    assert transport.stats.bytes_put > 0 and transport.stats.bytes_get > 0
    assert transport.stats.meta_msgs >= 3
    assert transport.payload_bytes(0) >= payload.nbytes

    # drop removes payload + metadata
    for sid in range(transport.num_servers):
        transport.drop(sid, key)
    assert key not in transport.keys(2)
    with pytest.raises(KeyError):
        transport.fetch(0, key, (0, 0))


def test_fetch_many_conformance(transport):
    """Scatter-gather fetch: N blocks, ONE round-trip, bit-exact — the
    same contract over both transports (mixed dtypes/shapes in one frame
    exercise the concatenated-payload offsets)."""
    key = _key("fm")
    box = BoundingBox((0, 0), (8, 8))
    blocks = [
        np.random.default_rng(7).random((8, 8)).astype(np.float32),
        np.arange(12, dtype=np.float16).reshape(3, 4),
        np.zeros((0, 5), np.float64),  # empty payload mid-frame
        np.asarray(np.random.default_rng(8).random((4, 4)) > 0.5),  # bool
    ]
    for i, payload in enumerate(blocks):
        transport.store(1, key, (i, 0), box, payload)
    transport.reset()
    got = transport.fetch_many(1, [(key, (i, 0)) for i in range(len(blocks))])
    assert len(got) == len(blocks)
    for want, back in zip(blocks, got):
        assert back.dtype == want.dtype and back.shape == want.shape
        np.testing.assert_array_equal(back, want)
    # one round-trip for the whole gather, every payload byte accounted
    # (raw bytes: over the shm plane the wire only carries block refs)
    assert transport.stats.gets == 1
    assert transport.stats.bytes_get_raw >= sum(b.nbytes for b in blocks)
    # empty request list short-circuits (no wire traffic)
    transport.reset()
    assert transport.fetch_many(1, []) == []
    assert transport.stats.gets == 0
    # a missing block surfaces as KeyError, same as plain fetch
    with pytest.raises(KeyError):
        transport.fetch_many(1, [(key, (0, 0)), (_key("absent"), (9, 9))])
    for sid in range(transport.num_servers):
        transport.drop(sid, key)


def test_transport_mutation_safety(transport):
    """Resident blocks never alias client buffers: mutating the array a
    caller put (or the one it fetched back) must not corrupt the store —
    on BOTH transports (the socket copies bytes on the wire; the in-proc
    shards copy on store and hand out read-only views)."""
    key = _key("mut")
    box = BoundingBox((0, 0), (4, 4))
    original = np.arange(16, dtype=np.float32).reshape(4, 4)
    buf = original.copy()
    transport.store(0, key, (0, 0), box, buf)
    buf[:] = -1.0  # caller scribbles on its buffer after the put
    got = transport.fetch(0, key, (0, 0))
    np.testing.assert_array_equal(got, original)
    # scribbling on the fetched array either raises (read-only view) or
    # lands in a private copy — never in the store
    try:
        got[0, 0] = 99.0
    except ValueError:
        pass
    np.testing.assert_array_equal(transport.fetch(0, key, (0, 0)), original)
    # same guarantee through the scatter-gather path
    transport.store(0, key, (1, 0), box, original.copy())
    many = transport.fetch_many(0, [(key, (0, 0)), (key, (1, 0))])
    for blk in many:
        try:
            blk[0, 0] = 77.0
        except ValueError:
            pass
    for blk in transport.fetch_many(0, [(key, (0, 0)), (key, (1, 0))]):
        np.testing.assert_array_equal(blk, original)
    transport.drop(0, key)


def test_drop_block_conformance(transport):
    """drop_block removes ONE block's payload + directory entry and
    leaves siblings intact — the put-rollback primitive (a whole-key
    drop would destroy sibling blocks), same over both transports."""
    key = _key("db")
    box = BoundingBox((0, 0), (8, 8))
    a = np.ones((8, 8), np.float32)
    transport.store(0, key, (0, 0), box, a)
    transport.store(0, key, (1, 0), box, a)
    transport.put_meta_batch(0, [(key, (0, 0), box, 0), (key, (1, 0), box, 0)])
    transport.drop_block(0, key, (0, 0))
    with pytest.raises(KeyError):
        transport.fetch(0, key, (0, 0))
    np.testing.assert_array_equal(transport.fetch(0, key, (1, 0)), a)
    looked = transport.lookup(0, key)
    assert (0, 0) not in looked and (1, 0) in looked
    transport.drop_block(0, key, (9, 9))  # idempotent on absent blocks
    transport.drop_block(0, _key("nope"), (0, 0))  # and on absent keys
    transport.drop(0, key)
    assert key not in transport.keys(0)


def test_homes_metadata_roundtrip(transport):
    """Directory entries carry a single home (legacy int, preserved
    as-is) or a replica list; both transports round-trip both forms and
    ``decode_homes`` normalizes them."""
    key = _key("homes")
    box = BoundingBox((0, 0), (8, 8))
    box2 = BoundingBox((8, 8), (16, 16))
    transport.put_meta(0, key, (1, 2), box, 3)          # legacy single home
    transport.put_meta(0, key, (3, 4), box, [1, 3])     # replica set
    transport.put_meta_batch(
        0, [(key, (5, 6), box, 2), (key, (7, 8), box2, [0, 2])]
    )
    looked = transport.lookup(0, key)
    bb, h = looked[(1, 2)]
    assert bb == box and isinstance(h, int) and decode_homes(h) == (3,)
    assert decode_homes(looked[(3, 4)][1]) == (1, 3)
    assert decode_homes(looked[(5, 6)][1]) == (2,)
    assert looked[(7, 8)][0] == box2
    assert decode_homes(looked[(7, 8)][1]) == (0, 2)
    transport.drop(0, key)


def test_replication_wire_format_preserved_at_r1(group):
    """replication=1 must keep today's directory format byte-for-byte
    (bare-int homes); replication=2 records the full replica ring — over
    both transports."""
    arr = np.random.default_rng(11).random((64, 64)).astype(np.float32)
    for make_tr in (lambda: InProcTransport(4), group.transport):
        dms1 = DistributedMemoryStorage(DOM, (16, 16), transport=make_tr())
        dms1.put(_key("r1"), DOM, arr)
        for _, (_, h) in dms1.transport.lookup(1, _key("r1")).items():
            assert isinstance(h, int)  # legacy format, not a 1-list
        assert sum(dms1.server_load()) == arr.nbytes
        dms1.delete(_key("r1"))
        dms1.close()

        dms2 = DistributedMemoryStorage(
            DOM, (16, 16), transport=make_tr(), replication=2
        )
        dms2.put(_key("r2"), DOM, arr)
        eps = getattr(dms2.transport, "endpoints", None)
        for bc, (_, h) in dms2.transport.lookup(3, _key("r2")).items():
            homes = decode_homes(h)
            assert homes == dms2.replica_servers(bc)
            assert len(homes) == 2
            assert homes[0] == dms2.home_server(bc)
            if eps is None:
                assert homes[1] == (homes[0] + 1) % 4  # SFC-ring neighbor
            else:
                # the fleet packs 2 shards per process: the ring walk
                # must skip the co-located neighbor — replicas live in
                # distinct failure domains (processes)
                assert eps[homes[0]] != eps[homes[1]]
        # write amplification: every block resident on both replicas
        assert sum(dms2.server_load()) == 2 * arr.nbytes
        np.testing.assert_array_equal(dms2.get(_key("r2"), DOM), arr)
        dms2.delete(_key("r2"))
        dms2.close()


def test_dms_get_uses_scatter_gather_round_trips(group):
    """A multi-block DMS read costs one fetch_many per touched server,
    not one fetch per block — over both transports."""
    arr = np.random.default_rng(9).random((64, 64)).astype(np.float32)
    for tr in (InProcTransport(4), group.transport()):
        dms = DistributedMemoryStorage(DOM, (16, 16), 4, transport=tr)
        dms.put(_key("sg"), DOM, arr)  # 16 blocks over 4 servers
        tr.reset()
        np.testing.assert_array_equal(dms.get(_key("sg"), DOM), arr)
        # 1 lookup + at most one gather per server (16 blocks without
        # scatter-gather would be 16 gets)
        assert tr.stats.gets <= 4
        assert tr.stats.bytes_get >= arr.nbytes
        dms.delete(_key("sg"))
        dms.close()


def test_dms_identical_results_over_both_transports(group):
    arr = np.random.default_rng(2).random((64, 64)).astype(np.float32)
    rois = [DOM, BoundingBox((3, 7), (41, 64)), BoundingBox((17, 0), (18, 53))]
    results = []
    for tr in (InProcTransport(4), group.transport()):
        dms = DistributedMemoryStorage(DOM, (16, 16), 4, transport=tr)
        dms.put(_key(), DOM, arr)
        results.append([dms.get(_key(), roi) for roi in rois])
        dms.delete(_key())
        dms.close()
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# DMS over live server processes
# ---------------------------------------------------------------------------
def test_dms_put_get_bit_exact_across_processes(group):
    tr = group.transport()
    dms = DistributedMemoryStorage(DOM, (16, 16), 4, transport=tr, name="NETDMS")
    arr = np.random.default_rng(3).random((64, 64)).astype(np.float32)
    dms.put(_key("net"), DOM, arr)
    np.testing.assert_array_equal(dms.get(_key("net"), DOM), arr)
    roi = BoundingBox((9, 21), (40, 60))
    np.testing.assert_array_equal(dms.get(_key("net"), roi), arr[roi.slices()])
    # payload landed on real remote shards, balanced by the SFC partition
    load = dms.server_load()
    assert sum(load) == arr.nbytes
    assert min(load) > 0
    # every server process hosts two shards of the fleet
    assert sorted(tr.ping(0)) == [0, 1]
    assert sorted(tr.ping(2)) == [2, 3]
    dms.delete(_key("net"))
    dms.close()


def test_scoped_transports_isolate_stores_on_shared_fleet(group):
    """Two stores sharing one server fleet must not see each other's keys
    (the isolation separate InProcTransports give for free)."""
    a = DistributedMemoryStorage(DOM, (16, 16), transport=group.transport(scope="A"))
    b = DistributedMemoryStorage(DOM, (16, 16), transport=group.transport(scope="B"))
    arr = np.ones((64, 64), np.float32)
    a.put(_key("shared"), DOM, arr)
    assert b.query("t", "shared") == []  # b cannot see a's regions
    with pytest.raises(KeyError):
        b.get(_key("shared"), DOM)
    b.put(_key("shared"), DOM, 2 * arr)
    b.delete(_key("shared"))  # must not destroy a's copy
    np.testing.assert_array_equal(a.get(_key("shared"), DOM), arr)
    a.delete(_key("shared"))
    a.close()
    b.close()


def test_dms_query_and_versioning_over_socket(group):
    tr = group.transport()
    dms = DistributedMemoryStorage(DOM, (16, 16), 4, transport=tr)
    dms.put(_key("v", ts=0), DOM, np.zeros((64, 64), np.float32))
    dms.put(_key("v", ts=1), DOM, np.ones((64, 64), np.float32))
    found = dms.query("t", "v")
    assert [k.timestamp for k, _ in found] == [0, 1]
    assert (dms.get(_key("v", ts=1), DOM) == 1).all()
    dms.delete(_key("v", ts=0))
    assert len(dms.query("t", "v")) == 1
    dms.delete(_key("v", ts=1))
    dms.close()


def test_concurrent_put_get_hammer(group):
    """Many threads sharing one SocketTransport against live servers."""
    tr = group.transport()
    dms = DistributedMemoryStorage(DOM, (16, 16), 4, transport=tr)
    tiles = list(DOM.tiles((16, 16)))
    rng = np.random.default_rng(4)
    payloads = {i: rng.random((16, 16)).astype(np.float32) for i in range(len(tiles))}
    errors = []

    def worker(wid: int):
        try:
            key = _key(f"hammer{wid}")
            for rep in range(3 * CHAOS_ITERS):
                for i, bb in enumerate(tiles):
                    dms.put(key.at(i), bb, payloads[i])
                for i, bb in enumerate(tiles):
                    np.testing.assert_array_equal(dms.get(key.at(i), bb), payloads[i])
        except Exception as e:  # noqa: BLE001
            errors.append((wid, e))

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    wall = time.perf_counter() - t0
    assert not errors, errors
    # virtual_time is the union of on-the-wire intervals: it can never
    # exceed elapsed wall time, no matter how many threads overlap
    assert tr.virtual_time() <= wall * 1.05
    assert dms.aggregate_throughput() > 0
    for w in range(8):
        for i in range(len(tiles)):
            dms.delete(_key(f"hammer{w}").at(i))
    dms.close()


def test_socket_close_refuses_new_requests(group):
    tr = group.transport()
    tr.ping(0)
    tr.close()
    with pytest.raises(TransportError, match="closed"):
        tr.fetch(0, _key("closed"), (0, 0))
    with pytest.raises(TransportError, match="closed"):
        tr.store(
            0, _key("closed"), (0, 0), BoundingBox((0, 0), (2, 2)),
            np.zeros((2, 2), np.float32),
        )
    tr.close()  # idempotent


def test_socket_close_while_requests_in_flight(group):
    """close() takes the per-connection locks: concurrent requests either
    complete normally or surface as TransportError — never an arbitrary
    mid-frame OSError."""
    tr = group.transport()
    key = _key("inflight")
    box = BoundingBox((0, 0), (64, 64))
    payload = np.random.default_rng(12).random((64, 64)).astype(np.float32)
    tr.store(1, key, (0, 0), box, payload)
    stop = threading.Event()
    bad: list[BaseException] = []

    def reader():
        while not stop.is_set():
            try:
                tr.fetch(1, key, (0, 0))
            except TransportError:
                return  # expected once closed
            except BaseException as e:  # noqa: BLE001
                bad.append(e)
                return

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    tr.close()
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not bad, bad
    cleanup = group.transport()
    cleanup.drop(1, key)
    cleanup.close()


# ---------------------------------------------------------------------------
# chaos: R-way replication + failover reads on a real fleet
# ---------------------------------------------------------------------------
def test_tiered_store_demotes_and_flushes_through_socket_tier(group, tmp_path):
    tile_bytes = 16 * 16 * 4
    store = TieredStore(
        [
            Tier("MEM", MemoryTier(name="MEM"), 2 * tile_bytes),
            Tier(
                "DMS",
                DistributedMemoryStorage(
                    DOM, (16, 16), 4, name="NET-DMS", transport=group.transport()
                ),
            ),
        ],
        name="NETTIER",
        write_policy="write_back",
    )
    tiles = list(DOM.tiles((16, 16)))
    rng = np.random.default_rng(5)
    payloads = [rng.random((16, 16)).astype(np.float32) for _ in tiles]
    keys = [_key("spill").at(i) for i in range(len(tiles))]
    for k, bb, a in zip(keys, tiles, payloads):
        store.put(k, bb, a)
    store.flush()  # write-backs reach the socket tier
    # capacity 2 tiles -> most keys were demoted over the wire
    stats = store.tier_stats()
    assert stats["MEM"].demotions > 0
    assert store.used_bytes("MEM") <= 2 * tile_bytes
    # every key still reads back bit-exact (MEM hit or socket fetch)
    for k, bb, a in zip(keys, tiles, payloads):
        np.testing.assert_array_equal(store.get(k, bb), a)
    # the cold ones are DMS-resident and the network tier answers locality
    locs = {store.locality(k) for k in keys}
    assert "DMS" in locs
    store.drain()  # push-down: bottom tier holds everything
    for k in keys:
        assert not store.dirty(k)
    dms = store.tiers[1].backend
    assert sum(dms.server_load()) >= len(tiles) * tile_bytes
    for k in keys:
        store.delete(k)
    store.close()  # closes the socket transport too


def test_make_wsi_storage_socket_tiered(group):
    """The opt-in pipeline wiring: make_wsi_storage(mode='tiered',
    transport='socket') against an already-running fleet."""
    from repro_torch.pipeline import make_wsi_storage

    reg = make_wsi_storage(
        64, 64, mode="tiered", transport="socket", endpoints=group.endpoints, tile=32
    )
    store3 = reg.get("DMS3")
    dms3 = store3.tiers[2].backend
    assert type(dms3.transport).__name__ == "SocketTransport"
    key = RegionKey("t", "RGB", ElementType.FLOAT32)
    dom3 = BoundingBox((0, 0, 0), (3, 64, 64))
    rgb = np.random.default_rng(6).random((3, 64, 64)).astype(np.float32)
    store3.put(key, dom3, rgb)
    np.testing.assert_array_equal(store3.get(key, dom3), rgb)
    store3.drain()  # reaches the socket-backed DMS tier
    assert not store3.dirty(key)
    store3.delete(key)
    for name in ("DMS3", "DMS2"):
        reg.get(name).close()

    # endpoints without transport="socket" is a deployment mistake, not a
    # silent fallback to in-process shards
    with pytest.raises(ValueError, match="transport='socket'"):
        make_wsi_storage(64, 64, mode="tiered", endpoints=group.endpoints)


def test_wsi_pipeline_green_on_socket_transport(group):
    """End-to-end: the RT two-stage pipeline over socket-backed storage
    matches the plain-function pipeline."""

    from repro_torch.configs.wsi import WSIConfig
    from repro_torch.core import Intent, RegionTemplate
    from repro_torch.pipeline import FeatureStage, SegmentationStage, analyze_tile, make_tile
    from repro_torch.pipeline import make_wsi_storage
    from repro_torch.runtime import SysEnv

    rgb, _ = make_tile(64, num_nuclei=4, seed=7)
    h, w = rgb.shape[1:]
    cfg = WSIConfig(seg_threshold=0.5, nucleus_roi=16)
    plain = analyze_tile(rgb, cfg, device="cpu")

    reg = make_wsi_storage(
        h, w, mode="tiered", transport="socket", endpoints=group.endpoints
    )
    dom3 = BoundingBox((0, 0, 0), (3, h, w))
    dom2 = BoundingBox((0, 0), (h, w))
    rt = RegionTemplate("Patient")
    rgb_region = rt.new_region("RGB", dom3, np.float32, input_storage="DMS3", lazy=True)
    reg.get("DMS3").put(rgb_region.key, dom3, np.asarray(rgb))

    env = SysEnv(num_workers=1, cpus_per_worker=2, accels_per_worker=1, registry=reg)
    seg = SegmentationStage(cfg, device="cpu")
    seg.add_region_template(rt, "RGB", dom3, Intent.INPUT, read_storage="DMS3")
    seg.add_region_template(rt, "Mask", dom2, Intent.OUTPUT, storage="DMS2")
    seg.add_region_template(rt, "Hema", dom2, Intent.OUTPUT, storage="DMS2")
    feat = FeatureStage(cfg, device="cpu")
    feat.add_region_template(rt, "Mask", dom2, Intent.INPUT, read_storage="DMS2")
    feat.add_region_template(rt, "Hema", dom2, Intent.INPUT, read_storage="DMS2")
    feat.add_dependency(seg)
    env.execute_component(seg)
    env.execute_component(feat)
    env.startup_execution()
    env.finalize_system()

    mask_key = seg.templates["Patient"].get("Mask").key
    got_mask = reg.get("DMS2").get(mask_key, dom2)
    np.testing.assert_array_equal(got_mask, plain["labels"].numpy())
    feats_region = feat.templates["Patient"].get("Features")
    np.testing.assert_allclose(
        feats_region.data["features"], plain["features"].numpy(), rtol=1e-4, atol=1e-4
    )
    for name in ("DMS3", "DMS2"):
        reg.get(name).close()


# ---------------------------------------------------------------------------
# regression: overlapping re-put chunks must not double-count coverage
# (ROADMAP open item: per-chunk volume counters -> mask-based _assemble)
# ---------------------------------------------------------------------------
def test_disk_overlap_coverage_is_mask_based(tmp_path):
    """Two overlapping puts whose volumes sum to the ROI volume but leave
    a hole: the old per-chunk counters accepted this and served zeros."""
    from repro_torch.storage import DiskStorage

    disk = DiskStorage(str(tmp_path), name="DISK")
    a = np.ones((32, 64), np.float32)
    disk.put(_key("hole"), BoundingBox((0, 0), (32, 64)), a)
    disk.put(_key("hole"), BoundingBox((16, 0), (48, 64)), a)
    # chunk volumes sum to 64*64 == DOM volume, but rows 48..64 are a hole
    with pytest.raises(KeyError):
        disk.get(_key("hole"), DOM)
    got = disk.get(_key("hole"), BoundingBox((0, 0), (48, 64)))
    assert (got == 1).all()


def test_dms_partial_coverage_still_raises(group):
    """Same contract over both transports: holes surface as KeyError."""
    for tr in (InProcTransport(4), group.transport()):
        dms = DistributedMemoryStorage(DOM, (16, 16), 4, transport=tr)
        a = np.ones((32, 64), np.float32)
        dms.put(_key("hole"), BoundingBox((0, 0), (32, 64)), a)
        dms.put(_key("hole"), BoundingBox((16, 0), (48, 64)), a)
        # covered rows: 0..48 of 64 -> full-domain read must fail
        with pytest.raises(KeyError):
            dms.get(_key("hole"), DOM)
        got = dms.get(_key("hole"), BoundingBox((0, 0), (48, 64)))
        assert (got == 1).all()
        dms.delete(_key("hole"))
        dms.close()


# ---------------------------------------------------------------------------
# shared-memory data plane: negotiation, zero-copy views, promotion,
# exhaustion fallback
# ---------------------------------------------------------------------------
def test_shm_negotiation_moves_payloads_off_the_wire(group):
    """A co-located client that negotiates shm fetches blocks out of the
    server arena: stats count the fetch raw bytes in full while the wire
    carries only the block ref (order-of-magnitude smaller)."""
    tr = group.transport(shm="require")
    key = _key("shmneg")
    box = BoundingBox((0, 0), (64, 64))
    payload = np.random.default_rng(21).random((64, 64)).astype(np.float32)
    try:
        tr.store(0, key, (0, 0), box, payload)
        tr.reset()
        got = tr.fetch(0, key, (0, 0))
        np.testing.assert_array_equal(got, payload)
        assert tr.stats.shm_gets == 1
        assert tr.stats.bytes_get_raw >= payload.nbytes
        assert tr.stats.bytes_get < payload.nbytes // 4  # ref, not payload
        # default mode hands out private copies: scribbling is safe
        got[0, 0] = -99.0
        np.testing.assert_array_equal(tr.fetch(0, key, (0, 0)), payload)
    finally:
        tr.drop(0, key)
        tr.close()


def test_shm_zero_copy_views_are_read_only(group):
    """zero_copy=True maps the arena block directly: the view is
    read-only (the store stays uncorruptible) and still bit-exact."""
    tr = group.transport(shm="require", zero_copy=True)
    key = _key("shmzc")
    box = BoundingBox((0, 0), (64, 64))
    payload = np.random.default_rng(22).random((64, 64)).astype(np.float32)
    try:
        tr.store(1, key, (0, 0), box, payload)
        got = tr.fetch(1, key, (0, 0))
        np.testing.assert_array_equal(got, payload)
        with pytest.raises(ValueError):
            got[0, 0] = 1.0
        # scatter-gather rides the same plane
        tr.store(1, key, (1, 0), box, 2 * payload)
        many = tr.fetch_many(1, [(key, (0, 0)), (key, (1, 0))])
        np.testing.assert_array_equal(many[0], payload)
        np.testing.assert_array_equal(many[1], 2 * payload)
        assert tr.stats.shm_gets >= 3
    finally:
        tr.drop(1, key)
        tr.close()


def test_shm_promotion_on_fetch_from_plain_store(group):
    """Blocks stored by a plain client are promoted into the arena when
    an shm client fetches them — the data plane is per-reader, not
    per-writer."""
    plain = group.transport()
    shm = group.transport(shm="require")
    key = _key("promote")
    box = BoundingBox((0, 0), (32, 32))
    payload = np.random.default_rng(23).random((32, 32)).astype(np.float32)
    try:
        plain.store(2, key, (0, 0), box, payload)
        got = shm.fetch(2, key, (0, 0))
        np.testing.assert_array_equal(got, payload)
        assert shm.stats.shm_gets == 1
    finally:
        plain.drop(2, key)
        plain.close()
        shm.close()


def test_dms_bit_exact_over_shm_transport(group):
    """Full DMS put/get over the shm data plane matches the array."""
    dms = DistributedMemoryStorage(
        DOM, (16, 16), 4, transport=group.transport(shm="require")
    )
    arr = np.random.default_rng(25).random((64, 64)).astype(np.float32)
    dms.put(_key("shmdms"), DOM, arr)
    np.testing.assert_array_equal(dms.get(_key("shmdms"), DOM), arr)
    roi = BoundingBox((5, 9), (61, 47))
    np.testing.assert_array_equal(dms.get(_key("shmdms"), roi), arr[roi.slices()])
    assert dms.transport.stats.shm_gets > 0
    dms.delete(_key("shmdms"))
    dms.close()


# ---------------------------------------------------------------------------
# wire codecs over live servers + mixed codec-vs-plain fleets
# ---------------------------------------------------------------------------
def _codec_arrays(rng):
    import jax.numpy as jnp

    return {
        "f32": rng.random((32, 32)).astype(np.float32),
        "f16": rng.random((16, 16)).astype(np.float16),
        "bf16": np.asarray(jnp.arange(64, dtype=jnp.bfloat16).reshape(8, 8)),
        "u8_labels": rng.integers(0, 8, (64, 64)).astype(np.uint8),
        "empty": np.zeros((0, 5), np.float32),
        "noncontig": rng.random((8, 8, 8)).astype(np.float64)[:, ::2, :],
        "bool": rng.random((16, 16)) > 0.5,
    }


@pytest.mark.parametrize("codec", ["zlib", "bf16", "int8"])
def test_wire_codec_roundtrip_over_socket(group, codec):
    """Every codec round-trips every dtype over a live fleet: lossless
    codecs bit-exact, lossy ones within tolerance on f32/f64 and
    bit-exact on everything else (they degrade to zlib off-dtype)."""
    tr = group.transport(wire_codec=codec)
    box = BoundingBox((0, 0), (64, 64))
    arrays = _codec_arrays(np.random.default_rng(26))
    key = _key(f"codec_{codec}")
    try:
        for i, (name, arr) in enumerate(arrays.items()):
            tr.store(0, key, (i, 0), box, arr)
            got = tr.fetch(0, key, (i, 0))
            assert got.dtype == arr.dtype, name
            assert got.shape == arr.shape, name
            lossy = (
                arr.size > 0
                and codec in ("bf16", "int8")
                and arr.dtype in (np.float32, np.float64)
            )
            if lossy:
                atol = 0.02 if codec == "bf16" else float(np.abs(arr).max()) / 127 + 1e-6
                np.testing.assert_allclose(
                    got.astype(np.float64), arr.astype(np.float64), atol=atol
                )
            else:
                np.testing.assert_array_equal(got, arr)
        # the whole matrix again through scatter-gather
        many = tr.fetch_many(0, [(key, (i, 0)) for i in range(len(arrays))])
        for got, arr in zip(many, arrays.values()):
            assert got.dtype == arr.dtype and got.shape == arr.shape
    finally:
        tr.drop(0, key)
        tr.close()


def test_zlib_codec_reduces_wire_bytes_on_label_tiles(group):
    """The acceptance claim at test scale: compressible uint8 label
    tiles move >=30% fewer wire bytes than raw under the zlib codec,
    bit-exact."""
    tr = group.transport(wire_codec="zlib")
    key = _key("labels")
    box = BoundingBox((0, 0), (64, 64))
    tile = np.kron(
        np.random.default_rng(27).integers(0, 8, (8, 8)).astype(np.uint8),
        np.ones((8, 8), np.uint8),
    )
    try:
        tr.store(3, key, (0, 0), box, tile)
        tr.reset()
        got = tr.fetch(3, key, (0, 0))
        np.testing.assert_array_equal(got, tile)
        assert tr.stats.bytes_get_raw >= tile.nbytes
        assert tr.stats.bytes_get < 0.7 * tr.stats.bytes_get_raw
    finally:
        tr.drop(3, key)
        tr.close()


def test_epoch_gossip_bootstraps_fresh_clients(group):
    """Membership changes announced to the fleet are served back to any
    client that asks (epoch op + adopt-newer), so a fresh client joins
    the current epoch without an out-of-band config push."""
    tr = group.transport(scope="gossip", connect_timeout=5.0, op_timeout=20.0)
    dms = DistributedMemoryStorage(DOM, (16, 16), transport=tr, replication=2)
    assert dms.epoch == 0
    view = dms.membership.leave(3)
    dms._ring = view  # simulate an admin change on THIS client...
    dms._announce("leave", 3, view.to_json())
    late = DistributedMemoryStorage(
        DOM, (16, 16),
        transport=group.transport(scope="gossip", connect_timeout=5.0),
        replication=2,
    )
    assert late.epoch == 0
    late.sync_membership()  # ...which the late client learns by gossip
    assert late.epoch == 1
    assert late.membership == view
    late.close()
    dms.close()


# ---------------------------------------------------------------------------
# per-key wire codecs (glob map negotiated per connection)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the wire between the two packages: one protocol, either side
# ---------------------------------------------------------------------------
def test_server_process_spawns_the_ports_server(group):
    """The port's fleet runs ``python -m repro_torch.storage.net``, which
    imports neither JAX nor the JAX package."""
    for sp in group.procs:
        assert sp.proc is not None and sp.proc.poll() is None
        argv = sp.proc.args
        assert argv[argv.index("-m") + 1] == "repro_torch.storage.net"
    code = (
        "import sys, repro_torch.storage.net\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'ml_dtypes'))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    import subprocess
    import sys

    from repro_torch.storage.net import _src_root

    env = {**os.environ, "PYTHONPATH": _src_root()}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _interop_blocks():
    rng = np.random.default_rng(41)
    return {
        "f32": rng.random((16, 16)).astype(np.float32),
        "i32": rng.integers(-1, 1000, (16, 16)).astype(np.int32),
        "u8": rng.integers(0, 2, (16, 16)).astype(np.uint8),
    }


def _wire_round_trip(transport_cls, endpoints, dms_cls, bbox_cls, key_cls, etype, shm):
    """Store blocks through one package's client on ``endpoints``, read them
    back block by block and through a DMS; returns the bytes read."""
    tr = transport_cls(endpoints, shm=shm, scope=f"interop-{shm}")
    out = {}
    try:
        for name, arr in _interop_blocks().items():
            key = key_cls("interop", name, etype.FLOAT32, 0)
            tr.store(0, key, (0, 0), bbox_cls((0, 0), arr.shape), arr)
            out[name] = np.asarray(tr.fetch(0, key, (0, 0))).tobytes()
        dom = bbox_cls((0, 0), (32, 32))
        dms = dms_cls(dom, (16, 16), len(endpoints), transport=tr)
        full = np.arange(32 * 32, dtype=np.float32).reshape(32, 32)
        key = key_cls("interop", "dms", etype.FLOAT32, 0)
        dms.put(key, dom, full)
        out["dms"] = dms.get(key, bbox_cls((3, 5), (29, 31))).tobytes()
        for sid in range(tr.num_servers):
            for k in tr.keys(sid):
                tr.drop(sid, k)
    finally:
        tr.close()
    return out


@pytest.mark.parametrize("shm", ["off", "auto"])
def test_wire_interop_between_the_packages(group, shm):
    """The port's ``SocketTransport`` on a ``python -m repro.storage.net``
    server and the JAX package's on the port's fleet move the same bytes."""
    import repro.core as jcore
    import repro.storage as jstorage
    import repro_torch.core as tcore
    import repro_torch.storage as tstorage

    want = {name: arr.tobytes() for name, arr in _interop_blocks().items()}
    want["dms"] = np.arange(32 * 32, dtype=np.float32).reshape(32, 32)[3:29, 5:31].tobytes()
    jgroup = jstorage.spawn_servers(2, processes=1)
    try:
        assert jgroup.procs[0].proc.args[jgroup.procs[0].proc.args.index("-m") + 1] == (
            "repro.storage.net")
        port_on_jax = _wire_round_trip(tstorage.SocketTransport, jgroup.endpoints,
                                       tstorage.DistributedMemoryStorage, tcore.BoundingBox,
                                       tcore.RegionKey, tcore.ElementType, shm)
    finally:
        jgroup.close()
    jax_on_port = _wire_round_trip(jstorage.SocketTransport, group.endpoints,
                                   jstorage.DistributedMemoryStorage, jcore.BoundingBox,
                                   jcore.RegionKey, jcore.ElementType, shm)
    assert port_on_jax == want
    assert jax_on_port == want
