"""The port's near-data compute (``repro_torch.serve.compute``) on the
CPU: the cases of ``tests/test_compute.py`` — chain registry validation
(typed fail-fast errors), gateway compute() exactness vs local fetch +
chain, compute-ROI coalescing, the generation-validated derived cache, and
make_wsi_storage(compute=True) — with every gateway and chain on
``device="cpu"`` (the plain versions); then the JAX package's gateways and
the port's on stores filled with the same tiles, answer for answer. The
chains' own parity with the JAX package is ``tests/test_torch_chains.py``."""
import sys
import threading

import numpy as np
import pytest

from repro_torch.core import BoundingBox, ElementType, RegionKey
from repro_torch.kernels import ref
from repro_torch.kernels.chains import (
    STANDARD_CHAINS,
    ChainParamError,
    UnknownChainError,
    list_stages,
    resolve_chain,
)
from repro_torch.serve import ComputeRequest, RegionGateway
from repro_torch.serve.gateway import GatewayConfig
from repro_torch.storage import DistributedMemoryStorage, Tier, TieredStore

H = W = 128
DOM3 = BoundingBox((0, 0, 0), (3, H, W))
TILE3 = (3, 32, 32)


def _key(name="RGB"):
    return RegionKey("nd", name, ElementType.FLOAT32)


def _stain_rgb(h, w, seed=0) -> np.ndarray:
    """Synthetic H&E-like tile via the *forward* Ruifrok model: blobby
    hematoxylin density in {0.15, 0.85} so the deconvolved plane is
    bimodal and thresholding is far from any decision boundary (chains
    stay bit-stable across impls)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    blobs = np.zeros((h, w), bool)
    for _ in range(6):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = rng.integers(6, 14)
        blobs |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    density = np.where(blobs, 0.85, 0.15).astype(np.float32)
    stains = np.stack([density, np.full_like(density, 0.05), np.full_like(density, 0.02)])
    m = ref.RUIFROK_HED / np.linalg.norm(ref.RUIFROK_HED, axis=1, keepdims=True)
    od = np.einsum("shw,sc->chw", stains, m)
    return (10.0 ** -od).astype(np.float32)


def _store() -> tuple[TieredStore, np.ndarray]:
    dms = DistributedMemoryStorage(DOM3, TILE3, 4)
    store = TieredStore([Tier("DMS", dms)], name="NDC")
    slide = _stain_rgb(H, W)
    for tile in DOM3.tiles(TILE3):
        store.put(_key(), tile, slide[tile.slices()])
    return store, slide


# ---------------------------------------------------------------------------
# chain registry + ref-vs-Pallas
# ---------------------------------------------------------------------------
def test_chain_digest_canonicalizes_params():
    base = resolve_chain("deconv|threshold")
    defaulted = resolve_chain("deconv|threshold", {"thr": 0.5, "norm": True})
    assert base.digest() == defaulted.digest()
    assert base.digest() != resolve_chain("deconv|threshold", {"thr": 0.4}).digest()
    assert set(list_stages()) >= {"deconv", "threshold", "fill", "ccl", "count", "glcm"}


def test_typed_errors_fail_fast():
    with pytest.raises(UnknownChainError, match="nope"):
        resolve_chain("deconv|nope")
    with pytest.raises(UnknownChainError):
        resolve_chain("")
    with pytest.raises(ChainParamError, match="thr"):
        resolve_chain("deconv|threshold", {"thr": 1.5})
    with pytest.raises(ChainParamError, match="unknown param"):
        resolve_chain("deconv", {"bogus": 1})
    with pytest.raises(ChainParamError, match="host reduction"):
        resolve_chain("deconv|threshold|ccl|count|threshold")  # host stage mid-chain
    with pytest.raises(ChainParamError):
        resolve_chain("deconv|threshold", {"stain": -1})  # rank-3 out feeds rank-2 stage


# ---------------------------------------------------------------------------
# gateway compute(): exactness, fail-fast, coalescing
# ---------------------------------------------------------------------------
def test_gateway_compute_matches_local_fetch_plus_chain_exactly():
    store, slide = _store()
    gw = RegionGateway(store, config=GatewayConfig(workers=2), device="cpu")
    rois = [
        BoundingBox((0, 0, 0), (3, 64, 64)),
        BoundingBox((0, 32, 48), (3, 96, 128)),
    ]
    for name in ("deconv|threshold", "deconv|threshold|ccl", "deconv|threshold|ccl|count"):
        chain = resolve_chain(name)
        for roi in rois:
            got = gw.compute(_key(), roi, name)
            want = chain(store.get(_key(), roi), impl=gw.config.compute_impl, device="cpu")
            np.testing.assert_array_equal(got, want)  # bit-exact, same impl
            np.testing.assert_array_equal(
                got, chain(slide[roi.slices()], impl=gw.config.compute_impl, device="cpu")
            )
    stats = gw.stats.as_dict()
    assert stats["compute_served"] == stats["compute_requests"] > 0
    assert stats["raw_fetch_bytes"] > stats["derived_reply_bytes"]
    gw.close()


def test_submit_compute_typed_errors_raise_before_queueing():
    store, _ = _store()
    gw = RegionGateway(store, config=GatewayConfig(workers=1), device="cpu")
    roi = BoundingBox((0, 0, 0), (3, 32, 32))
    with pytest.raises(UnknownChainError):
        gw.submit_compute(_key(), roi, "no_such_chain")
    with pytest.raises(ChainParamError):
        gw.submit_compute(_key(), roi, "deconv|threshold", {"thr": 7.0})
    with pytest.raises(ChainParamError, match="rank"):
        gw.submit_compute(_key(), BoundingBox((0, 0), (32, 32)), "deconv")
    with pytest.raises(TypeError):
        gw.submit_compute(_key(), roi)  # chain missing
    assert gw.stats.compute_requests == 0  # nothing was admitted
    assert gw.queue_depth() == 0
    gw.close()


def test_compute_coalesces_overlapping_rois_one_window_fetch():
    """Overlapping compute ROIs merge into ONE store window fetch (fewer
    transport frames than naive per-ROI reads) while each member's chain
    still runs on its own slice — results stay bit-exact."""
    store, slide = _store()
    transport = store.tiers[0].backend.transport
    chain = resolve_chain("deconv|threshold")
    rois = [BoundingBox((0, 0, x), (3, 32, x + 32)) for x in range(0, 65, 16)]

    transport.reset()
    for roi in rois:
        store.get(_key(), roi)
    naive_frames = transport.stats.gets + transport.stats.meta_msgs

    gw = RegionGateway(
        store, config=GatewayConfig(workers=1, batch_window=16, compute_cache_bytes=0),
        device="cpu"
    )
    gw.pause()  # queue the burst so one drain coalesces it
    tickets = [gw.submit_compute(_key(), roi, "deconv|threshold") for roi in rois]
    transport.reset()
    gw.resume()
    outs = [t.result(60.0) for t in tickets]
    gw_frames = transport.stats.gets + transport.stats.meta_msgs

    for roi, out in zip(rois, outs):
        np.testing.assert_array_equal(
            out, chain(slide[roi.slices()], impl=gw.config.compute_impl, device="cpu")
        )
    assert gw_frames < naive_frames, (gw_frames, naive_frames)
    assert gw.stats.compute_windows < len(rois)
    assert gw.stats.compute_coalesced >= len(rois)
    assert gw.stats.compute_window_fallbacks == 0
    gw.close()


def test_mixed_reads_and_computes_drain_into_separate_batches():
    """A read and a compute on the same key must not batch together (a
    window fetch answers reads; a kernel chain answers computes)."""
    store, slide = _store()
    gw = RegionGateway(store, config=GatewayConfig(workers=1), device="cpu")
    roi = BoundingBox((0, 0, 0), (3, 48, 48))
    chain = resolve_chain("deconv|threshold")
    gw.pause()
    t_read = gw.submit(_key(), roi)
    t_comp = gw.submit_compute(ComputeRequest(_key(), roi, "deconv|threshold"))
    gw.resume()
    np.testing.assert_array_equal(t_read.result(30.0), slide[roi.slices()])
    np.testing.assert_array_equal(
        t_comp.result(60.0), chain(slide[roi.slices()], impl=gw.config.compute_impl, device="cpu")
    )
    assert gw.stats.batches == 2
    assert gw.stats.served == 1 and gw.stats.compute_served == 1
    gw.close()


def test_reduced_chain_returns_feature_vector_not_region():
    store, slide = _store()
    gw = RegionGateway(store, config=GatewayConfig(workers=1), device="cpu")
    roi = BoundingBox((0, 0, 0), (3, H, W))
    count = gw.compute(_key(), roi, "deconv|threshold|ccl|count")
    assert count.shape == (1,) and count.dtype == np.int32
    chain = resolve_chain("deconv|threshold|ccl|count")
    np.testing.assert_array_equal(
        count, chain(slide, impl=gw.config.compute_impl, device="cpu")
    )
    assert count[0] > 0  # the blobs are there
    s = gw.stats.as_dict()
    assert s["raw_fetch_bytes"] >= 100 * s["derived_reply_bytes"]  # 4 B back
    gw.close()


# ---------------------------------------------------------------------------
# derived-product cache: hits, put-generation invalidation
# ---------------------------------------------------------------------------
def test_derived_cache_hits_and_invalidation_paths():
    store, slide = _store()
    gw = RegionGateway(store, config=GatewayConfig(workers=1), device="cpu")
    roi = BoundingBox((0, 0, 0), (3, 64, 64))
    chain = resolve_chain("deconv|threshold")

    first = gw.compute(_key(), roi, "deconv|threshold")
    again = gw.compute(_key(), roi, "deconv|threshold")
    np.testing.assert_array_equal(first, again)
    assert not np.shares_memory(first, again)  # callers never alias the cache
    assert gw.stats.compute_cache_hits == 1

    # a put THROUGH the gateway invalidates
    slide2 = slide.copy()
    slide2[:, :64, :64] = _stain_rgb(64, 64, seed=9)
    gw.put(_key(), BoundingBox((0, 0, 0), (3, 64, 64)), slide2[:, :64, :64])
    got = gw.compute(_key(), roi, "deconv|threshold")
    np.testing.assert_array_equal(
        got, chain(slide2[roi.slices()], impl=gw.config.compute_impl, device="cpu")
    )
    assert gw.stats.compute_cache_hits == 1  # miss: recomputed

    # a put BYPASSING the gateway is caught by TieredStore.generation
    gw.compute(_key(), roi, "deconv|threshold")  # re-warm (hit #2)
    assert gw.stats.compute_cache_hits == 2
    store.put(_key(), BoundingBox((0, 0, 0), (3, 64, 64)), slide[:, :64, :64])
    got = gw.compute(_key(), roi, "deconv|threshold")
    np.testing.assert_array_equal(
        got, chain(slide[roi.slices()], impl=gw.config.compute_impl, device="cpu")
    )
    assert gw.stats.compute_cache_hits == 2  # stale entry was a miss

    # different params -> different digest -> no false sharing
    gw.compute(_key(), roi, "deconv|threshold", {"thr": 0.4})
    assert gw.stats.compute_cache_hits == 2
    cache = gw.storage_stats()["compute"]["cache"]
    assert cache["entries"] >= 2 and cache["hits"] == 2
    gw.close()


def test_delete_invalidates_derived_products():
    store, _ = _store()
    gw = RegionGateway(store, config=GatewayConfig(workers=1), device="cpu")
    roi = BoundingBox((0, 0, 0), (3, 32, 32))
    gw.compute(_key(), roi, "deconv")
    gw.delete(_key())
    assert gw.storage_stats()["compute"]["cache"]["entries"] == 0
    with pytest.raises(KeyError):
        gw.compute(_key(), roi, "deconv")  # no ghost answers from the cache
    gw.close()


def test_cache_disabled_with_zero_budget():
    store, _ = _store()
    gw = RegionGateway(
        store, config=GatewayConfig(workers=1, compute_cache_bytes=0),
        device="cpu"
    )
    roi = BoundingBox((0, 0, 0), (3, 32, 32))
    gw.compute(_key(), roi, "deconv")
    gw.compute(_key(), roi, "deconv")
    assert gw.stats.compute_cache_hits == 0
    gw.close()


def test_concurrent_computes_and_writes_never_serve_stale(  # hammer
):
    """Writers flip the region between two versions while readers
    compute(); every answer must match ONE of the two versions' local
    chain output — never a mix and never a stale post-write hit that
    predates both. A chain here is many eager torch calls, each releasing
    the interpreter lock, so the switch interval is shortened: a reader
    then retakes the lock from the spinning writer in 0.1 ms, not 5."""
    store, slide = _store()
    gw = RegionGateway(store, config=GatewayConfig(workers=2), device="cpu")
    roi = BoundingBox((0, 0, 0), (3, 32, 32))
    chain = resolve_chain("deconv|threshold")
    v0 = slide[:, :32, :32].copy()
    v1 = _stain_rgb(32, 32, seed=7)
    want0 = chain(v0, impl=gw.config.compute_impl, device="cpu")
    want1 = chain(v1, impl=gw.config.compute_impl, device="cpu")
    box = BoundingBox((0, 0, 0), (3, 32, 32))
    errors = []
    stop = threading.Event()

    def writer():
        flip = False
        while not stop.is_set():
            gw.put(_key(), box, v1 if flip else v0)
            flip = not flip

    def reader():
        try:
            for _ in range(30):
                got = gw.compute(_key(), roi, "deconv|threshold")
                if not (np.array_equal(got, want0) or np.array_equal(got, want1)):
                    raise AssertionError("served a torn/stale derived product")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    w = threading.Thread(target=writer)
    readers = [threading.Thread(target=reader) for _ in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        w.start()
        for t in readers:
            t.start()
        for t in readers:
            t.join(timeout=120)
    finally:
        stop.set()
        w.join(timeout=10)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in readers + [w])
    assert not errors, errors
    gw.close()


# ---------------------------------------------------------------------------
# wiring
# ---------------------------------------------------------------------------
def test_make_wsi_storage_compute_implies_serving_gateways():
    from repro_torch.pipeline import make_wsi_storage

    reg = make_wsi_storage(64, 64, mode="tiered", compute=True, tile=32, device="cpu")
    gw3 = reg.get("DMS3")
    assert isinstance(gw3, RegionGateway)
    key = RegionKey("t", "RGB", ElementType.FLOAT32)
    dom3 = BoundingBox((0, 0, 0), (3, 64, 64))
    rgb = _stain_rgb(64, 64, seed=5)
    gw3.put(key, dom3, rgb)
    chain = resolve_chain("deconv|threshold")
    got = gw3.compute(key, dom3, "deconv|threshold")
    np.testing.assert_array_equal(got, chain(rgb, impl=gw3.config.compute_impl, device="cpu"))
    assert "compute" in gw3.storage_stats()
    for name in ("DMS3", "DMS2"):
        reg.get(name).close()


# ---------------------------------------------------------------------------
# the JAX package's gateway and the port's, on the same tiles
# ---------------------------------------------------------------------------
def _keyset(d, prefix=()):
    """Every key path of nested dicts."""
    out = set()
    for k, v in d.items():
        out.add(prefix + (k,))
        if isinstance(v, dict):
            out |= _keyset(v, prefix + (k,))
    return out


@pytest.mark.parametrize("name", ["deconv", "deconv|threshold", "deconv|threshold|fill",
                                  "deconv|threshold|ccl|count"])
def test_gateway_compute_equals_the_reference_gateways(name):
    """The JAX package's gateway (``compute_impl="auto"``: its jnp
    references on the CPU) and the port's (the plain versions on the CPU)
    return equal arrays for the same ROIs of the same tiles, count the
    same requests, hits, windows and bytes, and report stats with the same
    keys."""
    import repro.core as jcore
    import repro.serve as jserve
    import repro.storage as jstorage
    import repro_torch.core as tcore
    import repro_torch.serve as tserve
    import repro_torch.storage as tstorage

    slide = _stain_rgb(H, W, seed=4)
    runs = {}
    for pkg, (core, serve, storage, kw) in {
        "jax": (jcore, jserve, jstorage, {}),
        "torch": (tcore, tserve, tstorage, {"device": "cpu"}),
    }.items():
        dom = core.BoundingBox((0, 0, 0), (3, H, W))
        store = storage.TieredStore(
            [storage.Tier("DMS", storage.DistributedMemoryStorage(dom, TILE3, 4))], name="NDC")
        key = core.RegionKey("nd", "RGB", core.ElementType.FLOAT32)
        for tile in dom.tiles(TILE3):
            store.put(key, tile, slide[tile.slices()])
        gw = serve.RegionGateway(store, config=serve.GatewayConfig(workers=1), **kw)
        rois = [core.BoundingBox((0, 0, 0), (3, 64, 64)),
                core.BoundingBox((0, 32, 48), (3, 96, 128)), dom]
        outs = [gw.compute(key, roi, name) for roi in rois]
        outs.append(gw.compute(key, rois[0], name))  # a derived-cache hit
        runs[pkg] = (outs, gw.storage_stats())
        gw.close()
    (t_outs, t_stats), (j_outs, j_stats) = runs["torch"], runs["jax"]
    for got, want in zip(t_outs, j_outs):
        assert got.shape == want.shape and got.dtype == want.dtype
        if name == "deconv":
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        else:
            np.testing.assert_array_equal(got, want)
    assert _keyset(t_stats) == _keyset(j_stats)
    t_gw, j_gw = t_stats["gateway"], j_stats["gateway"]
    assert {k: v for k, v in t_gw.items() if k != "compute"} == {
        k: v for k, v in j_gw.items() if k != "compute"}
    t_row, j_row = t_gw["compute"]["chains"][name], j_gw["compute"]["chains"][name]
    assert {k: v for k, v in t_row.items() if k != "compute_ms"} == {
        k: v for k, v in j_row.items() if k != "compute_ms"}
    assert t_gw["compute"]["cache"] == j_gw["compute"]["cache"]
