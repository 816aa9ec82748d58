"""How the port's region stores decide that a read is whole.

A read that one block of an in-process DMS contains is that block's
read-only view: it is covered by the block's box, so the store builds and
scans no ROI-sized mask for it, and ``copies.stats()`` counts it under
``get_views``. A read assembled from several pieces counts the cells its
pieces cover with one mask, so overlapping pieces are counted once; a read
they cover only in part raises ``KeyError`` with the true count, in every
store. At replication 2 a partial directory answer is still healed by the
union of two directories."""
import numpy as np
import pytest

from repro_torch.core import BoundingBox, ElementType, RegionKey
from repro_torch.storage import (
    DiskStorage,
    DistributedMemoryStorage,
    InProcTransport,
    MemoryTier,
    TieredStore,
    copies,
)
from repro_torch.storage.tiers import _assemble

DOM = BoundingBox((0, 0), (64, 64))
BLOCK = (16, 64)  # row bands: each block of a C-ordered array is contiguous
ONE_BLOCK = BoundingBox((16, 0), (32, 64))
INSIDE = BoundingBox((18, 0), (30, 64))  # whole rows inside ONE_BLOCK: contiguous
# two overlapping pieces: rows [0, 32) and [16, 48), 48 of 64 rows together
PIECE_A, PIECE_B = BoundingBox((0, 0), (32, 64)), BoundingBox((16, 0), (48, 64))
COVERED = 48 * 64
STITCHED = BoundingBox((8, 4), (40, 60))  # needs both pieces


def _key(name: str = "X") -> RegionKey:
    return RegionKey("t", name, ElementType.FLOAT32, 0, 0)


def _data(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).random(DOM.shape, dtype=np.float32)


@pytest.fixture(autouse=True)
def _counts():
    copies.reset_stats()
    yield
    copies.reset_stats()


def _resident_blocks(dms: DistributedMemoryStorage) -> list[np.ndarray]:
    return [blk for srv in dms.transport.servers for blk in srv._blocks.values()]


# ---------------------------------------------------------------------------
# The view path: one block contains the read
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("roi", [ONE_BLOCK, INSIDE], ids=["the-block", "inside"])
def test_a_one_block_get_is_a_read_only_view_of_the_stored_block(roi):
    dms = DistributedMemoryStorage(DOM, BLOCK, 2)
    a = _data(1)
    dms.put(_key(), DOM, a)
    copies.reset_stats()
    got = dms.get(_key(), roi)
    assert not got.flags.writeable
    assert any(np.shares_memory(got, blk) for blk in _resident_blocks(dms))
    assert np.shares_memory(got, dms.get(_key(), roi))
    np.testing.assert_array_equal(got, a[roi.slices()])
    with pytest.raises(ValueError):
        got.setflags(write=True)


def test_a_one_block_get_counts_one_view_and_no_copy():
    dms = DistributedMemoryStorage(DOM, BLOCK, 2)
    dms.put(_key(), DOM, _data(2))
    copies.reset_stats()
    for n in (1, 2, 3):
        dms.get(_key(), ONE_BLOCK)
        assert copies.stats() == {"put_copies": 0, "put_bytes": 0, "get_copies": 0,
                                  "get_bytes": 0, "get_views": n}


@pytest.mark.parametrize("shape, part", [
    ((64, 64), BoundingBox((16, 0), (32, 64))),  # whole rows
    ((3, 64, 64), BoundingBox((1, 0, 0), (2, 64, 64))),  # one channel
], ids=["plane", "rgb"])
def test_the_view_answer_is_the_roi_volume_not_a_mask(shape, part):
    box = BoundingBox((0,) * len(shape), shape)
    block = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    block.setflags(write=False)
    for roi in (box, part):
        out, covered = _assemble([(box, block)], roi, share=True)
        assert type(covered) is int and covered == roi.volume
        assert np.shares_memory(out, block)
        np.testing.assert_array_equal(out, block[roi.slices()])
    assert copies.stats()["get_views"] == 2 and copies.stats()["get_copies"] == 0


def test_without_share_one_block_is_copied_and_counted_by_its_mask():
    block = _data(3)
    block.setflags(write=False)
    out, covered = _assemble([(DOM, block)], ONE_BLOCK)
    assert type(covered) is int and covered == ONE_BLOCK.volume
    assert out.flags.writeable and not np.shares_memory(out, block)
    assert copies.stats()["get_copies"] == 1 and copies.stats()["get_views"] == 0


def test_overlapping_pieces_are_counted_once():
    a = _data(4)
    pieces = [(bb, a[bb.slices()]) for bb in (PIECE_A, PIECE_B, PIECE_A)]
    out, covered = _assemble(pieces, DOM)
    assert covered == COVERED
    np.testing.assert_array_equal(out[:48], a[:48])
    assert not out[48:].any()
    assert _assemble([(PIECE_A, a[PIECE_A.slices()])], BoundingBox((40, 0), (64, 64))) == (None, 0)


# ---------------------------------------------------------------------------
# Reads from several pieces, in every store
# ---------------------------------------------------------------------------
def _dms(tmp_path):
    return DistributedMemoryStorage(DOM, BLOCK, 2), None


def _memory(tmp_path):
    return MemoryTier(), None


def _disk(tmp_path):
    store = DiskStorage(str(tmp_path / "disk"))
    return store, store.close


def _tiered(tmp_path):
    store = TieredStore([("MEM", MemoryTier()), ("DISK", DiskStorage(str(tmp_path / "tiered")))])
    return store, store.close  # closes its tiers too


def _put_pieces(store, a: np.ndarray) -> None:
    """PIECE_A and PIECE_B of ``a``; a tiered store gets one in each tier,
    so only the hierarchy together covers them."""
    if isinstance(store, TieredStore):
        store.tiers[0].backend.put(_key(), PIECE_A, a[PIECE_A.slices()])
        store.tiers[1].backend.put(_key(), PIECE_B, a[PIECE_B.slices()])
        store.tiers[1].backend.flush()
        return
    for bb in (PIECE_A, PIECE_B):
        store.put(_key(), bb, a[bb.slices()])
    if isinstance(store, DiskStorage):
        store.flush()


STORES = {
    "dms": (_dms, f"covers only {COVERED}/{DOM.volume} cells of"),
    "memory": (_memory, f"covers only {COVERED}/{DOM.volume} of"),
    "disk": (_disk, f"covers only {COVERED}/{DOM.volume} of"),
    "tiered": (_tiered, "no tier holds"),  # its message names no count
}


@pytest.mark.parametrize("kind", list(STORES))
def test_a_partly_covered_read_raises_with_the_true_count(tmp_path, kind):
    make, message = STORES[kind]
    store, close = make(tmp_path)
    try:
        _put_pieces(store, _data(5))
        with pytest.raises(KeyError, match=message):
            store.get(_key(), DOM)
        with pytest.raises(KeyError):  # no piece there at all
            store.get(_key(), BoundingBox((50, 0), (64, 64)))
    finally:
        if close:
            close()


@pytest.mark.parametrize("kind", list(STORES))
def test_a_read_stitched_from_two_pieces_is_a_fresh_array_of_the_right_bytes(tmp_path, kind):
    make, _ = STORES[kind]
    store, close = make(tmp_path)
    a = _data(6)
    try:
        _put_pieces(store, a)
        copies.reset_stats()
        got = store.get(_key(), STITCHED)
        np.testing.assert_array_equal(got, a[STITCHED.slices()])
        assert got.flags.writeable and got.flags.owndata
        assert copies.stats()["get_views"] == 0 and copies.stats()["get_copies"] >= 1
    finally:
        if close:
            close()


# ---------------------------------------------------------------------------
# Replication 2: a partial directory answer is healed by the union
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("roi", [DOM, INSIDE], ids=["across-blocks", "in-the-lost-block"])
def test_a_partial_directory_is_repaired_by_the_union(roi):
    """Server 0's directory loses the entry of the block that holds
    ``INSIDE``, as a rejoined server's would. Reads rotate over both
    directories; those that start at server 0 find a hole, the union of
    two directories fills it, and every read returns the stored bytes."""
    transport = InProcTransport(2)
    dms = DistributedMemoryStorage(DOM, BLOCK, transport=transport, replication=2)
    a = _data(7)
    dms.put(_key(), DOM, a)
    meta = transport.servers[0]._meta[_key()]
    lost = next(bc for bc, (box, _) in meta.items() if box.contains(INSIDE))
    del meta[lost]
    for _ in range(4):
        got = dms.get(_key(), roi)
        np.testing.assert_array_equal(got, a[roi.slices()])
    assert dms.stats.directory_repairs > 0
    if roi == INSIDE:  # the healed read is still one block's view
        assert not got.flags.writeable and copies.stats()["get_views"] == 4


def test_at_replication_one_a_hole_raises_with_the_true_count():
    dms = DistributedMemoryStorage(DOM, BLOCK, 2)
    dms.put(_key(), BoundingBox((0, 0), (16, 64)), _data(8)[:16])
    dms.put(_key(), BoundingBox((32, 0), (64, 64)), _data(8)[32:])
    with pytest.raises(KeyError, match=f"covers only {48 * 64}/{DOM.volume} cells of"):
        dms.get(_key(), DOM)
    assert dms.stats.directory_repairs == 0
