"""The port's in-process region store keeps its contract while it copies less:
a caller that changes its array after ``put`` leaves what is stored as it
was; what ``get`` returns is never changed behind the caller's back (one
block covering the read comes back as a read-only view of it, which no
later put writes into); overwriting a key keeps every other key's data; and
``repro_torch.storage.copies`` counts the host bytes each side copied."""
import numpy as np
import pytest

from repro_torch.core import BoundingBox, ElementType, RegionKey
from repro_torch.storage import DistributedMemoryStorage, InProcTransport, copies

DOM = BoundingBox((0, 0), (64, 128))
BLOCK = (32, 128)  # row bands: each block of a C-ordered array is contiguous
ONE_BLOCK = BoundingBox((0, 0), (32, 128))  # exactly one block


def _key(name: str = "X", version: int = 0) -> RegionKey:
    return RegionKey("t", name, ElementType.FLOAT32, 0, version)


def _data(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random(DOM.shape, dtype=np.float32)


@pytest.fixture
def dms():
    copies.reset_stats()
    yield DistributedMemoryStorage(DOM, BLOCK, 2)
    copies.reset_stats()


@pytest.mark.parametrize("roi", [DOM, ONE_BLOCK, BoundingBox((8, 4), (40, 100))],
                         ids=["two-blocks", "one-block", "inside"])
def test_a_caller_changing_its_array_after_put_leaves_the_store_as_it_was(dms, roi):
    a = _data(1)
    want = a.copy()
    dms.put(_key(), DOM, a)
    a[:] = -1.0
    np.testing.assert_array_equal(dms.get(_key(), roi), want[roi.slices()])


def test_two_gets_of_one_region_never_alias_writably(dms):
    dms.put(_key(), DOM, _data(2))
    for roi in (ONE_BLOCK, DOM):
        one, two = dms.get(_key(), roi), dms.get(_key(), roi)
        for got in (one, two):
            if got.flags.writeable:
                assert not np.shares_memory(one, two)
            else:
                with pytest.raises(ValueError):
                    got.setflags(write=True)
                with pytest.raises(ValueError):
                    got.view().setflags(write=True)


def test_a_read_is_never_changed_by_later_puts(dms):
    """A read covered by one block is that block's view; later puts of the
    key go to other buffers while it lives, and its buffer is reused only
    once it is gone."""
    first = _data(3)
    dms.put(_key(), DOM, first)
    held = dms.get(_key(), ONE_BLOCK)
    assert not held.flags.writeable
    for seed in range(4, 8):
        dms.put(_key(), DOM, _data(seed))
        assert not np.shares_memory(held, dms.get(_key(), ONE_BLOCK))
    np.testing.assert_array_equal(held, first[ONE_BLOCK.slices()])
    np.testing.assert_array_equal(dms.get(_key(), DOM), _data(7))


def test_overwriting_a_key_keeps_every_other_keys_data(dms):
    other, other_v1 = _data(10), _data(11)
    dms.put(_key("Y"), DOM, other)
    dms.put(_key("Y", 1), DOM, other_v1)
    for seed in range(12, 18):
        dms.put(_key(), DOM, _data(seed))  # overwrites, buffers reused
        np.testing.assert_array_equal(dms.get(_key("Y"), DOM), other)
        np.testing.assert_array_equal(dms.get(_key("Y", 1), ONE_BLOCK),
                                      other_v1[ONE_BLOCK.slices()])
    np.testing.assert_array_equal(dms.get(_key(), DOM), _data(17))


def test_the_copy_counter_counts_what_moved(dms):
    a = _data(20)
    dms.put(_key(), DOM, a)  # two contiguous blocks: the store's copy of each
    assert copies.stats() == {"put_copies": 2, "put_bytes": a.nbytes,
                              "get_copies": 0, "get_bytes": 0}
    copies.reset_stats()
    dms.get(_key(), ONE_BLOCK)  # one block: its view, no copy
    assert copies.stats()["get_copies"] == 0
    roi = BoundingBox((8, 4), (40, 100))
    dms.get(_key(), roi)  # across blocks: one assembled array
    assert copies.stats() == {"put_copies": 0, "put_bytes": 0,
                              "get_copies": 1, "get_bytes": roi.volume * 4}
    copies.reset_stats()
    t = np.ascontiguousarray(a.T)  # a transposed view, cut into blocks: one copy to
    dms.put(_key("Z"), DOM, t.T)  # make each block contiguous, one to store it
    assert copies.stats()["put_copies"] == 4 and copies.stats()["put_bytes"] == 2 * a.nbytes


def test_a_fleet_that_cannot_share_its_blocks_copies_every_read():
    class Private(InProcTransport):
        shares_blocks = False

    dms = DistributedMemoryStorage(DOM, BLOCK, transport=Private(2))
    a = _data(30)
    dms.put(_key(), DOM, a)
    got = dms.get(_key(), ONE_BLOCK)
    assert got.flags.writeable and got.flags.owndata
    np.testing.assert_array_equal(got, a[ONE_BLOCK.slices()])


def test_spares_reuse_a_buffer_only_once_nothing_reads_it():
    spares = copies.Spares(keep=1)
    a = np.arange(4096, dtype=np.float32).reshape(64, 64)

    def address(x):
        return x.__array_interface__["data"][0]

    first = spares.copy(a)
    held, view = address(first), first[8:]
    del first
    second = spares.copy(a + 1)  # the view still reads the first buffer
    assert address(second) != held
    np.testing.assert_array_equal(view, a[8:])
    del view, second  # both back; one kept
    third = spares.copy(a + 2)
    assert address(third) == held
    np.testing.assert_array_equal(third, a + 2)
    assert not third.flags.writeable
    assert address(spares.copy(a)) != held  # none left free: a buffer of its own


def test_a_download_is_stored_without_a_copy_and_stays_read_only(dms):
    import torch

    t = torch.from_numpy(_data(40)[:32])  # one block's worth
    host = copies.download(t)
    assert not host.flags.writeable and copies.immutable(host)
    np.testing.assert_array_equal(host, t.numpy())
    dms.put(_key(), ONE_BLOCK, host)
    assert copies.stats()["put_copies"] == 0  # kept as it is: nothing can write it
    got = dms.get(_key(), ONE_BLOCK)
    assert np.shares_memory(got, host) and not got.flags.writeable
    assert not copies.immutable(np.array(host)) and not copies.immutable(t.numpy())
