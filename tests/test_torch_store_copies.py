"""The port's in-process region store keeps its contract while it copies less:
a caller that changes its array after ``put`` leaves what is stored as it
was; what ``get`` returns is never changed behind the caller's back (one
block covering the read comes back as a read-only view of it, which no
later put writes into); overwriting a key keeps every other key's data; and
``repro_torch.storage.copies`` counts the host bytes each side copied."""
import numpy as np
import pytest

from repro_torch import staging
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
                              "get_copies": 0, "get_bytes": 0, "get_views": 0}
    copies.reset_stats()
    dms.get(_key(), ONE_BLOCK)  # one block: its view, no copy
    assert copies.stats()["get_copies"] == 0 and copies.stats()["get_views"] == 1
    roi = BoundingBox((8, 4), (40, 100))
    dms.get(_key(), roi)  # across blocks: one assembled array
    assert copies.stats() == {"put_copies": 0, "put_bytes": 0,
                              "get_copies": 1, "get_bytes": roi.volume * 4, "get_views": 1}
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


# ---------------------------------------------------------------------------
# Page-locked spares: only where the process holds a CUDA context
# ---------------------------------------------------------------------------
NO_CONTEXT = r"""
import numpy as np, torch
from repro_torch import staging
from repro_torch.core import BoundingBox, ElementType, RegionKey
from repro_torch.storage import DistributedMemoryStorage, copies
dom = BoundingBox((0, 0), (64, 128))
dms = DistributedMemoryStorage(dom, (32, 128), 2)
key = RegionKey("t", "X", ElementType.FLOAT32, 0, 0)
locked = []
for seed in range(4):  # buffers come back and are reused
    dms.put(key, dom, np.random.default_rng(seed).random(dom.shape, dtype=np.float32))
    one = dms.get(key, BoundingBox((0, 0), (32, 128)))
    host = copies.download(torch.from_numpy(np.array(one)))
    locked += [staging.page_locked(one), staging.page_locked(host), copies.immutable(one)]
print(torch.cuda.is_initialized(), locked.count(True), len(locked))
"""


def test_without_a_cuda_context_puts_gets_and_downloads_pin_nothing():
    """In a fresh process, as a socket storage server's: the store opens no
    context, and every spare is pageable (each block still a spare's)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([src, os.environ.get("PYTHONPATH", "")])}
    done = subprocess.run([sys.executable, "-c", NO_CONTEXT], env=env, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.split() == ["False", "4", "12"]  # the 4 are immutable(), not pinned


@pytest.fixture
def pinning(monkeypatch):
    """Pinning switched on by hand, page-locked buffers stood in for by plain
    ones, which ``staging.page_locked`` knows by their address."""
    state = {"on": False}
    locked = set()

    def host_buffer(nbytes):
        raw = np.empty(nbytes, np.uint8)
        if state["on"]:
            locked.add(raw.ctypes.data)
        return raw

    monkeypatch.setattr(staging, "pinning", lambda: state["on"])
    monkeypatch.setattr(staging, "host_buffer", host_buffer)
    monkeypatch.setattr(staging, "page_locked", lambda a: np.asarray(a).ctypes.data in locked)
    return state


@pytest.mark.parametrize("freed", ["before", "after"])
def test_a_pageable_spare_is_not_reused_once_pinning_is_on(pinning, freed):
    """A pageable spare freed before the context came up is dropped when
    the next copy looks for one; one that comes back after is never kept."""
    spares = copies.Spares(keep=2)
    a = np.arange(4096, dtype=np.float32).reshape(64, 64)
    first = spares.copy(a)
    raw = copies._lease(first).raw
    assert not staging.page_locked(first)
    if freed == "before":
        del first
        assert [r for r, _ in spares._free[a.nbytes]] == [raw]
    pinning["on"] = True
    if freed == "after":
        del first
        assert not spares._free.get(a.nbytes)
    second = spares.copy(a + 1)
    assert staging.page_locked(second) and copies._lease(second).raw is not raw
    np.testing.assert_array_equal(second, a + 1)
    assert not spares._free.get(a.nbytes)
    del second  # a page-locked spare comes back and is reused
    third = spares.copy(a + 2)
    assert staging.page_locked(third) and not third.flags.writeable


@pytest.mark.parametrize("make", [
    lambda: np.arange(24, dtype=np.int16).reshape(4, 6),
    lambda: np.arange(48, dtype=np.float64).reshape(6, 8)[:, ::2],  # strided: torch copies it
    lambda: np.arange(48, dtype=np.float64).reshape(6, 8)[::-1],  # torch cannot view it
    lambda: np.arange(8, dtype=">f4"),  # nor this byte order
    lambda: np.zeros(5, np.longdouble) + 1.5,  # nor this dtype
    lambda: np.array([True, False, True]),
], ids=["int16", "strided", "reversed", "byteswapped", "longdouble", "bool"])
def test_a_put_copy_is_the_source_bit_for_bit(pinning, make):
    """A copy by torch where it can view the source, by numpy where not."""
    src = make()
    ro = src.copy()
    ro.setflags(write=False)  # a read-only source goes by numpy
    for s in (src, ro):
        got = copies.Spares().copy(s)
        assert got.dtype == s.dtype and got.shape == s.shape and not got.flags.writeable
        assert got.tobytes() == s.tobytes()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda.init()
    from repro_torch import staging

    staging.reset_transfer_stats()
    yield torch.device("cuda")
    staging.reset_transfer_stats()


@pytest.mark.cuda
def test_a_put_lands_in_a_page_locked_buffer(card, dms):
    from repro_torch import staging

    a = _data(50)
    dms.put(_key(), DOM, a)
    got = dms.get(_key(), ONE_BLOCK)
    assert staging.page_locked(got) and staging._host_view(got).is_pinned()
    np.testing.assert_array_equal(got, a[ONE_BLOCK.slices()])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, cast", [(np.float32, None), (np.int32, None),
                                         (np.uint8, "float32")])
def test_uploading_a_store_block_takes_no_staging_copy(card, dtype, cast):
    import torch

    from repro_torch import staging

    dom = BoundingBox((0, 0, 0), (3, 1024, 1024))
    dms = DistributedMemoryStorage(dom, (3, 1024, 1024), 1)
    a = np.random.default_rng(51).integers(0, 256, dom.shape).astype(dtype)
    dms.put(_key(), dom, a)
    block = dms.get(_key(), dom)  # one block: the spare itself
    cast = getattr(torch, cast) if cast else None
    got = staging.upload(block, card, cast)
    counts = staging.transfer_stats()
    assert counts["upload_pinned"] == 1 and counts["upload_pinned_bytes"] == a.nbytes
    assert counts["upload_staged"] == 0 and counts["upload_direct"] == 0
    want = torch.as_tensor(a, dtype=cast, device=card)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool"])
def test_a_download_into_a_pinned_spare_equals_cpu(card, dtype):
    import torch

    from repro_torch import staging

    t = torch.randn(2048, 1024, device=card) > 0 if dtype == "bool" else \
        (torch.randn(2048, 1024, device=card) * 1e4).to(getattr(torch, dtype))
    host = copies.download(t)
    assert staging.page_locked(host) and not host.flags.writeable
    assert host.tobytes() == t.cpu().numpy().tobytes()
    counts = staging.transfer_stats()
    assert counts["download_pinned"] == 1 and counts["download_pinned_bytes"] == host.nbytes
    assert counts["download_pageable"] == 0


@pytest.mark.cuda
def test_no_spare_is_freed_to_the_driver_while_the_store_lives(card):
    """Blocks die and come back, more than the spares keep: the buffers let
    go of return to torch's host cache, whose blocks are never given back to
    the driver (a free there synchronises the device)."""
    import torch

    dom = BoundingBox((0, 0), (2048, 2048))
    dms = DistributedMemoryStorage(dom, (1024, 2048), 2)
    t = torch.rand(2048, 2048, device=card)
    held = []
    for i in range(12):
        dms.put(_key(), dom, np.full(dom.shape, i, np.float32))
        held.append(copies.download(t))
        if i == 3:
            before = torch.cuda.host_memory_stats()
        if i % 3 == 2:
            held.clear()  # more buffers back at once than a spare list keeps
    after = torch.cuda.host_memory_stats()
    assert "num_host_free" in after
    assert after["num_host_free"] == before["num_host_free"]
    np.testing.assert_array_equal(dms.get(_key(), dom), np.full(dom.shape, 11, np.float32))
