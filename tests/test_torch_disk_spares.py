"""The DISK tier reads each chunk straight from its file into a reused spare
(``storage/copies.py``'s ``Spares``): the read is read-only and bit for bit
the put; a spare is reused only once every array over it is gone; a ROI
across chunks is assembled and its chunks' spares come back; a file that
ends early raises, so no byte of an earlier chunk is handed out; a
checkpoint restore lets go of its spares. ``DiskStats`` counts the reads and
the reused ones."""
import os

import numpy as np
import pytest

from repro_torch import staging
from repro_torch.core import BoundingBox, ElementType, RegionKey
from repro_torch.storage import CheckpointManager, DiskStorage, TieredStore, copies
from repro_torch.storage import disk as disk_mod

BOX = BoundingBox((0, 0), (512, 512))  # 1 MiB of float32
NEXT = BoundingBox((512, 0), (1024, 512))  # the box below it


def _key(name: str = "X", et: ElementType = ElementType.FLOAT32) -> RegionKey:
    return RegionKey("t", name, et, 0, 0)


def _data(seed: int, shape=BOX.shape, dtype=np.float32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.random(shape, dtype=dtype)
    return rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype)


def _address(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


@pytest.fixture
def pageable(monkeypatch):
    """Spares as a process with no CUDA context keeps them, whatever an
    earlier test in this process opened."""
    monkeypatch.setattr(staging, "pinning", lambda: False)
    monkeypatch.setattr(staging, "host_buffer", lambda nbytes: np.empty(nbytes, np.uint8))


@pytest.fixture
def disk(tmp_path, pageable):
    return DiskStorage(str(tmp_path / "disk"))


def _counts(d: DiskStorage) -> tuple[int, int]:
    return d.stats.chunk_reads, d.stats.chunk_reads_reused


@pytest.mark.parametrize("dtype, et, shape", [
    (np.float32, ElementType.FLOAT32, (512, 512)),
    (np.int32, ElementType.INT32, (512, 512)),
    (np.uint8, ElementType.UINT8, (1024, 1024)),
    (np.uint16, ElementType.BFLOAT16, (1024, 512)),  # bfloat16 as its raw words
], ids=["float32", "int32", "uint8", "bfloat16"])
def test_a_one_chunk_read_is_a_read_only_spare_equal_to_the_put(disk, dtype, et, shape):
    box = BoundingBox((0, 0), shape)
    a = _data(1, shape, dtype)
    disk.put(_key(et=et), box, a)
    got = disk.get(_key(et=et), box)
    assert got.dtype == a.dtype and got.shape == a.shape
    assert got.tobytes() == a.tobytes()
    assert not got.flags.writeable and copies.immutable(got)
    with pytest.raises(ValueError):
        got.setflags(write=True)
    assert disk.stats.bytes_read == a.nbytes
    assert _counts(disk) == (1, 0)  # a fresh spare


def test_a_second_read_of_the_size_reuses_the_spare(disk):
    disk.put(_key("A"), BOX, _data(2))
    disk.put(_key("B"), BOX, _data(3))
    first = disk.get(_key("A"), BOX)
    held = _address(first)
    del first
    second = disk.get(_key("B"), BOX)
    assert _address(second) == held
    np.testing.assert_array_equal(second, _data(3))
    assert _counts(disk) == (2, 1)


def test_a_spare_is_never_reread_into_while_a_view_of_it_lives(disk):
    disk.put(_key("A"), BOX, _data(4))
    disk.put(_key("B"), BOX, _data(5))
    first = disk.get(_key("A"), BOX)
    view = first[100:300]
    del first
    second = disk.get(_key("B"), BOX)  # same size: the first spare is still read
    assert not np.shares_memory(view, second)
    np.testing.assert_array_equal(view, _data(4)[100:300])
    np.testing.assert_array_equal(second, _data(5))
    assert _counts(disk) == (2, 0)
    del view, second
    third = disk.get(_key("A"), BOX)  # both back now
    np.testing.assert_array_equal(third, _data(4))
    assert _counts(disk) == (3, 1)


def test_a_roi_across_two_chunks_is_assembled_and_both_spares_come_back(disk):
    top, bottom = _data(6), _data(7)
    disk.put(_key(), BOX, top)
    disk.put(_key(), NEXT, bottom)
    roi = BoundingBox((300, 10), (700, 500))
    got = disk.get(_key(), roi)
    whole = np.concatenate([top, bottom])
    np.testing.assert_array_equal(got, whole[roi.slices()])
    assert not copies.immutable(got)  # a copy, not a spare
    assert len(disk._spares._free[BOX.volume * 4]) == 2
    np.testing.assert_array_equal(disk.get(_key(), BOX.union(NEXT)), whole)
    assert _counts(disk) == (4, 2)


@pytest.mark.parametrize("shape", [(512, 512), (64, 64)], ids=["spare", "small"])
def test_a_truncated_chunk_file_raises_naming_it(disk, shape):
    """A spare that held an earlier chunk is free when the truncated one is
    read: the read raises rather than hand out those bytes."""
    box = BoundingBox((0, 0), shape)
    disk.put(_key("A"), box, _data(8, shape))
    disk.put(_key("B"), box, _data(9, shape))
    disk.get(_key("A"), box)  # read, then let go of: a free spare of its size
    (entry,) = disk._index[_key("B")]
    path = os.path.join(disk.root, entry.file)
    with open(path, "r+b") as f:
        f.truncate(entry.nbytes - 4096)
    with pytest.raises(EOFError, match=entry.file):
        disk.get(_key("B"), box)
    assert disk.stats.chunk_reads == 1


def test_short_reads_are_read_on_until_the_chunk_is_whole(disk, monkeypatch):
    """A network file system may return fewer bytes than asked for."""
    class Trickle:
        def __init__(self, f):
            self.f, self.calls = f, 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.f.close()

        def seek(self, offset):
            return self.f.seek(offset)

        def readinto(self, buf):
            self.calls += 1
            return self.f.readinto(buf[:100_003])

    opened = []

    def trickle_open(path, mode="r", buffering=-1):
        opened.append(Trickle(open(path, mode, buffering=buffering)))
        return opened[-1]

    a = _data(10)
    disk.put(_key(), BOX, a)
    monkeypatch.setattr(disk_mod, "open", trickle_open, raising=False)
    got = disk.get(_key(), BOX)
    np.testing.assert_array_equal(got, a)
    assert opened[0].calls == -(-a.nbytes // 100_003)


@pytest.mark.parametrize("shape", [(256, 512), (64, 64), (1, 3)], ids=["512KiB", "16KiB", "12B"])
def test_a_small_chunk_is_read_into_a_spare_too(disk, shape):
    box = BoundingBox((0, 0), shape)
    disk.put(_key("A"), box, _data(11, shape))
    disk.put(_key("B"), box, _data(12, shape))
    first = disk.get(_key("A"), box)
    np.testing.assert_array_equal(first, _data(11, shape))
    assert not first.flags.writeable and copies.immutable(first)
    del first
    second = disk.get(_key("B"), box)
    np.testing.assert_array_equal(second, _data(12, shape))
    assert _counts(disk) == (2, 1)


def test_a_checkpoint_restore_lets_go_of_its_spares(tmp_path, pageable, monkeypatch):
    emptied = []
    monkeypatch.setattr(staging, "empty_host_cache", lambda: emptied.append(1))
    store = DiskStorage(str(tmp_path / "ckpt"))
    ckpt = CheckpointManager(store)
    tree = {"w": _data(13, (512, 512)), "b": _data(14, (8,)), "step": np.int64(7)}
    ckpt.save(1, tree)
    back = ckpt.restore(tree)
    for name, a in tree.items():
        np.testing.assert_array_equal(back[name], a)
        assert back[name].flags.writeable
    assert store.stats.chunk_reads == 3 and not store._spares._free
    assert emptied == [1]  # and their page-locked memory goes back


def test_the_tiered_store_counters_carry_the_disk_reads(tmp_path, pageable):
    dom = BoundingBox((0, 0), (1024, 512))
    store = TieredStore.standard(dom, (512, 512), root=str(tmp_path / "t"))
    try:
        disk = {t.name: t.backend for t in store.tiers}["DISK"]
        disk.put(_key(), BOX, _data(12))
        store.get(_key(), BOX)
        store.get(_key(), BOX)
        counters = store.counters()
        assert counters["DISK.chunk_reads"] == 2
        assert counters["DISK.chunk_reads_reused"] == 1
    finally:
        store.close()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_a_read_is_page_locked_and_uploads_with_no_staging_copy(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda.init()
    disk = DiskStorage(str(tmp_path / "disk"))
    card = torch.device("cuda")
    shape = (3, 1024, 1024)
    box = BoundingBox((0, 0, 0), shape)
    a = _data(13, shape)
    disk.put(_key(), box, a)
    for reused in (0, 1):
        staging.reset_transfer_stats()
        got = disk.get(_key(), box)
        assert staging.page_locked(got) and not got.flags.writeable
        up = staging.upload(got, card)
        counts = staging.transfer_stats()
        assert counts["upload_pinned"] == 1 and counts["upload_pinned_bytes"] == a.nbytes
        assert counts["upload_staged"] == 0 and counts["upload_direct"] == 0
        assert torch.equal(up, torch.as_tensor(a, device=card))
        assert _counts(disk) == (1 + reused, reused)
        del got, up


@pytest.mark.cuda
def test_a_checkpoint_restore_gives_its_page_locked_memory_back(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda.init()
    store = DiskStorage(str(tmp_path / "ckpt"))
    ckpt = CheckpointManager(store)
    tree = {"w": _data(15, (1024, 1024)), "v": _data(16, (3, 512, 512))}
    ckpt.save(1, tree)
    staging.empty_host_cache()
    held = torch.cuda.host_memory_stats()["allocated_bytes.current"]
    back = ckpt.restore(tree)
    for name, a in tree.items():
        np.testing.assert_array_equal(back[name], a)
    assert not store._spares._free
    assert torch.cuda.host_memory_stats()["allocated_bytes.current"] <= held
