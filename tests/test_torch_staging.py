"""Host-to-card uploads through pinned memory (``repro_torch.staging``).

On the CPU: which inputs engage the pinned path, the counters of
``pipeline/wsi.py::_upload`` under threads, and the benchmark's reader of
them. The tests marked ``cuda`` skip where no card is present; on the card
they hold staged uploads bit for bit against ``torch.as_tensor``.
"""
import collections
import importlib.util
import sys
import threading
import warnings
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import staging
from repro_torch.pipeline import wsi

N = 1 << 22  # elements of a 16 MiB float32 array
READER = Path(__file__).resolve().parents[1] / "rtbench" / "metrics" / "staged_upload_share.wsi.py"
CPU = torch.device("cpu")


@pytest.fixture
def counts():
    staging.reset_stats()
    yield staging.stats
    staging.reset_stats()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def share_reader():
    spec = importlib.util.spec_from_file_location("staged_upload_share", READER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("make, engages", [
    (lambda: np.zeros(N, np.float32), True),
    (lambda: np.arange(12, dtype=np.int32).reshape(3, 4), True),  # small: one path for all sizes
    (lambda: np.zeros(0, np.float32), True),
    (lambda: np.array(1.5), True),  # zero dimensions
    (lambda: np.zeros((2, N), np.float32)[:, ::2], False),  # not contiguous
    (lambda: np.zeros((N, 2), np.float32).T, False),  # Fortran order
    (lambda: np.zeros(8, ">f4"), False),  # a byte order torch cannot view
    (lambda: torch.zeros(4 * N, dtype=torch.uint8), True),
    (lambda: torch.arange(10.0)[3:], True),  # a contiguous view at an offset
    (lambda: torch.zeros(N, requires_grad=True), False),  # as_tensor records its copy
    (lambda: torch.zeros(8 * N, dtype=torch.uint8)[::2], False),
    (lambda: read_only(np.arange(12, dtype=np.float32)), True),  # a store's block: viewed
    (lambda: read_only(np.zeros((8, 6), np.float32)[:, ::3]), False),
], ids=["array", "small", "empty", "scalar", "strided", "fortran", "byteswapped", "tensor",
        "tensor-view", "grad", "strided-tensor", "read-only", "read-only-strided"])
def test_pinned_path_takes_contiguous_host_arrays(make, engages):
    x = make()
    src = staging._host_view(x)
    assert (src is not None) == engages
    if engages and src.numel():  # a view of the source, not a copy
        assert src.data_ptr() == (x.data_ptr() if isinstance(x, torch.Tensor)
                                  else x.ctypes.data)


def read_only(x: np.ndarray) -> np.ndarray:
    x.setflags(write=False)
    return x


@pytest.mark.parametrize("layout", ["contiguous", "strided", "scalar", "read-only"])
def test_the_view_takes_bfloat16_by_its_bits_as_host_tensor_does(layout):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    full = np.linspace(-3, 3, 48, dtype=np.float32).reshape(6, 8).astype(ml_dtypes.bfloat16)
    x = np.asarray({"contiguous": full, "strided": full[:, ::2], "scalar": full[2, 3],
                    "read-only": read_only(full.copy())}[layout])
    want = staging.host_tensor(x)
    assert want.dtype == torch.bfloat16 and tuple(want.shape) == x.shape
    assert torch.equal(want.view(torch.int16), torch.from_numpy(x.view(np.int16).copy()))
    src = staging._host_view(x)
    if layout == "strided":
        assert src is None  # no view of a non-contiguous input
        return
    assert src.dtype == torch.bfloat16 and torch.equal(src.view(torch.int16),
                                                       want.view(torch.int16))
    assert src.data_ptr() == x.ctypes.data


@pytest.mark.parametrize("source", ["array", "store-block"])
def test_a_read_only_source_moves_without_a_warning_or_a_writable_alias(counts, source):
    """Uploads from several threads at once: no process-wide warnings filter
    is changed, and what leaves ``staging`` for the caller is a copy."""
    from repro_torch.core import BoundingBox, ElementType, RegionKey
    from repro_torch.storage import DistributedMemoryStorage

    want = np.random.default_rng(11).random((64, 32), dtype=np.float32)
    x = read_only(want.copy())
    if source == "store-block":
        dom = BoundingBox((0, 0), want.shape)
        dms = DistributedMemoryStorage(dom, want.shape, 1)
        key = RegionKey("t", "X", ElementType.FLOAT32, 0, 0)
        dms.put(key, dom, want)
        x = dms.get(key, dom)  # one block: the store's own read-only buffer
    assert not x.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        view = staging._host_view(x)
        locked = staging.page_locked(x)
        moved = [staging.upload(x, CPU), staging.to_device(x, CPU)[0], staging.host_tensor(x)]
    assert view.data_ptr() == x.ctypes.data and not locked
    for got in moved:
        assert torch.equal(got, torch.from_numpy(want))
        assert not np.shares_memory(got.numpy(), x)
    assert counts()["direct_uploads"] == 2


READ_ONLY_UPLOADS = r"""
import warnings
import numpy as np
from repro_torch import staging
from repro_torch.core import BoundingBox, ElementType, RegionKey
from repro_torch.storage import DistributedMemoryStorage

dom = BoundingBox((0, 0), (64, 32))
dms = DistributedMemoryStorage(dom, (64, 32), 1)
key = RegionKey("t", "X", ElementType.FLOAT32, 0, 0)
dms.put(key, dom, np.ones((64, 32), np.float32))
block = dms.get(key, dom)
warnings.simplefilter("error")
staging._host_view(block), staging.page_locked(block), staging.upload(block, "cpu")
staging.to_device(block, "cpu")
print(block.flags.writeable)
"""


def test_a_fresh_process_moves_a_store_block_without_a_warning():
    """Torch warns of a read-only array once a process and then never again,
    so only a process that has not warned yet can show that none is raised."""
    import os
    import subprocess

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([src, os.environ.get("PYTHONPATH", "")])}
    done = subprocess.run([sys.executable, "-c", READ_ONLY_UPLOADS], env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.split() == ["False"]


class _Event:
    """A CUDA event's ``query`` with its answer set by hand."""

    def __init__(self) -> None:
        self.done = False

    def query(self) -> bool:
        return self.done


def test_a_page_locked_source_lives_until_its_dma_is_done(monkeypatch):
    """Torch records its uses only of blocks of its own allocator, so
    ``to_device`` keeps any other page-locked source until the event after its
    DMA completes; completed events are found, oldest first, at later calls."""
    events = []

    def put(x, device, dtype):  # a DMA queued from page-locked memory
        events.append(_Event())
        return torch.zeros(1), events[-1], x

    monkeypatch.setattr(staging, "_put", put)
    monkeypatch.setattr(staging, "_held", collections.deque())
    sources = [np.full(4, i, np.float32) for i in range(2)]
    alive = [weakref.ref(x) for x in sources]
    for x in sources:
        staging.to_device(x, CPU)
    del x
    sources.clear()
    assert all(ref() is not None for ref in alive)
    events[1].done = True  # the later DMA ends first: the older still reads
    staging.to_device(np.zeros(1), CPU)
    assert all(ref() is not None for ref in alive)
    events[0].done = True
    staging.to_device(np.zeros(1), CPU)
    assert [ref() is None for ref in alive] == [True, True]
    assert [event for event, _ in staging._held] == events[2:]  # the two still in flight


def test_upload_on_the_cpu_is_direct_and_counted(counts):
    big = np.arange(N + 3, dtype=np.float32)
    small = np.arange(12, dtype=np.int32).reshape(3, 4)
    got = wsi._upload(big, CPU)
    assert torch.equal(got, torch.as_tensor(big))
    assert torch.equal(wsi._upload(small, CPU, torch.float32),
                       torch.as_tensor(small, dtype=torch.float32))
    assert counts() == {"staged_uploads": 0, "staged_bytes": 0,
                        "direct_uploads": 2, "direct_bytes": big.nbytes + small.nbytes}
    staging.reset_stats()
    assert set(counts().values()) == {0}


def test_a_cpu_tensor_for_the_cpu_is_returned_as_it_is(counts):
    """As ``torch.as_tensor``: no copy, and counted as direct."""
    x = torch.arange(6.0).reshape(2, 3)
    assert wsi._upload(x, CPU) is x
    assert counts()["direct_uploads"] == 1 and counts()["staged_uploads"] == 0


def test_the_counters_lose_no_upload_under_threads(counts):
    """More threads than cores upload at once, switching often."""
    x = np.ones((7, 5), np.float64)
    threads, rounds = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        workers = [threading.Thread(target=lambda: [staging.upload(x, CPU) for _ in range(rounds)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    n = threads * rounds
    assert counts() == {"staged_uploads": 0, "staged_bytes": 0,
                        "direct_uploads": n, "direct_bytes": n * x.nbytes}


def test_the_benchmark_reads_the_staged_share_and_clears_it(counts):
    read = share_reader()
    assert read(None) is None  # nothing uploaded
    staging._count("staged", 300)
    staging._count("direct", 100)
    assert read(None) == pytest.approx(75.0)
    assert read(None) is None  # the first read took the counts
    staging._count("direct", 5)
    assert read(None) == 0.0


def test_a_program_without_staging_reads_none(counts, monkeypatch):
    monkeypatch.delattr(repro_torch, "staging")
    monkeypatch.setitem(sys.modules, "repro_torch.staging", None)  # the import fails
    staging._count("staged", 300)
    assert share_reader()(None) is None
    assert staging.stats()["staged_bytes"] == 300  # left alone


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


CASES = {
    "float32": (lambda g: g.standard_normal((3, 4096, 4096), np.float32), None),
    "float32-ragged": (lambda g: g.standard_normal((3, 4095, 4097), np.float32), None),
    "int32": (lambda g: g.integers(-2**31, 2**31 - 1, (4096, 4096), np.int32), None),
    "uint8-to-float32": (lambda g: g.integers(0, 256, (3, 4096, 4096), np.uint8),
                         torch.float32),
    "float64-to-float32": (lambda g: g.standard_normal((4096, 4096)) * 1e3, torch.float32),
    "small-int32": (lambda g: g.integers(-2**31, 2**31 - 1, (3, 4), np.int32), None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_equals_as_tensor_bit_for_bit(card, counts, case):
    make, dtype = CASES[case]
    x = make(np.random.default_rng(7))
    got = staging.upload(x, card, dtype)
    assert counts()["staged_uploads"] == 1 and counts()["staged_bytes"] == x.nbytes
    want = torch.as_tensor(x, dtype=dtype, device=card)
    assert got.device.type == "cuda" and got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(bits(got), bits(want))


@pytest.mark.cuda
def test_a_cpu_tensor_and_a_side_stream_stage_too(card, counts):
    x = torch.randn(3, 2048, 2048)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = staging.upload(x, card)
    assert counts()["staged_uploads"] == 1
    assert torch.equal(bits(got.cpu()), bits(x))  # on the card when upload returned


@pytest.mark.cuda
def test_a_non_contiguous_input_goes_direct(card, counts):
    x = np.random.default_rng(3).standard_normal((4096, 8192), np.float32)[:, ::2]
    got = wsi._upload(x, card)
    assert counts() == {"staged_uploads": 0, "staged_bytes": 0,
                        "direct_uploads": 1, "direct_bytes": x.nbytes}
    assert torch.equal(bits(got), bits(torch.as_tensor(x, device=card)))


@pytest.mark.cuda
def test_overwriting_the_source_after_return_leaves_the_card_alone(card, counts):
    x = np.random.default_rng(5).standard_normal((3, 4096, 4096), np.float32)
    want = x.copy()
    got = wsi._upload(x, card, torch.float32)
    x[...] = -1.0  # at once, before anything else touches the card
    assert counts()["staged_uploads"] == 1
    assert np.array_equal(got.cpu().numpy().view(np.int32), want.view(np.int32))


@pytest.mark.cuda
def test_four_threads_upload_at_once_and_all_land(card, counts):
    xs = [np.full((2, 4096, 4096), i, np.int32) + np.arange(4096, dtype=np.int32)
          for i in range(4)]
    got = [None] * 4
    errors = []
    start = threading.Barrier(4)

    def work(i):
        try:
            start.wait(timeout=30)
            for _ in range(3):
                got[i] = staging.upload(xs[i], card)
        except Exception as err:  # noqa: BLE001 — reported by the assertion below
            errors.append(err)

    workers = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=120)
    assert not any(w.is_alive() for w in workers) and not errors, errors
    assert counts()["staged_uploads"] == 12
    for i in range(4):
        assert torch.equal(got[i].cpu(), torch.from_numpy(xs[i]))


# ---------------------------------------------------------------------------
# Host-card transfers by their host buffer (``staging.transfer_stats``)
# ---------------------------------------------------------------------------
PINNED_READER = READER.parent / "pinned_host_share.rt.py"


@pytest.fixture
def transfers():
    from repro_torch.storage import copies

    staging.reset_transfer_stats()
    staging.reset_stats()
    copies.reset_stats()
    yield staging.transfer_stats
    staging.reset_transfer_stats()
    staging.reset_stats()
    copies.reset_stats()


def pinned_reader():
    spec = importlib.util.spec_from_file_location("pinned_host_share", PINNED_READER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("path", staging.TRANSFERS)
def test_the_transfer_counter_counts_each_path_and_resets_apart(transfers, path):
    from repro_torch.storage import copies

    staging.count_transfer(path, 300)
    staging.count_transfer(path, 12)
    staging._count("staged", 7)
    copies.count("put", 9)
    want = dict.fromkeys(transfers(), 0)
    want.update({path: 2, path + "_bytes": 312})
    assert transfers() == want
    staging.reset_stats()
    copies.reset_stats()
    assert transfers() == want  # the other counters' resets leave it alone
    staging._count("staged", 7)
    copies.count("put", 9)
    staging.reset_transfer_stats()
    assert set(transfers().values()) == {0}
    assert staging.stats()["staged_bytes"] == 7 and copies.stats()["put_bytes"] == 9


def test_host_to_host_moves_are_no_transfers(transfers):
    """Uploads for the CPU and downloads of CPU tensors cross no bus."""
    from repro_torch.storage import copies

    wsi._upload(np.ones(64, np.float32), CPU)
    host = copies.download(torch.arange(64.0))
    assert not staging.page_locked(host)
    t = torch.arange(12.0).reshape(3, 4)
    fresh, into = staging.to_host(t), staging.to_host(t, torch.empty(3, 4))
    assert torch.equal(fresh, t) and torch.equal(into, t) and not staging.page_locked(fresh)
    assert set(transfers().values()) == {0}


def test_the_benchmark_reads_the_pinned_share_and_clears_it(transfers):
    read = pinned_reader()
    assert read(None) is None  # nothing moved
    staging.count_transfer("upload_pinned", 200)
    staging.count_transfer("download_pinned", 100)
    staging.count_transfer("upload_staged", 50)
    staging.count_transfer("upload_direct", 25)
    staging.count_transfer("download_pageable", 25)
    staging._count("staged", 1000)  # another reader's counter: not in the share
    assert read(None) == pytest.approx(75.0)
    assert read(None) is None  # the first read took the counts
    assert staging.stats()["staged_bytes"] == 1000
    staging.count_transfer("download_pageable", 5)
    assert read(None) == 0.0


@pytest.mark.parametrize("gone", ["module", "counter"])
def test_a_program_without_the_transfer_counter_reads_none(transfers, monkeypatch, gone):
    staging.count_transfer("upload_pinned", 300)
    if gone == "module":
        monkeypatch.delattr(repro_torch, "staging")
        monkeypatch.setitem(sys.modules, "repro_torch.staging", None)  # the import fails
    else:
        monkeypatch.delattr(staging, "transfer_stats")
    assert pinned_reader()(None) is None
    monkeypatch.undo()
    assert staging.transfer_stats()["upload_pinned_bytes"] == 300  # left alone


@pytest.mark.cuda
def test_a_pageable_source_is_staged_and_a_pinned_one_is_not(card, transfers):
    x = np.random.default_rng(9).standard_normal((3, 2048, 2048), np.float32)
    pinned = torch.from_numpy(x).pin_memory()
    got = [staging.upload(x, card), staging.upload(pinned, card)]
    counts = transfers()
    assert counts["upload_staged"] == 1 and counts["upload_pinned"] == 1
    assert counts["upload_pinned_bytes"] == counts["upload_staged_bytes"] == x.nbytes
    want = torch.as_tensor(x, device=card)
    assert all(torch.equal(bits(g), bits(want)) for g in got)


# ---------------------------------------------------------------------------
# Every route of region data through ``staging``, on the card
# ---------------------------------------------------------------------------
def store_block(shape, seed, dtype=np.float32):
    """A one-block store's read of its block: the store's own read-only
    buffer, page-locked where the process holds a CUDA context."""
    from repro_torch.core import BoundingBox, ElementType, RegionKey
    from repro_torch.storage import DistributedMemoryStorage

    dom = BoundingBox((0,) * len(shape), shape)
    dms = DistributedMemoryStorage(dom, shape, 1)
    key = RegionKey("t", "X", ElementType.from_dtype(dtype), 0, 0)
    a = np.random.default_rng(seed).random(shape).astype(dtype)
    dms.put(key, dom, a)
    return dms, key, dom, a


@pytest.mark.cuda
def test_to_device_of_a_page_locked_store_block_is_a_dma_of_the_block(card, transfers):
    """No host copy, no warning, bit for bit; the block's buffer stays out of
    the store's reuse until the DMA is done, though nothing else holds it."""
    from repro_torch.core import RegionTemplate
    from repro_torch.storage import copies

    torch.cuda.init()
    dms, key, dom, a = store_block((3, 2048, 2048), 13)
    block = dms.get(key, dom)
    assert staging.page_locked(block) and not block.flags.writeable
    region = RegionTemplate("P").new_region("X", dom, np.float32, data=block)
    address = block.ctypes.data
    del block
    copies.reset_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        arr = region.to_device()
    assert staging._held[-1][1].data_ptr() == address  # the DMA's source, held
    for seed in range(3):  # the store lets go of the block; its spare is not reused
        dms.put(key, dom, np.full(a.shape, seed, np.float32))
    region.block_until_ready()
    assert region.ready() and torch.equal(arr, torch.from_numpy(a).to(card))
    counts = transfers()
    assert counts["upload_pinned"] == 1 and counts["upload_pinned_bytes"] == a.nbytes
    assert counts["upload_staged"] == 0 and counts["upload_direct"] == 0
    assert copies.stats()["get_copies"] == 0


@pytest.mark.cuda
def test_prefetch_and_the_pipeline_move_by_path_and_equal_as_tensor(card, transfers):
    from repro_torch.runtime import DevicePipeline, prefetch_to_device

    torch.cuda.init()
    dms, key, dom, _ = store_block((1024, 1024), 17)
    pageable = np.random.default_rng(19).random((1024, 1024), dtype=np.float32)
    batches = [{"x": pageable}, {"x": dms.get(key, dom)}, {"x": pageable[:, ::2]}]
    want = [torch.as_tensor(np.array(b["x"]), device=card) for b in batches]
    got = list(prefetch_to_device(iter(batches), depth=2, device=card))
    assert all(torch.equal(g["x"], w) for g, w in zip(got, want))
    counts = transfers()
    assert [counts[p] for p in ("upload_staged", "upload_pinned", "upload_direct")] == [1, 1, 1]
    staging.reset_transfer_stats()
    pipe = DevicePipeline(lambda t: t * 2 + 1, window=2, device=card)
    outs = list(pipe.map([pageable, pageable[::-1].copy()]))
    for host, out in zip((pageable, pageable[::-1].copy()), outs):
        assert isinstance(out, np.ndarray)
        assert np.array_equal(out, (torch.as_tensor(host, device=card) * 2 + 1).cpu().numpy())
    counts = transfers()
    assert counts["upload_staged"] == 2 and counts["download_pinned"] == 2
    assert counts["download_pinned_bytes"] == 2 * pageable.nbytes
    assert counts["download_pageable"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("chain_name", ["deconv|threshold|fill", "deconv|threshold|ccl|count"])
def test_the_chains_local_call_is_bit_for_bit(card, transfers, chain_name):
    """Against the chain's device stages on ``torch.as_tensor``'s upload,
    from a pageable array and from a store's read-only block."""
    from repro_torch.core.regions import to_numpy
    from repro_torch.kernels.chains import resolve_chain
    from repro_torch.pipeline import make_tile

    torch.cuda.init()
    chain = resolve_chain(chain_name)
    rgb, _ = make_tile(512, num_nuclei=30, seed=23)
    dms, key, dom, _ = store_block(rgb.shape, 0)
    dms.put(key, dom, rgb)
    for x in (rgb, dms.get(key, dom)):
        out = to_numpy(chain.device_fn("auto")(torch.as_tensor(np.array(x), device=card)))
        want = chain.host_fn()(out) if chain.host_fn() is not None else out
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = chain(x, device=card)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    counts = transfers()
    assert counts["upload_staged"] == 1 and counts["upload_pinned"] == 1
