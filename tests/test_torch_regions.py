"""Region template / data region semantics of the port (paper S3.3), the
cases of ``tests/test_regions.py`` on ``repro_torch.core``, plus the
device touchpoints that the port rewrote for torch: element types with
bfloat16 (no ``ml_dtypes`` needed to name it), uploads, readiness and
downloads."""
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro_torch.core import (
    BoundingBox,
    DataRegion,
    ElementType,
    RegionKey,
    RegionTemplate,
    StorageRegistry,
)
from repro_torch.storage import DistributedMemoryStorage

ROOT = Path(__file__).resolve().parents[1]


def test_template_bb_grows_to_minimum_cover():
    rt = RegionTemplate("Patient")
    rt.new_region("RGB", BoundingBox((0, 0), (50, 50)), np.float32)
    assert rt.bb == BoundingBox((0, 0), (50, 50))
    rt.new_region("Mask", BoundingBox((25, 25), (100, 80)), np.int32)
    assert rt.bb == BoundingBox((0, 0), (100, 80))


def test_versioning_latest_wins():
    rt = RegionTemplate("P")
    bb = BoundingBox((0, 0), (4, 4))
    rt.new_region("RGB", bb, np.float32, timestamp=0, version=0)
    rt.new_region("RGB", bb, np.float32, timestamp=0, version=1)
    rt.new_region("RGB", bb, np.float32, timestamp=3, version=0)
    assert rt.get("RGB").key.timestamp == 3
    assert rt.get("RGB", timestamp=0).key.version == 1
    assert rt.get("RGB", timestamp=0, version=0).key.version == 0
    assert len(rt.versions("RGB")) == 3


def test_duplicate_key_rejected():
    rt = RegionTemplate("P")
    bb = BoundingBox((0, 0), (4, 4))
    rt.new_region("RGB", bb, np.float32)
    with pytest.raises(ValueError):
        rt.new_region("RGB", bb, np.float32)


def test_lazy_instantiate_and_write_through_storage():
    reg = StorageRegistry()
    dom = BoundingBox((0, 0), (16, 16))
    dms = reg.register(DistributedMemoryStorage(dom, (8, 8), 2, name="DMS"))
    data = np.arange(256, dtype=np.float32).reshape(16, 16)
    key = RegionKey("default", "RGB", ElementType.FLOAT32)
    dms.put(key, dom, data)

    rt = RegionTemplate("P")
    r = rt.new_region("RGB", dom, np.float32, input_storage="DMS", lazy=True)
    assert r.empty()
    got = r.instantiate(reg)
    assert np.array_equal(got, data)
    assert r.stats["reads"] == 1

    # ROI view + write-back with bumped version
    roi = BoundingBox((4, 4), (12, 12))
    view = r.with_roi(roi)
    view.input_storage = "DMS"
    view.instantiate(reg)
    view.key = view.key.bump()
    view.output_storage = "DMS"
    view.set_data(np.asarray(view.data) + 1)
    view.write(reg)
    assert np.array_equal(dms.get(view.key, roi), data[4:12, 4:12] + 1)


def test_pack_unpack_metadata_only():
    rt = RegionTemplate("P", "ns")
    bb = BoundingBox((0, 0), (8, 8))
    r = rt.new_region("RGB", bb, np.uint8, data=np.zeros((8, 8), np.uint8),
                      input_storage="DMS", output_storage="DISK")
    blob = rt.pack()
    rt2 = RegionTemplate.unpack(blob)
    r2 = rt2.get("RGB")
    assert r2.key == r.key and r2.bb == bb
    assert r2.empty()  # payloads never ride the control channel
    assert r2.input_storage == "DMS" and r2.output_storage == "DISK"
    assert rt2.bb == rt.bb


@pytest.mark.parametrize("dt", [np.uint8, np.int32, np.int64, np.float32, np.float64, np.bool_,
                                ml_dtypes.bfloat16])
def test_elementtype_roundtrip(dt):
    et = ElementType.from_dtype(dt)
    assert et.to_dtype() == np.dtype(dt)
    assert et.itemsize == np.dtype(dt).itemsize
    assert int(et) == int(jcore.ElementType.from_dtype(dt))  # the reference's numbering
    torch_dt = torch.bfloat16 if dt is ml_dtypes.bfloat16 else torch.from_numpy(
        np.zeros(1, dt)).dtype
    assert ElementType.from_dtype(torch_dt) is et


def test_bfloat16_needs_no_ml_dtypes_until_a_numpy_array_does():
    """Importing the port and naming bfloat16 (by torch dtype) loads no
    ml_dtypes; a region's size comes from a table, not from numpy."""
    code = (
        "import sys, numpy as np, torch\n"
        "from repro_torch.core import BoundingBox, ElementType, RegionTemplate\n"
        "et = ElementType.from_dtype(torch.bfloat16)\n"
        "r = RegionTemplate('P').new_region('X', BoundingBox((0, 0), (4, 4)), torch.bfloat16)\n"
        "assert et is ElementType.BFLOAT16 and r.nbytes == 32 and et.itemsize == 2\n"
        "sys.exit(1 if 'ml_dtypes' in sys.modules else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_to_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    region = DataRegion(RegionKey("d", "X", ElementType.FLOAT32), BoundingBox((0, 0), (2, 2)),
                        data=np.ones((2, 2), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        region.to_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        region.to_device("cuda")
    assert region.location == "host"  # nothing moved


@pytest.mark.parametrize("dtype", [np.float32, np.int32, ml_dtypes.bfloat16])
def test_to_device_cpu_ready_and_to_host(dtype):
    data = (np.arange(12, dtype=np.float32).reshape(3, 4) * 1.5).astype(dtype)
    data.setflags(write=False)  # as a store may hand it out
    region = DataRegion(RegionKey("d", "X", ElementType.from_dtype(dtype)),
                        BoundingBox((0, 0), (3, 4)), data=data)
    assert region.location == "host" and region.ready()
    arr = region.to_device("cpu", blocking=True)
    assert isinstance(arr, torch.Tensor) and arr.device.type == "cpu"
    assert region.location == "device" and region.ready()
    region.block_until_ready()
    assert region.nbytes == data.nbytes
    back = region.to_host()
    assert region.location == "host"
    assert back.dtype == data.dtype
    np.testing.assert_array_equal(back.view(np.uint8), data.view(np.uint8))


def test_write_of_a_device_region_stages_host_bytes():
    reg = StorageRegistry()
    dom = BoundingBox((0, 0), (8, 8))
    dms = reg.register(DistributedMemoryStorage(dom, (8, 8), 1, name="DMS"))
    region = RegionTemplate("P").new_region("Y", dom, np.float32, output_storage="DMS",
                                            data=torch.full((8, 8), 2.5))
    assert region.location == "device"  # a tensor is the device form, on any device
    region.write(reg)
    got = dms.get(region.key, dom)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, np.full((8, 8), 2.5, np.float32))
