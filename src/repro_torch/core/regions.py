"""Region templates and data regions (paper S3.3, Fig. 6).

A ``RegionTemplate`` is a named container covering a spatio-temporal
bounding box and holding many ``DataRegion``s.  Data regions are the
storage materialization of a data type; they are identified by the tuple

    (namespace::name, element type, timestamp, version)

and carry their own bounding box + ROI.  Applications read/write through
get/insert on the template; *where* the bytes live (host memory, device
memory, the DMS distributed store, the DISK store) is the runtime's
business, not the application's.

Materialization states:
  - metadata-only (lazy): shape/dtype/bb known, no payload   (paper: lazyRead)
  - host:   numpy ndarray on the host
  - device: torch.Tensor (on the CUDA card, or on the CPU when asked for
            by name), with a CUDA event marking the end of its upload

The storage backends implement the small ``StorageBackend`` protocol at the
bottom of this file; concrete implementations live in repro_torch.storage.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Any, Callable, Iterable, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.bbox import BoundingBox
from repro_torch.device import resolve_device


class ElementType(enum.IntEnum):
    """Element type of a data region (paper: CHAR, UCHAR, ... extended)."""

    UINT8 = 0
    INT32 = 1
    INT64 = 2
    FLOAT32 = 3
    FLOAT64 = 4
    BFLOAT16 = 5
    BOOL = 6

    def to_dtype(self) -> np.dtype:
        if self is ElementType.BFLOAT16:
            return _bfloat16_dtype()
        return np.dtype(_NUMPY_DTYPES[self])

    @staticmethod
    def from_dtype(dtype) -> "ElementType":
        """numpy dtype, scalar type or ``torch.dtype`` -> element type.

        bfloat16 is recognised by name (``ml_dtypes.bfloat16`` and the like)
        or as ``torch.bfloat16``, so no call here imports ``ml_dtypes``."""
        if isinstance(dtype, torch.dtype):
            if dtype == torch.bfloat16:
                return ElementType.BFLOAT16
            dtype = torch.empty((), dtype=dtype).numpy().dtype
        dt = np.dtype(dtype)
        if dt.name == "bfloat16":
            return ElementType.BFLOAT16
        for et, np_type in _NUMPY_DTYPES.items():
            if dt == np.dtype(np_type):
                return et
        raise ValueError(f"unsupported dtype {dtype}")

    @property
    def itemsize(self) -> int:
        return _ITEMSIZE[self]


# numpy types of the element types numpy has; bfloat16 comes from ml_dtypes
_NUMPY_DTYPES = {
    ElementType.UINT8: np.uint8,
    ElementType.INT32: np.int32,
    ElementType.INT64: np.int64,
    ElementType.FLOAT32: np.float32,
    ElementType.FLOAT64: np.float64,
    ElementType.BOOL: np.bool_,
}
_ITEMSIZE = {**{et: np.dtype(t).itemsize for et, t in _NUMPY_DTYPES.items()},
             ElementType.BFLOAT16: 2}


def _bfloat16_dtype() -> np.dtype:
    """numpy's bfloat16 dtype, from ``ml_dtypes``, imported only here."""
    try:
        import ml_dtypes
    except ImportError as e:
        raise RuntimeError(
            "a bfloat16 numpy array needs the ml_dtypes package, which is not "
            "installed; keep bfloat16 data in torch tensors"
        ) from e
    return np.dtype(ml_dtypes.bfloat16)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device -> a host numpy array; bfloat16 goes through
    its bits (``torch`` has no numpy bfloat16) into ``ml_dtypes.bfloat16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_bfloat16_dtype())
    return t.numpy()


class RegionKind(enum.IntEnum):
    """Region type (paper: dense/sparse 1D/2D/3D, polygons, objects)."""

    DENSE = 0
    SPARSE = 1
    POLYGON = 2
    OBJECTSET = 3  # e.g. per-object feature vectors


class Intent(enum.IntEnum):
    """How a stage uses a data region (paper Fig. 8)."""

    INPUT = 0
    OUTPUT = 1
    INPUT_OUTPUT = 2

    @property
    def reads(self) -> bool:
        return self in (Intent.INPUT, Intent.INPUT_OUTPUT)

    @property
    def writes(self) -> bool:
        return self in (Intent.OUTPUT, Intent.INPUT_OUTPUT)


@dataclasses.dataclass(frozen=True, order=True)
class RegionKey:
    """The (namespace::name, type, timestamp, version) tuple identifier."""

    namespace: str
    name: str
    elem_type: ElementType
    timestamp: int = 0
    version: int = 0

    @property
    def qualified(self) -> str:
        return f"{self.namespace}::{self.name}"

    def bump(self) -> "RegionKey":
        return dataclasses.replace(self, version=self.version + 1)

    def at(self, timestamp: int) -> "RegionKey":
        return dataclasses.replace(self, timestamp=timestamp)


# --------------------------------------------------------------------------
# Storage protocol implemented by repro_torch.storage backends
# --------------------------------------------------------------------------
@runtime_checkable
class StorageBackend(Protocol):
    name: str

    def put(self, key: RegionKey, bb: BoundingBox, array: np.ndarray) -> None: ...

    def get(self, key: RegionKey, roi: BoundingBox) -> np.ndarray: ...

    def query(self, namespace: str, name: str) -> list[tuple[RegionKey, BoundingBox]]: ...

    def delete(self, key: RegionKey) -> None: ...


class StorageRegistry:
    """Named registry so stages refer to backends by string ("DISK", "DMS")."""

    def __init__(self) -> None:
        self._backends: dict[str, StorageBackend] = {}
        self._lock = threading.Lock()

    def register(self, backend: StorageBackend) -> StorageBackend:
        with self._lock:
            self._backends[backend.name] = backend
        return backend

    def get(self, name: str) -> StorageBackend:
        with self._lock:
            if name not in self._backends:
                raise KeyError(
                    f"storage backend {name!r} not registered (have {sorted(self._backends)})"
                )
            return self._backends[name]

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._backends)

    def locality(self, name: str, key: "RegionKey") -> str | None:
        """Which layer of ``name`` holds ``key``.

        Hierarchical backends (e.g. ``TieredStore``) answer with a tier
        name ("MEM"/"DISK"/"DMS"); flat backends are their own single
        tier, so their backend name is returned (informative for event
        logs; tier pricing tables simply won't list it).  The Manager
        uses this for locality-aware dispatch and per-input events.
        """
        backend = self.get(name)
        loc = getattr(backend, "locality", None)
        if callable(loc):
            return loc(key)
        return backend.name


# A process-global registry; SysEnv (runtime.manager) populates it.
STORAGE = StorageRegistry()


# --------------------------------------------------------------------------
# Data regions
# --------------------------------------------------------------------------
class DataRegion:
    """One storage materialization of a typed region of data.

    Mirrors the paper's abstract DataRegion (Fig. 6b): tuple identifier,
    element/region type, bounding box + ROI, lazy instantiation, and
    pluggable input/output storage.  Concrete payloads are numpy arrays
    (host) or torch tensors (device); OBJECTSET payloads are dicts of arrays.
    """

    def __init__(
        self,
        key: RegionKey,
        bb: BoundingBox,
        kind: RegionKind = RegionKind.DENSE,
        *,
        roi: BoundingBox | None = None,
        data: Any | None = None,
        input_storage: str | None = None,
        output_storage: str | None = None,
        lazy: bool = False,
        resolution: int = 0,
    ) -> None:
        self.key = key
        self.kind = kind
        self.bb = bb
        self.roi = roi if roi is not None else bb
        self.input_storage = input_storage
        self.output_storage = output_storage
        self.lazy = lazy
        self.resolution = resolution
        self._data = data
        self._location = "none" if data is None else _infer_location(data)
        self._lock = threading.RLock()
        self._event: torch.cuda.Event | None = None  # marks the end of an upload
        # async transfer bookkeeping (paper: non-blocking upload/download)
        self._pending: list[Callable[[], None]] = []
        self.stats = {"reads": 0, "writes": 0, "bytes_read": 0, "bytes_written": 0}

    # -- payload state --------------------------------------------------------
    @property
    def location(self) -> str:
        with self._lock:
            return self._location

    def empty(self) -> bool:
        with self._lock:
            return self._data is None

    @property
    def data(self) -> Any:
        # Lock-free fast path: holding _lock across instantiate() would
        # serialize every reader behind a storage fetch.  _data only
        # transitions None -> payload here (instantiate is idempotent),
        # so a stale None costs a redundant fetch, never a wrong answer.
        if self._data is None:  # relint: allow(guarded-attribute) — see above
            if self.lazy and self.input_storage:
                self.instantiate(STORAGE)
            else:
                raise RuntimeError(f"data region {self.key} not materialized")
        return self._data  # relint: allow(guarded-attribute) — monotonic publication

    def set_data(self, array: Any) -> None:
        with self._lock:
            self._data = array
            self._location = _infer_location(array)

    # -- storage interaction (paper: instantiateRegion / write) -----------------
    def instantiate(self, registry: StorageRegistry | None = None) -> Any:
        """Read the ROI from the input storage backend into host memory."""
        registry = registry or STORAGE
        if self.input_storage is None:
            raise RuntimeError(f"{self.key}: no input storage bound")
        backend = registry.get(self.input_storage)
        t0 = time.perf_counter()
        arr = backend.get(self.key, self.roi)
        with self._lock:
            self._data = arr
            self._location = "host"
            self.stats["reads"] += 1
            self.stats["bytes_read"] += int(getattr(arr, "nbytes", 0))
            self.stats["read_s"] = self.stats.get("read_s", 0.0) + time.perf_counter() - t0
        return arr

    def write(self, registry: StorageRegistry | None = None) -> None:
        """Stage the payload (restricted to the ROI) to the output backend."""
        registry = registry or STORAGE
        if self.output_storage is None:
            raise RuntimeError(f"{self.key}: no output storage bound")
        with self._lock:
            if self._data is None:
                raise RuntimeError(f"{self.key}: nothing to write")
        backend = registry.get(self.output_storage)
        arr = self.to_host()
        t0 = time.perf_counter()
        backend.put(self.key, self.roi, arr)
        with self._lock:
            self.stats["writes"] += 1
            self.stats["bytes_written"] += int(getattr(arr, "nbytes", 0))
            self.stats["write_s"] = self.stats.get("write_s", 0.0) + time.perf_counter() - t0

    # -- host/device movement (paper: upload/download, sync or async) -----------
    def to_device(self, device=None, *, blocking: bool = False) -> torch.Tensor:
        """Upload the payload to ``device`` (``None``: the CUDA card; see
        ``repro_torch.device.resolve_device``) and return it as a tensor.

        A host numpy array bound for the card is copied from pinned memory
        without blocking the host; a CUDA event recorded after the copy is
        what :meth:`ready` queries and :meth:`block_until_ready` waits on.
        """
        dev = resolve_device(device)
        with self._lock:
            if self._data is None:
                raise RuntimeError(f"{self.key}: not materialized")
            data = self._data
            src = host_tensor(data) if isinstance(data, np.ndarray) else torch.as_tensor(data)
            event = None
            if dev.type == "cuda":
                if not src.is_cuda:
                    src = src.pin_memory()
                arr = src.to(dev, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
            else:
                arr = src.to(dev)
            self._data = arr
            self._event = event
            self._location = "device"
        if blocking and event is not None:
            event.synchronize()
        return arr

    def to_host(self) -> np.ndarray:
        with self._lock:
            if self._location == "device":
                self._data = to_numpy(self._data)
                self._event = None
                self._location = "host"
            return self._data

    def ready(self) -> bool:
        """Non-blocking transfer-completion query (paper S3.3)."""
        # A readiness probe must stay non-blocking: taking _lock here
        # would park it behind an in-flight to_device()'s upload.
        # CPython attribute loads are atomic; a stale answer is the
        # accepted semantics of an asynchronous query.
        if self._location != "device":  # relint: allow(guarded-attribute) — see above
            return self._data is not None  # relint: allow(guarded-attribute) — see above
        event = self._event  # relint: allow(guarded-attribute) — see above
        return event is None or event.query()

    def block_until_ready(self) -> None:
        # snapshot under the lock, then block OUTSIDE it: holding _lock
        # across a device sync would stall every concurrent reader
        with self._lock:
            location, event = self._location, self._event
        if location == "device" and event is not None:
            event.synchronize()

    # -- misc -------------------------------------------------------------
    @property
    def nbytes(self) -> int:
        with self._lock:
            data = self._data
        if data is None:
            return int(np.prod(self.roi.shape)) * self.key.elem_type.itemsize
        return int(getattr(data, "nbytes", 0))

    def with_roi(self, roi: BoundingBox) -> "DataRegion":
        """Metadata-sharing view with a different ROI (partitioning, S3.4)."""
        return DataRegion(
            self.key,
            self.bb,
            self.kind,
            roi=roi,
            input_storage=self.input_storage,
            output_storage=self.output_storage,
            lazy=True,
        )

    def __repr__(self) -> str:
        return (
            f"DataRegion({self.key.qualified} t={self.key.timestamp} v={self.key.version} "
            f"{self.kind.name} bb={self.bb} roi={self.roi} "
            f"loc={self._location})"  # relint: allow(guarded-attribute) — diagnostic snapshot; repr must not block
        )


def _infer_location(data: Any) -> str:
    return "device" if isinstance(data, torch.Tensor) else "host"


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host numpy array -> a CPU tensor (bfloat16 from ``ml_dtypes`` goes
    through its bits). It shares ``arr``'s memory where ``arr`` is writable
    and contiguous, else holds a copy."""
    bits = arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr
    out = torch.from_numpy(np.require(bits, requirements=["C", "W"]))
    return out.view(torch.bfloat16) if bits is not arr else out


class ObjectSetRegion(DataRegion):
    """OBJECTSET data region: per-object records (e.g. feature vectors).

    Payload is a dict of equal-length arrays keyed by field name, plus the
    per-object bounding boxes; matches the paper's feature-computation
    output (one 50-100 dim vector per segmented nucleus).
    """

    def __init__(self, key: RegionKey, bb: BoundingBox, **kw: Any) -> None:
        super().__init__(key, bb, RegionKind.OBJECTSET, **kw)

    @property
    def num_objects(self) -> int:
        if self._data is None:
            return 0
        first = next(iter(self._data.values()))
        return int(first.shape[0])


# --------------------------------------------------------------------------
# Region template
# --------------------------------------------------------------------------
class RegionTemplate:
    """Named container of data regions within a minimal bounding box.

    ``insert`` grows the template bb to remain the minimum box containing
    all inserted regions (paper S3.3).  Regions sharing a name are kept in
    a version list and must differ in (elem_type, timestamp, version).
    """

    def __init__(self, name: str, namespace: str = "default") -> None:
        self.name = name
        self.namespace = namespace
        self._regions: dict[str, list[DataRegion]] = {}
        self.bb: BoundingBox | None = None
        self._lock = threading.RLock()

    # -- insertion / lookup ------------------------------------------------------
    def insert(self, region: DataRegion) -> DataRegion:
        with self._lock:
            lst = self._regions.setdefault(region.key.name, [])
            for existing in lst:
                if existing.key == region.key:
                    raise ValueError(
                        f"duplicate data region {region.key} in template {self.name!r}"
                    )
            lst.append(region)
            self.bb = region.bb if self.bb is None else self.bb.union(region.bb)
        return region

    def get(
        self,
        name: str,
        *,
        timestamp: int | None = None,
        version: int | None = None,
        elem_type: ElementType | None = None,
    ) -> DataRegion:
        """Associative lookup; unspecified identifiers resolve to the latest."""
        with self._lock:
            lst = self._regions.get(name)
            if not lst:
                raise KeyError(f"no data region {name!r} in template {self.name!r}")
            cands = [
                r
                for r in lst
                if (timestamp is None or r.key.timestamp == timestamp)
                and (version is None or r.key.version == version)
                and (elem_type is None or r.key.elem_type == elem_type)
            ]
            if not cands:
                raise KeyError(
                    f"no data region {name!r} matching ts={timestamp} v={version} in {self.name!r}"
                )
            # paper: "the system will use the latest staged region"
            return max(cands, key=lambda r: (r.key.timestamp, r.key.version))

    def num_regions(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._regions.values())

    def region_names(self) -> list[str]:
        with self._lock:
            return sorted(self._regions)

    def all_regions(self) -> list[DataRegion]:
        with self._lock:
            return [r for lst in self._regions.values() for r in lst]

    def versions(self, name: str) -> list[RegionKey]:
        with self._lock:
            return sorted(r.key for r in self._regions.get(name, []))

    # -- convenience constructors -----------------------------------------------
    def new_region(
        self,
        name: str,
        bb: BoundingBox,
        dtype,
        *,
        kind: RegionKind = RegionKind.DENSE,
        timestamp: int = 0,
        version: int = 0,
        data: Any | None = None,
        input_storage: str | None = None,
        output_storage: str | None = None,
        lazy: bool = False,
    ) -> DataRegion:
        key = RegionKey(self.namespace, name, ElementType.from_dtype(dtype), timestamp, version)
        cls = ObjectSetRegion if kind == RegionKind.OBJECTSET else DataRegion
        region = cls(
            key,
            bb,
            **({} if kind == RegionKind.OBJECTSET else {"kind": kind}),
            data=data,
            input_storage=input_storage,
            output_storage=output_storage,
            lazy=lazy,
        )
        return self.insert(region)

    # -- partitioning (manager side, paper Fig. 8a) -------------------------------
    def partition(self, tile_shape: Iterable[int]) -> list[BoundingBox]:
        with self._lock:
            if self.bb is None:
                raise RuntimeError("empty region template has no domain to partition")
            return list(self.bb.tiles(tuple(tile_shape)))

    # -- pack/unpack for Manager -> Worker shipping (paper S3.2) -------------------
    def pack(self) -> dict:
        """Metadata-only description; payloads travel through global storage."""
        with self._lock:
            return {
                "name": self.name,
                "namespace": self.namespace,
                "bb": self.bb,
                "regions": [
                    {
                        "key": r.key,
                        "bb": r.bb,
                        "roi": r.roi,
                        "kind": r.kind,
                        "input_storage": r.input_storage,
                        "output_storage": r.output_storage,
                        "lazy": r.lazy,
                    }
                    for r in self.all_regions()
                ],
            }

    @staticmethod
    def unpack(blob: dict) -> "RegionTemplate":
        rt = RegionTemplate(blob["name"], blob["namespace"])
        for rd in blob["regions"]:
            cls = ObjectSetRegion if rd["kind"] == RegionKind.OBJECTSET else DataRegion
            kw = {} if rd["kind"] == RegionKind.OBJECTSET else {"kind": rd["kind"]}
            rt.insert(
                cls(
                    rd["key"],
                    rd["bb"],
                    **kw,
                    roi=rd["roi"],
                    input_storage=rd["input_storage"],
                    output_storage=rd["output_storage"],
                    lazy=True,
                )
            )
        rt.bb = blob["bb"]
        return rt

    def __repr__(self) -> str:
        return (
            f"RegionTemplate({self.namespace}::{self.name} "
            f"bb={self.bb} regions={self.num_regions()})"  # relint: allow(guarded-attribute) — diagnostic snapshot; repr must not block
        )
