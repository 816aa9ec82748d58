"""Core region-template abstraction (the paper's primary contribution)."""
from repro_torch.core.bbox import BoundingBox, union_all
from repro_torch.core.hilbert import (
    hilbert_d2xy,
    hilbert_xy2d,
    morton_decode,
    morton_encode,
    sfc_index,
    sfc_order_for,
)
from repro_torch.core.pacing import TokenBucket
from repro_torch.core.regions import (
    STORAGE,
    DataRegion,
    ElementType,
    Intent,
    ObjectSetRegion,
    RegionKey,
    RegionKind,
    RegionTemplate,
    StorageBackend,
    StorageRegistry,
)

__all__ = [
    "BoundingBox",
    "union_all",
    "hilbert_d2xy",
    "hilbert_xy2d",
    "morton_encode",
    "morton_decode",
    "sfc_index",
    "sfc_order_for",
    "TokenBucket",
    "STORAGE",
    "DataRegion",
    "ElementType",
    "Intent",
    "ObjectSetRegion",
    "RegionKey",
    "RegionKind",
    "RegionTemplate",
    "StorageBackend",
    "StorageRegistry",
]
