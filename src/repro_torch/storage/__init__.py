"""Global storage implementations for data regions (paper S4 + S7).

Storage hierarchy
-----------------
All backends implement the same ``StorageBackend`` protocol
(``put``/``get``/``query``/``delete``), so stages never care where bytes
live.  Picking one:

* ``DistributedMemoryStorage`` (DMS) — in-memory, SFC-partitioned across
  servers; the fastest *shared* layer.  Use for hot inter-stage exchange
  when everything fits in aggregate RAM.  Its servers sit behind the
  ``Transport`` message protocol: ``InProcTransport`` (in-process shards
  + virtual-time link model) or ``SocketTransport`` (framed TCP to
  ``ServerProcess`` hosts — the multi-host deployment).
  ``replication=R`` places every block on R servers along the SFC ring
  and fails reads over between replicas, so R-1 dead servers cause zero
  failed reads (directories are replicated everywhere already).
* ``DiskStorage`` (DISK) — ADIOS-style chunked staging with I/O groups
  and a crash-tolerant manifest.  Use for durable staging, checkpoints,
  and payloads too large for memory.
* ``SpatioTemporalCache`` — an LRU + motion-predictive prefetch *front*
  for any single backend.  Use when one client re-reads a drifting ROI
  stream (tracking workloads).
* ``TieredStore`` — the automatic hierarchy (bounded RAM tier -> DISK ->
  DMS) behind one name: read-through promotion, capacity-triggered
  spill-down, write-through/write-back with ``flush()``/``drain()``, and
  a ``PlacementPolicy`` hook (pin namespaces, size/dtype thresholds, ROI
  spill granularity).  Prefer it whenever the working set is bigger than
  any single layer or the access pattern is not known up front; its
  ``locality(key)`` query also lets the runtime scheduler price
  transfers per tier.

The modules are copies of ``repro.storage``'s, which hold no JAX, but the
checkpoint manager (``storage.checkpoint``), which writes the reference's
layout from torch tensors and modules.
"""
from repro_torch.storage.autotune import IOConfig, TuneResult, autotune_io
from repro_torch.storage.checkpoint import CheckpointManager
from repro_torch.storage.codec import (
    WIRE_CODECS,
    Encoded,
    decode_block,
    encode_block,
)
from repro_torch.storage.disk import DiskCostModel, DiskStats, DiskStorage
from repro_torch.storage.dms import (
    DistributedMemoryStorage,
    DMSStats,
    InProcTransport,
    Transport,
    TransportError,
    TransportStats,
    decode_homes,
    encode_homes,
)
from repro_torch.storage.net import (
    ServerGroup,
    ServerProcess,
    ShmTransport,
    SocketTransport,
    spawn_servers,
)
from repro_torch.storage.membership import RingView, TokenBucket, adopt_newer
from repro_torch.storage.shm import ShmArena, ShmWindow
from repro_torch.storage.placement import (
    Placement,
    PlacementPolicy,
    PlacementRule,
    dtype_tier,
    pin_namespace,
    size_threshold,
    when,
)
from repro_torch.storage.stcache import SpatioTemporalCache, STCacheStats
from repro_torch.storage.tiers import (
    TIER_BANDWIDTH,
    MemoryTier,
    Tier,
    TieredStore,
    TierStats,
)

__all__ = [
    "CheckpointManager",
    "DiskCostModel",
    "DiskStats",
    "DiskStorage",
    "DistributedMemoryStorage",
    "DMSStats",
    "InProcTransport",
    "Transport",
    "TransportStats",
    "decode_homes",
    "encode_homes",
    "ServerGroup",
    "ServerProcess",
    "ShmArena",
    "ShmTransport",
    "ShmWindow",
    "SocketTransport",
    "TransportError",
    "spawn_servers",
    "WIRE_CODECS",
    "Encoded",
    "decode_block",
    "encode_block",
    "IOConfig",
    "TuneResult",
    "autotune_io",
    "SpatioTemporalCache",
    "STCacheStats",
    "RingView",
    "TokenBucket",
    "adopt_newer",
    "Placement",
    "PlacementPolicy",
    "PlacementRule",
    "dtype_tier",
    "pin_namespace",
    "size_threshold",
    "when",
    "TIER_BANDWIDTH",
    "MemoryTier",
    "Tier",
    "TieredStore",
    "TierStats",
]

