"""Global storage implementations for data regions (paper S4 + S7).

Storage hierarchy
-----------------
All backends implement the same ``StorageBackend`` protocol
(``put``/``get``/``query``/``delete``), so stages never care where bytes
live.  Picking one:

* ``DistributedMemoryStorage`` (DMS) — in-memory, SFC-partitioned across
  servers; the fastest *shared* layer.  Use for hot inter-stage exchange
  when everything fits in aggregate RAM.  Its servers sit behind the
  ``Transport`` message protocol; this package has the in-process one,
  ``InProcTransport`` (in-process shards + virtual-time link model).
  ``replication=R`` places every block on R servers along the SFC ring
  and fails reads over between replicas, so R-1 dead servers cause zero
  failed reads (directories are replicated everywhere already).
* ``DiskStorage`` (DISK) — ADIOS-style chunked staging with I/O groups
  and a crash-tolerant manifest.  Use for durable staging and payloads
  too large for memory.
* ``TieredStore`` — the automatic hierarchy (bounded RAM tier -> DISK ->
  DMS) behind one name: read-through promotion, capacity-triggered
  spill-down, write-through/write-back with ``flush()``/``drain()``, and
  a ``PlacementPolicy`` hook (pin namespaces, size/dtype thresholds, ROI
  spill granularity).  Prefer it whenever the working set is bigger than
  any single layer or the access pattern is not known up front; its
  ``locality(key)`` query also lets the runtime scheduler price
  transfers per tier.

The modules are copies of ``repro.storage``'s, which hold no JAX. The
socket and shared-memory transports, the spatio-temporal cache front, the
I/O autotuner and the checkpoint manager are not ported yet: asking this
package for one of their names raises ``AttributeError``.
"""
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
from repro_torch.storage.membership import RingView, TokenBucket, adopt_newer
from repro_torch.storage.placement import (
    Placement,
    PlacementPolicy,
    PlacementRule,
    dtype_tier,
    pin_namespace,
    size_threshold,
    when,
)
from repro_torch.storage.tiers import (
    TIER_BANDWIDTH,
    MemoryTier,
    Tier,
    TieredStore,
    TierStats,
)

__all__ = [
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
    "TransportError",
    "WIRE_CODECS",
    "Encoded",
    "decode_block",
    "encode_block",
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

# names of repro.storage that this package does not have yet, by the module
# of repro.storage that holds them
NOT_PORTED = {
    "CheckpointManager": "checkpoint",
    "SocketTransport": "net",
    "ServerGroup": "net",
    "ServerProcess": "net",
    "ShmTransport": "net",
    "spawn_servers": "net",
    "ShmArena": "shm",
    "ShmWindow": "shm",
    "SpatioTemporalCache": "stcache",
    "STCacheStats": "stcache",
    "IOConfig": "autotune",
    "TuneResult": "autotune",
    "autotune_io": "autotune",
}


def __getattr__(name: str):
    if name in NOT_PORTED:
        raise AttributeError(
            f"{name} (repro.storage.{NOT_PORTED[name]}) is not yet ported to "
            f"repro_torch (ROADMAP queue 1)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
