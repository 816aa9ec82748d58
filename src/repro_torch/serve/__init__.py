"""Serving substrate: the region-serving gateway (staged admission ->
fairness -> response-cache -> coalesce pipeline over the tiered region
store), the near-data compute engine (server-side kernel chains), and LM
serving (caches, prefill/decode steps and greedy generation)."""
from repro_torch.serve.compute import (
    ComputeEngine,
    ComputeRequest,
    ComputeTicket,
    DerivedCache,
)
from repro_torch.serve.fair import DEFAULT_CLASSES, ClientPacer, FairScheduler
from repro_torch.serve.gateway import (
    GatewayClosed,
    GatewayConfig,
    GatewayStats,
    Overloaded,
    ReadTicket,
    RegionGateway,
    WriteTicket,
)
from repro_torch.serve.rcache import GenerationTracker, ResponseCache, WindowPrefetcher
from repro_torch.serve.step import (
    abstract_cache,
    cache_pspecs,
    cache_shardings,
    generate,
    make_cache,
    make_decode_step,
    make_prefill_step,
    shard_tree,
)

__all__ = [
    "DEFAULT_CLASSES",
    "ClientPacer",
    "ComputeEngine",
    "ComputeRequest",
    "ComputeTicket",
    "DerivedCache",
    "FairScheduler",
    "GatewayClosed",
    "GatewayConfig",
    "GatewayStats",
    "GenerationTracker",
    "Overloaded",
    "ReadTicket",
    "RegionGateway",
    "ResponseCache",
    "WindowPrefetcher",
    "WriteTicket",
    "abstract_cache",
    "cache_pspecs",
    "cache_shardings",
    "generate",
    "make_cache",
    "make_decode_step",
    "make_prefill_step",
    "shard_tree",
]
