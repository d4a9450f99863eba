"""Dynamic graphs: incremental densest-subgraph maintenance and multi-tenant
serving.

  buffer.py   — fixed-capacity sentinel-padded edge buffer (pow-2 growth)
  delta.py    — incremental maintenance engine (degree deltas + warm peel)
  fused.py    — fused multi-tenant execution (row-batched bucket peels: one
                launch of K2's rows entry a pass for a whole bucket)
  registry.py — multi-tenant named-graph registry (capacity bucketing, LRU)
  service.py  — batch query front-end with latency/build metrics

Every engine, registry and service also runs sharded (``sharded=True``,
``mesh=``): one tenant's lanes split over the ranks of a
``core.distributed.Mesh``, one all-reduce a pass.
"""
from repro_torch.stream.buffer import EdgeBuffer
from repro_torch.stream.delta import (
    DeltaEngine, EngineMetrics, QueryResult, UpdateStats,
)
from repro_torch.stream.fused import (
    FusedEngine, FusedPool, TenantBatch, ingest_group, query_group,
)
from repro_torch.stream.registry import GraphRegistry, TenantStats
from repro_torch.stream.service import ServiceResponse, StreamService

__all__ = [
    "EdgeBuffer",
    "DeltaEngine",
    "QueryResult",
    "UpdateStats",
    "EngineMetrics",
    "FusedEngine",
    "FusedPool",
    "TenantBatch",
    "ingest_group",
    "query_group",
    "GraphRegistry",
    "TenantStats",
    "StreamService",
    "ServiceResponse",
]
