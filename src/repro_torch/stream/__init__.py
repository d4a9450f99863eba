"""Dynamic graphs: incremental densest-subgraph maintenance on one device.

``EdgeBuffer`` holds a mutable undirected edge set in fixed-capacity,
sentinel-padded slots; ``DeltaEngine`` keeps its symmetric COO lanes and
degrees resident on the device, patches them in O(batch) per update and
answers densest-subgraph queries (warm, pruned, refined) bit for bit as a
cold peel would. The JAX package's fused multi-tenant engine, graph
registry and service (``fused``, ``registry``, ``service``) are not ported
yet (ROADMAP queue 1 item 3).
"""
from repro_torch.stream.buffer import EdgeBuffer
from repro_torch.stream.delta import (
    DeltaEngine, EngineMetrics, QueryResult, UpdateStats,
)

__all__ = ["EdgeBuffer", "DeltaEngine", "QueryResult", "UpdateStats",
           "EngineMetrics"]
