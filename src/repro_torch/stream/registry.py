"""Multi-tenant named-graph registry with capacity bucketing.

A serving deployment holds many evolving graphs (one per customer, region,
or product surface). The registry normalizes every tenant onto shared
buckets:

  * vertex space  -> next power of two (``DeltaEngine.node_capacity``)
  * edge capacity -> next power of two   (``EdgeBuffer`` growth rule)
  * update batch  -> next power of two   (``delta.MIN_BATCH`` floor)

Fused tenants (``fused=True``) of one bucket share a lane stack and answer
queries through one batched program a flush (stream/fused.py).

Eviction is plain LRU on engine *access* (updates and queries both touch):
the registry is a cache of warm device state, not the system of record —
an evicted tenant can be re-registered and replayed from its stream.

Sharded tenants (``sharded=True``) span the registry's mesh (``mesh=``, a
``core.distributed.Mesh``; by default one made at the first sharded
registration over the default process group, or a world of one), every rank
of which runs the same registry and feeds it the same traffic.

This is the JAX package's ``stream/registry.py``; a registry takes
``device=`` (None means the GPU and raises where there is none; with a mesh,
the mesh's device).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import torch

from repro_torch.core.dispatch import resolve_kernel
from repro_torch.core.distributed import make_mesh, mesh_device
from repro_torch.stream.buffer import MIN_CAPACITY, next_pow2
from repro_torch.stream.delta import DeltaEngine
from repro_torch.stream.fused import FusedEngine, FusedPool


@dataclass
class TenantStats:
    name: str
    n_nodes: int
    node_capacity: int
    n_edges: int
    edge_capacity: int
    eps: float
    n_update_batches: int
    n_queries: int
    n_refreshes: int
    update_ms_total: float
    query_ms_total: float
    # candidate pruning (core/prune.py): the operator-facing view of the
    # warm-start pipeline — how much of the graph the ceil(rho~)-core keeps,
    # which compacted buckets queries run in, and whether plan rebuilds keep
    # keeping the same buckets (reuse = healthy steady state)
    pruned: bool = False
    n_pruned_queries: int = 0
    n_prune_fallbacks: int = 0
    candidate_fraction: float = 0.0
    prune_bucket_v: int = 0
    prune_bucket_e: int = 0
    bucket_reuses: int = 0
    # sharded streaming (core/distributed.py): how many devices the
    # tenant's edge slots span, plus the contracting-graph counters — a
    # healthy sliding-window tenant shows shrinks instead of a capacity
    # high-water mark, and a delete-heavy one shows tombstone compactions
    sharded: bool = False
    n_shards: int = 1
    n_buffer_shrinks: int = 0
    n_bucket_shrinks: int = 0
    tombstone_fraction: float = 0.0
    # fused multi-tenant execution (stream/fused.py): which lane of which
    # bucket stack this tenant's device state lives in — same-bucket
    # tenants answer queries through one batched program per flush
    fused: bool = False
    lane: int = -1
    batch_lanes: int = 0
    # near-optimal refinement (repro_torch.refine): certified queries served,
    # total rounds spent, and how many were answered by the cached
    # certificate alone (no peel dispatched — the early-exit path)
    n_refine_queries: int = 0
    refine_rounds_total: int = 0
    n_certified_skips: int = 0
    # first-call vs steady split (obs audit layer): query_ms_total above
    # keeps the combined number; these separate first calls (a kernel
    # library load) from steady-state latency (the SLO-relevant series)
    n_query_first_calls: int = 0
    query_first_call_ms: float = 0.0
    query_steady_ms: float = 0.0
    # kernel-tier dispatch (core/dispatch.py): whether this tenant's passes
    # run through the CUDA kernels (bit-identical to the scatter tier; the
    # default is on for a CUDA device)
    kernel: bool = False
    # where this tenant's device state lives and how its programs launch:
    # "solo", "sharded", "fused", or "fused+sharded" (one of the four cells
    # of the placement matrix)
    placement: str = "solo"
    # which worker process hosts this tenant (the telemetry plane): the
    # cross-process collector re-keys tenants by
    # (worker, tenant), so the same tenant name on two workers stays
    # distinct in the fleet view
    worker: str = ""


def placement_of(eng) -> str:
    """The placement-matrix cell an engine occupies (fused x sharded)."""
    fused = bool(getattr(eng, "fused", False))
    if fused and eng.sharded:
        return "fused+sharded"
    if fused:
        return "fused"
    return "sharded" if eng.sharded else "solo"


class GraphRegistry:
    """Name -> DeltaEngine map with capacity bucketing + LRU eviction."""

    def __init__(self, max_tenants: int = 64, eps: float = 0.0,
                 refresh_every: int = 32, pruned: bool = True,
                 sharded: bool = False, mesh=None, fused: bool = False,
                 kernel: bool | None = None, worker: str = "",
                 device: torch.device | str | None = None):
        if max_tenants <= 0:
            raise ValueError("max_tenants must be >= 1")
        # every tenant's device state lives here (None: the GPU; with a
        # mesh, the mesh's device)
        self.device = mesh_device(mesh, device)
        # one mesh for the whole registry: sharded tenants of one capacity
        # bucket then share a fused stack (the pool keys on the mesh)
        self.mesh = mesh
        self.max_tenants = int(max_tenants)
        # worker identity for cross-process telemetry (surfaced per tenant
        # in TenantStats.worker; the service defaults it to the pid)
        self.worker = str(worker)
        self.default_eps = float(eps)
        self.default_refresh_every = int(refresh_every)
        self.default_pruned = bool(pruned)
        self.default_sharded = bool(sharded)
        # one fused pool for the whole registry: fused tenants that bucket
        # together share a lane stack, so bucket membership is a batch
        # roster (join/evict = row swap) rather than a compile event
        self.default_fused = bool(fused)
        self.fused_pool = FusedPool()
        # kernel-tier default: None is on for a CUDA device (the
        # ``resolve_kernel`` rule); per-tenant ``register(kernel=...)``
        # overrides it
        self.default_kernel = kernel
        self._engines: OrderedDict[str, DeltaEngine] = OrderedDict()
        self.evictions = 0

    # -- lifecycle ----------------------------------------------------------
    def register(
        self,
        name: str,
        n_nodes: int,
        eps: float | None = None,
        capacity: int = MIN_CAPACITY,
        refresh_every: int | None = None,
        pruned: bool | None = None,
        sharded: bool | None = None,
        fused: bool | None = None,
        kernel: bool | None = None,
    ) -> DeltaEngine:
        """Create (or return the existing) engine for ``name``.

        ``fused=True`` opts the tenant into the fused multi-tenant layer
        (stream/fused.py): its device state becomes a row of the bucket's
        stacked tensors and same-bucket queries batch into one program a
        flush, at bit-identical per-tenant results. ``sharded=True`` spans
        the tenant's lanes over the registry's mesh (at identical query
        results); with ``fused=True`` too, its bucket's batched programs make
        one collective a pass for the whole bucket.

        Re-registering with the same logical config is an idempotent no-op;
        a conflicting config raises rather than silently handing back an
        engine sized for a different graph."""
        want_eps = self.default_eps if eps is None else float(eps)
        want_sharded = (self.default_sharded if sharded is None
                        else bool(sharded))
        want_fused = self.default_fused if fused is None else bool(fused)
        # resolve exactly like DeltaEngine.__init__ will, so the re-register
        # conflict check below compares like with like (sharded engines stay
        # on the scatter tier)
        want_kernel = resolve_kernel(
            self.default_kernel if kernel is None else kernel, self.device) and not want_sharded
        if name in self._engines:
            eng = self.get(name)
            is_fused = isinstance(eng, FusedEngine)
            if (eng.n_nodes != int(n_nodes) or eng.eps != want_eps
                    or eng.sharded != want_sharded
                    or is_fused != want_fused
                    or eng.kernel != want_kernel):
                raise ValueError(
                    f"tenant {name!r} already registered with "
                    f"n_nodes={eng.n_nodes}, eps={eng.eps}, "
                    f"sharded={eng.sharded}, fused={is_fused}, "
                    f"kernel={eng.kernel}; got "
                    f"n_nodes={n_nodes}, eps={want_eps}, "
                    f"sharded={want_sharded}, fused={want_fused}, "
                    f"kernel={want_kernel}"
                )
            return eng
        kwargs = dict(
            n_nodes=n_nodes,
            eps=want_eps,
            capacity=next_pow2(capacity),
            refresh_every=(
                self.default_refresh_every if refresh_every is None
                else int(refresh_every)
            ),
            pruned=self.default_pruned if pruned is None else bool(pruned),
            kernel=want_kernel,
            device=self.device,
        )
        if want_sharded and self.mesh is None:
            self.mesh = make_mesh(device=self.device)
        mesh = self.mesh if want_sharded else None
        if want_fused:
            eng = FusedEngine(name, self.fused_pool, sharded=want_sharded, mesh=mesh, **kwargs)
        else:
            eng = DeltaEngine(sharded=want_sharded, mesh=mesh, **kwargs)
        eng.tenant = name  # label spans/audit records with the tenant name
        self._engines[name] = eng
        self._engines.move_to_end(name)
        while len(self._engines) > self.max_tenants:
            _, evicted = self._engines.popitem(last=False)
            if isinstance(evicted, FusedEngine):
                evicted.release()  # free the lane: a cheap row swap
            self.evictions += 1
        return eng

    def get(self, name: str) -> DeltaEngine:
        eng = self._engines.get(name)
        if eng is None:
            raise KeyError(f"unknown tenant {name!r}")
        self._engines.move_to_end(name)  # LRU touch
        return eng

    def remove(self, name: str) -> None:
        eng = self._engines.pop(name, None)
        if isinstance(eng, FusedEngine):
            eng.release()

    def engines(self) -> dict[str, DeltaEngine]:
        """Name -> engine snapshot (no LRU touch) for grouped operations —
        the fused query/ingest helpers take this mapping directly."""
        return dict(self._engines)

    def __contains__(self, name: str) -> bool:
        return name in self._engines

    def __len__(self) -> int:
        return len(self._engines)

    def names(self) -> list[str]:
        """Tenants, least-recently-used first."""
        return list(self._engines)

    # -- stats --------------------------------------------------------------
    def stats(self, name: str) -> TenantStats:
        eng = self._engines[name]  # no LRU touch: stats are observability
        m = eng.metrics
        return TenantStats(
            name=name,
            n_nodes=eng.n_nodes,
            node_capacity=eng.node_capacity,
            n_edges=eng.n_edges,
            edge_capacity=eng.buffer.capacity,
            eps=eng.eps,
            n_update_batches=m.n_update_batches,
            n_queries=m.n_queries,
            n_refreshes=m.n_refreshes,
            update_ms_total=m.update_ms_total,
            query_ms_total=m.query_ms_total,
            pruned=eng.pruned,
            n_pruned_queries=m.n_pruned_queries,
            n_prune_fallbacks=m.n_prune_fallbacks,
            candidate_fraction=m.candidate_fraction,
            prune_bucket_v=m.prune_bucket_v,
            prune_bucket_e=m.prune_bucket_e,
            bucket_reuses=m.bucket_reuses,
            sharded=eng.sharded,
            n_shards=eng.n_shards,
            n_buffer_shrinks=m.n_buffer_shrinks,
            n_bucket_shrinks=m.n_bucket_shrinks,
            tombstone_fraction=eng.buffer.tombstone_fraction,
            fused=isinstance(eng, FusedEngine),
            lane=(eng._lane if isinstance(eng, FusedEngine)
                  and eng._lane is not None else -1),
            batch_lanes=(eng.batch.lanes if isinstance(eng, FusedEngine)
                         and eng.batch is not None else 0),
            n_refine_queries=m.n_refine_queries,
            refine_rounds_total=m.refine_rounds_total,
            n_certified_skips=m.n_certified_skips,
            n_query_first_calls=m.n_query_first_calls,
            query_first_call_ms=m.query_first_call_ms_total,
            query_steady_ms=m.query_steady_ms_total,
            kernel=eng.kernel,
            placement=placement_of(eng),
            worker=self.worker,
        )

    def all_stats(self) -> list[TenantStats]:
        return [self.stats(n) for n in self._engines]


__all__ = ["GraphRegistry", "TenantStats", "placement_of"]
