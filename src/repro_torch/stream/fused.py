"""Fused multi-tenant execution: a bucket of tenants peeled by one launch a pass.

Tenants of the same (node_capacity, edge_capacity, eps, kernel, device)
bucket share stacked device state, and every query flush or ingest runs one
batched program for all the bucket's queried tenants instead of one per
tenant:

  * :class:`TenantBatch` keeps the bucket's state as leading-axis tensors —
    ``[T, 2*capacity]`` int32 lanes, ``[T, node_capacity]`` degrees and
    warm-seed masks, and below ``DENSE_NODE_CAP`` a ``[T, V, V]`` float32
    adjacency — one row (a *lane* of the stack) a tenant. Join and evict are
    row writes; a full stack doubles.
  * ingest (``delta._batched_apply``), the warm peel
    (``delta._batched_warm_peel``), the pruned bucket peel
    (``prune._batched_bucket_peel``, after the row-batched resident prep
    ``prune.prepare_pruned_peel_rows``) and the refinement rounds
    (``loads._batched_refine_round``) each run once for the group, with the
    batch axis written out (``core/batched.py``): a pass is one launch of
    K2's rows entry for every queried tenant, converged rows frozen, each
    row's triple bit-identical to a solo ``DeltaEngine`` fed the same stream.
    The dense buckets peel and refine through batched float32 products
    (exact below 2^24; refused unless the matmul precision is "highest").
  * :class:`FusedEngine` is a ``DeltaEngine`` whose device state is its row
    of the bucket's stacks: ``_src``, ``_dst``, ``_deg``, ``_prev_mask`` and
    ``_lane_perm`` are properties that read the row and write into it, so
    the inherited host paths (plan, refresh, cbds, the re-sort) can never
    part from the stack, even when the stack grows.
  * :func:`query_group` answers many tenants with one flush per bucket;
    :func:`ingest_group` applies many tenants' batches with one patch per
    bucket. The service's coalescing window and ``top_k_densest`` route
    through them.

Lane order with the kernel on: K1 and K2 need every row dst-sorted. Each
row keeps the buffer's dst-sorted layout with its ``lane_perm`` (row of a
``[T, 2*capacity]`` stack), a batch marks the rows it patched unsorted, and
one stable ``torch.sort(dim=1)`` of the unsorted rows among those about to
be peeled restores them (``TenantBatch.resort``). The JAX package's stacks
keep the unsorted slot layout (its kernel recomputes bands from the data);
the triple does not depend on the order within a row.

Sharded buckets (``mesh=``; tenants registered ``sharded=True``): each rank
holds its block of every tenant's lanes, ``[T, 2*capacity / n]``, and the
replicated ``[T, V]`` state, and every batched program above runs over the
rank's blocks with one ``[G, V + 1]`` all-reduce a batched pass for the whole
group (one ``[T, V]`` one an ingest): the collective's cost spread over the
bucket's tenants, the reason the tier exists. As in the JAX package they
keep the scatter tier, no dense stack, and their pruned members are
prepared on the host from their buffers (``prune.prepare_pruned_peel``),
the bucket peel sharded. The mesh is part of the pool's key.

Differences from the JAX package's module, none in a result: the group is
not padded to a power of two (the padding only reuses XLA executables; the
audit key keeps the JAX formula, so spans and ``compiled`` match), the
unsharded pruned members are prepared on the device from their rows instead
of on the host from their buffers, and a sharded stack is written in place
by its rank (the JAX package's laundering jits only keep XLA's output
shardings consistent).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import replace as dc_replace

import numpy as np
import torch

from repro_torch.core.batched import dense_pass_rows, init_rows, require_exact_matmul, run_rows
from repro_torch.core.dispatch import assert_exact_envelope
from repro_torch.core.distributed import lane_block, mesh_device, mesh_device_count
from repro_torch.core.pbahmani import PeelState
from repro_torch.core.prune import (
    _batched_bucket_peel, merge_pruned_peel, prepare_pruned_peel, prepare_pruned_peel_rows,
)
from repro_torch.obs.audit import AUDITOR
from repro_torch.obs.trace import get_tracer, span
from repro_torch.refine.certify import (
    better_fraction, dual_fraction, make_certificate, max_fraction,
)
from repro_torch.refine.engine import DEFAULT_TARGET_GAP
from repro_torch.refine.loads import _batched_dense_refine_round, _batched_refine_round
from repro_torch.stream.buffer import MIN_CAPACITY, next_pow2
from repro_torch.stream.delta import (
    MIN_BATCH, DeltaEngine, QueryResult, _batched_apply, _batched_warm_peel,
)

MIN_LANES = 4  # smallest lane stack; doubles when a bucket fills
# buckets whose (pow-2) vertex space fits under this bound also keep a dense
# [T, V, V] float32 adjacency stack and peel through batched products: every
# value involved is an integer < 2^24, so float32 accumulation is exact and
# the trajectory stays bit-identical. Memory is the gate: V=512 is 1 MiB a
# tenant.
DENSE_NODE_CAP = 512


def _dense_warm_peel_body(adj, deg, n_edges, prev_mask, eps: float):
    """``delta._batched_warm_peel`` off the dense adjacency ``[G, V, V]``:
    the same init off the maintained degrees, the same loop with the JAX
    package's ``_dense_pass`` as a batched pass (``core.batched.
    dense_pass_rows``), and the previous mask re-evaluated as
    ``pm' A pm / 2``."""
    require_exact_matmul()
    final = run_rows(init_rows(deg, n_edges), lambda s: dense_pass_rows(s, adj, eps))
    pm = prev_mask.to(torch.float32)
    warm_e = (pm * torch.bmm(adj, pm[:, :, None])[:, :, 0]).sum(dim=1).to(torch.int32) // 2
    warm_v = prev_mask.sum(dim=1, dtype=torch.int32)
    warm_rho = torch.where(
        warm_v > 0, warm_e.to(torch.float32) / warm_v.clamp(min=1).to(torch.float32), 0.0)
    return final, warm_rho


# ---------------------------------------------------------------------------
# the per-bucket lane stack
# ---------------------------------------------------------------------------
class TenantBatch:
    """Stacked device state for every tenant in one capacity bucket.

    ``mesh`` makes the stack *sharded*: each rank holds its block of every
    row's lanes, and every batched program makes one collective a pass for
    the whole bucket. The dense tier is unsharded only, as in the JAX
    package."""

    def __init__(self, node_capacity: int, edge_capacity: int, eps: float,
                 lanes: int = MIN_LANES, kernel: bool = False,
                 device: torch.device | str | None = None, mesh=None):
        self.mesh = mesh
        self.sharded = mesh is not None
        self.device = mesh_device(mesh, device)
        self.node_capacity = int(node_capacity)
        self.edge_capacity = int(edge_capacity)
        self.eps = float(eps)
        self.kernel = bool(kernel)
        self.lanes = max(next_pow2(lanes), MIN_LANES)
        self.dense = self.node_capacity <= DENSE_NODE_CAP and not self.sharded
        self.lane_of: dict[str, int] = {}
        self._free = list(range(self.lanes - 1, -1, -1))
        self.lane_generation: dict[int, int] = {}
        self.n_ingests = 0            # ingest batches absorbed
        self.n_ingest_dispatches = 0  # patches launched for them (one each)
        self.n_group_peels = 0        # fused query flushes
        self._alloc(self.lanes)

    @property
    def n_shards(self) -> int:
        return mesh_device_count(self.mesh) if self.sharded else 1

    def _alloc(self, lanes: int) -> None:
        v, dev = self.node_capacity, self.device
        width = 2 * self.edge_capacity // self.n_shards  # this rank's block of a row
        self._src = torch.full((lanes, width), v, dtype=torch.int32, device=dev)
        self._dst = torch.full((lanes, width), v, dtype=torch.int32, device=dev)
        self._deg = torch.zeros((lanes, v), dtype=torch.int32, device=dev)
        self._prev_mask = torch.zeros((lanes, v), dtype=torch.bool, device=dev)
        self._adj = (torch.zeros((lanes, v, v), dtype=torch.float32, device=dev)
                     if self.dense else None)
        # kernel mode: each row dst-sorted, lane_perm its unsorted lane ->
        # position map (a blank row is sorted as it is)
        self._lane_perm = (torch.arange(width, dtype=torch.int32, device=dev).repeat(lanes, 1)
                           if self.kernel else None)
        self._unsorted = np.zeros(lanes, dtype=bool)

    def _stacks(self) -> list[str]:
        return [n for n in ("_src", "_dst", "_deg", "_prev_mask", "_adj", "_lane_perm")
                if getattr(self, n) is not None]

    def _grow(self) -> None:
        """Double the lane count, keeping every row."""
        old, saved = self.lanes, {n: getattr(self, n) for n in self._stacks()}
        unsorted = self._unsorted
        self.lanes = old * 2
        self._alloc(self.lanes)
        for n, t in saved.items():
            getattr(self, n)[:old].copy_(t)
        self._unsorted[:old] = unsorted
        self._free = list(range(self.lanes - 1, old - 1, -1)) + self._free

    # -- membership ---------------------------------------------------------
    def join(self, name: str) -> int:
        """Allocate a lane for ``name`` (the caller writes the state)."""
        if name in self.lane_of:
            return self.lane_of[name]
        if not self._free:
            self._grow()
        lane = self._free.pop()
        self.lane_of[name] = lane
        return lane

    def evict(self, name: str) -> None:
        """Free ``name``'s lane and blank it."""
        lane = self.lane_of.pop(name, None)
        if lane is None:
            return
        width = 2 * self.edge_capacity
        sent = np.full(width, self.node_capacity, np.int32)
        self.write_lane(lane, sent, sent, np.zeros(self.node_capacity, np.int32),
                        torch.zeros(self.node_capacity, dtype=torch.bool), generation=-1,
                        lane_perm=np.arange(width, dtype=np.int32))
        self.lane_generation.pop(lane, None)
        self._free.append(lane)

    def write_lane(self, lane: int, src, dst, deg, mask, generation: int,
                   lane_perm=None) -> None:
        """One tenant's whole state into row ``lane`` (host arrays or
        tensors): a resync, a join or an evict. A sharded stack takes the
        rank's block of the full-width lanes."""
        if self.sharded:
            src, dst = lane_block(src, self.mesh), lane_block(dst, self.mesh)

        def put(stack, value):
            t = value if isinstance(value, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(value))
            stack[lane].copy_(t)

        put(self._src, src)
        put(self._dst, dst)
        put(self._deg, deg)
        put(self._prev_mask, mask)
        if self.kernel:
            put(self._lane_perm, lane_perm)
            self._unsorted[lane] = False
        if self.dense:
            nc = self.node_capacity
            adj = np.zeros((nc, nc), np.float32)
            s, d = np.asarray(src), np.asarray(dst)
            valid = s < nc
            np.add.at(adj, (s[valid], d[valid]), 1.0)
            put(self._adj, adj)
        self.lane_generation[lane] = generation

    def set_mask_rows(self, lanes: torch.Tensor, masks: torch.Tensor) -> None:
        """Write updated warm-seed masks ``[k, V]`` into rows ``lanes``."""
        if lanes.numel():
            self._prev_mask.index_copy_(0, lanes, masks)

    # -- batched programs ---------------------------------------------------
    def ingest(self, rows: dict[int, tuple]) -> int:
        """One patch of every row with a pending batch (``rows``: lane ->
        padded batch row; the others untouched). Returns the widest batch
        row dispatched."""
        b = max(max(r[0].shape[0] for r in rows.values()), MIN_BATCH)
        written = _batched_apply(self._src, self._dst, self._deg, rows, self._lane_perm,
                                 self._adj, self.mesh)
        if self.kernel:
            self._unsorted[written] = True
        self.n_ingests += 1
        self.n_ingest_dispatches += 1
        return b

    def resort(self, lanes) -> None:
        """Restore dst order of the unsorted rows among ``lanes`` (kernel
        mode): one stable sort of their dst along the row, src gathered by
        its order, and each row's ``lane_perm`` composed with the order's
        inverse, written back into the stacks."""
        dirty = [int(lane) for lane in lanes if self._unsorted[int(lane)]]
        if not dirty:
            return
        idx = torch.tensor(dirty, dtype=torch.int64, device=self.device)
        dst, order = torch.sort(self._dst.index_select(0, idx), dim=1, stable=True)
        src = torch.gather(self._src.index_select(0, idx), 1, order)
        inverse = torch.empty_like(order).scatter_(
            1, order, torch.arange(order.shape[1], device=self.device).expand_as(order))
        perm = torch.gather(inverse, 1, self._lane_perm.index_select(0, idx).long())
        self._dst.index_copy_(0, idx, dst)
        self._src.index_copy_(0, idx, src)
        self._lane_perm.index_copy_(0, idx, perm.to(torch.int32))
        self._unsorted[dirty] = False

    def rows(self, lanes: list[int]) -> tuple[torch.Tensor, ...]:
        """(src, dst, deg, prev_mask) of ``lanes`` gathered into ``[g, ...]``
        tensors, dst order restored first in kernel mode."""
        if self.kernel:
            self.resort(lanes)
        idx = torch.tensor(lanes, dtype=torch.int64, device=self.device)
        return tuple(t.index_select(0, idx) for t in (self._src, self._dst, self._deg,
                                                       self._prev_mask))

    def peel_rows(self, lanes: list[int], n_edges: list[int]):
        """Batched warm peel of ``lanes``: returns the row-batched final
        (PeelState) and float32 ``[g]`` warm densities."""
        src, dst, deg, mask = self.rows(lanes)
        ne = torch.tensor(n_edges, dtype=torch.int32, device=self.device)
        if self.dense:
            idx = torch.tensor(lanes, dtype=torch.int64, device=self.device)
            return _dense_warm_peel_body(self._adj.index_select(0, idx), deg, ne, mask,
                                         self.eps)
        return _batched_warm_peel(src, dst, deg, ne, mask, self.node_capacity, self.eps,
                                  self.kernel, self.mesh)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"TenantBatch(|V|={self.node_capacity}, "
                f"cap={self.edge_capacity}, eps={self.eps}, "
                f"lanes={len(self.lane_of)}/{self.lanes})")


class FusedPool:
    """(node_capacity, edge_capacity, eps, kernel, device, mesh) ->
    TenantBatch. One pool per registry: tenants that bucket together share a
    lane stack and therefore every batched program; sharded and unsharded
    tenants, or tenants on different meshes, never do."""

    def __init__(self):
        self.batches: dict[tuple, TenantBatch] = {}

    def batch_for(self, node_capacity: int, edge_capacity: int, eps: float,
                  kernel: bool = False, device: torch.device | str | None = None,
                  mesh=None) -> TenantBatch:
        device = mesh_device(mesh, device)
        key = (int(node_capacity), int(edge_capacity), float(eps), bool(kernel), str(device),
               mesh)
        batch = self.batches.get(key)
        if batch is None:
            batch = self.batches[key] = TenantBatch(
                key[0], key[1], key[2], kernel=key[3], device=device, mesh=mesh)
        return batch

    def place(self, eng: "FusedEngine") -> None:
        """Give ``eng`` a lane in the batch of its *current* buffer capacity;
        a capacity change migrates it (evict + join)."""
        batch = self.batch_for(eng.node_capacity, eng.buffer.capacity, eng.eps, eng.kernel,
                               device=eng.device, mesh=eng.mesh)
        if eng.batch is batch:
            return
        if eng.batch is not None:
            eng.batch.evict(eng.name)
        eng._lane = batch.join(eng.name)
        eng.batch = batch


# ---------------------------------------------------------------------------
# the drop-in engine
# ---------------------------------------------------------------------------
def _row_property(stack: str):
    """A FusedEngine attribute that IS its row of the batch's ``stack``:
    reads return the row (a view), writes copy into it."""
    def get(self):
        batch = self.batch
        if batch is None or getattr(batch, stack) is None:
            return self._detached.get(stack)
        return getattr(batch, stack)[self._lane]

    def put(self, value):
        batch = self.batch
        if batch is None or getattr(batch, stack) is None:
            self._detached[stack] = value
            return
        row = getattr(batch, stack)[self._lane]
        if value is not None and value.data_ptr() != row.data_ptr():
            row.copy_(value)

    return property(get, put)


class FusedEngine(DeltaEngine):
    """A DeltaEngine whose device state is a row of a shared TenantBatch.

    Host bookkeeping (EdgeBuffer, staleness, plans, metrics) is inherited;
    every device dispatch goes through the bucket's stacks. A single query
    runs as a group of one; ``query_group`` fuses many tenants' queries into
    one flush."""

    _src = _row_property("_src")
    _dst = _row_property("_dst")
    _deg = _row_property("_deg")
    _prev_mask = _row_property("_prev_mask")
    _lane_perm = _row_property("_lane_perm")

    def __init__(self, name: str, pool: FusedPool, n_nodes: int,
                 eps: float = 0.0, capacity: int = MIN_CAPACITY,
                 refresh_every: int = 32, pruned: bool = True,
                 sharded: bool = False, mesh=None,
                 kernel: bool | None = None,
                 device: torch.device | str | None = None):
        # state before the first placement (DeltaEngine.__init__ writes it)
        self._detached: dict = {}
        self.batch: TenantBatch | None = None
        self._lane: int | None = None
        super().__init__(n_nodes, eps=eps, capacity=capacity,
                         refresh_every=refresh_every, pruned=pruned,
                         sharded=sharded, mesh=mesh, kernel=kernel, device=device)
        self.name = str(name)
        self.pool = pool
        self.fused = True
        self.tenant = str(name)
        self.kind = "fused+sharded" if self.sharded else "fused"

    @property
    def _sorted(self) -> bool:
        return self.batch is None or not self.batch._unsorted[self._lane]

    @_sorted.setter
    def _sorted(self, value: bool) -> None:
        if self.batch is not None and self.kernel:
            self.batch._unsorted[self._lane] = not value

    def _audit_shape(self) -> tuple:
        # the lane-stack width shapes every batched dispatch of this engine
        lanes = self.batch.lanes if self.batch is not None else 0
        return super()._audit_shape() + (lanes,)

    # -- device-state plumbing ---------------------------------------------
    def _resync_device(self) -> None:
        """Full upload into this tenant's row (placing it first: a capacity
        change migrates buckets here)."""
        prev = self._prev_mask.clone()
        lane_perm = None
        if self.kernel:
            assert_exact_envelope(2 * self.buffer.capacity, self.node_capacity)
            src, dst, deg, lane_perm = self.buffer.dst_sorted_state(self.node_capacity)
        else:
            src, dst, deg = self.buffer.resident_state(self.node_capacity)
        self.pool.place(self)
        self.batch.write_lane(self._lane, src, dst, deg, prev, self.buffer.generation,
                              lane_perm)
        self._generation = self.buffer.generation

    def _resort(self) -> None:
        """Restore this row's dst order inside the stack."""
        self.batch.resort([self._lane])

    def _dispatch_batch(self, slots, su, sv, du, dv, w) -> None:
        row = (slots, su, sv, du, dv, w)
        if getattr(self, "_staging", False):
            self._staged_row = row  # collected by ingest_group
            return
        self.batch.ingest({self._lane: row})

    def release(self) -> None:
        """Give the lane back (registry eviction / removal)."""
        if self.batch is not None:
            self._detached = {"_prev_mask": self._prev_mask.clone()}
            self.batch.evict(self.name)
            self.batch = None
            self._lane = None
            self._generation = -1

    def _cold_full_peel(self) -> PeelState:
        """Epoch re-anchor through the batched peel (a group of one): the
        maintained-degree init equals ``init_state``'s histogram, so the
        triple is the cold peel's."""
        final, _ = self.batch.peel_rows([self._lane], [self.buffer.n_edges])
        row = PeelState(*(x[0] for x in final))
        self._prev_mask = row.best_mask
        return row

    # -- queries ------------------------------------------------------------
    def query(self, refine: bool = False, target_gap: float | None = None,
              max_refine_rounds: int = 64) -> QueryResult:
        if refine:
            return query_group({self.name: self}, refine=True, target_gap=target_gap,
                               max_refine_rounds=max_refine_rounds)[self.name]
        if self._cached_query is not None:
            return self._cached_query
        if self._generation < 0:
            self._resync_device()
        if self.stale:
            return self.refresh()
        return query_group({self.name: self})[self.name]

    def __repr__(self) -> str:  # pragma: no cover
        return (f"FusedEngine({self.name!r}, |V|={self.n_nodes}, "
                f"|E|={self.buffer.n_edges}, lane={self._lane}, "
                f"batch={self.batch!r})")


# ---------------------------------------------------------------------------
# fused flushes
# ---------------------------------------------------------------------------
def _pruned_result(density: float, mask: np.ndarray, passes: int) -> QueryResult:
    return QueryResult(density=density, mask=mask, passes=passes,
                       warm_density=density, warm_mask=mask.copy(),
                       refreshed=False, pruned=True)


def _flush(batch: TenantBatch, members, refine: bool = False,
           target_gap: float | None = None,
           max_refine_rounds: int = 64) -> dict[str, QueryResult]:
    """One fused flush for ``members`` (same bucket, warm path): one
    row-batched prep and at most one batched bucket peel per plan-bucket
    shape for the pruned members, one batched warm peel for the rest, and
    with ``refine`` one batched refinement loop for the group. Per-tenant
    results are bit-identical to each engine's solo query.

    Observability: one span and one audit record attributed to the bucket
    (tenant ``bucket:VxE``); each member's latency share carries the
    flush's ``compiled`` flag into its first-call/steady split."""
    label = f"bucket:{batch.node_capacity}x{batch.edge_capacity}"
    with span("fused_flush", tenant=label, engine="fused") as sp:
        AUDITOR.sync()  # member refreshes/plan state ran under their own keys
        out, refined, cached, audit_shape = _flush_body(
            batch, members, refine, target_gap, max_refine_rounds)
        compiled = AUDITOR.record(label, "fused_flush", audit_shape)
        sp.set("members", len(members)).set("compiled", compiled)
        if refine:
            sp.set("path", "refined")
        share = sp.elapsed_ms / max(len(members), 1)
    tracer = get_tracer()
    reg = tracer.registry
    feed = tracer.enabled and reg.enabled
    for name, eng in members:
        if name not in cached:  # a cache hit is not a new peel query
            q = out[name]
            q.latency_ms = share
            q.compiled = compiled
            eng._note_query_ms(share, compiled)
            eng._cached_query = q
            if feed:
                hist = "query_first_call_ms" if compiled else "query_ms"
                reg.histogram(hist, tenant=eng.tenant, engine=eng.kind).observe(share)
                if q.passes:
                    reg.counter("peel_passes_total", tenant=eng.tenant,
                                engine=eng.kind).inc(int(q.passes))
        if refined is not None:
            r = refined[name]
            r.latency_ms = share
            r.compiled = compiled
            eng._cached_refined = r
            if feed:
                if r.refine_rounds:
                    reg.counter("refine_rounds_total", tenant=eng.tenant,
                                engine=eng.kind).inc(int(r.refine_rounds))
                if r.certificate is not None:
                    reg.gauge("certified_gap", tenant=eng.tenant,
                              engine=eng.kind).set(float(r.certificate.rel_gap))
    return refined if refined is not None else out


def _flush_body(batch: TenantBatch, members, refine: bool,
                target_gap: float | None, max_refine_rounds: int):
    out: dict[str, QueryResult] = {}
    warm: list = []
    dispatches: list = []
    # a member with a valid memoized peel (possible only on the refined path)
    # reuses it as the refinement seed instead of re-peeling its lane
    cached: set[str] = set()
    live: list = []
    for name, eng in members:
        if eng._cached_query is not None:
            cached.add(name)
            out[name] = eng._cached_query
        else:
            live.append((name, eng))
    for name, eng in live:
        if eng.pruned and eng._plan is None:
            eng._rebuild_plan()
    pruned = [(name, eng) for name, eng in live if eng.pruned and eng._plan.enabled]
    warm = [(name, eng) for name, eng in live if not (eng.pruned and eng._plan.enabled)]
    if pruned:
        lanes = [eng._lane for _, eng in pruned]
        if batch.sharded:
            # the JAX package's host prep from each member's buffer and
            # degrees (one download for the group), the bucket peel sharded
            deg = batch._deg.index_select(0, torch.tensor(
                lanes, dtype=torch.int64, device=batch.device)).cpu().numpy()
            preps = [prepare_pruned_peel(*eng.buffer.host_view(), deg[i], eng.buffer.n_edges,
                                         batch.eps, eng._plan)
                     for i, (_, eng) in enumerate(pruned)]
        else:
            src, dst, _, _ = batch.rows(lanes)
            preps = prepare_pruned_peel_rows(
                src, dst, batch.node_capacity, [eng.buffer.n_edges for _, eng in pruned],
                batch.eps, [eng._plan for _, eng in pruned], batch.kernel)
        for (name, eng), prep in zip(pruned, preps):
            if prep is None or (batch.sharded and not isinstance(prep, tuple)
                                and prep.plan.bucket_e % batch.n_shards):
                # no bucket fits (or, sharded, the bucket's lanes do not
                # split over the ranks, as pruned_peel_host refuses them)
                eng.metrics.n_prune_fallbacks += 1
                eng._plan = dc_replace(eng._plan, enabled=False)
                warm.append((name, eng))
            elif isinstance(prep, tuple):
                out[name] = _pruned_result(*eng._absorb_pruned_result(*prep))
            else:
                dispatches.append((name, eng, prep))

    # plans grouped by bucket shape: one batched bucket peel a group
    by_buckets = defaultdict(list)
    for name, eng, pd in dispatches:
        by_buckets[pd.plan.buckets].append((name, eng, pd))
    for buckets, items in by_buckets.items():
        dev = batch.device
        if batch.sharded:
            b_src, b_dst = (torch.from_numpy(np.ascontiguousarray(lane_block(
                np.stack([getattr(pd, f) for _, _, pd in items]), batch.mesh))).to(dev)
                for f in ("b_src", "b_dst"))
        else:
            b_src = torch.stack([pd.b_src for _, _, pd in items])
            b_dst = torch.stack([pd.b_dst for _, _, pd in items])
        d_b, mask_b, passes_b = _batched_bucket_peel(
            b_src, b_dst,
            torch.tensor([pd.n_v1 for _, _, pd in items], dtype=torch.int32, device=dev),
            torch.tensor([pd.n_e1 for _, _, pd in items], dtype=torch.int32, device=dev),
            torch.tensor(np.asarray([pd.best_d1 for _, _, pd in items], np.float32),
                         device=dev),
            torch.ones(len(items), dtype=torch.int32, device=dev),  # pass 0 ran in the prep
            batch.eps, *buckets, batch.kernel, batch.mesh)
        if batch.sharded:  # the host preps merge on the host
            d_b, mask_b, passes_b = (t.cpu().numpy() for t in (d_b, mask_b, passes_b))
            for i, (name, eng, pd) in enumerate(items):
                merged = merge_pruned_peel(pd, d_b[i], mask_b[i], passes_b[i])
                out[name] = _pruned_result(*eng._absorb_pruned_result(*merged))
            continue
        # each member's strict-> merge on the device, then one download
        masks = torch.stack([torch.where(
            d_b[i] > float(pd.best_d1),
            pd.a1 & mask_b[i].index_select(0, pd.perm.clamp(0, buckets[0] - 1)),
            pd.a1 if pd.better1 else pd.active0) for i, (_, _, pd) in enumerate(items)])
        masks, d_b, passes_b = masks.cpu().numpy(), d_b.cpu().numpy(), passes_b.cpu().numpy()
        for i, (name, eng, pd) in enumerate(items):
            density, mask, passes = eng._absorb_pruned_result(
                float(d_b[i]), masks[i], int(passes_b[i]), pd.observed, pd.plan)
            out[name] = _pruned_result(density, mask, passes)

    if warm:
        lanes = [eng._lane for _, eng in warm]
        final, warm_rho = batch.peel_rows(lanes, [eng.buffer.n_edges for _, eng in warm])
        bd = final.best_density.cpu().numpy()
        wr = warm_rho.cpu().numpy()
        bm = final.best_mask.cpu().numpy()
        ps = final.passes.cpu().numpy()
        keep = wr > bd  # the previous mask stays the warm seed
        prev = (batch._prev_mask.index_select(0, torch.tensor(
            lanes, dtype=torch.int64, device=batch.device)).cpu().numpy()
            if keep.any() else None)
        for i, (name, eng) in enumerate(warm):
            density, wrho = float(bd[i]), float(wr[i])
            mask = bm[i][: eng.n_nodes].copy()
            if keep[i]:
                warm_density = wrho
                warm_mask = prev[i][: eng.n_nodes].copy()
            else:
                warm_density = density
                warm_mask = mask.copy()
            out[name] = QueryResult(
                density=density, mask=mask, passes=int(ps[i]),
                warm_density=warm_density, warm_mask=warm_mask, refreshed=False)
        upd = torch.from_numpy(np.flatnonzero(~keep)).to(batch.device)
        batch.set_mask_rows(torch.tensor(lanes, dtype=torch.int64,
                                         device=batch.device).index_select(0, upd),
                            final.best_mask.index_select(0, upd))

    batch.n_group_peels += 1
    refined = None
    if refine:
        refined = _refine_flush(batch, members, out, target_gap, max_refine_rounds)
    # every shape determinant of the flush, as the JAX package keys its audit:
    # lane-stack width, pow-2 gather/peel/refine group sizes, and the plan
    # buckets peeled
    bucket_sig = tuple(sorted(
        (bk, next_pow2(len(items))) for bk, items in by_buckets.items()))
    audit_shape = (
        batch.node_capacity, batch.edge_capacity, batch.eps, batch.lanes,
        batch.kernel, batch.n_shards,
        next_pow2(len(pruned)) if pruned else 0,
        next_pow2(len(warm)) if warm else 0,
        bucket_sig,
        next_pow2(max(len(members), 1)) if refine else 0,
    )
    return out, refined, cached, audit_shape


def _refine_flush(batch: TenantBatch, members, peel_out,
                  target_gap: float | None,
                  max_rounds: int) -> dict[str, QueryResult]:
    """Batched refinement rounds for one bucket's queried rows: loads live in
    ``[G, V]`` tensors and every round is one batched loop (dense products
    under DENSE_NODE_CAP, K2's rows entry otherwise), converged rows frozen.
    The loop runs until every member's certificate meets ``target_gap``;
    members that met it early ride along and their certificates only
    tighten. With a negative target (fixed rounds) each member equals its
    solo refinement bit for bit."""
    tg = DEFAULT_TARGET_GAP if target_gap is None else float(target_gap)
    max_rounds = max(int(max_rounds), 1)  # a certificate needs >= 1 round
    g = len(members)
    lanes = [eng._lane for _, eng in members]
    src_g, dst_g, deg_g, _ = batch.rows(lanes)
    dev = batch.device
    adj_g = (batch._adj.index_select(0, torch.tensor(lanes, dtype=torch.int64, device=dev))
             if batch.dense else None)

    nc = batch.node_capacity
    seeds = []
    best_mask = np.zeros((g, nc), dtype=bool)
    best_ne = np.zeros(g, np.int32)
    best_nv = np.zeros(g, np.int32)
    best_density = np.zeros(g, np.float32)
    passes0 = np.zeros(g, np.int32)
    n_edges = np.zeros(g, np.int32)
    for i, (name, eng) in enumerate(members):
        q = peel_out[name]
        mask_full = np.zeros(nc, dtype=bool)
        mask_full[: eng.n_nodes] = q.mask
        ne, nv = eng._mask_counts(mask_full)
        seeds.append((ne, nv, mask_full))
        best_mask[i] = mask_full
        best_ne[i], best_nv[i] = ne, nv
        best_density[i] = np.float32(ne) / np.float32(nv) if nv else np.float32(0.0)
        passes0[i] = q.passes
        n_edges[i] = eng.buffer.n_edges

    def up(a):
        return torch.from_numpy(a).to(dev)

    loads = torch.zeros((g, nc), dtype=torch.int32, device=dev)
    bd, be, bv, bm, ps, ne_t = (up(best_density), up(best_ne), up(best_nv), up(best_mask),
                                up(passes0), up(n_edges))
    duals: list = [None] * g
    certs: list = [None] * g
    rounds = 0
    for t in range(1, max_rounds + 1):
        if batch.dense:
            loads, bd, be, bv, bm, ps = _batched_dense_refine_round(
                adj_g, deg_g, ne_t, loads, bd, be, bv, bm, ps, batch.eps)
        else:
            loads, bd, be, bv, bm, ps = _batched_refine_round(
                src_g, dst_g, deg_g, ne_t, loads, bd, be, bv, bm, ps, nc, batch.eps,
                batch.kernel, batch.mesh)
        rounds = t
        loads_np = loads.cpu().numpy()
        be_np, bv_np = be.cpu().numpy(), bv.cpu().numpy()
        done = True
        for i in range(g):
            b_ne, b_nv = max_fraction((int(be_np[i]), int(bv_np[i])), seeds[i][:2])
            num, den = dual_fraction(loads_np[i], t)
            if duals[i] is None or better_fraction(num, den, *duals[i]):
                duals[i] = (num, den)
            certs[i] = make_certificate(b_ne, b_nv, *duals[i])
            done = done and certs[i].rel_gap <= tg
        if done:
            break

    bm_np, ps_np = bm.cpu().numpy(), ps.cpu().numpy()
    out = {}
    for i, (name, eng) in enumerate(members):
        cert = certs[i]
        seed_ne, seed_nv, seed_mask = seeds[i]
        if cert.best_ne == seed_ne and cert.best_nv == seed_nv:
            mask_full = seed_mask
        else:
            mask_full = bm_np[i]
        eng._refine_cert = cert
        eng._cert_mask = mask_full.copy()
        eng._cert_insert_slack = 0
        eng.metrics.n_refine_queries += 1
        eng.metrics.refine_rounds_total += rounds
        mask = mask_full[: eng.n_nodes].copy()
        out[name] = QueryResult(
            density=cert.density, mask=mask, passes=int(ps_np[i]),
            warm_density=cert.density, warm_mask=mask.copy(),
            refreshed=peel_out[name].refreshed,
            pruned=peel_out[name].pruned, certificate=cert,
            refine_rounds=rounds,
        )
    return out


def query_group(engines: dict[str, DeltaEngine], refine: bool = False,
                target_gap: float | None = None,
                max_refine_rounds: int = 64) -> dict[str, QueryResult]:
    """Answer a set of tenants' densest-subgraph queries, fused wherever
    possible: fused tenants flush per bucket (one batched warm peel, one
    row-batched prep and one batched bucket peel per plan shape); other
    engines take their own query path. Cached results are reused, and stale
    tenants take their epoch refresh individually first.

    ``refine=True`` answers with *certified* densities: a bucket's members
    share one batched refinement loop per flush; tenants whose cached
    certificate still proves equality on their current graph skip it (the
    certified skip)."""
    out: dict[str, QueryResult] = {}
    flushes: dict[TenantBatch, list] = defaultdict(list)
    tg = DEFAULT_TARGET_GAP if target_gap is None else float(target_gap)
    for name, eng in engines.items():
        if not isinstance(eng, FusedEngine):
            out[name] = (eng.query(refine=True, target_gap=target_gap,
                                   max_refine_rounds=max_refine_rounds)
                         if refine else eng.query())
            continue
        if refine:
            cached = eng._cached_refined
            if (cached is not None and cached.certificate is not None
                    and cached.certificate.rel_gap <= tg):
                out[name] = cached
                continue
            if eng._generation < 0 or eng._generation != eng.buffer.generation:
                eng._resync_device()
            skip = eng._certified_skip()
            if skip is not None:
                out[name] = skip
                continue
            if eng.stale:
                eng.refresh()  # re-anchor; the refined flush runs below
            flushes[eng.batch].append((name, eng))
            continue
        if eng._cached_query is not None:
            out[name] = eng._cached_query
            continue
        if eng._generation < 0 or eng._generation != eng.buffer.generation:
            eng._resync_device()
        if eng.stale:
            out[name] = eng.refresh()
            continue
        flushes[eng.batch].append((name, eng))
    for batch, members in flushes.items():
        out.update(_flush(batch, members, refine=refine, target_gap=target_gap,
                          max_refine_rounds=max_refine_rounds))
    return out


def ingest_group(updates: dict[str, tuple], engines: dict[str, DeltaEngine]):
    """Apply many tenants' update batches with one patch per bucket: host
    staging (buffer bookkeeping, row padding) per tenant, then every staged
    row of a bucket in one ``_batched_apply``. ``updates`` maps tenant ->
    (insert, delete); non-fused engines apply directly. Returns tenant ->
    UpdateStats."""
    stats = {}
    rows_by_batch: dict[TenantBatch, dict[int, tuple]] = defaultdict(dict)
    try:
        for name, (insert, delete) in updates.items():
            eng = engines[name]
            if not isinstance(eng, FusedEngine):
                stats[name] = eng.apply_updates(insert=insert, delete=delete)
                continue
            eng._staging = True
            eng._staged_row = None
            try:
                stats[name] = eng.apply_updates(insert=insert, delete=delete)
            finally:
                eng._staging = False
            if eng._staged_row is not None:
                rows_by_batch[eng.batch][eng._lane] = eng._staged_row
                eng._staged_row = None
    finally:
        # dispatch whatever staged even if a later tenant's batch raised: a
        # staged tenant's host buffer has already committed, so its row MUST
        # receive the patch or later queries would peel stale degrees
        for batch, rows in rows_by_batch.items():
            label = f"bucket:{batch.node_capacity}x{batch.edge_capacity}"
            with span("fused_ingest", tenant=label, engine="fused") as sp:
                AUDITOR.sync()  # staged members recorded (no dispatch) above
                b = batch.ingest(rows)
                compiled = AUDITOR.record(
                    label, "fused_ingest",
                    (batch.node_capacity, batch.edge_capacity, batch.eps,
                     batch.lanes, batch.kernel, batch.n_shards, b))
                sp.set("n_lanes", len(rows)).set("compiled", compiled)
    return stats


__all__ = ["TenantBatch", "FusedPool", "FusedEngine", "query_group",
           "ingest_group", "MIN_LANES", "DENSE_NODE_CAP"]
