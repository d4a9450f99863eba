"""Incremental densest-subgraph maintenance over an EdgeBuffer.

The static path pays O(|E|) twice per query: once on the host (re-padding
the edge arrays) and once on the device (the degree histogram of
``init_state``). ``DeltaEngine`` keeps the graph *resident*: the symmetric
COO lanes live on the device and each update batch is one O(batch) patch
(``_apply_batch``) that

  * writes the edge slots touched by the batch into the lanes, and
  * applies the degree delta as a signed int32 histogram over just the
    batch endpoints; the paper's ``atomicAdd``/``atomicSub`` pair collapses
    into one ``index_add_`` a side.

Queries then run the peel loop from the *maintained* integer state
(``_warm_peel``). Degree maintenance is exact integer arithmetic, so the
warm initial state is bit-identical to what a from-scratch ``init_state``
computes, and the peel trajectory, hence the density, EQUALS a cold
``pbahmani`` on the materialized graph. The previous best mask is
re-evaluated on the current graph in the same call: its density is a valid
anytime lower bound, reported as ``warm_density``/``warm_mask`` without
perturbing the oracle-exact ``density``.

A staleness counter triggers an *epoch refresh* when the accumulated weight
reaches ``refresh_every``: the buffer compacts its slots, device state is
rebuilt, and the query re-anchors through a cold peel. Batches weigh
``1 + DELETE_STALENESS_WEIGHT · deleted_fraction``, so delete-dominated
streams, whose tombstone holes fragment the slot space fastest, refresh
earlier. With ``pruned=True`` (the default) queries run the candidate-pruned
peel of ``core/prune.py`` resident on the engine's lanes, from a plan
rebuilt at epoch cadence; the triple is bit-identical to the unpruned peel.

**Lane order with the kernels on.** K1 and K2 (and the compactions K3/K4
feed them) need the lanes sorted by dst: a row whose lanes are not
contiguous is stored twice, not summed. A batch patches slots through
``lane_perm`` (device int32 ``[2*capacity]``, unsorted lane -> current
position), so the patched lanes hold their new dst at an old position and
leave the order. The engine marks the lanes unsorted; before the next pass
over them (warm, cold or pruned peel, the plan, refinement, ``cbds``) one
stable sort of ``dst`` on the device restores it, gathers ``src`` by the
same order and composes ``lane_perm`` with the sort's inverse. A resync,
which uploads the host's sorted snapshot, also clears the flag. A batch
stays O(batch); the query that follows pays the sort. The triple does not
depend on the order within a row (every sum is int32), so the result is the
same as the JAX package's, whose kernel works on drifted lanes.

**Sharding.** With ``sharded=True`` (or ``mesh=``, a
``core.distributed.Mesh``) one tenant's graph spans the mesh's ranks, one
process a rank, every rank feeding the engine the same batches: the host
``EdgeBuffer`` is replicated, each rank holds lanes ``[r·L/n, (r+1)·L/n)`` of
the buffer's slot layout on its device, and the |V| state is replicated. A
batch writes the rank's lanes and histograms its slice ``B/n`` of the batch,
one all-reduce; every query path (warm, pruned, refined, ``cbds``, the
refresh's cold peel) runs its passes over the rank's lanes with one
all-reduce a pass (``core/distributed.py``). Sharded engines keep the
scatter tier, as the JAX package's do: their lanes are in slot order, not
dst-sorted. The triple equals the single-device engine's bit for bit.

This is the JAX package's ``stream/delta.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from dataclasses import replace as dc_replace

import numpy as np
import torch

from repro_torch.core.batched import init_rows, peel_rows_to_end
from repro_torch.core.cbds import cbds_resident
from repro_torch.core.density import live_lane_count, live_lane_count_rows
from repro_torch.core import collective
from repro_torch.core.dispatch import assert_exact_envelope, resolve_kernel
from repro_torch.core.distributed import (
    lane_block, make_mesh, mesh_device, mesh_device_count, validate_stream_mesh,
)
from repro_torch.core.pbahmani import PeelState, init_state, state_from_degrees
from repro_torch.core.prune import (
    PrunePlan, _peel_to_end, _plan, build_plan, pruned_peel_host, pruned_peel_resident,
)
from repro_torch.obs.audit import AUDITOR
from repro_torch.obs.trace import span
from repro_torch.refine.certify import GapCertificate, make_certificate
from repro_torch.refine.engine import DEFAULT_TARGET_GAP, refine_resident
from repro_torch.stream.buffer import MIN_CAPACITY, EdgeBuffer, next_pow2

MIN_BATCH = 64  # smallest padded update-batch shape (pow-2 buckets above)
DELETE_STALENESS_WEIGHT = 3.0  # an all-delete batch ages the epoch 4x


def _build_batch_row(ins, ins_slots, dele, del_slots, capacity: int,
                     sentinel: int, b_floor: int = MIN_BATCH):
    """Pad one effective update batch into the fixed-shape scatter row of the
    JAX package's jitted apply: pow-2 length, slot ``2*capacity`` and zero
    weights in the padding lanes. Its width is the batch's audit shape and
    ``UpdateStats.batch_capacity``; ``_apply_batch`` drops the padding."""
    n = ins.shape[0] + dele.shape[0]
    b = max(next_pow2(max(n, 1)), b_floor)
    slots = np.full(b, 2 * capacity, np.int32)  # OOB pad
    su = np.full(b, sentinel, np.int32)
    sv = np.full(b, sentinel, np.int32)
    du = np.full(b, sentinel, np.int32)
    dv = np.full(b, sentinel, np.int32)
    w = np.zeros(b, np.int32)
    # deletes first; an insert reusing a freed slot must win the scatter,
    # so drop the delete's slot write (its degree delta and the insert's
    # are independent — keyed on endpoints, not slots)
    m = dele.shape[0]
    if m:
        keep = ~np.isin(del_slots, ins_slots)
        dslots = np.where(keep, del_slots, 2 * capacity)
        slots[:m] = dslots
        du[:m], dv[:m] = dele[:, 0], dele[:, 1]
        w[:m] = -1
    k = ins.shape[0]
    if k:
        slots[m : m + k] = ins_slots
        su[m : m + k], sv[m : m + k] = ins[:, 0], ins[:, 1]
        du[m : m + k], dv[m : m + k] = ins[:, 0], ins[:, 1]
        w[m : m + k] = 1
    return slots, su, sv, du, dv, w


def _apply_batch(
    src: torch.Tensor,
    dst: torch.Tensor,
    deg: torch.Tensor,
    slots, su, sv, du, dv, w,
    lane_perm: torch.Tensor | None = None,
    mesh=None,
) -> bool:
    """Apply one padded batch row (host int32 arrays) to the resident lanes
    and degrees **in place**: O(batch) host work, one upload, at most two
    ``index_put_`` and two ``index_add_``.

    Slot ``s`` occupies lanes ``s`` and ``s + capacity``; ``lane_perm``
    (device int32, kernel mode) maps them to their current positions. The
    scatter tier's ``mode="drop"`` becomes a host filter: ``index_put_``
    raises on the padding marker ``2*capacity``, and a delete whose slot an
    insert reuses already carries that marker, so no index repeats. The
    degree histogram keeps every lane of nonzero weight, real vertices all
    (the sentinel row of the JAX package's ``segment_sum`` is never
    written).

    With ``mesh`` the lanes are this rank's block (the JAX package's
    ``_make_sharded_apply``): the rank writes the lanes of the batch that
    fall in its block, histograms its slice ``B/n`` of the batch, and the
    histograms are summed over the mesh by one all-reduce. Returns whether
    any lane was written."""
    width = src.shape[0]
    n, r = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    cap = width * n // 2
    real = slots < cap
    pos = np.concatenate([slots[real], slots[real] + cap]) - r * width
    mine = (pos >= 0) & (pos < width)
    part = slice(r * (w.shape[0] // n), (r + 1) * (w.shape[0] // n))
    du, dv, w = du[part], dv[part], w[part]
    signed = w != 0
    k = int(mine.sum())
    host = np.concatenate([pos[mine], np.concatenate([su[real], sv[real]])[mine],
                           np.concatenate([sv[real], su[real]])[mine],
                           du[signed], dv[signed], w[signed]])
    if host.size == 0 and mesh is None:
        return False
    batch = torch.from_numpy(host.astype(np.int32)).to(src.device)
    lanes, a, b = batch[:3 * k].view(3, k)
    d_u, d_v, d_w = batch[3 * k:].view(3, -1)
    if k:
        if lane_perm is not None:
            lanes = lane_perm.index_select(0, lanes)
        lanes = lanes.long()
        src.index_put_((lanes,), a)
        dst.index_put_((lanes,), b)
    hist = deg if mesh is None else torch.zeros_like(deg)
    hist.index_add_(0, d_u, d_w)
    hist.index_add_(0, d_v, d_w)
    if mesh is not None:
        # repro: allow RPR402 -- the early return needs mesh None: with one, every rank gets here
        deg += collective.all_reduce_sum(hist, mesh)
    return k > 0


def _warm_peel(
    src: torch.Tensor,
    dst: torch.Tensor,
    deg: torch.Tensor,
    n_edges: int,
    prev_mask: torch.Tensor,
    n_nodes: int,
    eps: float,
    kernel: bool = False,
    mesh=None,
) -> tuple[PeelState, torch.Tensor]:
    """Peel from the maintained degree array (skips the O(|E|) histogram of
    ``init_state``; bit-identical state, hence identical result) and
    re-evaluate the previous best mask on the current graph. The pass loop
    is the host loop of ``prune._peel_to_end``, one ``.item()`` a pass;
    ``kernel`` runs each pass's edge stage on K2 (dst-sorted lanes). With
    ``mesh`` (the JAX package's ``make_sharded_warm_peel``) the lanes are
    this rank's block: one all-reduce a pass, one for the previous mask's
    edges. Returns (final state, float32 density of ``prev_mask``)."""
    final = _peel_to_end(state_from_degrees(deg, n_edges), src, dst, n_nodes, eps, kernel,
                         mesh)
    warm_e = collective.all_reduce_sum(live_lane_count(src, dst, prev_mask, n_nodes), mesh) // 2
    warm_v = prev_mask.sum(dtype=torch.int32)
    warm_rho = torch.where(
        warm_v > 0,
        warm_e.to(torch.float32) / warm_v.clamp(min=1).to(torch.float32), 0.0)
    return final, warm_rho


def _batched_apply(
    src: torch.Tensor,
    dst: torch.Tensor,
    deg: torch.Tensor,
    rows: dict[int, tuple],
    lane_perm: torch.Tensor | None = None,
    adj: torch.Tensor | None = None,
    mesh=None,
) -> list[int]:
    """``_apply_batch`` of many tenants at once, **in place** on lane stacks
    ``src``/``dst`` ``[T, 2*capacity]`` and ``deg`` ``[T, V]`` (the JAX
    package's vmapped ``_batched_apply_jit``): ``rows`` maps a stack row to
    its padded batch row (host int32 arrays). The rows are translated to
    flat indices on the host, uploaded once, and applied with one
    ``index_put_`` a side and two ``index_add_``, so the group costs what one
    tenant's batch costs. ``lane_perm`` (``[T, 2*capacity]``, kernel mode)
    maps each row's unsorted lanes to their positions; ``adj`` (``[T, V,
    V]`` float32, the dense buckets) takes the signed weights at (u, v) and
    (v, u) too, as exact float32 integers. With ``mesh`` the stacks hold
    this rank's blocks (``[T, 2*capacity / n]``; the JAX package's
    ``_make_sharded_batched_apply``): each row's lanes in the block are
    written, each row's slice ``B/n`` histogrammed, and the ``[T, V]``
    histograms summed over the mesh by one all-reduce. Returns the stack
    rows whose lanes were written."""
    width = src.shape[1]
    n, r = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    cap, n_nodes = width * n // 2, deg.shape[1]
    parts, written = [], []
    for lane, (slots, su, sv, du, dv, w) in rows.items():
        real = slots < cap
        pos = np.concatenate([slots[real], slots[real] + cap]).astype(np.int64) - r * width
        mine = (pos >= 0) & (pos < width)
        part = slice(r * (w.shape[0] // n), (r + 1) * (w.shape[0] // n))
        du, dv, w = du[part], dv[part], w[part]
        signed = w != 0
        if mine.any():
            written.append(lane)
        parts.append((lane * width + pos[mine],
                      np.concatenate([su[real], sv[real]])[mine],
                      np.concatenate([sv[real], su[real]])[mine],
                      lane, du[signed], dv[signed], w[signed]))
    if not parts:
        return written
    lanes = np.concatenate([p[0] for p in parts])
    a = np.concatenate([p[1] for p in parts])
    b = np.concatenate([p[2] for p in parts])
    row = np.concatenate([np.full(p[4].shape[0], p[3], np.int64) for p in parts])
    du = np.concatenate([p[4] for p in parts]).astype(np.int64)
    dv = np.concatenate([p[5] for p in parts]).astype(np.int64)
    w = np.concatenate([p[6] for p in parts]).astype(np.int32)
    k, m = lanes.shape[0], du.shape[0]
    host = np.concatenate([lanes, row * n_nodes + du, row * n_nodes + dv,
                           (row * n_nodes + du) * n_nodes + dv,
                           (row * n_nodes + dv) * n_nodes + du])
    idx = torch.from_numpy(host).to(src.device)
    vals = torch.from_numpy(np.concatenate([a, b, w]).astype(np.int32)).to(src.device)
    flat = idx[:k]
    if k:
        if lane_perm is not None:
            # a slot's lanes move with its row's sort: their position inside
            # the row, offset back to the row's base
            base = flat - flat % width
            flat = base + lane_perm.view(-1).index_select(0, flat).to(torch.int64)
        src.view(-1).index_put_((flat,), vals[:k])
        dst.view(-1).index_put_((flat,), vals[k:2 * k])
    d_w = vals[2 * k:]
    hist = deg if mesh is None else torch.zeros_like(deg)
    hist.view(-1).index_add_(0, idx[k:k + m], d_w)
    hist.view(-1).index_add_(0, idx[k + m:k + 2 * m], d_w)
    if mesh is not None:
        deg += collective.all_reduce_sum(hist, mesh)
    if adj is not None:
        fw = d_w.to(torch.float32)
        adj.view(-1).index_put_((idx[k + 2 * m:k + 3 * m],), fw, accumulate=True)
        adj.view(-1).index_put_((idx[k + 3 * m:],), fw, accumulate=True)
    return written


def _batched_warm_peel(
    src: torch.Tensor,
    dst: torch.Tensor,
    deg: torch.Tensor,
    n_edges: torch.Tensor,
    prev_mask: torch.Tensor,
    n_nodes: int,
    eps: float,
    kernel: bool = False,
    mesh=None,
) -> tuple[PeelState, torch.Tensor]:
    """``_warm_peel`` of G tenants at once (the JAX package's vmapped
    ``_batched_warm_peel_jit``): lanes ``[G, L]``, degrees and previous masks
    ``[G, V]``, ``n_edges`` int32 ``[G]``. One batched pass a step for the
    whole group (``core.batched``; K2's rows entry with ``kernel``), a row
    frozen once it has converged, so each row's final state equals the
    single warm peel's. With ``mesh`` (``make_sharded_batched_warm_peel``)
    the lanes are this rank's blocks and a batched pass makes one ``[G, V +
    1]`` all-reduce for the group. Returns (final state, float32 ``[G]``
    density of each row's ``prev_mask``)."""
    final = peel_rows_to_end(init_rows(deg, n_edges), src, dst, n_nodes, eps, kernel, mesh)
    warm_e = collective.all_reduce_sum(
        live_lane_count_rows(src, dst, prev_mask, n_nodes), mesh) // 2
    warm_v = prev_mask.sum(dim=1, dtype=torch.int32)
    warm_rho = torch.where(
        warm_v > 0,
        warm_e.to(torch.float32) / warm_v.clamp(min=1).to(torch.float32), 0.0)
    return final, warm_rho


def _entry_points() -> list:
    """The auditor's ``"stream"`` provider: the engine's own cached entry
    points. It dispatches eagerly and builds nothing itself (the kernels it
    reaches are counted by the ``"kernels"`` provider of
    ``kernels/build.py``); the fused engine's programs will register
    here."""
    return []


AUDITOR.register_provider(_entry_points, name="stream")


@dataclass
class UpdateStats:
    """Outcome of one ``apply_updates`` batch."""

    n_inserted: int
    n_deleted: int
    n_edges: int
    batch_capacity: int   # padded batch width (the audit shape)
    regrew: bool          # buffer layout epoch changed (grow or tombstone
                          # compaction): device state was rebuilt whole
    latency_ms: float
    compiled: bool = False  # this batch loaded a kernel library (audit)


@dataclass
class QueryResult:
    density: float            # oracle-exact: == cold pbahmani on this graph
                              # (refined queries: best certified density,
                              # >= the peel's, never above rho*)
    mask: np.ndarray          # bool [n_nodes] achieving ``density``
    passes: int
    warm_density: float       # max(density, prev-mask re-evaluation)
    warm_mask: np.ndarray     # mask achieving ``warm_density``
    refreshed: bool           # this query ran the epoch-refresh path
    latency_ms: float = 0.0
    pruned: bool = False      # peeled the compacted candidate subproblem
    # refinement (repro_torch.refine, query(refine=True) only)
    certificate: GapCertificate | None = None
    refine_rounds: int = 0
    certified_skip: bool = False  # cached bound proved equality: no peel ran
    compiled: bool = False        # this query loaded a kernel library, so
                                  # latency_ms is a first-call number (audit)


@dataclass
class EngineMetrics:
    n_update_batches: int = 0
    n_queries: int = 0
    n_refreshes: int = 0
    update_ms_total: float = 0.0
    query_ms_total: float = 0.0
    shape_buckets: set = field(default_factory=set)
    # candidate pruning (core/prune.py)
    n_pruned_queries: int = 0     # queries that peeled inside the buckets
    n_prune_fallbacks: int = 0    # bucket fit-misses (full-width branch)
    n_plan_builds: int = 0        # rho~ bootstrap + core fixpoint runs
    bucket_reuses: int = 0        # plan rebuilds that kept the same buckets
    candidate_fraction: float = 0.0  # |ceil(rho~)-core| / n_nodes
    prune_bucket_v: int = 0
    prune_bucket_e: int = 0
    # contracting-graph bookkeeping
    n_buffer_shrinks: int = 0     # epoch refreshes that halved slot capacity
    n_bucket_shrinks: int = 0     # mid-epoch prune-bucket shrinks
    # near-optimal refinement (repro_torch.refine)
    n_refine_queries: int = 0     # queries that ran refinement rounds
    refine_rounds_total: int = 0
    n_certified_skips: int = 0    # refined queries answered from the cached
                                  # certificate alone (no peel dispatched)
    # first-call vs steady split (audit layer): query_ms_total keeps the
    # combined number
    n_query_first_calls: int = 0
    query_first_call_ms_total: float = 0.0
    query_steady_ms_total: float = 0.0


class DeltaEngine:
    """Dynamic graph + online densest-subgraph queries for one tenant.

    ``device=None`` means the GPU and raises where there is none; pass
    ``device="cpu"`` for the plain PyTorch path. ``kernel=None`` means the
    kernels (K1-K4) on a CUDA device and the scatter tier elsewhere;
    ``True`` forces them (their plain versions on the CPU). The triple is
    the same either way."""

    def __init__(
        self,
        n_nodes: int,
        eps: float = 0.0,
        capacity: int = MIN_CAPACITY,
        refresh_every: int = 32,
        pruned: bool = True,
        sharded: bool = False,
        mesh=None,
        kernel: bool | None = None,
        device: torch.device | str | None = None,
    ):
        if n_nodes <= 0:
            raise ValueError("DeltaEngine needs n_nodes >= 1")
        self.sharded = bool(sharded) or mesh is not None
        # sharded=True spans the tenant's lanes over the mesh's ranks (its
        # device is the mesh's); without a mesh, the default group's
        self.mesh = None
        n_dev = 1
        if self.sharded:
            self.mesh = mesh if mesh is not None else make_mesh(device=device)
            n_dev = validate_stream_mesh(self.mesh, max(next_pow2(capacity), MIN_CAPACITY))
        self.device = mesh_device(self.mesh, device)
        self.n_nodes = int(n_nodes)
        # the vertex space is padded to a power of two, as the JAX package
        # pads it for shared executables: both engines hold the same arrays
        self.node_capacity = max(next_pow2(self.n_nodes), 2)
        self.eps = float(eps)
        self.refresh_every = int(refresh_every)
        self.pruned = bool(pruned)
        # sharded engines stay on the scatter tier, as the JAX package's do:
        # their lanes are in slot order, split by rank, not dst-sorted
        self.kernel = resolve_kernel(kernel, self.device) and not self.sharded
        # observability identity: a registry overwrites ``tenant`` with the
        # registered name; spans and audit records are labeled with it
        self.tenant = "-"
        self.kind = "sharded" if self.sharded else "delta"
        # floor capacity (incl. epoch shrinks) at one lane block per rank
        self.buffer = EdgeBuffer(self.node_capacity, capacity=capacity,
                                 min_capacity=max(MIN_CAPACITY, n_dev // 2))
        self.metrics = EngineMetrics()
        self._src = None          # device int32 [2*capacity] (sharded: this rank's
                                  # [2*capacity / n]), sentinel-padded
        self._dst = None
        self._deg = None          # device int32 [node_capacity]
        self._lane_perm = None    # kernel mode: device int32, lane -> position
        self._sorted = True       # kernel mode: the lanes' dst ascends
        self._generation = -1     # buffer generation mirrored on device
        self._prev_mask = torch.zeros(self.node_capacity, dtype=torch.bool,
                                      device=self.device)
        self._staleness = 0.0     # delete-weighted batches since last refresh
        self._plan: PrunePlan | None = None
        self._last_handoff: tuple[int, int] | None = None
        self._cached_query: QueryResult | None = None
        # refinement state: the certificate + its mask persist across
        # updates — deletions keep the dual bound valid and insertions shift
        # it by the max incident count, which is what lets a later refined
        # query skip the peel when the bound proves equality
        self._cached_refined: QueryResult | None = None
        self._refine_cert: GapCertificate | None = None
        self._cert_mask: np.ndarray | None = None
        self._cert_insert_slack: int = 0

    # -- device-state management -------------------------------------------
    @property
    def sentinel(self) -> int:
        return self.node_capacity

    @property
    def n_shards(self) -> int:
        """Devices this tenant's edge slots are partitioned across."""
        return mesh_device_count(self.mesh) if self.mesh is not None else 1

    def _audit_shape(self) -> tuple:
        """Shape determinants of every dispatch this engine can make (audit
        keys extend it per op — batch width, plan buckets). A build under an
        already-seen (tenant, op, shape) key is a steady-state recompile;
        anything that legitimately changes dispatch shapes MUST appear here
        or the auditor raises false alarms."""
        return (self.node_capacity, 2 * self.buffer.capacity,
                self.eps, self.n_shards, self.kernel)

    def _note_query_ms(self, ms: float, compiled: bool) -> None:
        """Query-latency bookkeeping with the first-call/steady split."""
        self.metrics.n_queries += 1
        self.metrics.query_ms_total += ms
        if compiled:
            self.metrics.n_query_first_calls += 1
            self.metrics.query_first_call_ms_total += ms
        else:
            self.metrics.query_steady_ms_total += ms

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        # a copy even on the CPU: the lanes are patched in place, and the
        # buffer caches the arrays it hands out
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, copy=True)

    def _resync_device(self) -> None:
        """Full O(|E|) upload — on first use, regrow, or epoch compaction.
        Kernel mode uploads the buffer's dst-sorted snapshot instead, with
        its lane permutation, so later batches patch the sorted layout in
        O(batch). A sharded engine uploads its rank's block of the lanes."""
        if self.kernel:
            assert_exact_envelope(2 * self.buffer.capacity,
                                  self.node_capacity)
            src, dst, deg, lane_perm = self.buffer.dst_sorted_state(
                self.node_capacity)
            self._lane_perm = self._upload(lane_perm)
            self._sorted = True
        else:
            src, dst, deg = self.buffer.resident_state(self.node_capacity)
            if self.mesh is not None:
                src, dst = lane_block(src, self.mesh), lane_block(dst, self.mesh)
        self._src, self._dst, self._deg = (self._upload(src), self._upload(dst),
                                           self._upload(deg))
        self._generation = self.buffer.generation

    def _resort(self) -> None:
        """Restore dst order on the device after patches (kernel mode): one
        stable sort of ``dst``, ``src`` gathered by its order, and
        ``lane_perm`` composed with the order's inverse so that it maps each
        slot's lanes to their new positions."""
        dst, order = torch.sort(self._dst, stable=True)
        self._src = self._src.index_select(0, order)
        self._dst = dst
        inverse = torch.empty_like(self._lane_perm)
        inverse.index_put_((order,), torch.arange(
            order.shape[0], dtype=inverse.dtype, device=inverse.device))
        self._lane_perm = inverse.index_select(0, self._lane_perm)
        self._sorted = True

    def _lanes(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The resident (src, dst) lanes for a pass over them: dst-sorted in
        kernel mode (re-sorted here if a batch patched them)."""
        if not self._sorted:
            self._resort()
        return self._src, self._dst

    def _check_endpoints(self, edges) -> None:
        e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if e.size and (e.min() < 0 or e.max() >= self.n_nodes):
            raise ValueError(
                f"edge endpoint out of range [0, {self.n_nodes}): "
                f"min={e.min()} max={e.max()}"
            )

    # -- ingest -------------------------------------------------------------
    def apply_updates(self, insert=None, delete=None) -> UpdateStats:
        with span("ingest", tenant=self.tenant, engine=self.kind) as sp:
            AUDITOR.sync()  # foreign cache growth is not this batch's fault
            if insert is not None:
                self._check_endpoints(insert)
            if delete is not None:
                self._check_endpoints(delete)
            if self._generation < 0:
                self._resync_device()

            gen_before = self.buffer.generation
            ins, ins_slots, dele, del_slots = self.buffer.apply(insert, delete)
            regrew = self.buffer.generation != gen_before

            if regrew:
                # capacity doubled or tombstones forced a compaction: the
                # slot layout moved, rebuild device state whole (and
                # invalidate the prune plan — its lane-width basis may be
                # stale)
                self._resync_device()
                self._plan = None
            else:
                # sharded engines need the batch divisible into per-rank
                # histogram slices (pow-2 ranks)
                row = _build_batch_row(
                    ins, ins_slots, dele, del_slots, self.buffer.capacity,
                    self.sentinel, b_floor=max(MIN_BATCH, self.n_shards))
                b = row[0].shape[0]
                self._dispatch_batch(*row)
                self.metrics.shape_buckets.add((2 * self.buffer.capacity, b))

            # staleness ages faster on delete-heavy batches: tombstone holes
            # are what the epoch compaction exists to clean up (insert-only
            # streams accumulate exactly 1 per batch)
            n_eff = int(ins.shape[0]) + int(dele.shape[0])
            del_frac = (int(dele.shape[0]) / n_eff) if n_eff else 0.0
            self._staleness += 1.0 + DELETE_STALENESS_WEIGHT * del_frac
            self._cached_query = None  # graph changed: next query recomputes
            self._cached_refined = None
            if self._refine_cert is not None and ins.shape[0]:
                # each inserted edge adds one unit of load to (at most) both
                # endpoints of the averaged orientation, so the dual bound
                # shifts by at most the max incident insert count — deletions
                # only free load and leave it valid as-is (certify.py)
                counts = np.bincount(ins.astype(np.int64).ravel())
                self._cert_insert_slack += int(counts.max())
            # the audit shape extends the engine key with the dispatched
            # batch width; a regrow rebuilt device state whole at the NEW
            # capacity, which _audit_shape already reflects
            shape = self._audit_shape() + (("resync",) if regrew else (b,))
            compiled = AUDITOR.record(self.tenant, "ingest", shape)
            sp.set("n_inserted", int(ins.shape[0]))
            sp.set("n_deleted", int(dele.shape[0]))
            sp.set("compiled", compiled)
            sp.set("kernel", self.kernel)
            ms = sp.elapsed_ms
        self.metrics.n_update_batches += 1
        self.metrics.update_ms_total += ms
        return UpdateStats(
            n_inserted=int(ins.shape[0]),
            n_deleted=int(dele.shape[0]),
            n_edges=self.buffer.n_edges,
            batch_capacity=0 if regrew else int(b),
            regrew=regrew,
            latency_ms=ms,
            compiled=compiled,
        )

    def _dispatch_batch(self, slots, su, sv, du, dv, w) -> None:
        """Apply one padded batch row to the device-resident state. Kernel
        mode translates the slots through ``lane_perm`` on the device and
        marks the lanes unsorted: the patched lanes hold their new dst at
        their old positions until the next pass re-sorts (``_lanes``)."""
        wrote = _apply_batch(self._src, self._dst, self._deg, slots, su, sv, du,
                             dv, w, self._lane_perm, self.mesh)
        if self.kernel and wrote:
            self._sorted = False

    # -- candidate pruning (core/prune.py) ----------------------------------
    def _rebuild_plan(self) -> None:
        """rho~ bootstrap + ceil(rho~)-core analysis + bucket sizing. The
        previous epoch's best mask seeds rho~ (re-evaluated on the current
        edges, so the bound stays sound after deletions); the last observed
        handoff sizes the buckets with slack, so steady-state epochs keep
        their buckets (``bucket_reuses``)."""
        src, dst = self._lanes()
        rho_lb, k, _, n_cand, ne_cand = _plan(
            src, dst, self._prev_mask, self.buffer.n_edges, self.node_capacity,
            self.kernel, self.mesh)
        new = build_plan(
            rho_lb.item(), int(k), n_cand.item(), ne_cand.item(),
            node_width=self.node_capacity,
            lane_width=2 * self.buffer.capacity,
            observed=self._last_handoff,
            n_vertices=self.n_nodes,
        )
        if self._plan is not None and new.buckets == self._plan.buckets:
            self.metrics.bucket_reuses += 1
        self._plan = new
        self.metrics.n_plan_builds += 1
        self.metrics.candidate_fraction = new.candidate_fraction
        self.metrics.prune_bucket_v = new.bucket_v
        self.metrics.prune_bucket_e = new.bucket_e

    def _run_pruned_peel(self) -> tuple[float, np.ndarray, int] | None:
        """The pruned query resident on the engine's lanes
        (``prune.pruned_peel_resident``: pass 0, compaction, bucket peel and
        merge on the device). Returns (density, mask[:n_nodes], passes) —
        bit-identical to the unpruned cold peel — or ``None`` when the
        survivor set fits no legal bucket (caller runs the full-width path;
        counted as a prune fallback). A sharded engine runs the JAX package's
        host path (``prune.pruned_peel_host`` on the replicated buffer, the
        bucket peel sharded over the mesh)."""
        if self.mesh is not None:
            u, v = self.buffer.host_view()
            res = pruned_peel_host(
                u, v, self._deg.cpu().numpy(), self.buffer.n_edges, self.eps, self._plan,
                mesh=self.mesh, kernel=self.kernel)
        else:
            src, dst = self._lanes()
            res = pruned_peel_resident(
                src, dst, self.node_capacity, self.buffer.n_edges, self.eps,
                self._plan, self.kernel)
        if res is None:
            # survivor set fits no legal bucket this epoch: stop trying
            # until the refresh rebuilds the plan
            self.metrics.n_prune_fallbacks += 1
            self._plan = dc_replace(self._plan, enabled=False)
            return None
        return self._absorb_pruned_result(*res)

    def _absorb_pruned_result(
        self, density: float, mask: np.ndarray, passes: int,
        observed: tuple[int, int], plan: PrunePlan,
    ) -> tuple[float, np.ndarray, int]:
        """Post-dispatch bookkeeping for one pruned result (plan regrow /
        shrink accounting, prev-mask warm seed, metrics)."""
        self._last_handoff = observed
        if plan is not self._plan:  # in-flight bucket regrow or shrink
            if (plan.bucket_v < self._plan.bucket_v
                    or plan.bucket_e < self._plan.bucket_e):
                self.metrics.n_bucket_shrinks += 1
            self._plan = plan
            self.metrics.prune_bucket_v = plan.bucket_v
            self.metrics.prune_bucket_e = plan.bucket_e
        self._prev_mask = torch.from_numpy(mask).to(self.device, copy=True)
        self.metrics.n_pruned_queries += 1
        return density, mask[: self.n_nodes], passes

    # -- queries ------------------------------------------------------------
    @property
    def stale(self) -> bool:
        return self._staleness >= self.refresh_every

    def _cold_full_peel(self) -> PeelState:
        """Full-width peel re-anchor from the cold degree histogram (sharded:
        from the exactly resynced degrees, the same ints, as the JAX
        package's sharded engine does)."""
        src, dst = self._lanes()
        if self.mesh is not None:
            return _warm_peel(src, dst, self._deg, self.buffer.n_edges, self._prev_mask,
                              self.node_capacity, self.eps, self.kernel, self.mesh)[0]
        return _peel_to_end(
            init_state(src, dst, self.node_capacity, self.buffer.n_edges),
            src, dst, self.node_capacity, self.eps, self.kernel)

    def refresh(self) -> QueryResult:
        """Epoch refresh: compact the buffer (shrinking capacity when the
        graph contracted past the hysteresis), rebuild device state, rebuild
        the prune plan (warm-started from the previous epoch's density), and
        re-anchor with a cold peel — compacted when the plan allows."""
        with span("refresh", tenant=self.tenant, engine=self.kind) as sp:
            AUDITOR.sync()
            if self.buffer.epoch_compact(shrink=True):
                self.metrics.n_buffer_shrinks += 1
                self._plan = None  # lane-width sizing basis changed
            self._resync_device()
            self._staleness = 0.0
            out = None
            if self.pruned:
                self._rebuild_plan()
                if self._plan.enabled:
                    out = self._run_pruned_peel()
            if out is not None:
                density, mask, passes = out
                pruned_flag = True
            else:
                final = self._cold_full_peel()
                self._prev_mask = final.best_mask
                density = float(final.best_density)
                mask = final.best_mask.cpu().numpy()[: self.n_nodes]
                passes = int(final.passes)
                pruned_flag = False
            buckets = (self._plan.buckets
                       if pruned_flag and self._plan is not None else None)
            compiled = AUDITOR.record(
                self.tenant, "refresh", self._audit_shape() + (buckets,))
            sp.set("passes", passes).set("density", density)
            sp.set("path", "pruned" if pruned_flag else "warm")
            sp.set("compiled", compiled)
            sp.set("kernel", self.kernel)
            if pruned_flag:
                sp.set("candidate_fraction", self.metrics.candidate_fraction)
            ms = sp.elapsed_ms
        self.metrics.n_refreshes += 1
        self._note_query_ms(ms, compiled)
        self._cached_query = QueryResult(
            density=density, mask=mask, passes=passes,
            warm_density=density, warm_mask=mask.copy(),
            refreshed=True, latency_ms=ms, pruned=pruned_flag,
            compiled=compiled,
        )
        return self._cached_query

    def query(self, refine: bool = False, target_gap: float | None = None,
              max_refine_rounds: int = 64) -> QueryResult:
        """Densest-subgraph query on the current graph. Warm path unless the
        staleness counter says the epoch is due; repeat queries on an
        unchanged graph return the memoized result.

        ``refine=True`` serves a *certified* density instead: the exact
        warm/pruned peel seeds weighted-peel refinement rounds
        (repro_torch.refine) off the same resident device state, until the
        LP-duality gap closes below ``target_gap`` (relative to the dual
        bound; default ``refine.DEFAULT_TARGET_GAP``) or
        ``max_refine_rounds`` is spent. The reported density is >= the
        peel's, never above rho*, and carries a :class:`GapCertificate`.
        When the previous certificate still *proves* equality on the
        current graph — deletions keep the dual bound valid; insertions
        shift it by their max incident count — the peel is skipped
        entirely and the query costs one host re-count
        (``certified_skip`` marks it)."""
        if refine:
            return self._query_refined(target_gap, max_refine_rounds)
        if self._cached_query is not None:
            return self._cached_query
        if self._generation < 0:
            self._resync_device()
        if self.stale:
            return self.refresh()
        with span("query", tenant=self.tenant, engine=self.kind) as sp:
            AUDITOR.sync()
            out = None
            if self.pruned:
                if self._plan is None:
                    self._rebuild_plan()
                out = self._run_pruned_peel() if self._plan.enabled else None
            if out is not None:
                density, mask, passes = out
                warm_density, warm_mask = density, mask.copy()
                pruned_flag = True
                # post-op plan: an in-flight bucket regrow already swapped it
                # in via _absorb_pruned_result, so this IS what dispatched
                buckets = self._plan.buckets
                sp.set("candidate_fraction", self.metrics.candidate_fraction)
            else:
                src, dst = self._lanes()
                final, warm_rho = _warm_peel(
                    src, dst, self._deg, self.buffer.n_edges, self._prev_mask,
                    self.node_capacity, self.eps, self.kernel, self.mesh)
                density = float(final.best_density)
                warm_rho = float(warm_rho)
                mask = final.best_mask.cpu().numpy()[: self.n_nodes]
                passes = int(final.passes)
                if warm_rho > density:
                    warm_density = warm_rho
                    warm_mask = self._prev_mask.cpu().numpy()[: self.n_nodes]
                    # keep the stronger candidate as next query's warm seed
                else:
                    warm_density = density
                    warm_mask = mask.copy()
                    self._prev_mask = final.best_mask
                pruned_flag = False
                buckets = None
            compiled = AUDITOR.record(
                self.tenant, "query", self._audit_shape() + (buckets,))
            sp.set("passes", passes).set("density", density)
            sp.set("path", "pruned" if pruned_flag else "warm")
            sp.set("compiled", compiled)
            sp.set("kernel", self.kernel)
            ms = sp.elapsed_ms
        self._note_query_ms(ms, compiled)
        self._cached_query = QueryResult(
            density=density, mask=mask, passes=passes,
            warm_density=warm_density, warm_mask=warm_mask,
            refreshed=False, latency_ms=ms, pruned=pruned_flag,
            compiled=compiled,
        )
        return self._cached_query

    # -- near-optimal refinement (repro_torch.refine) ------------------------
    def _mask_counts(self, mask: np.ndarray) -> tuple[int, int]:
        """Exact integer (ne, nv) of ``mask`` (full vertex width) on the
        current graph, from the host slot arrays — O(|E|) numpy, no device
        dispatch (what makes the certified skip a peel-free query)."""
        u, v = self.buffer.host_view()
        lv = np.zeros(self.node_capacity + 1, dtype=bool)
        lv[: self.node_capacity] = mask
        return int((lv[u] & lv[v]).sum()), int(mask.sum())

    def _certified_skip(self) -> QueryResult | None:
        """Answer a refined query from the cached certificate alone when it
        still proves equality: the stored mask's density re-counted on the
        *current* edges must reach the stored dual bound shifted by the
        insert slack (exact integer comparison — a proof, so the returned
        density IS rho* of the current graph). Returns None otherwise."""
        cert = self._refine_cert
        if cert is None or self._cert_mask is None:
            return None
        with span("refine", tenant=self.tenant, engine=self.kind) as sp:
            ne, nv = self._mask_counts(self._cert_mask)
            if nv == 0:
                return None
            dual_num = cert.dual_num + self._cert_insert_slack * cert.dual_den
            if ne * cert.dual_den < dual_num * nv:
                return None  # bound no longer proves equality: full path
            new_cert = make_certificate(ne, nv, dual_num, cert.dual_den)
            self._refine_cert = new_cert  # re-anchored to the current graph
            self._cert_insert_slack = 0
            mask = self._cert_mask[: self.n_nodes].copy()
            sp.set("certified_skip", True).set("refine_rounds", 0)
            sp.set("certified_gap", new_cert.rel_gap)
            sp.set("path", "refined")
            ms = sp.elapsed_ms
        self._note_query_ms(ms, False)  # host-only: never a first call
        self.metrics.n_certified_skips += 1
        res = QueryResult(
            density=new_cert.density, mask=mask, passes=0,
            warm_density=new_cert.density, warm_mask=mask.copy(),
            refreshed=False, latency_ms=ms, certificate=new_cert,
            refine_rounds=0, certified_skip=True,
        )
        self._cached_refined = res
        return res

    def _query_refined(self, target_gap: float | None,
                       max_rounds: int) -> QueryResult:
        tg = DEFAULT_TARGET_GAP if target_gap is None else float(target_gap)
        cached = self._cached_refined
        if (cached is not None and cached.certificate is not None
                and cached.certificate.rel_gap <= tg):
            return cached
        if self._generation < 0:
            self._resync_device()
        skip = self._certified_skip()
        if skip is not None:
            return skip
        q = self.query()  # exact eps-peel seed (pruned/warm path)
        with span("refine", tenant=self.tenant, engine=self.kind) as sp:
            AUDITOR.sync()  # the seed query above recorded its own growth
            seed_mask = np.zeros(self.node_capacity, dtype=bool)
            seed_mask[: self.n_nodes] = q.mask
            seed_ne, seed_nv = self._mask_counts(seed_mask)
            src, dst = self._lanes()
            cert, mask_full, passes, rounds, _ = refine_resident(
                src, dst, self._deg, self.buffer.n_edges, self.node_capacity,
                self.eps, seed_ne, seed_nv, seed_mask, q.passes, tg,
                max_rounds, self.kernel, mesh=self.mesh)
            self._refine_cert = cert
            self._cert_mask = mask_full.copy()
            self._cert_insert_slack = 0
            compiled = AUDITOR.record(
                self.tenant, "refine", self._audit_shape())
            sp.set("refine_rounds", rounds)
            sp.set("certified_gap", cert.rel_gap)
            sp.set("path", "refined").set("compiled", compiled)
            sp.set("kernel", self.kernel)
            ms = sp.elapsed_ms
        self.metrics.n_refine_queries += 1
        self.metrics.refine_rounds_total += rounds
        self.metrics.query_ms_total += ms
        if compiled:
            self.metrics.query_first_call_ms_total += ms
        else:
            self.metrics.query_steady_ms_total += ms
        mask = mask_full[: self.n_nodes].copy()
        res = QueryResult(
            density=cert.density, mask=mask, passes=passes,
            warm_density=cert.density, warm_mask=mask.copy(),
            refreshed=q.refreshed, latency_ms=q.latency_ms + ms,
            pruned=q.pruned, certificate=cert, refine_rounds=rounds,
            compiled=compiled or q.compiled,
        )
        self._cached_refined = res
        return res

    def density(self) -> float:
        return self.query().density

    def cbds(self, rounds: int = 1) -> dict:
        """CBDS-P on the current graph, on the resident lanes
        (``core.cbds.cbds_resident``, K2 and K1 in kernel mode; sharded, over
        the mesh)."""
        if self._generation < 0:
            self._resync_device()
        src, dst = self._lanes()
        res = cbds_resident(src, dst, self.node_capacity, self.buffer.n_edges,
                            int(rounds), self.kernel, self.mesh)
        res["member_mask"] = res["member_mask"][: self.n_nodes]
        return res

    # -- introspection -------------------------------------------------------
    @property
    def n_edges(self) -> int:
        return self.buffer.n_edges

    @staticmethod
    def compile_count() -> int:
        """Total builds the auditor sees (``AUDITOR.total_compile_count()``:
        kernel libraries loaded by this process). Class-level: every engine
        shares them. ``AUDITOR.snapshot()`` says which tenant, op and shape
        triggered each."""
        return AUDITOR.total_compile_count()

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"DeltaEngine(|V|={self.n_nodes}/{self.node_capacity}, "
            f"|E|={self.buffer.n_edges}, eps={self.eps}, "
            f"pruned={self.pruned}, device={self.device}, kernel={self.kernel}, "
            f"shards={self.n_shards}, "
            f"stale_in={self.refresh_every - self._staleness:.1f})"
        )


__all__ = ["DeltaEngine", "QueryResult", "UpdateStats", "EngineMetrics",
           "MIN_BATCH", "DELETE_STALENESS_WEIGHT"]
