"""Candidate pruning: the exactness-preserving compacted peel.

Every ``pbahmani`` pass sweeps the full padded edge lanes, but the live set
shrinks geometrically, so most lanes of most passes are dead weight. This
module peels a *compacted fixed-shape subproblem* instead:

  1. a density lower bound rho~ is bootstrapped on the graph (its own
     density, a previous best mask re-evaluated on the current edges, and
     the densities of the iterated ceil(rho~)-cores; every candidate is an
     achieved subgraph density, hence a sound lower bound on rho*), and the
     k-core machinery (``kcore._level_fixpoint``) runs to the
     ceil(rho~)-core: the plan's candidate counts and bucket sizes;
  2. the peel's pass 0 runs on the device over the cached dst-sorted lanes
     (degrees from K1, one ``pbahmani_pass``), the host reads the three
     counts that size the buckets in one sync, and the survivors' induced
     edges are compacted on the device (``_compact_edges``: K3 for the
     order-preserving vertex index map, K4 for the lanes when ``kernel`` is
     on) into pow-2 buckets that come out dst-sorted with no sort;
  3. the peel runs inside the bucket on the device, with a second,
     bucket-width compaction ladder for the trajectory's tail (K3 and K4
     again), K2 carries every pass's edge stage, and the bucket result is
     merged back into the full vertex space on the device.

The JAX package does steps 2 and 3's merge on the host, because there a
device compaction cost more than a peel pass; on the H100 the one-pass K3
and K4 cost less than one. Its host half stays here as well
(``prepare_pruned_peel``, ``compact_candidates``, ``upload_buckets``,
``merge_pruned_peel``, ``pruned_peel_host``) for callers that hold host
slot arrays; both halves give the same arrays, lane for lane.

Exactness-preservation invariant: the pruned peel returns the bit-identical
(density, mask, passes) triple of the unpruned peel. Pass 0 is the peel's
own pass on the device, or is simulated on the host with the same int32
degrees and the same float32 threshold; a pass depends
only on the induced live subgraph and the scalar state, and compaction is an
order-preserving relabelling, so every integer the recurrence reads is
unchanged and every float32 scalar is computed from identical integers; best
tracking uses the same strict ``>`` at every merge point.

Order on the card: K2 needs dst-sorted lanes. The resident prep compacts
the graph's dst-sorted lanes, ``_emit_buckets`` sorts the host's, every
compaction keeps lane order under the monotone ``perm``, and the fill (the
child's vertex count) sorts after every live id, so every rung reaches K2
sorted. A graph's lanes are its undirected slots then their mirrors, so the
stable dst sort orders a pair of lanes as ``_emit_buckets`` orders them and
the two preps give the same bucket arrays.

This is the JAX package's ``core/prune.py``: its ``lax.while_loop``s are
host loops that read the live counts once a pass, and its vmapped bucket
peel is ``_batched_bucket_peel``, a batch axis written out
(``core/batched.py``) for the fused tenants, with a row-batched resident
prep beside it (``prepare_pruned_peel_rows``). Its sharded variants are the
same functions with ``mesh=`` (``make_sharded_plan``,
``pruned_peel_host(mesh=)``, the bucket peels over this rank's block of the
bucket lanes, the ladder compacting per rank).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.batched import init_rows, peel_rows_to_end, pbahmani_pass_rows, run_rows
from repro_torch.core.density import live_lane_count
from repro_torch.core import collective
from repro_torch.core.dispatch import (
    assert_exact_envelope, lane_degrees, lane_degrees_rows, resolve_device, resolve_kernel,
)
from repro_torch.core.distributed import lane_block, mesh_device
from repro_torch.core.kcore import CoreState, _level_fixpoint
from repro_torch.core.pbahmani import PeelState, pbahmani, pbahmani_pass
from repro_torch.graphs.convert import to_device
from repro_torch.graphs.graph import Graph
from repro_torch.kernels.compact import prefix_sum, stream_compact
from repro_torch.utils.num import next_pow2

MIN_BUCKET_V = 64     # smallest compacted vertex space (pow-2 buckets above)
MIN_BUCKET_E = 256    # smallest compacted lane count
LADDER_RATIO = 8      # second-level bucket = first-level bucket / ratio
BUCKET_SLACK = 1.5    # headroom over the observed handoff size
# mid-epoch bucket shrink fires only when the freshly-sized buckets are at
# least this factor below the plan's; with BUCKET_SLACK regrow this leaves a
# >2.5x swing between shrink and regrow, so oscillating graphs cannot thrash
BUCKET_SHRINK_HYSTERESIS = 4


@dataclass(frozen=True)
class PrunePlan:
    """Pruning decision for one graph.

    rho_lb / k / candidate counts come from the iterated ceil(rho~)-core;
    buckets are the fixed shapes of the compacted subproblem.
    """

    rho_lb: float            # sound lower bound on rho* (achieved density)
    k: int                   # prune level: candidates = ceil(rho_lb)-core
    n_candidates: int        # |ceil(rho_lb)-core|
    n_candidate_edges: int   # |E(core)|
    candidate_fraction: float  # |core| / graph vertex count (not padding)
    bucket_v: int            # compacted vertex-space size (pow-2)
    bucket_e: int            # compacted lane count (pow-2, holds 2|E| lanes)
    bucket_v2: int           # second-level ladder bucket
    bucket_e2: int
    enabled: bool
    node_width: int = 0      # sizing basis, kept for in-flight regrow
    lane_width: int = 0
    n_vertices: int = 0      # candidate_fraction denominator
    from_observed: bool = False  # buckets sized from a real handoff (a
                                 # shrink only trusts observed sizing)

    @property
    def buckets(self) -> tuple[int, int, int, int]:
        return (self.bucket_v, self.bucket_e, self.bucket_v2, self.bucket_e2)


# ---------------------------------------------------------------------------
# rho~ bootstrap + candidate core (plan analysis)
# ---------------------------------------------------------------------------
def _ceil_level(rho: torch.Tensor) -> torch.Tensor:
    return torch.ceil(rho).to(torch.int32).clamp(min=1)


def _plan(
    src: torch.Tensor,
    dst: torch.Tensor,
    prev_mask: torch.Tensor,
    n_edges: int,
    n_nodes: int,
    kernel: bool = False,
    mesh=None,
) -> tuple[torch.Tensor, int, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bootstrap rho~ and shrink to the ceil(rho~)-core.

    Returns (rho_lb, k, candidate_mask, n_candidates, n_candidate_edges).
    rho_lb only takes densities of actual subgraphs of the graph (live
    graph, re-validated previous mask, iterated cores), so rho_lb <= rho*.
    The loop over core levels runs on the host, one sync a level.
    ``kernel`` takes the degrees from K1 and each fixpoint iteration from
    K2 (the lanes must then be dst-sorted). With ``mesh`` the lanes are this
    rank's block (:func:`make_sharded_plan`): the degrees, the previous
    mask's edges and every fixpoint iteration are summed over the mesh.
    """
    dev = src.device
    deg = lane_degrees(src, dst, n_nodes, kernel, mesh)
    active = deg > 0
    n_v = active.sum(dtype=torch.int32)
    n_e = torch.tensor(n_edges, dtype=torch.int32, device=dev)
    rho0 = n_e.to(torch.float32) / n_v.clamp(min=1).to(torch.float32)
    # a previous best mask, re-evaluated on the current edges: a sound warm
    # start for rho~ (it is a subgraph of this graph)
    warm_e = collective.all_reduce_sum(live_lane_count(src, dst, prev_mask, n_nodes), mesh) // 2
    warm_v = prev_mask.sum(dtype=torch.int32)
    warm_rho = torch.where(
        warm_v > 0, warm_e.to(torch.float32) / warm_v.clamp(min=1).to(torch.float32), 0.0)
    rho_lb = torch.maximum(rho0, warm_rho)
    c = CoreState(
        k=-1,  # level already completed (none)
        deg=deg,
        active=active,
        coreness=torch.zeros(n_nodes, dtype=torch.int32, device=dev),
        n_v=n_v,
        n_e=n_e,
        best_density=rho_lb,
        best_k=torch.tensor(0, dtype=torch.int32, device=dev),
        best_n_v=n_v,
        best_n_e=n_e,
    )
    while True:
        # keep shrinking while the bound justifies a deeper core
        # repro: allow RPR101 -- the one host sync of each plan iteration
        n_v_h, level = (int(x) for x in torch.stack(
            [c.n_v, _ceil_level(c.best_density) - 1]).tolist())
        # repro: allow RPR102 -- c.k is CoreState's level, a Python int, not a tensor
        if not (n_v_h > 0 and c.k < level):
            break
        c = _level_fixpoint(c._replace(k=level), src, dst, n_nodes, kernel, mesh)
        rho_c = torch.where(
            c.n_v > 0,
            c.n_e.to(torch.float32) / c.n_v.clamp(min=1).to(torch.float32),
            0.0,
        )
        c = c._replace(best_density=torch.maximum(c.best_density, rho_c))
    return c.best_density, c.k + 1, c.active, c.n_v, c.n_e


def make_sharded_plan(mesh, n_nodes: int):
    """The JAX package's sharded plan analysis as a callable ``(src_l, dst_l,
    prev_mask, n_edges) -> (rho_lb, k, candidate_mask, n_candidates,
    n_candidate_edges)`` over this rank's block of the lanes (scatter tier,
    as the sharded engine runs): ``_plan`` with ``mesh``. The integers are
    the single-device plan's on any rank count."""
    def run(src_l, dst_l, prev_mask, n_edges):
        return _plan(src_l, dst_l, prev_mask, int(n_edges), n_nodes, False, mesh)

    return run


def build_plan(
    rho_lb: float,
    k: int,
    n_candidates: int,
    n_candidate_edges: int,
    node_width: int,
    lane_width: int,
    observed: tuple[int, int] | None = None,
    n_vertices: int | None = None,
) -> PrunePlan:
    """Size the compaction buckets for a (node_width, lane_width) graph.

    ``observed`` is a previous handoff (survivor count, live lanes);
    buckets track it with ``BUCKET_SLACK`` headroom. The vertex bucket may
    reach the full (pow-2) vertex space; the lane bucket must stay strictly
    below the full lane width for pruning to pay off.
    """
    # exactness rides on int32 counts surviving the JAX kernel tier's f32
    # accumulation; both packages refuse out-of-envelope shapes here
    assert_exact_envelope(node_width, lane_width)
    cap_v = max(next_pow2(node_width), MIN_BUCKET_V)
    cap_e = max(next_pow2(lane_width) // 2, MIN_BUCKET_E)
    if observed is not None:
        h_nv, h_lanes = observed
        bv = next_pow2(max(int(h_nv * BUCKET_SLACK), MIN_BUCKET_V))
        be = next_pow2(max(int(h_lanes * BUCKET_SLACK), MIN_BUCKET_E))
    else:
        bv = max(cap_v // 2, MIN_BUCKET_V)
        be = cap_e
    bv = min(bv, cap_v)
    be = min(be, cap_e)
    bv2 = max(bv // LADDER_RATIO, MIN_BUCKET_V)
    be2 = max(be // LADDER_RATIO, MIN_BUCKET_E)
    enabled = be < lane_width
    n_vertices = node_width if n_vertices is None else int(n_vertices)
    return PrunePlan(
        rho_lb=float(rho_lb),
        k=int(k),
        n_candidates=int(n_candidates),
        n_candidate_edges=int(n_candidate_edges),
        candidate_fraction=float(n_candidates) / max(n_vertices, 1),
        bucket_v=int(bv),
        bucket_e=int(be),
        bucket_v2=int(min(bv2, bv)),
        bucket_e2=int(min(be2, be)),
        enabled=bool(enabled),
        node_width=int(node_width),
        lane_width=int(lane_width),
        n_vertices=n_vertices,
        from_observed=observed is not None,
    )


def maybe_shrink_plan(
    plan: PrunePlan, n_v1: int, lanes1: int
) -> PrunePlan | None:
    """A right-sized plan when the observed handoff fits buckets
    ``BUCKET_SHRINK_HYSTERESIS``x smaller on either axis, else None.
    Shrinking changes only shapes; bit-identity holds for every bucket
    choice. First-shot plans (sized before any handoff was seen) never
    shrink: their slack is intentional headroom."""
    if not plan.from_observed:
        return None
    bv = next_pow2(max(int(n_v1 * BUCKET_SLACK), MIN_BUCKET_V))
    be = next_pow2(max(int(lanes1 * BUCKET_SLACK), MIN_BUCKET_E))
    if (bv * BUCKET_SHRINK_HYSTERESIS > plan.bucket_v
            and be * BUCKET_SHRINK_HYSTERESIS > plan.bucket_e):
        return None
    new = build_plan(
        plan.rho_lb, plan.k, plan.n_candidates, plan.n_candidate_edges,
        node_width=plan.node_width, lane_width=plan.lane_width,
        observed=(n_v1, lanes1), n_vertices=plan.n_vertices or None,
    )
    if not new.enabled or new.buckets == plan.buckets:
        return None
    return new


# ---------------------------------------------------------------------------
# device side: bucket peel with a second-level compaction ladder
# ---------------------------------------------------------------------------
def _scatter_drop(size: int, fill, slot: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``full(size, fill)`` with ``out[slot] = values`` where ``slot < size``
    (other slots drop into a discarded tail row): the scatter tier's
    ``.at[slot].set(values, mode="drop")``."""
    out = torch.full((size + 1,), fill, dtype=values.dtype, device=slot.device)
    return out.scatter_(0, slot.clamp(max=size).long(), values)[:size]


def _compact_edges(
    src: torch.Tensor,
    dst: torch.Tensor,
    live_v: torch.Tensor,
    n_nodes: int,
    bucket_v: int,
    bucket_e: int,
    kernel: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Remap of the subgraph induced by ``live_v`` into bucket lanes (the
    resident prep and the in-bucket ladder step). ``kernel`` scans
    ``live_v`` with K3 and packs the lanes with K4; otherwise a cumsum and a
    scatter. Both pack survivors as a dense prefix in lane order (overflow
    lanes drop), so the outputs are identical, and a dst-sorted parent hands
    a dst-sorted child to the next rung because ``perm`` is monotone.
    Returns (perm, bucket_src, bucket_dst)."""
    src_c = src.clamp(max=n_nodes - 1)
    dst_c = dst.clamp(max=n_nodes - 1)
    valid = (src < n_nodes) & (dst < n_nodes)
    live = valid & live_v.index_select(0, src_c) & live_v.index_select(0, dst_c)
    perm = (prefix_sum(live_v) if kernel else torch.cumsum(live_v, 0, dtype=torch.int32)) - 1
    p_src, p_dst = perm.index_select(0, src_c), perm.index_select(0, dst_c)
    if kernel:
        packed = stream_compact(torch.stack([p_src, p_dst], dim=1), live,
                                out_size=bucket_e, fill=bucket_v)
        return perm, packed[:, 0].contiguous(), packed[:, 1].contiguous()
    pos = torch.where(live, torch.cumsum(live, 0, dtype=torch.int32) - 1, bucket_e)
    return (perm, _scatter_drop(bucket_e, bucket_v, pos, p_src),
            _scatter_drop(bucket_e, bucket_v, pos, p_dst))


def _peel_to_end(
    state: PeelState, src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
    eps: float, kernel: bool = False, mesh=None,
) -> PeelState:
    while state.n_v.item() > 0:  # repro: allow RPR101 -- the one host sync of each pass
        state = pbahmani_pass(state, src, dst, n_nodes, eps, kernel, mesh)
    return state


def _staged_peel(
    state: PeelState,
    src: torch.Tensor,
    dst: torch.Tensor,
    n_nodes: int,
    eps: float,
    bucket_v: int,
    bucket_e: int,
    kernel: bool = False,
    mesh=None,
) -> PeelState:
    """Peel at the current width until the live set fits (bucket_v,
    bucket_e), compact, and finish inside the smaller bucket. The returned
    state is in the *current* (n_nodes-wide) space and bit-identical to
    ``_peel_to_end`` on the same input. The compaction runs whether or not
    anything is left, as the JAX package's traced program does.

    With ``mesh`` the lanes are this rank's block, and the ladder compacts
    *per rank*, as the JAX package's sharded bucket peel does: each rank packs
    its own live lanes into a local ``bucket_e``-lane bucket (no rank can
    overflow it: the mesh's live lanes fit it at the switch). The lane order
    differs from the single-device ladder's, the int32 sums do not."""
    s1 = state
    while True:
        # repro: allow RPR101 -- the one host sync of each pass, on replicated counts
        n_v, n_e = torch.stack([s1.n_v, s1.n_e]).tolist()
        if not (n_v > 0 and (n_v > bucket_v or 2 * n_e > bucket_e)):
            break
        s1 = pbahmani_pass(s1, src, dst, n_nodes, eps, kernel, mesh)
    perm, b_src, b_dst = _compact_edges(
        src, dst, s1.active, n_nodes, bucket_v, bucket_e, kernel)
    if kernel:
        # survivors land as a dense prefix, so the live mask is arange < n_v
        # and the degree pull is the same stream compaction (fill 0 == what
        # the scatter leaves in dead slots)
        b_deg = stream_compact(s1.deg, s1.active, out_size=bucket_v, fill=0)
        b_active = torch.arange(bucket_v, dtype=torch.int32, device=src.device) < s1.n_v
    else:
        vslot = torch.where(s1.active, perm, bucket_v)
        b_deg = _scatter_drop(bucket_v, 0, vslot, s1.deg)
        b_active = _scatter_drop(bucket_v, False, vslot, torch.ones_like(s1.active))
    s2 = _peel_to_end(
        PeelState(
            deg=b_deg,
            active=b_active,
            n_v=s1.n_v,
            n_e=s1.n_e,
            best_density=s1.best_density,
            best_mask=torch.zeros(bucket_v, dtype=torch.bool, device=src.device),
            passes=s1.passes,
        ),
        b_src, b_dst, bucket_v, eps, kernel, mesh,
    )
    improved = s2.best_density > s1.best_density
    mask_back = s1.active & s2.best_mask.index_select(0, perm.clamp(0, bucket_v - 1))
    # the peel runs to an empty live set, so the terminal deg/active are
    # identically zero (what _peel_to_end would hold)
    return s1._replace(
        deg=torch.zeros_like(s1.deg),
        active=torch.zeros_like(s1.active),
        best_density=s2.best_density,
        best_mask=torch.where(improved, mask_back, s1.best_mask),
        passes=s2.passes,
        n_v=s2.n_v,
        n_e=s2.n_e,
    )


def _bucket_peel_body(
    b_src: torch.Tensor,
    b_dst: torch.Tensor,
    n_v: torch.Tensor,
    n_e: torch.Tensor,
    best_density: torch.Tensor,
    passes: torch.Tensor,
    eps: float,
    bucket_v: int,
    bucket_v2: int,
    bucket_e2: int,
    kernel: bool = False,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Peel the compacted subproblem to completion (with the ladder).

    Both preps emit compact ids as a dense prefix, so the live mask is
    ``arange < n_v``. ``kernel`` routes the degrees (K1 over the bucket's
    dst-sorted lanes, whose sentinel tail would otherwise pile every
    histogram atomic onto one row), the degree updates (K2) and the
    ladder's compaction (K3 and K4) through the kernels; the triple is
    bit-identical either way.
    """
    dev = b_src.device
    final = _staged_peel(
        PeelState(
            deg=lane_degrees(b_src, b_dst, bucket_v, kernel, mesh),
            active=torch.arange(bucket_v, dtype=torch.int32, device=dev) < n_v,
            n_v=n_v,
            n_e=n_e,
            best_density=best_density,
            best_mask=torch.zeros(bucket_v, dtype=torch.bool, device=dev),
            passes=passes,
        ),
        b_src, b_dst, bucket_v, eps, bucket_v2, bucket_e2, kernel, mesh,
    )
    return final.best_density, final.best_mask, final.passes


def _bucket_peel(
    b_src: torch.Tensor, b_dst: torch.Tensor, n_v: int, n_e: int,
    best_density: float, passes: int, eps: float, bucket_v: int, bucket_e: int,
    bucket_v2: int, bucket_e2: int, kernel: bool = False, mesh=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The device bucket peel from host scalars; the lanes are already on
    the device (the resident prep's, or ``upload_buckets``; with ``mesh``
    this rank's block of them, ``bucket_e / n`` lanes). Returns (density,
    mask, passes) as device tensors."""
    width = bucket_e if mesh is None else bucket_e // mesh.size
    if b_src.shape != (width,):
        raise ValueError(f"bucket lanes {tuple(b_src.shape)} do not match "
                         f"bucket_e={bucket_e}")

    def scalar(x, dtype):
        return torch.tensor(x, dtype=dtype, device=b_src.device)

    return _bucket_peel_body(
        b_src, b_dst, scalar(n_v, torch.int32), scalar(n_e, torch.int32),
        scalar(best_density, torch.float32), scalar(passes, torch.int32),
        float(eps), bucket_v, bucket_v2, bucket_e2, kernel, mesh)


# ---------------------------------------------------------------------------
# host side: pass-0 simulation, compaction, and state merge
# ---------------------------------------------------------------------------
def _pass0_host(
    deg: np.ndarray, n_edges: int, eps: float
) -> tuple[np.ndarray, np.ndarray, int, np.float32]:
    """Replicate the peel's pass 0 in host float32: same ints, same f32
    threshold arithmetic as ``pbahmani_pass`` / ``peel_threshold``.
    Returns (active0, survivors, n_v0, rho0)."""
    active0 = deg > 0
    n_v0 = int(active0.sum())
    rho0 = np.float32(n_edges) / np.float32(max(n_v0, 1))
    thr0 = np.float32(2.0 * (1.0 + eps)) * rho0
    failed0 = active0 & (deg.astype(np.float32) <= thr0)
    return active0, active0 & ~failed0, n_v0, rho0


def _induced_slots(u: np.ndarray, v: np.ndarray, live_v: np.ndarray) -> np.ndarray:
    """Indices of undirected slots whose endpoints both survive ``live_v``
    (sentinel slots are dropped via the appended always-False row)."""
    lv = np.concatenate([live_v, np.zeros(1, dtype=bool)])
    return np.flatnonzero(lv[u] & lv[v])


def _emit_buckets(
    u: np.ndarray,
    v: np.ndarray,
    idx: np.ndarray,
    live_v: np.ndarray,
    bucket_v: int,
    bucket_e: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Remap the slots ``idx`` into sentinel(=bucket_v)-padded symmetric COO
    bucket arrays, **emitted dst-sorted**: K2's precondition, and it
    survives every ladder rung without re-sorting. The scatter tier's sums
    are order-invariant, so the order changes nothing there. Returns (perm,
    bucket_src, bucket_dst)."""
    k = idx.size
    if 2 * k > bucket_e or int(live_v.sum()) > bucket_v:
        raise ValueError("subproblem does not fit the requested buckets")
    perm = np.cumsum(live_v.astype(np.int64)) - 1
    bu = perm[u[idx]].astype(np.int32)
    bv_ = perm[v[idx]].astype(np.int32)
    bs = np.concatenate([bu, bv_])
    bd = np.concatenate([bv_, bu])
    order = np.argsort(bd, kind="stable")
    b_src = np.full(bucket_e, bucket_v, np.int32)
    b_dst = np.full(bucket_e, bucket_v, np.int32)
    b_src[:2 * k] = bs[order]
    b_dst[:2 * k] = bd[order]
    return perm, b_src, b_dst


def compact_candidates(
    u: np.ndarray,
    v: np.ndarray,
    live_v: np.ndarray,
    bucket_v: int,
    bucket_e: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Host compaction of the undirected slot arrays ``u, v``
    (sentinel-padded, sentinel == len(live_v)) to the subgraph induced by
    ``live_v``. Returns (perm, bucket_src, bucket_dst, live_lanes), the
    bucket arrays in symmetric COO, sentinel(=bucket_v)-padded; ``perm`` is
    the order-preserving vertex index map (full id -> compact id, valid
    where ``live_v``)."""
    idx = _induced_slots(u, v, live_v)
    perm, b_src, b_dst = _emit_buckets(u, v, idx, live_v, bucket_v, bucket_e)
    return perm, b_src, b_dst, 2 * idx.size


@dataclass
class PrunedDispatch:
    """A prepared compacted subproblem awaiting its device bucket peel.

    Produced by :func:`prepare_pruned_peel` (numpy arrays, merged by
    :func:`merge_pruned_peel`) or :func:`prepare_pruned_peel_resident`
    (the same arrays as tensors on the device, merged by
    :func:`merge_pruned_peel_resident`)."""

    b_src: np.ndarray        # [bucket_e] sentinel(=bucket_v)-padded COO
    b_dst: np.ndarray
    n_v1: int                # pass-0 survivor count
    n_e1: int                # surviving undirected edges
    best_d1: np.float32      # best density after the pass-0/1 merge
    eps: float
    plan: PrunePlan          # may have regrown/shrunk relative to the input
    perm: np.ndarray         # full id -> compact id (valid where ``a1``)
    a1: np.ndarray           # pass-0 survivor mask (full vertex space)
    active0: np.ndarray      # pass-0 live mask
    better1: bool            # pass-1 density beat pass-0's
    observed: tuple[int, int]  # (n_v1, lanes1) handoff for bucket sizing


def _fit_plan(
    plan: PrunePlan, n_v1: int, lanes1: int, node_width: int, lane_width: int,
) -> PrunePlan | None:
    """``plan`` sized for the pass-0 handoff (n_v1 survivors, lanes1 live
    lanes): regrown to the observed size on the plan's own sizing basis
    (``node_width``/``lane_width`` stand in where the plan has none) when it
    does not fit, None when no legal bucket holds it, else shrunk when
    ``maybe_shrink_plan`` says so."""
    if n_v1 > plan.bucket_v or lanes1 > plan.bucket_e:
        plan = build_plan(
            plan.rho_lb, plan.k, plan.n_candidates, plan.n_candidate_edges,
            node_width=plan.node_width or node_width,
            lane_width=plan.lane_width or lane_width,
            observed=(n_v1, lanes1), n_vertices=plan.n_vertices or None,
        )
        if (not plan.enabled or n_v1 > plan.bucket_v
                or lanes1 > plan.bucket_e):
            return None
        return plan
    return maybe_shrink_plan(plan, n_v1, lanes1) or plan


def _best_after_pass0(n_v1: int, n_e1: int, rho0: np.float32) -> tuple[bool, np.float32]:
    """(better1, best_d1): whether the pass-0 survivors' float32 density
    beats ``rho0`` (strict ``>``), and the best of the two."""
    rho1 = (np.float32(n_e1) / np.float32(max(n_v1, 1))
            if n_v1 > 0 else np.float32(0.0))
    better1 = bool(rho1 > rho0)
    return better1, np.float32(rho1 if better1 else rho0)


def prepare_pruned_peel(
    u: np.ndarray,
    v: np.ndarray,
    deg: np.ndarray,
    n_edges: int,
    eps: float,
    plan: PrunePlan,
) -> (PrunedDispatch
      | tuple[float, np.ndarray, int, tuple[int, int], PrunePlan] | None):
    """Host half of the pruned query: pass-0 simulation + compaction.

    Returns a :class:`PrunedDispatch` ready for the device bucket peel, or
    the finished result tuple for the empty-graph case, or ``None`` when the
    survivor set fits no legal bucket (the caller runs its unpruned path)."""
    n_nodes = deg.shape[0]
    active0, a1, n_v0, rho0 = _pass0_host(deg, n_edges, eps)
    if n_v0 == 0:
        return float(rho0), active0, 0, (0, 0), plan
    n_v1 = int(a1.sum())
    idx = _induced_slots(u, v, a1)
    lanes1 = 2 * idx.size
    # the host knows the exact size before dispatch
    plan = _fit_plan(plan, n_v1, lanes1, n_nodes, u.shape[0] * 2)
    if plan is None:
        return None
    perm, b_src, b_dst = _emit_buckets(u, v, idx, a1, plan.bucket_v,
                                       plan.bucket_e)
    n_e1 = lanes1 // 2
    better1, best_d1 = _best_after_pass0(n_v1, n_e1, rho0)
    return PrunedDispatch(
        b_src=b_src, b_dst=b_dst, n_v1=n_v1, n_e1=n_e1,
        best_d1=best_d1, eps=float(eps), plan=plan, perm=perm,
        a1=a1, active0=active0, better1=better1, observed=(n_v1, lanes1),
    )


def upload_buckets(pd: PrunedDispatch, device: torch.device | str, mesh=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dispatch's bucket lanes on ``device`` (two int32 uploads); with
    ``mesh`` this rank's contiguous block of them (dst-sorted, as the whole
    bucket is)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a if mesh is None else lane_block(a, mesh))).to(device) for a in (pd.b_src, pd.b_dst))


def merge_pruned_peel(
    pd: PrunedDispatch, d_b, mask_b, passes_b
) -> tuple[float, np.ndarray, int, tuple[int, int], PrunePlan]:
    """Host merge of the device bucket triple back into the full vertex
    space: the exact strict-``>`` merge of the unpruned trajectory."""
    density = np.float32(d_b)
    passes = int(passes_b)
    if density > pd.best_d1:  # strict >: earliest best wins, as unpruned
        mask_b = np.asarray(mask_b)
        mask = pd.a1 & mask_b[np.minimum(pd.perm, pd.plan.bucket_v - 1)]
    else:
        mask = pd.a1 if pd.better1 else pd.active0
    return float(density), mask, passes, pd.observed, pd.plan


def pruned_peel_host(
    u: np.ndarray,
    v: np.ndarray,
    deg: np.ndarray,
    n_edges: int,
    eps: float,
    plan: PrunePlan,
    mesh=None,
    kernel: bool = False,
    device: torch.device | str | None = None,
) -> tuple[float, np.ndarray, int, tuple[int, int], PrunePlan] | None:
    """The full pruned query: host pass 0 + compaction, device bucket peel
    on ``device``, host merge. ``u, v`` are undirected host slot arrays
    (sentinel-padded), ``deg`` the exact int32 degree array (len == vertex
    space == sentinel).

    Returns (density, mask, passes, observed_handoff, plan); ``plan`` may
    have grown or shrunk to the observed survivor set. Returns ``None``
    when the survivor set fits no legal bucket; the caller runs its
    unpruned path. ``kernel`` selects K2 and K4 inside the bucket peel.

    With ``mesh`` (every rank calling with the same arrays) the bucket peel
    runs sharded on the mesh's device: each rank peels its block of the
    bucket lanes, one all-reduce a pass, and its ladder compacts per rank.
    The same triple; ``None`` when the rank count does not divide the bucket
    lanes (pruning cannot pay off on that mesh; the full-width path can).
    """
    device = mesh_device(mesh, device)
    prep = prepare_pruned_peel(u, v, deg, n_edges, eps, plan)
    if prep is None or isinstance(prep, tuple):
        return prep
    pd = prep
    if mesh is not None and pd.plan.bucket_e % mesh.size:
        return None
    b_src, b_dst = upload_buckets(pd, device, mesh)
    d_b, mask_b, passes_b = _bucket_peel(
        b_src, b_dst, pd.n_v1, pd.n_e1, float(pd.best_d1), 1, float(eps),
        *pd.plan.buckets, kernel, mesh)
    return merge_pruned_peel(pd, d_b.item(), mask_b.cpu().numpy(), passes_b.item())


# ---------------------------------------------------------------------------
# resident: the pruned query's pass 0, compaction and merge on the device
# ---------------------------------------------------------------------------
def prepare_pruned_peel_resident(
    src: torch.Tensor,
    dst: torch.Tensor,
    n_nodes: int,
    n_edges: int,
    eps: float,
    plan: PrunePlan,
    kernel: bool = False,
) -> (PrunedDispatch
      | tuple[float, np.ndarray, int, tuple[int, int], PrunePlan] | None):
    """:func:`prepare_pruned_peel` on the device, over the graph's resident
    dst-sorted lanes (``to_device(graph, device, sorted=True)``, whatever
    ``kernel`` is: the bucket's lane order is theirs).

    The degrees are K1 over the lanes with ``kernel`` (``lane_degrees``; by
    the mirror identity the int32 of ``Graph.degrees``) and pass 0 is one
    ``pbahmani_pass`` (one K2 launch), the peel's own float32 threshold. The
    host reads (n_v0, n_v1, n_e1) in one sync and sizes the plan as the host
    prep does, so a survivor set that fits no bucket returns None before K3
    or K4 runs. The compaction is ``_compact_edges`` (K3 and K4 with
    ``kernel``). Returns a :class:`PrunedDispatch` whose arrays are device
    tensors equal to the host prep's (``perm`` where ``a1``), the finished
    result for an edgeless graph, or None."""
    dev = src.device
    deg = lane_degrees(src, dst, n_nodes, kernel)
    active0 = deg > 0
    n_v0_t = active0.sum(dtype=torch.int32)
    n_e = torch.tensor(n_edges, dtype=torch.int32, device=dev)
    rho0_t = n_e.to(torch.float32) / n_v0_t.clamp(min=1).to(torch.float32)
    s1 = pbahmani_pass(
        PeelState(deg=deg, active=active0, n_v=n_v0_t, n_e=n_e, best_density=rho0_t,
                  best_mask=active0, passes=torch.zeros((), dtype=torch.int32, device=dev)),
        src, dst, n_nodes, float(eps), kernel)
    n_v0, n_v1, n_e1 = torch.stack([n_v0_t, s1.n_v, s1.n_e]).tolist()  # the one sync
    rho0 = np.float32(n_edges) / np.float32(max(n_v0, 1))
    if n_v0 == 0:
        return float(rho0), active0.cpu().numpy(), 0, (0, 0), plan
    # a symmetric graph's live lanes are twice its live edges; the lane
    # width stands in as the host prep's (its slots plus one pad, doubled)
    lanes1 = 2 * n_e1
    plan = _fit_plan(plan, n_v1, lanes1, n_nodes, 2 * (n_edges + 1))
    if plan is None:
        return None
    perm, b_src, b_dst = _compact_edges(src, dst, s1.active, n_nodes, plan.bucket_v,
                                        plan.bucket_e, kernel)
    better1, best_d1 = _best_after_pass0(n_v1, n_e1, rho0)
    return PrunedDispatch(
        b_src=b_src, b_dst=b_dst, n_v1=n_v1, n_e1=n_e1, best_d1=best_d1, eps=float(eps),
        plan=plan, perm=perm, a1=s1.active, active0=active0, better1=better1,
        observed=(n_v1, lanes1),
    )


def merge_pruned_peel_resident(
    pd: PrunedDispatch, d_b: torch.Tensor, mask_b: torch.Tensor, passes_b: torch.Tensor,
) -> tuple[float, np.ndarray, int, tuple[int, int], PrunePlan]:
    """:func:`merge_pruned_peel` on the device for a resident dispatch: the
    same strict-``>`` merge, then the mask comes back with one copy."""
    back = pd.a1 & mask_b.index_select(0, pd.perm.clamp(0, pd.plan.bucket_v - 1))
    mask = torch.where(d_b > float(pd.best_d1), back, pd.a1 if pd.better1 else pd.active0)
    mask = mask.cpu().numpy()
    return float(d_b.item()), mask, int(passes_b.item()), pd.observed, pd.plan


def pruned_peel_resident(
    src: torch.Tensor,
    dst: torch.Tensor,
    n_nodes: int,
    n_edges: int,
    eps: float,
    plan: PrunePlan,
    kernel: bool = False,
) -> tuple[float, np.ndarray, int, tuple[int, int], PrunePlan] | None:
    """The full pruned query on the lanes' device: resident prep, bucket peel
    (no upload: it takes the prep's tensors), device merge. Returns what
    :func:`pruned_peel_host` returns, None included."""
    prep = prepare_pruned_peel_resident(src, dst, n_nodes, n_edges, eps, plan, kernel)
    if prep is None or isinstance(prep, tuple):
        return prep
    d_b, mask_b, passes_b = _bucket_peel(
        prep.b_src, prep.b_dst, prep.n_v1, prep.n_e1, float(prep.best_d1), 1, float(eps),
        *prep.plan.buckets, kernel)
    return merge_pruned_peel_resident(prep, d_b, mask_b, passes_b)


# ---------------------------------------------------------------------------
# row-batched: G same-bucket subproblems peeled together (the fused tenants)
# ---------------------------------------------------------------------------
def _staged_peel_rows(
    state: PeelState,
    src: torch.Tensor,
    dst: torch.Tensor,
    n_nodes: int,
    eps: float,
    bucket_v: int,
    bucket_e: int,
    kernel: bool = False,
    mesh=None,
) -> PeelState:
    """``_staged_peel`` of each row of a row-batched state (lanes [G, L]),
    as the JAX package's vmap runs it: the batched pass runs while any row
    does not fit (bucket_v, bucket_e), a row that fits or has converged
    waiting frozen; then every row is compacted on its own (``_compact_edges``
    and, with ``kernel``, the degree pull: one K3 and two K4 launches a row),
    the rows are stacked into ``[G, bucket_e]`` lanes and the batched peel
    finishes inside the bucket. Each row's result equals ``_staged_peel`` of
    that row."""
    dev = src.device

    def unfits(s: PeelState) -> torch.Tensor:
        return (s.n_v > 0) & ((s.n_v > bucket_v) | (2 * s.n_e > bucket_e))

    s1 = run_rows(state, lambda s: pbahmani_pass_rows(s, src, dst, n_nodes, eps, kernel, mesh),
                  live=unfits)
    perms, b_src, b_dst, b_deg = [], [], [], []
    for r in range(src.shape[0]):
        perm, bs, bd = _compact_edges(src[r], dst[r], s1.active[r], n_nodes, bucket_v,
                                      bucket_e, kernel)
        if kernel:
            b_deg.append(stream_compact(s1.deg[r], s1.active[r], out_size=bucket_v, fill=0))
        else:
            vslot = torch.where(s1.active[r], perm, bucket_v)
            b_deg.append(_scatter_drop(bucket_v, 0, vslot, s1.deg[r]))
        perms.append(perm)
        b_src.append(bs)
        b_dst.append(bd)
    perm = torch.stack(perms)
    # survivors land as a dense prefix of each row on both tiers
    b_active = torch.arange(bucket_v, dtype=torch.int32, device=dev)[None, :] < s1.n_v[:, None]
    s2 = peel_rows_to_end(
        PeelState(deg=torch.stack(b_deg), active=b_active, n_v=s1.n_v, n_e=s1.n_e,
                  best_density=s1.best_density,
                  best_mask=torch.zeros_like(b_active), passes=s1.passes),
        torch.stack(b_src), torch.stack(b_dst), bucket_v, eps, kernel, mesh)
    improved = s2.best_density > s1.best_density
    mask_back = s1.active & torch.gather(s2.best_mask, 1, perm.clamp(0, bucket_v - 1).long())
    return s1._replace(
        deg=torch.zeros_like(s1.deg),
        active=torch.zeros_like(s1.active),
        best_density=s2.best_density,
        best_mask=torch.where(improved[:, None], mask_back, s1.best_mask),
        passes=s2.passes,
        n_v=s2.n_v,
        n_e=s2.n_e,
    )


def _batched_bucket_peel(
    b_src: torch.Tensor, b_dst: torch.Tensor, n_v: torch.Tensor, n_e: torch.Tensor,
    best_density: torch.Tensor, passes: torch.Tensor, eps: float, bucket_v: int,
    bucket_e: int, bucket_v2: int, bucket_e2: int, kernel: bool = False, mesh=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_bucket_peel`` of G same-bucket subproblems at once (the JAX
    package's vmapped ``_batched_bucket_peel_jit``): lanes ``[G, bucket_e]``,
    the scalars int32/float32 ``[G]`` on the lanes' device. The degrees are
    one launch of K1's rows entry with ``kernel`` (``lane_degrees_rows``), the
    passes K2's rows entry, the ladder ``_staged_peel_rows``. Returns
    (density [G], mask [G, bucket_v], passes [G]); row r's equals
    ``_bucket_peel`` of row r. With ``mesh`` the lanes are this rank's blocks
    (``[G, bucket_e / n]``; the JAX package's
    ``_make_sharded_batched_bucket_peel``): one all-reduce a batched pass."""
    width = bucket_e if mesh is None else bucket_e // mesh.size
    if b_src.shape[1:] != (width,):
        raise ValueError(f"bucket lanes {tuple(b_src.shape)} do not match "
                         f"bucket_e={bucket_e}")
    dev = b_src.device
    active = torch.arange(bucket_v, dtype=torch.int32, device=dev)[None, :] < n_v[:, None]
    final = _staged_peel_rows(
        PeelState(deg=lane_degrees_rows(b_src, b_dst, bucket_v, kernel, mesh), active=active,
                  n_v=n_v.to(torch.int32), n_e=n_e.to(torch.int32),
                  best_density=best_density.to(torch.float32),
                  best_mask=torch.zeros_like(active), passes=passes.to(torch.int32)),
        b_src, b_dst, bucket_v, eps, bucket_v2, bucket_e2, kernel, mesh)
    return final.best_density, final.best_mask, final.passes


def prepare_pruned_peel_rows(
    src: torch.Tensor,
    dst: torch.Tensor,
    n_nodes: int,
    n_edges: list[int],
    eps: float,
    plans: list[PrunePlan],
    kernel: bool = False,
) -> list:
    """:func:`prepare_pruned_peel_resident` of G graphs at once, lanes
    ``[G, L]`` (each row dst-sorted, whatever ``kernel`` is, as there): the
    degrees are one launch of K1's rows entry with ``kernel``, pass 0 one
    batched pass (K2's rows entry), the host reads every row's (n_v0, n_v1,
    n_e1) in one sync, and each row whose plan fits is compacted on its own
    (one K3 and one K4 launch). Returns one entry a row, what
    :func:`prepare_pruned_peel_resident` returns for it."""
    dev = src.device
    g = src.shape[0]
    deg = lane_degrees_rows(src, dst, n_nodes, kernel)
    n_e = torch.tensor(n_edges, dtype=torch.int32, device=dev)
    s0 = init_rows(deg, n_e)
    s1 = pbahmani_pass_rows(s0, src, dst, n_nodes, float(eps), kernel)
    counts = torch.stack([s0.n_v, s1.n_v, s1.n_e]).cpu().numpy()  # the one sync
    out = []
    for r in range(g):
        n_v0, n_v1, n_e1 = (int(x) for x in counts[:, r])
        rho0 = np.float32(n_edges[r]) / np.float32(max(n_v0, 1))
        if n_v0 == 0:
            out.append((float(rho0), s0.active[r].cpu().numpy(), 0, (0, 0), plans[r]))
            continue
        lanes1 = 2 * n_e1
        plan = _fit_plan(plans[r], n_v1, lanes1, n_nodes, 2 * (n_edges[r] + 1))
        if plan is None:
            out.append(None)
            continue
        perm, b_src, b_dst = _compact_edges(src[r], dst[r], s1.active[r], n_nodes,
                                            plan.bucket_v, plan.bucket_e, kernel)
        better1, best_d1 = _best_after_pass0(n_v1, n_e1, rho0)
        out.append(PrunedDispatch(
            b_src=b_src, b_dst=b_dst, n_v1=n_v1, n_e1=n_e1, best_d1=best_d1,
            eps=float(eps), plan=plan, perm=perm, a1=s1.active[r], active0=s0.active[r],
            better1=better1, observed=(n_v1, lanes1)))
    return out


def plan_for_graph(
    graph: Graph, prev_mask: np.ndarray | None = None,
    observed: tuple[int, int] | None = None,
    kernel: bool = False,
    device: torch.device | str | None = None,
) -> PrunePlan:
    """Analyze a static graph on ``device``: rho~ bootstrap + candidate core
    + buckets. ``kernel`` routes the analysis' degrees through K1 and its
    core fixpoint through K2 (fed the cached dst-sorted lanes); the plan
    integers are identical."""
    device = resolve_device(device)
    n = graph.n_nodes
    if n == 0 or graph.n_edges == 0:
        return build_plan(0.0, 1, 0, 0, max(n, 1), max(graph.src.shape[0], 1))
    pm = (torch.zeros(n, dtype=torch.bool, device=device) if prev_mask is None
          else torch.from_numpy(np.asarray(prev_mask, dtype=bool)).to(device))
    src, dst = to_device(graph, device, sorted=kernel)
    rho_lb, k, _, n_cand, ne_cand = _plan(src, dst, pm, graph.n_edges, n, kernel)
    return build_plan(
        rho_lb.item(), int(k), n_cand.item(), ne_cand.item(),
        node_width=n, lane_width=graph.src.shape[0], observed=observed,
        n_vertices=n,
    )


def slot_arrays(graph: Graph) -> tuple[np.ndarray, np.ndarray]:
    """The graph's undirected slots (one entry per edge) as int64, plus one
    sentinel pad slot so empty graphs stay valid."""
    half = graph.n_directed // 2
    pad = np.asarray([graph.n_nodes], np.int64)
    return (np.concatenate([graph.src[:half].astype(np.int64), pad]),
            np.concatenate([graph.dst[:half].astype(np.int64), pad]))


def pbahmani_pruned(
    graph: Graph, eps: float = 0.0, plan: PrunePlan | None = None,
    kernel: bool | None = None, device: torch.device | str | None = None,
) -> tuple[float, np.ndarray, int]:
    """Candidate-pruned P-Bahmani: bit-identical to ``pbahmani(graph, eps)``
    (density, mask and pass count) at bucket-width device cost. ``device``
    and ``kernel`` resolve as in ``pbahmani``; the triple is the same with
    the kernels on or off. The query runs resident on ``device``
    (:func:`pruned_peel_resident` over the graph's cached dst-sorted lanes).
    Falls back to the unpruned peel when the pass-0 survivors fit no bucket
    smaller than the graph."""
    device = resolve_device(device)
    kernel = resolve_kernel(kernel, device)
    if plan is None:
        plan = plan_for_graph(graph, kernel=kernel, device=device)
    if not plan.enabled or graph.n_nodes == 0:
        return pbahmani(graph, eps=eps, kernel=kernel, device=device)
    src, dst = to_device(graph, device, sorted=True)
    res = pruned_peel_resident(src, dst, graph.n_nodes, graph.n_edges, float(eps), plan,
                               kernel)
    if res is None:
        return pbahmani(graph, eps=eps, kernel=kernel, device=device)
    density, mask, passes, _, _ = res
    return float(density), mask, passes


__all__ = [
    "PrunePlan",
    "PrunedDispatch",
    "prepare_pruned_peel",
    "merge_pruned_peel",
    "prepare_pruned_peel_resident",
    "merge_pruned_peel_resident",
    "pruned_peel_resident",
    "prepare_pruned_peel_rows",
    "upload_buckets",
    "build_plan",
    "maybe_shrink_plan",
    "plan_for_graph",
    "make_sharded_plan",
    "compact_candidates",
    "pruned_peel_host",
    "pbahmani_pruned",
    "slot_arrays",
    "MIN_BUCKET_V",
    "MIN_BUCKET_E",
    "BUCKET_SHRINK_HYSTERESIS",
]
