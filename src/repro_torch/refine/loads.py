"""Edge-load state for iterated weighted peeling (Greedy++ / Frank-Wolfe).

The eps-approximate peel (core/pbahmani.py) stops at a 2(1+eps) guarantee.
One *refinement round* is a full peel of the graph with the key

    key(v) = load(v) + deg(v)

instead of deg(v): the iterated greedy of Greedy++ (Boob et al.), whose
threshold-batched parallel form converges to near-exact density, read as
Frank-Wolfe on the load-balancing LP: each round charges every live edge to
exactly one endpoint, and ``loads / T`` after T rounds is a feasible LP point.

Load accounting: when a batch F of vertices fails in one pass, every live
edge with an endpoint in F dies and is charged to exactly one endpoint, the
one in F, or the smaller vertex id when both are (ascending-id sequential
removal). So after T rounds ``sum(loads) == T * |E|`` and
``max_v loads(v) / T >= rho*(G)``: the dual side of the certificate
(refine/certify.py).

All state is int32 (loads are counts), so a round is exact integer
arithmetic. Threshold: ``(1+eps) * (sum_live loads + 2|E_live|) / |V_live|``,
Bahmani's ``2(1+eps)rho`` at zero loads; the ``key <= min_key`` guard makes
termination robust to float32 rounding of large load sums.

This is the JAX package's ``refine/loads.py``: the pass, the round and its
host loop, and the fused buckets' rounds: the row-batched COO
round (``_batched_refine_round``, one launch of K2's rows entry a pass for
the group) and the dense round over ``[G, V, V]`` float32 adjacency
(``_batched_dense_refine_round``, batched products a pass). Every COO pass
and round takes ``mesh``: the lanes are then this rank's block, and a pass's
``delta``, ``removed`` and ``inc`` are summed over the mesh by one all-reduce
(the JAX package's ``_sharded_refine_pass`` makes three psums).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.batched import require_exact_matmul, run_rows
from repro_torch.core.dispatch import peel_edges, peel_edges_rows


class RefinePeelState(NamedTuple):
    """Carry of one weighted-peel round. All tensors fixed-shape.

    deg:      int32 [V]  live degree (0 once removed)
    loads:    int32 [V]  accumulated edge loads (across rounds + this round)
    active:   bool  [V]  live mask
    n_v, n_e: int32 []   live vertex / undirected edge counts
    load_sum: int32 []   sum of loads over live vertices
    best_density: f32 [] best density seen (the exact fraction is
                         best_ne/best_nv)
    best_ne, best_nv: int32 []  integer counts of the best subgraph, the
                         primal side of the exact-rational certificate
    best_mask: bool [V]  vertex set achieving the best density
    passes:   int32 []   cumulative pass counter (across rounds)
    """

    deg: torch.Tensor
    loads: torch.Tensor
    active: torch.Tensor
    n_v: torch.Tensor
    n_e: torch.Tensor
    load_sum: torch.Tensor
    best_density: torch.Tensor
    best_ne: torch.Tensor
    best_nv: torch.Tensor
    best_mask: torch.Tensor
    passes: torch.Tensor


def refine_threshold(load_sum: torch.Tensor, n_e: torch.Tensor, n_v: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """(1+eps) * average key over live vertices, float32. The constant is
    rounded to float32 before the one float32 multiply, as the JAX package
    and ``certify.refine_round_np`` do."""
    avg = (load_sum + 2 * n_e).to(torch.float32) / n_v.clamp(min=1).to(torch.float32)
    return avg * float(np.float32(1.0 + eps))


def _fold_best(state: RefinePeelState, n_e_new, n_v_new, active_new):
    """Strict-> best tracking off the new live set (f32 compare, exact ints
    carried alongside for the certificate)."""
    rho_new = n_e_new.to(torch.float32) / n_v_new.clamp(min=1).to(torch.float32)
    rho_new = torch.where(n_v_new > 0, rho_new, 0.0)
    better = rho_new > state.best_density
    return (
        torch.where(better, rho_new, state.best_density),
        torch.where(better, n_e_new, state.best_ne),
        torch.where(better, n_v_new, state.best_nv),
        torch.where(better, active_new, state.best_mask),
    )


def refine_pass(
    state: RefinePeelState, src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
    eps: float, kernel: bool = False, mesh=None,
) -> RefinePeelState:
    """One weighted peeling pass over the symmetric COO lanes: fail every
    live vertex with load+deg <= threshold (or at the live minimum), charge
    each dying edge to exactly one failing endpoint (the smaller id wins a
    tie), and decrement survivor degrees: ``pbahmani_pass`` plus loads.
    ``kernel`` routes the edge stage, both reductions and the charges,
    through the fused kernel K2 (dst-sorted lanes); the trajectory is
    bit-identical either way."""
    key = (state.loads + state.deg).to(torch.float32)
    thr = refine_threshold(state.load_sum, state.n_e, state.n_v, eps)
    min_key = torch.where(state.active, key, torch.inf).min()
    failed = state.active & ((key <= thr) | (key <= min_key))

    # survivor degree decrement as in pbahmani_pass, and each dying edge
    # charged to one failing endpoint (core/dispatch.py:peel_edges)
    # repro: allow RPR304 -- pass body; its host callers assert the envelope
    delta_to_dst, removed_directed, inc = peel_edges(
        src, dst, state.active, failed, n_nodes, kernel, charge=True, mesh=mesh)
    n_e_new = state.n_e - removed_directed // 2
    active_new = state.active & ~failed
    deg_new = torch.where(active_new, state.deg - delta_to_dst, 0)
    n_v_new = state.n_v - failed.sum(dtype=torch.int32)
    loads_new = state.loads + inc
    load_sum_new = state.load_sum - torch.where(failed, state.loads, 0).sum(
        dtype=torch.int32)

    best_density, best_ne, best_nv, best_mask = _fold_best(
        state, n_e_new, n_v_new, active_new)
    return RefinePeelState(
        deg=deg_new, loads=loads_new, active=active_new, n_v=n_v_new,
        n_e=n_e_new, load_sum=load_sum_new, best_density=best_density,
        best_ne=best_ne, best_nv=best_nv, best_mask=best_mask,
        passes=state.passes + 1,
    )


def refine_round_body(
    src, dst, deg, n_edges, loads, best_density, best_ne, best_nv,
    best_mask, passes, n_nodes: int, eps: float, kernel: bool = False, mesh=None,
):
    """One full refinement round from the degree array. Returns (loads,
    best_density, best_ne, best_nv, best_mask, passes); the host turns
    ``loads`` into the top-k dual bound (certify.dual_fraction). The loop
    over passes runs on the host, one sync a pass."""
    active = deg > 0
    state = RefinePeelState(
        deg=deg,
        loads=loads,
        active=active,
        n_v=active.sum(dtype=torch.int32),
        n_e=n_edges,
        load_sum=torch.where(active, loads, 0).sum(dtype=torch.int32),
        best_density=best_density,
        best_ne=best_ne,
        best_nv=best_nv,
        best_mask=best_mask,
        passes=passes,
    )
    while state.n_v.item() > 0:  # repro: allow RPR101 -- the one host sync of each pass
        state = refine_pass(state, src, dst, n_nodes, eps, kernel, mesh)
    return (state.loads, state.best_density, state.best_ne, state.best_nv,
            state.best_mask, state.passes)


def _refine_round(src, dst, deg, n_edges, loads, best_density, best_ne,
                  best_nv, best_mask, passes, n_nodes: int, eps: float,
                  kernel: bool = False, mesh=None):
    """One round on int32/float32/bool tensors of one device; the JAX
    package's ``_refine_round_jit`` (with ``mesh``, its
    ``_make_sharded_refine_round``)."""
    i32 = torch.int32
    return refine_round_body(
        src, dst, deg.to(i32), n_edges.to(i32), loads.to(i32),
        best_density.to(torch.float32), best_ne.to(i32), best_nv.to(i32),
        best_mask, passes.to(i32), n_nodes, eps, kernel, mesh)


# ---------------------------------------------------------------------------
# row-batched rounds: a bucket of fused tenants refined together
# ---------------------------------------------------------------------------
def _fold_best_rows(state: RefinePeelState, n_e_new, n_v_new, active_new):
    rho_new = n_e_new.to(torch.float32) / n_v_new.clamp(min=1).to(torch.float32)
    rho_new = torch.where(n_v_new > 0, rho_new, 0.0)
    better = rho_new > state.best_density
    return (
        torch.where(better, rho_new, state.best_density),
        torch.where(better, n_e_new, state.best_ne),
        torch.where(better, n_v_new, state.best_nv),
        torch.where(better[:, None], active_new, state.best_mask),
    )


def _failing_rows(state: RefinePeelState, eps: float) -> torch.Tensor:
    """Each row's failing set: key <= its threshold, or at its live minimum."""
    key = (state.loads + state.deg).to(torch.float32)
    thr = refine_threshold(state.load_sum, state.n_e, state.n_v, eps)
    min_key = torch.where(state.active, key, torch.inf).min(dim=1).values
    return state.active & ((key <= thr[:, None]) | (key <= min_key[:, None]))


def _advance_rows(state, failed, delta, removed, inc) -> RefinePeelState:
    n_e_new = state.n_e - removed // 2
    active_new = state.active & ~failed
    n_v_new = state.n_v - failed.sum(dim=1, dtype=torch.int32)
    best_density, best_ne, best_nv, best_mask = _fold_best_rows(
        state, n_e_new, n_v_new, active_new)
    return RefinePeelState(
        deg=torch.where(active_new, state.deg - delta, 0), loads=state.loads + inc,
        active=active_new, n_v=n_v_new, n_e=n_e_new,
        load_sum=state.load_sum - torch.where(failed, state.loads, 0).sum(
            dim=1, dtype=torch.int32),
        best_density=best_density, best_ne=best_ne, best_nv=best_nv,
        best_mask=best_mask, passes=state.passes + 1)


def refine_pass_rows(
    state: RefinePeelState, src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
    eps: float, kernel: bool = False, mesh=None,
) -> RefinePeelState:
    """``refine_pass`` of every row of a row-batched state (lanes [G, L],
    vertex tensors [G, V], scalars [G]): each row's threshold, min key and
    load sum its own; the edge stage and the charges one call of
    ``dispatch.peel_edges_rows`` (one launch of K2's rows entry with
    ``kernel``)."""
    failed = _failing_rows(state, eps)
    # repro: allow RPR304 -- batched pass body; its callers assert the envelope
    delta, removed, inc = peel_edges_rows(src, dst, state.active, failed, n_nodes, kernel,
                                          charge=True, mesh=mesh)
    return _advance_rows(state, failed, delta, removed, inc)


def _init_rows(deg, n_edges, loads, best_density, best_ne, best_nv, best_mask, passes):
    i32 = torch.int32
    active = deg > 0
    return RefinePeelState(
        deg=deg.to(i32), loads=loads.to(i32), active=active,
        n_v=active.sum(dim=1, dtype=i32), n_e=n_edges.to(i32),
        load_sum=torch.where(active, loads, 0).sum(dim=1, dtype=i32),
        best_density=best_density.to(torch.float32), best_ne=best_ne.to(i32),
        best_nv=best_nv.to(i32), best_mask=best_mask, passes=passes.to(i32))


def _out(final: RefinePeelState):
    return (final.loads, final.best_density, final.best_ne, final.best_nv,
            final.best_mask, final.passes)


def _batched_refine_round(src, dst, deg, n_edges, loads, best_density, best_ne,
                          best_nv, best_mask, passes, n_nodes: int, eps: float,
                          kernel: bool = False, mesh=None):
    """One refinement round of G tenants at once (the JAX package's vmapped
    ``_batched_refine_round_jit``; with ``mesh`` its
    ``_make_sharded_batched_refine_round``, one ``[G, 2V + 1]`` all-reduce a
    batched pass): every argument carries a leading row axis. The batched
    pass runs while any row is live, a converged row kept as it was, so each
    row's outputs equal ``_refine_round`` on that row."""
    state = _init_rows(deg, n_edges, loads, best_density, best_ne, best_nv, best_mask,
                       passes)
    return _out(run_rows(state, lambda s: refine_pass_rows(s, src, dst, n_nodes, eps,
                                                           kernel, mesh)))


# ---------------------------------------------------------------------------
# dense (GEMV) variant: the fused small-tenant buckets
# ---------------------------------------------------------------------------
def _dense_refine_pass(state: RefinePeelState, adj: torch.Tensor, adj_tri: torch.Tensor,
                       eps: float) -> RefinePeelState:
    """``refine_pass_rows`` off the dense adjacency ``[G, V, V]`` float32 kept
    by the fused buckets under ``DENSE_NODE_CAP``: ``adj @ failed`` counts
    each vertex's failing neighbours, ``adj_tri @ failed`` (``adj`` masked to
    column > row) the failing neighbours whose tie it wins, so a failing
    vertex is charged its edges to survivors plus those ties. Every float32
    sum is over integers below 2^24, hence exact: the trajectory equals the
    lane pass's."""
    failed = _failing_rows(state, eps)
    f = failed.to(torch.float32)[:, :, None]
    af = torch.bmm(adj, f)[:, :, 0]
    aa = torch.bmm(adj, state.active.to(torch.float32)[:, :, None])[:, :, 0]
    ff = f[:, :, 0]
    removed = (2.0 * (ff * aa).sum(dim=1) - (ff * af).sum(dim=1)).to(torch.int32)
    af_i = af.to(torch.int32)
    tie_wins = torch.bmm(adj_tri, f)[:, :, 0].to(torch.int32)
    inc = torch.where(failed, state.deg - af_i + tie_wins, 0)
    return _advance_rows(state, failed, af_i, removed, inc)


def _upper(adj: torch.Tensor) -> torch.Tensor:
    n = adj.shape[-1]
    idx = torch.arange(n, device=adj.device)
    return adj * (idx[:, None] < idx[None, :]).to(torch.float32)


def dense_refine_round_body(adj, deg, n_edges, loads, best_density, best_ne, best_nv,
                            best_mask, passes, eps: float):
    """One refinement round off one tenant's dense adjacency ``[V, V]``: the
    JAX package's ``dense_refine_round_body``, as a group of one."""
    out = _batched_dense_refine_round(
        adj[None], deg[None], n_edges.reshape(1), loads[None], best_density.reshape(1),
        best_ne.reshape(1), best_nv.reshape(1), best_mask[None], passes.reshape(1), eps)
    return tuple(x[0] for x in out)


def _batched_dense_refine_round(adj, deg, n_edges, loads, best_density, best_ne,
                                best_nv, best_mask, passes, eps: float):
    """One refinement round of G dense tenants (``[G, V, V]`` adjacency) at
    once: batched float32 products a pass, converged rows frozen. Needs
    ``torch.get_float32_matmul_precision() == "highest"``."""
    require_exact_matmul()
    adj_tri = _upper(adj)  # adj is constant over the round
    state = _init_rows(deg, n_edges, loads, best_density, best_ne, best_nv, best_mask,
                       passes)
    return _out(run_rows(state, lambda s: _dense_refine_pass(s, adj, adj_tri, eps)))


__all__ = [
    "RefinePeelState",
    "refine_threshold",
    "refine_pass",
    "refine_round_body",
    "_refine_round",
    "refine_pass_rows",
    "_batched_refine_round",
    "dense_refine_round_body",
    "_batched_dense_refine_round",
]
