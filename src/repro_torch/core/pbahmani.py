"""P-Bahmani: parallel (2+2eps)-approximate densest subgraph (paper Alg. 1).

Device formulation: the paper's two "parts" per pass map to

  part 1 (parallel fail-scan)   -> masked vector compare over all vertices
  part 2 (atomic degree update) -> one pass over the edge lanes: the fused
                                   edge stage (core/dispatch.py:peel_edges)
  barrier                       -> the data dependence between passes

State is fixed-shape (degree array + masks + 0-d tensors). The loop over
passes runs on the host and reads ``n_v`` once per pass: one device sync a
pass, O(log_{1+eps} n) in all. ``pbahmani_pass`` is one pass.

Under ``obs.trace.capture()`` a call records a ``pbahmani`` span (label
``eps``) over ``peel_setup`` (the lanes and the initial state), one
``peel_pass`` a pass (its enqueue) and a ``host_sync`` span at each wait
(core/syncs.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.density import degrees_from_coo, peel_threshold
from repro_torch.core.dispatch import (
    assert_exact_envelope, peel_edges, resolve_device, resolve_kernel,
)
from repro_torch.core.syncs import host_read, host_sync, scalar
from repro_torch.graphs.convert import to_device
from repro_torch.graphs.graph import Graph
from repro_torch.obs.trace import detail


class PeelState(NamedTuple):
    """Carry of the peeling loop. All tensors fixed-shape.

    deg:      int32 [V]   current degree of live vertices (0 for removed)
    active:   bool  [V]   live mask (the paper's ``active`` set)
    n_v, n_e: int32 []    live vertex / undirected edge counts
    best_density: f32 []  max density over all intermediate subgraphs
    best_mask: bool [V]   vertex set achieving best_density
    passes:   int32 []    pass counter (paper: O(log_{1+eps} n))
    """

    deg: torch.Tensor
    active: torch.Tensor
    n_v: torch.Tensor
    n_e: torch.Tensor
    best_density: torch.Tensor
    best_mask: torch.Tensor
    passes: torch.Tensor


def state_from_degrees(deg: torch.Tensor, n_edges: int) -> PeelState:
    """The peel's initial state from int32 degrees ``[V]``: isolated
    vertices never contribute to density."""
    active = deg > 0
    n_v = active.sum(dtype=torch.int32)
    n_e = scalar(n_edges, torch.int32, deg.device)
    rho0 = n_e.to(torch.float32) / n_v.clamp(min=1).to(torch.float32)
    return PeelState(
        deg=deg,
        active=active,
        n_v=n_v,
        n_e=n_e,
        best_density=rho0,
        best_mask=active,
        passes=scalar(0, torch.int32, deg.device),
    )


def init_state(src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
               n_edges: int) -> PeelState:
    del dst
    return state_from_degrees(degrees_from_coo(src, n_nodes), n_edges)


def pbahmani_pass(
    state: PeelState, src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
    eps: float, kernel: bool = False, mesh=None,
) -> PeelState:
    """One peeling pass: fail every live vertex with deg <= 2(1+eps)·rho.

    Edge-centric (load-balanced by construction — every edge does O(1)
    work). ``kernel`` selects the fused edge-stage kernel K2 for part 2
    (core/dispatch.py); results are bit-identical either way. With ``mesh``
    the lanes are this rank's block and the pass makes one all-reduce.
    """
    thr = peel_threshold(state.n_e, state.n_v, eps)
    failed = state.active & (state.deg.to(torch.float32) <= thr)

    # paper part 2: atomicSub on neighbor degrees -> one deterministic
    # reduction onto dst, and the count of dying directed lanes
    delta_to_dst, removed_directed = peel_edges(src, dst, state.active, failed,
                                                n_nodes, kernel, mesh=mesh)
    n_e_new = state.n_e - removed_directed // 2

    active_new = state.active & ~failed
    deg_new = torch.where(active_new, state.deg - delta_to_dst, 0)
    n_v_new = state.n_v - failed.sum(dtype=torch.int32)

    rho_new = n_e_new.to(torch.float32) / n_v_new.clamp(min=1).to(torch.float32)
    rho_new = torch.where(n_v_new > 0, rho_new, 0.0)
    better = rho_new > state.best_density
    best_density = torch.where(better, rho_new, state.best_density)
    best_mask = torch.where(better, active_new, state.best_mask)

    return PeelState(
        deg=deg_new,
        active=active_new,
        n_v=n_v_new,
        n_e=n_e_new,
        best_density=best_density,
        best_mask=best_mask,
        passes=state.passes + 1,
    )


def pbahmani(
    graph: Graph, eps: float = 0.0, pruned: bool = False,
    refine_rounds: int = 0, kernel: bool | None = None,
    device: torch.device | str | None = None,
) -> tuple[float, np.ndarray, int]:
    """Run P-Bahmani. Returns (best_density, best_mask, passes).

    Guarantee (Bahmani et al. 2012): best_density >= rho*(G) / (2 + 2·eps).

    ``device=None`` means the GPU, and raises where there is none.
    ``kernel=None`` means the fused edge-stage kernel K2 on a CUDA device
    and the scatter tier elsewhere; ``True`` forces K2 (its plain version on
    the CPU). With K2 the edge lanes come from ``graph.dst_sorted()``,
    uploaded once, and the triple is bit-identical to the scatter path.

    ``pruned=True`` runs the candidate-pruned peel (core/prune.py, with K3
    and K4 in its compaction ladder when ``kernel`` is on): the same triple.
    ``refine_rounds > 0`` feeds the peel result through that many
    weighted-peel refinement rounds (refine/): the density is never below
    the peel's, and ``passes`` then counts the seed peel's passes plus every
    round's. ``refine.refine`` gives the certificate and the ``target_gap``
    loop.
    """
    with detail("pbahmani", eps=eps):
        device = resolve_device(device)
        if graph.n_nodes == 0:
            return 0.0, np.zeros(0, dtype=bool), 0
        kernel = resolve_kernel(kernel, device)
        if kernel:
            assert_exact_envelope(graph.src.shape[0], graph.n_nodes)
        if pruned:
            from repro_torch.core.prune import pbahmani_pruned

            out = pbahmani_pruned(graph, eps=eps, kernel=kernel, device=device)
        else:
            with detail("peel_setup"):
                src, dst = to_device(graph, device, sorted=kernel)
                state = init_state(src, dst, graph.n_nodes, graph.n_edges)
            while True:
                with host_sync("pass_test"):
                    # repro: allow RPR101 -- the one host sync of each pass
                    live = state.n_v.item() > 0
                if not live:
                    break
                with detail("peel_pass"):
                    state = pbahmani_pass(state, src, dst, graph.n_nodes, float(eps), kernel)
            out = (host_read(state.best_density), host_read(state.best_mask),
                   host_read(state.passes))
        if refine_rounds > 0:
            from repro_torch.refine.engine import refine

            # negative target: run exactly refine_rounds rounds (deterministic)
            res = refine(graph, target_gap=-1.0, max_rounds=int(refine_rounds),
                         eps=eps, seed=out, kernel=kernel, device=device)
            return res.density, res.mask, res.passes
        return out


# ---------------------------------------------------------------------------
# NumPy reference (bit-for-bit oracle for tests; also the fast host path)
# ---------------------------------------------------------------------------
def pbahmani_np(graph: Graph, eps: float = 0.0) -> tuple[float, np.ndarray, int]:
    n = graph.n_nodes
    s = graph.src[: graph.n_directed].astype(np.int64)
    d = graph.dst[: graph.n_directed].astype(np.int64)
    deg = np.bincount(s, minlength=n).astype(np.int64)
    active = deg > 0
    n_v = int(active.sum())
    n_e = graph.n_edges
    best = n_e / max(n_v, 1)
    best_mask = active.copy()
    passes = 0
    while n_v > 0:
        rho = n_e / n_v
        thr = 2.0 * (1.0 + eps) * rho
        failed = active & (deg <= thr)
        live = active[s] & active[d]
        fs = failed[s] & live
        fd = failed[d] & live
        n_e -= int((fs | fd).sum()) // 2
        delta = np.bincount(d[fs], minlength=n)
        active &= ~failed
        deg = np.where(active, deg - delta, 0)
        n_v -= int(failed.sum())
        passes += 1
        if n_v > 0:
            rho_new = n_e / n_v
            if rho_new > best:
                best = rho_new
                best_mask = active.copy()
    return float(best), best_mask, passes


__all__ = ["PeelState", "init_state", "state_from_degrees", "pbahmani_pass", "pbahmani",
           "pbahmani_np"]
