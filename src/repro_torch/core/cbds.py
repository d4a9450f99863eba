"""CBDS-P: Core-Based Dense Subgraph, parallel (paper Algorithm 2).

Phase 1: k-core decomposition with per-level density tracking (kcore.py)
         -> densest core S* = {v : coreness >= k*}, a 2-approximation.
Phase 2: batch-augment S* with "legitimate" outside vertices. A vertex v with
         e(v -> S~) > rho(S~) strictly increases the density when added
         (paper §3.2: delta rho = (n·e~ − e)/(n(n+1)) > 0). The paper selects,
         in parallel, all v with e(v -> S*) > max_density, then adds the edges
         among the selected set itself (the pairwise loop, lines 76-87), and
         reports the improved density — guaranteed >= rho(S*), hence strictly
         better than the plain 2-approximation whenever any vertex qualifies.

Device adaptation: the paper's per-thread ``eligible_vector``/``legit_vector``
+ critical sections become two reductions over the edge lanes:
  e_into_S[v]   = sum over edges (v,u) of S_mask[u]        (one scatter-add)
  cross(L)      = sum over edges of L[src] & L[dst] / 2    (one masked sum)
The first is reduced onto *dst* by the mirror identity the peel uses (the
lanes are symmetric, so lane (u -> v) carries lane (v -> u)'s test), through
``peel_delta``: the sorted segment-sum K1 with the kernel on. Phase 1 runs on
the fused edge-stage kernel K2.
Self-edges are absent by the simple-graph convention; the paper's 0.5
self-edge counting is therefore a no-op here.

Beyond-paper extension: ``rounds > 1`` iterates phase 2 — after absorbing the
legit set, recompute e(v -> S~) against the enlarged S~ and absorb again.
Each round is monotone non-decreasing in density, so the result remains a
valid (and usually strictly better) lower bound for rho*. The paper runs one
round; rounds=1 is the faithful setting and the default.

Under ``obs.trace.capture()`` a call records a ``cbds_p`` span (label
``rounds``) over the k-core's ``kcore_level`` spans (core/kcore.py), one
``cbds_augment`` span a round and a ``host_sync`` span at each wait
(core/syncs.py).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import collective
from repro_torch.core.dispatch import peel_delta, resolve_device, resolve_kernel
from repro_torch.core.kcore import _kcore, kcore_np
from repro_torch.core.syncs import host_read, scalar
from repro_torch.graphs.convert import to_device
from repro_torch.graphs.graph import Graph
from repro_torch.obs.trace import detail


def _augment_once(
    member: torch.Tensor,
    m_v: torch.Tensor,
    m_e: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    n_nodes: int,
    kernel: bool = False,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One phase-2 round. Returns (member', m_v', m_e', n_added). ``kernel``
    sums ``e_into`` with K1 over dst-sorted lanes (the same integers). With
    ``mesh`` the lanes are this rank's: ``e_into`` and the legit pairs are
    summed over the mesh, two all-reduces.

    The legitimacy test ``e_into > rho`` is evaluated in exact integer
    arithmetic: for integer e_into, ``e_into > m_e / m_v`` iff
    ``e_into > m_e // m_v``. A float32 rho could round across an integer
    boundary once m_v grows past ~2^23 and absorb (or reject) boundary
    vertices differently from the float64 NumPy reference.
    """
    src_c = src.clamp(max=n_nodes - 1)
    dst_c = dst.clamp(max=n_nodes - 1)
    valid = (src < n_nodes) & (dst < n_nodes)

    # e_into_S[v]: edges from v into the current member set (paper's `legits`);
    # lane (u -> v) tests its mirror (v -> u): u a member, v not
    into_mirror = (valid & member.index_select(0, src_c)
                   & ~member.index_select(0, dst_c))
    # repro: allow RPR304 -- e_into is an int sum in both packages: no f32 envelope
    e_into = peel_delta(into_mirror, dst, n_nodes, kernel, mesh)

    legit = ~member & (e_into > m_e // m_v.clamp(min=1))
    n_added = legit.sum(dtype=torch.int32)

    # intermediate_edges = edges(legit -> S) + edges within the legit set
    inter_into = torch.where(legit, e_into, 0).sum(dtype=torch.int32)
    legit_pair = (valid & legit.index_select(0, src_c)
                  & legit.index_select(0, dst_c))
    inter_cross = collective.all_reduce_sum(legit_pair.sum(dtype=torch.int32), mesh) // 2

    member_new = member | legit
    m_e_new = m_e + inter_into + inter_cross
    m_v_new = m_v + n_added
    return member_new, m_v_new, m_e_new, n_added


def _cbds(src, dst, n_nodes: int, n_edges: int, rounds: int, kernel: bool, mesh=None):
    """Phases 1 and 2: (core state, member mask, density, n_legit)."""
    core = _kcore(src, dst, n_nodes, n_edges, kernel, mesh)
    member = core.coreness >= core.best_k
    m_v, m_e = core.best_n_v, core.best_n_e

    n_legit = scalar(0, torch.int32, src.device)
    for _ in range(int(rounds)):
        with detail("cbds_augment"):
            member, m_v, m_e, n_added = _augment_once(member, m_v, m_e, src, dst, n_nodes,
                                                      kernel, mesh)
            n_legit = n_legit + n_added

    density = m_e.to(torch.float32) / m_v.clamp(min=1).to(torch.float32)
    return core, member, torch.maximum(density, core.best_density), n_legit


def cbds_resident(
    src: torch.Tensor, dst: torch.Tensor, n_nodes: int, n_edges: int,
    rounds: int = 1, kernel: bool = False, mesh=None,
) -> dict:
    """CBDS-P over COO lanes already on the device (dst-sorted with
    ``kernel``): the body of :func:`cbds_p`, and what a resident caller such
    as ``stream.DeltaEngine.cbds`` runs on its own lanes (with ``mesh``,
    this rank's block of a sharded engine's)."""
    core, member, density, n_legit = _cbds(src, dst, n_nodes, n_edges, rounds, kernel, mesh)
    return {
        "density": host_read(density),
        "core_density": host_read(core.best_density),
        "k_star": host_read(core.best_k),
        "member_mask": host_read(member),
        "n_legit": host_read(n_legit),
    }


def cbds_p(
    graph: Graph, rounds: int = 1, kernel: bool | None = None,
    device: torch.device | str | None = None,
) -> dict:
    """Run CBDS-P. rounds=1 is the paper-faithful configuration.

    ``device`` and ``kernel`` resolve as in ``pbahmani``; ``kernel`` selects
    K2 for the k-core phase and K1 for each augmentation round (on dst-sorted
    lanes) and changes no result.
    """
    with detail("cbds_p", rounds=rounds):
        device = resolve_device(device)
        kernel = resolve_kernel(kernel, device)
        src, dst = to_device(graph, device, sorted=kernel)
        return cbds_resident(src, dst, graph.n_nodes, graph.n_edges, rounds, kernel)


# ---------------------------------------------------------------------------
# NumPy reference
# ---------------------------------------------------------------------------
def cbds_np(graph: Graph, rounds: int = 1) -> dict:
    coreness, core_density, k_star, m_v, m_e = kcore_np(graph)
    n = graph.n_nodes
    s = graph.src[: graph.n_directed].astype(np.int64)
    d = graph.dst[: graph.n_directed].astype(np.int64)
    member = coreness >= k_star
    n_legit = 0
    for _ in range(rounds):
        # exact integer form of e_into > m_e/m_v (see _augment_once)
        into = member[d] & ~member[s]
        e_into = np.bincount(s[into], minlength=n)
        legit = ~member & (e_into > m_e // max(m_v, 1))
        if not legit.any():
            break
        inter = int(e_into[legit].sum()) + int((legit[s] & legit[d]).sum()) // 2
        m_e += inter
        m_v += int(legit.sum())
        member |= legit
        n_legit += int(legit.sum())
    density = max(m_e / max(m_v, 1), core_density)
    return {
        "density": float(density),
        "core_density": float(core_density),
        "k_star": int(k_star),
        "member_mask": member,
        "n_legit": n_legit,
    }


__all__ = ["cbds_p", "cbds_resident", "cbds_np"]
