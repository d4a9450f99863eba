"""k-core decomposition (CBDS-P phase 1), adapted from PKC (Kabir & Madduri).

PKC processes levels k = 0, 1, 2, ... with per-thread work queues (``buff``)
and atomic degree decrements. The device version replaces the queues with a
*level-synchronous fixpoint*: at level k, repeatedly fail every live vertex
with deg <= k and subtract its edge contributions via one pass over the
edge lanes (core/dispatch.py:peel_edges), until no vertex fails; then
k += 1. k-core decomposition is confluent, so this computes identical
coreness values.

Following the paper's modification of PKC, the sweep also records, for every
k, the density of the (k+1)-core that remains once level k completes — the
argmax over k is the densest core (phase 2's starting point; a 2-approximation
to the densest subgraph by Tatti 2019 + monotonicity).

Both loops run on the host: the outer one reads ``n_v`` once per level, the
inner one reads ``any(active & (deg <= k))`` once per fixpoint iteration.
Under ``obs.trace.capture()`` each level records a ``kcore_level`` span
(attribute ``k``) holding one ``kcore_iter`` span a fixpoint iteration (its
peel's enqueue), and each read a ``host_sync`` span (core/syncs.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.density import degrees_from_coo
from repro_torch.core.dispatch import (
    assert_exact_envelope, lane_degrees, peel_edges, resolve_device, resolve_kernel,
)
from repro_torch.core.syncs import host_sync, scalar
from repro_torch.graphs.convert import to_device
from repro_torch.graphs.graph import Graph
from repro_torch.obs.trace import detail


class CoreState(NamedTuple):
    k: int                     # current level (the host loop owns it)
    deg: torch.Tensor          # int32 [V]
    active: torch.Tensor       # bool  [V]
    coreness: torch.Tensor     # int32 [V]
    n_v: torch.Tensor          # int32 [] live vertices
    n_e: torch.Tensor          # int32 [] live undirected edges
    best_density: torch.Tensor  # f32  [] densest core seen
    best_k: torch.Tensor       # int32 [] its core index k*
    best_n_v: torch.Tensor     # int32 [] |S*| (m_v in the paper)
    best_n_e: torch.Tensor     # int32 [] |E(S*)| (m_e in the paper)


def _level_fixpoint(
    state: CoreState, src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
    kernel: bool = False, mesh=None,
) -> CoreState:
    """Remove all vertices of degree <= k until none remain (inner loop).
    ``kernel`` routes the edge stage through the fused kernel K2
    (core/dispatch.py) — bit-identical coreness either way. With ``mesh``
    the lanes are this rank's and each iteration makes one all-reduce; the
    loop's test reads replicated state, so every rank iterates alike."""
    s = state
    while True:
        failed = s.active & (s.deg <= s.k)
        with host_sync("fixpoint_test"):
            # repro: allow RPR101 -- the one host sync of each iteration
            done = not failed.any().item()
        if done:
            return s
        with detail("kcore_iter"):
            delta_to_dst, removed_directed = peel_edges(src, dst, s.active, failed,
                                                        n_nodes, kernel, mesh=mesh)
            active_new = s.active & ~failed
            s = s._replace(
                deg=torch.where(active_new, s.deg - delta_to_dst, 0),
                active=active_new,
                coreness=torch.where(failed, s.k, s.coreness),
                n_v=s.n_v - failed.sum(dtype=torch.int32),
                n_e=s.n_e - removed_directed // 2,
            )


def _kcore(
    src: torch.Tensor, dst: torch.Tensor, n_nodes: int, n_edges: int,
    kernel: bool = False, mesh=None,
) -> CoreState:
    """k-core decomposition with per-level density tracking. With ``mesh``
    the lanes are this rank's block: the degrees are ``lane_degrees`` summed
    over the mesh (K1 with ``kernel``), each fixpoint iteration one
    all-reduce."""
    dev = src.device
    zero = scalar(0, torch.int32, dev)
    s = CoreState(
        k=0,
        deg=(degrees_from_coo(src, n_nodes) if mesh is None
             else lane_degrees(src, dst, n_nodes, kernel, mesh)),
        active=torch.ones(n_nodes, dtype=torch.bool, device=dev),
        coreness=torch.zeros(n_nodes, dtype=torch.int32, device=dev),
        n_v=scalar(n_nodes, torch.int32, dev),
        n_e=scalar(n_edges, torch.int32, dev),
        best_density=scalar(0.0, torch.float32, dev),
        best_k=zero,
        best_n_v=zero,
        best_n_e=zero,
    )
    while True:
        with host_sync("level_test"):
            # repro: allow RPR101 -- the one host sync of each level
            live = s.n_v.item() > 0
        if not live:
            return s
        with detail("kcore_level") as level:
            level.set("k", s.k)
            # graph remaining on *entry* to level k is the k-core; record its
            # density (paper Alg. 2, the `single` block after each level).
            density = s.n_e.to(torch.float32) / s.n_v.clamp(min=1).to(torch.float32)
            better = density > s.best_density
            s = s._replace(
                best_density=torch.where(better, density, s.best_density),
                best_k=torch.where(better, s.k, s.best_k),
                best_n_v=torch.where(better, s.n_v, s.best_n_v),
                best_n_e=torch.where(better, s.n_e, s.best_n_e),
            )
            s = _level_fixpoint(s, src, dst, n_nodes, kernel, mesh)
        s = s._replace(k=s.k + 1)


def kcore_decompose(
    graph: Graph, kernel: bool | None = None,
    device: torch.device | str | None = None,
) -> tuple[np.ndarray, float, int, int, int]:
    """Returns (coreness [V], best_core_density, k*, m_v, m_e).

    The densest core is {v : coreness[v] >= k*}; its density is a
    2-approximation of rho* (lower-bounded by the largest core's density).
    ``device`` and ``kernel`` resolve as in ``pbahmani``; kernel mode feeds
    the cached dst-sorted lanes — identical outputs either way.
    """
    device = resolve_device(device)
    kernel = resolve_kernel(kernel, device)
    if kernel:
        assert_exact_envelope(graph.src.shape[0], graph.n_nodes)
    src, dst = to_device(graph, device, sorted=kernel)
    final = _kcore(src, dst, graph.n_nodes, graph.n_edges, kernel)
    return (
        final.coreness.cpu().numpy(),
        float(final.best_density),
        int(final.best_k),
        int(final.best_n_v),
        int(final.best_n_e),
    )


# ---------------------------------------------------------------------------
# NumPy reference (oracle vs networkx.core_number in tests)
# ---------------------------------------------------------------------------
def kcore_np(graph: Graph) -> tuple[np.ndarray, float, int, int, int]:
    n = graph.n_nodes
    s = graph.src[: graph.n_directed].astype(np.int64)
    d = graph.dst[: graph.n_directed].astype(np.int64)
    deg = np.bincount(s, minlength=n).astype(np.int64)
    active = np.ones(n, dtype=bool)
    coreness = np.zeros(n, dtype=np.int64)
    n_v, n_e = n, graph.n_edges
    best_density, best_k, best_nv, best_ne = 0.0, 0, 0, 0
    k = 0
    while n_v > 0:
        if n_v > 0:
            density = n_e / n_v
            if density > best_density:
                best_density, best_k, best_nv, best_ne = density, k, n_v, n_e
        while True:
            failed = active & (deg <= k)
            if not failed.any():
                break
            live = active[s] & active[d]
            fs = failed[s] & live
            fd = failed[d] & live
            n_e -= int((fs | fd).sum()) // 2
            delta = np.bincount(d[fs], minlength=n)
            active &= ~failed
            deg = np.where(active, deg - delta, 0)
            coreness[failed] = k
            n_v -= int(failed.sum())
        k += 1
    return coreness.astype(np.int32), float(best_density), best_k, best_nv, best_ne


__all__ = ["CoreState", "kcore_decompose", "kcore_np"]
