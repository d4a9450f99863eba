"""CBDS-P (the paper's Algorithm 2) in plain NumPy: the yardstick for the
port's ``cbds_p``, bit for bit.

Phase 1 is the k-core decomposition with the density of every level's core:
the core entered at level k is ``{v : coreness(v) >= k}`` (all vertices at
k = 0), its density the float32 quotient of its edge and vertex counts, and
the densest core the first level, from k = 0 up to the largest coreness,
with the largest such density (a strict increase replaces the best). The
coreness is unique, so any exact algorithm gives the same levels; this one
peels the vertices of degree at most k level by level over CSR neighbour
lists, which touches each lane once in all (a scan of every lane a
fixpoint iteration, as the port's level loop makes, takes minutes here).

Phase 2 makes ``rounds`` augmentation rounds in exact integers: a vertex
outside the set joins when its edges into the set exceed ``m_e // m_v``;
the set's edge count grows by those edges and by the edges among the new
vertices. The density reported is the larger of the augmented set's
float32 density and the densest core's.

``precision="bfloat16"`` rounds every level's density to bfloat16 before
the densest core is chosen: the control.
"""
from __future__ import annotations

import numpy as np

from dsgbench.reference.peel import rounder


def coreness(n_nodes: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """int64 ``[n_nodes]`` coreness over symmetric lanes ``src -> dst``."""
    s = np.asarray(src, dtype=np.int64)
    d = np.asarray(dst, dtype=np.int64)
    order = np.argsort(s, kind="stable")
    nbr = d[order]
    deg = np.bincount(s, minlength=n_nodes).astype(np.int64)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    core = np.zeros(n_nodes, dtype=np.int64)
    alive = np.ones(n_nodes, dtype=bool)
    left, k = n_nodes, 0
    while left > 0:
        failed = np.flatnonzero(alive & (deg <= k))
        if failed.size == 0:
            k = max(k + 1, int(deg[alive].min()))
            continue
        core[failed] = k
        alive[failed] = False
        left -= failed.size
        counts = indptr[failed + 1] - indptr[failed]
        total = int(counts.sum())
        if total:
            first = np.repeat(indptr[failed] - (np.cumsum(counts) - counts), counts)
            nb = nbr[first + np.arange(total)]
            nb = nb[alive[nb]]
            deg -= np.bincount(nb, minlength=n_nodes)
    return core


def cbds_ref(n_nodes: int, src: np.ndarray, dst: np.ndarray, rounds: int = 1,
             precision: str = "float32") -> dict:
    """``cbds_p``'s dict over symmetric lanes (each undirected edge twice,
    no padding, no self-loop): density, core_density (float32), k_star,
    member_mask, n_legit."""
    rnd = rounder(precision)
    s = np.asarray(src, dtype=np.int64)
    d = np.asarray(dst, dtype=np.int64)
    core = coreness(n_nodes, s, d)
    k_max = int(core.max()) if n_nodes else 0
    # vertices and edges of the core entered at each level 0..k_max
    n_v = np.cumsum(np.bincount(core, minlength=k_max + 1)[::-1])[::-1]
    lane_level = np.minimum(core[s], core[d])
    n_e = np.cumsum(np.bincount(lane_level, minlength=k_max + 1)[::-1])[::-1] // 2
    dens = rnd(n_e.astype(np.float32) / np.maximum(n_v, 1).astype(np.float32))
    best_density, best_k = np.float32(0.0), 0
    for k in range(k_max + 1):
        if dens[k] > best_density:
            best_density, best_k = np.float32(dens[k]), k
    member = core >= best_k
    m_v = int(n_v[best_k]) if best_density > 0 else 0
    m_e = int(n_e[best_k]) if best_density > 0 else 0
    if best_density == 0:  # no core has an edge: the port keeps k* = 0, m = 0
        member = core >= 0
    n_legit = 0
    for _ in range(int(rounds)):
        into = member[s] & ~member[d]
        e_into = np.bincount(d[into], minlength=n_nodes)
        legit = ~member & (e_into > m_e // max(m_v, 1))
        added = int(np.count_nonzero(legit))
        inter = int(e_into[legit].sum()) + int(np.count_nonzero(legit[s] & legit[d])) // 2
        member = member | legit
        m_e += inter
        m_v += added
        n_legit += added
    density = np.float32(np.float32(m_e) / np.float32(max(m_v, 1)))
    return {
        "density": float(max(density, best_density)),
        "core_density": float(best_density),
        "k_star": best_k,
        "member_mask": member,
        "n_legit": n_legit,
    }


__all__ = ["coreness", "cbds_ref"]
