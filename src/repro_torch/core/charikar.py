"""Charikar's serial greedy 2-approximation (baseline the paper compares to).

Peels the single minimum-degree vertex per step (lazy min-heap, O(E log V));
the best intermediate density is a 2-approximation of rho*. The paper notes
P-Bahmani at eps=0 matches this accuracy class; we keep the exact serial
algorithm as the accuracy/runtime baseline for benches (paper Table 3 and the
serial-vs-parallel speedup figures).
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.graphs.graph import Graph


def charikar(graph: Graph) -> tuple[float, np.ndarray]:
    """Returns (best_density, best_mask). Exact serial Charikar greedy."""
    n = graph.n_nodes
    if n == 0 or graph.n_edges == 0:
        return 0.0, np.zeros(n, dtype=bool)
    indptr, indices = graph.to_csr()
    deg = (indptr[1:] - indptr[:-1]).astype(np.int64)

    heap: list[tuple[int, int]] = [(int(deg[v]), v) for v in range(n)]
    heapq.heapify(heap)
    alive = np.ones(n, dtype=bool)
    n_e = graph.n_edges
    n_v = n
    best = n_e / n
    removal_order = np.empty(n, dtype=np.int64)
    best_step = -1  # index into removal_order: best set = survivors after it

    step = 0
    while n_v > 0:
        d, v = heapq.heappop(heap)
        if not alive[v] or d != deg[v]:
            continue  # stale entry
        alive[v] = False
        removal_order[step] = v
        n_e -= int(deg[v])
        n_v -= 1
        for e in range(indptr[v], indptr[v + 1]):
            u = int(indices[e])
            if alive[u]:
                deg[u] -= 1
                heapq.heappush(heap, (int(deg[u]), u))
        if n_v > 0:
            rho = n_e / n_v
            if rho > best:
                best = rho
                best_step = step
        step += 1

    mask = np.ones(n, dtype=bool)
    if best_step >= 0:
        mask[removal_order[: best_step + 1]] = False
    else:
        pass  # the whole graph is the best subgraph
    return float(best), mask


def degeneracy_order(graph: Graph) -> np.ndarray:
    """Vertex removal order of the greedy peel (useful for samplers/tests)."""
    n = graph.n_nodes
    indptr, indices = graph.to_csr()
    deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
    heap = [(int(deg[v]), v) for v in range(n)]
    heapq.heapify(heap)
    alive = np.ones(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    step = 0
    while step < n:
        d, v = heapq.heappop(heap)
        if not alive[v] or d != deg[v]:
            continue
        alive[v] = False
        order[step] = v
        step += 1
        for e in range(indptr[v], indptr[v + 1]):
            u = int(indices[e])
            if alive[u]:
                deg[u] -= 1
                heapq.heappush(heap, (int(deg[u]), u))
    return order


__all__ = ["charikar", "degeneracy_order"]
