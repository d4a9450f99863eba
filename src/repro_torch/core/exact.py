"""Exact densest subgraph via Goldberg's max-flow construction (1984).

The paper's Table 3 "Exact Density" column. Binary search over the candidate
density g with the classic network:

    s -> v        capacity deg(v)            for every vertex v
    v -> t        capacity 2g                for every vertex v
    u <-> v       capacity 1 each direction  for every edge {u, v}

min-cut(s, t) < 2|E|  <=>  exists S with rho(S) > g.  Candidate densities are
rationals with denominator <= n, so the search terminates once the interval is
below 1/(n(n-1)); the optimal S is the source side of the final min cut.

Max-flow is Dinic's algorithm on CSR-packed residual arcs (host-side numpy —
the exact solver is a *baseline*, deliberately not the GPU path; the paper
itself notes flow-based methods do not scale, which is its motivation).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.graph import Graph


class _Dinic:
    """Dinic max-flow with arc arrays (to, cap, next) + head index."""

    def __init__(self, n: int, m_arcs: int):
        self.n = n
        self.head = np.full(n, -1, dtype=np.int64)
        self.to = np.zeros(m_arcs, dtype=np.int64)
        self.nxt = np.zeros(m_arcs, dtype=np.int64)
        self.cap = np.zeros(m_arcs, dtype=np.float64)
        self.cnt = 0

    def add_edge(self, u: int, v: int, c: float, c_rev: float = 0.0) -> None:
        for (a, b, cc) in ((u, v, c), (v, u, c_rev)):
            e = self.cnt
            self.to[e] = b
            self.cap[e] = cc
            self.nxt[e] = self.head[a]
            self.head[a] = e
            self.cnt += 1

    def _bfs(self, s: int, t: int) -> np.ndarray | None:
        level = np.full(self.n, -1, dtype=np.int64)
        level[s] = 0
        frontier = [s]
        while frontier:
            nxt_frontier = []
            for u in frontier:
                e = self.head[u]
                while e != -1:
                    v = self.to[e]
                    if self.cap[e] > 1e-12 and level[v] < 0:
                        level[v] = level[u] + 1
                        nxt_frontier.append(int(v))
                    e = self.nxt[e]
            frontier = nxt_frontier
        return level if level[t] >= 0 else None

    def _dfs(self, s: int, t: int, level: np.ndarray, it: np.ndarray) -> float:
        """Iterative blocking flow with the current-arc optimization."""
        total = 0.0
        stack = [s]
        path: list[int] = []  # arcs along the current partial path
        while stack:
            u = stack[-1]
            if u == t:
                bottleneck = min(self.cap[a] for a in path)
                for a in path:
                    self.cap[a] -= bottleneck
                    self.cap[a ^ 1] += bottleneck
                total += bottleneck
                # retreat to just before the first saturated arc
                for idx, a in enumerate(path):
                    if self.cap[a] <= 1e-12:
                        stack = stack[: idx + 1]
                        path = path[:idx]
                        break
                continue
            e = it[u]
            while e != -1:
                v = self.to[e]
                if self.cap[e] > 1e-12 and level[v] == level[u] + 1:
                    break
                e = self.nxt[e]
            it[u] = e
            if e != -1:
                stack.append(int(self.to[e]))
                path.append(int(e))
            else:
                level[u] = -1  # dead end: prune from the level graph
                stack.pop()
                if path:
                    path.pop()
        return total

    def max_flow(self, s: int, t: int) -> float:
        flow = 0.0
        while True:
            level = self._bfs(s, t)
            if level is None:
                return flow
            it = self.head.copy()
            flow += self._dfs(s, t, level, it)

    def min_cut_source_side(self, s: int) -> np.ndarray:
        """bool [n]: vertices reachable from s in the residual graph."""
        seen = np.zeros(self.n, dtype=bool)
        seen[s] = True
        frontier = [s]
        while frontier:
            nxt_frontier = []
            for u in frontier:
                e = self.head[u]
                while e != -1:
                    v = self.to[e]
                    if self.cap[e] > 1e-12 and not seen[v]:
                        seen[v] = True
                        nxt_frontier.append(int(v))
                    e = self.nxt[e]
            frontier = nxt_frontier
        return seen


def _build_network(graph: Graph, g: float) -> _Dinic:
    n = graph.n_nodes
    m = graph.n_edges
    half = graph.n_directed // 2
    deg = graph.degrees()
    net = _Dinic(n + 2, 4 * n + 4 * half)
    s, t = n, n + 1
    for v in range(n):
        net.add_edge(s, v, float(deg[v]))
        net.add_edge(v, t, 2.0 * g)
    su, du = graph.src[:half], graph.dst[:half]
    for i in range(half):
        net.add_edge(int(su[i]), int(du[i]), 1.0, 1.0)
    del m
    return net


def exact_densest(
    graph: Graph,
    tol: float | None = None,
    lo: float = 0.0,
    hi: float | None = None,
) -> tuple[float, np.ndarray]:
    """Returns (rho*, mask of an optimum subgraph). O(binary search · flow).

    ``lo``/``hi`` bound the search; pass a 2-approximation rho~ as
    (lo=rho~, hi=2·rho~) to halve the number of flow computations.
    """
    n, m = graph.n_nodes, graph.n_edges
    if m == 0:
        return 0.0, np.zeros(n, dtype=bool)
    if hi is None:
        hi = float(m)
    if tol is None:
        tol = 1.0 / (n * (n - 1) + 1) if n > 1 else 1e-9
    best_mask: np.ndarray | None = None
    while hi - lo > tol:
        g = (lo + hi) / 2.0
        net = _build_network(graph, g)
        flow = net.max_flow(n, n + 1)
        if flow < 2.0 * m - 1e-9:  # cut < 2|E| => exists S with rho(S) > g
            lo = g
            side = net.min_cut_source_side(n)
            best_mask = side[:n].copy()
        else:
            hi = g
    if best_mask is None or not best_mask.any():
        # optimum <= first midpoint; fall back to one more probe just below hi
        net = _build_network(graph, max(lo - tol, 0.0))
        net.max_flow(n, n + 1)
        side = net.min_cut_source_side(n)
        best_mask = side[:n].copy()
    rho = graph.subgraph_density(best_mask)
    return float(rho), best_mask


__all__ = ["exact_densest"]
