"""Synthetic graph generators (deterministic, seeded).

The paper benchmarks on SNAP graphs; offline we generate structurally similar
suites: Erdős–Rényi, power-law (Barabási–Albert-style preferential
attachment), RMAT (Graph500 kernel), and planted-dense-subgraph instances
whose optimum density is known by construction (used to validate the
approximation bounds end-to-end).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.graph import Graph


def erdos_renyi(n: int, p: float, seed: int = 0) -> Graph:
    """G(n, p). Memory O(n^2 * p) expected; use for n <= ~20k."""
    rng = np.random.default_rng(seed)
    # sample the upper triangle by geometric skips to avoid n^2 memory blowup
    m_expected = int(p * n * (n - 1) / 2)
    if n <= 4096:
        iu = np.triu_indices(n, k=1)
        keep = rng.random(iu[0].shape[0]) < p
        edges = np.stack([iu[0][keep], iu[1][keep]], axis=1)
    else:
        total = n * (n - 1) // 2
        m = rng.binomial(total, p)
        flat = rng.choice(total, size=min(m, total), replace=False)
        # invert the triangular index
        i = (np.floor((2 * n - 1 - np.sqrt((2 * n - 1) ** 2 - 8 * flat)) / 2)).astype(np.int64)
        j = (flat - i * (2 * n - i - 1) // 2 + i + 1).astype(np.int64)
        edges = np.stack([i, j], axis=1)
    del m_expected
    return Graph.from_edges(edges, n_nodes=n)


def barabasi_albert(n: int, m: int, seed: int = 0) -> Graph:
    """Preferential attachment: each new vertex attaches to m earlier ones."""
    rng = np.random.default_rng(seed)
    targets = list(range(m))
    repeated: list[int] = []
    edges = []
    for v in range(m, n):
        for t in targets:
            edges.append((v, t))
        repeated.extend(targets)
        repeated.extend([v] * m)
        # sample next targets proportional to degree (sample from `repeated`)
        idx = rng.integers(0, len(repeated), size=m)
        targets = list({repeated[i] for i in idx})
        while len(targets) < m:
            targets.append(int(rng.integers(0, v + 1)))
            targets = list(set(targets))
    return Graph.from_edges(np.array(edges, dtype=np.int64), n_nodes=n)


def rmat(scale: int, edge_factor: int = 16, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19) -> Graph:
    """Graph500-style RMAT: n = 2^scale vertices, edge_factor*n edges."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        # quadrant probabilities (a, b, c, d)
        src_bit = (r >= a + b).astype(np.int64)
        r2 = rng.random(m)
        thr = np.where(src_bit == 0, a / (a + b), c / (1.0 - a - b))
        dst_bit = (r2 >= thr).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return Graph.from_edges(np.stack([src, dst], axis=1), n_nodes=n)


def planted_dense(
    n: int,
    clique_size: int,
    p_background: float = 0.01,
    p_planted: float = 0.9,
    seed: int = 0,
) -> tuple[Graph, np.ndarray, float]:
    """ER background + a dense planted block on the first ``clique_size`` ids.

    Returns (graph, planted_mask, planted_block_density). When
    ``p_planted * (clique_size-1) / 2`` well exceeds the background density the
    planted block is (whp) the densest subgraph — used to validate recovery.
    """
    rng = np.random.default_rng(seed)
    g_bg = erdos_renyi(n, p_background, seed=seed + 1)
    k = clique_size
    iu = np.triu_indices(k, k=1)
    keep = rng.random(iu[0].shape[0]) < p_planted
    planted_edges = np.stack([iu[0][keep], iu[1][keep]], axis=1)
    half = g_bg.n_directed // 2
    all_edges = np.concatenate(
        [np.stack([g_bg.src[:half], g_bg.dst[:half]], axis=1), planted_edges], axis=0
    )
    g = Graph.from_edges(all_edges, n_nodes=n)
    mask = np.zeros(n, dtype=bool)
    mask[:k] = True
    return g, mask, g.subgraph_density(mask)


def small_named(name: str) -> Graph:
    """Classic small graphs with known exact densest subgraphs (for tests)."""
    if name == "triangle_plus_path":
        # densest subgraph = the triangle, rho* = 1.0
        return Graph.from_edges(np.array([[0, 1], [1, 2], [0, 2], [2, 3], [3, 4]]))
    if name == "k4_plus_star":
        # K4 (rho = 6/4 = 1.5) + a star that dilutes
        return Graph.from_edges(
            np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3],
                      [4, 5], [4, 6], [4, 7], [4, 0]])
        )
    if name == "two_cliques":
        # K5 (rho 2.0) and K4 (rho 1.5) joined by one edge
        k5 = [(i, j) for i in range(5) for j in range(i + 1, 5)]
        k4 = [(5 + i, 5 + j) for i in range(4) for j in range(i + 1, 4)]
        return Graph.from_edges(np.array(k5 + k4 + [(0, 5)]))
    if name == "petersen":
        outer = [(i, (i + 1) % 5) for i in range(5)]
        spokes = [(i, i + 5) for i in range(5)]
        inner = [(5 + i, 5 + (i + 2) % 5) for i in range(5)]
        return Graph.from_edges(np.array(outer + spokes + inner))
    raise ValueError(f"unknown graph {name!r}")
