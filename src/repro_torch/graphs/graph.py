"""Graph containers: COO (symmetric directed-pair) + CSR views.

The paper stores the graph as a hash-table-of-hash-tables ("super map") to
tolerate arbitrary vertex IDs. On the GPU the natural container is a pair of
flat ``int32`` index arrays (COO) — vertex IDs are densified once at
construction (host side) and every device-side op is a masked vector op over
edges. This module is the host side; ``graphs/convert.py`` uploads it.

Conventions
-----------
* Simple undirected graphs: no self-loops, no duplicate edges. A single
  undirected edge {u, v} is stored as TWO directed entries (u→v, v→u) so that
  per-vertex reductions (degree, neighbor aggregation) are plain
  ``segment_sum`` over ``dst`` — the deterministic replacement for the
  paper's per-neighbor atomic updates.
* Padding: directed arrays are padded to ``pad_to`` with the sentinel vertex
  ``n_nodes``; reductions use ``num_segments = n_nodes + 1`` and drop the last
  row. The layout is the JAX package's, so the two hold identical arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    import networkx


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class Graph:
    """Host-side immutable simple undirected graph in symmetric COO form.

    Attributes:
      n_nodes:  |V|.
      n_edges:  |E| (undirected edge count).
      src, dst: int32 [n_directed_padded] symmetric directed pairs; entries
                beyond 2·|E| hold the sentinel ``n_nodes``.
      n_directed: 2·|E| (valid prefix length of src/dst).
    """

    n_nodes: int
    n_edges: int
    src: np.ndarray
    dst: np.ndarray
    n_directed: int

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_edges(
        edges: np.ndarray, n_nodes: int | None = None, pad_multiple: int = 256
    ) -> "Graph":
        """Build from an [m, 2] array of undirected edges (any orientation).

        Deduplicates, drops self-loops, symmetrizes, pads. The pairs are
        deduplicated as the int64 keys ``(u - lo) * span + (v - lo)``, whose
        order is the rows' lexicographic order: the same array as the JAX
        package's row-wise ``np.unique``, by one ``np.sort`` and a mask
        (``np.unique`` of the same keys is over 100x slower under numpy 2.3).
        """
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        uv = np.zeros((0, 2), np.int64)
        if edges.size:
            u = np.minimum(edges[:, 0], edges[:, 1])
            v = np.maximum(edges[:, 0], edges[:, 1])
            keep = u != v  # drop self-loops (simple-graph convention; DESIGN §1)
            u, v = u[keep], v[keep]
            if u.size:
                lo, hi = int(u.min()), int(v.max())
                if lo < 0 or hi >= np.iinfo(np.int32).max:
                    # src/dst and the sentinel n_nodes are int32
                    raise ValueError(f"vertex ids must lie in [0, 2**31 - 1); got [{lo}, {hi}]")
                span = hi - lo + 1  # span^2 < 2^62 fits int64
                keys = np.sort((u - lo) * span + (v - lo))
                keys = keys[np.r_[True, keys[1:] != keys[:-1]]]
                uv = np.stack([keys // span + lo, keys % span + lo], axis=1)
        if n_nodes is None:
            n_nodes = int(uv.max()) + 1 if uv.size else 0
        m = uv.shape[0]
        n_directed = 2 * m
        padded = max(_round_up(max(n_directed, 1), pad_multiple), pad_multiple)
        src = np.full(padded, n_nodes, dtype=np.int32)
        dst = np.full(padded, n_nodes, dtype=np.int32)
        src[:m] = uv[:, 0]
        dst[:m] = uv[:, 1]
        src[m:n_directed] = uv[:, 1]
        dst[m:n_directed] = uv[:, 0]
        return Graph(n_nodes=int(n_nodes), n_edges=m, src=src, dst=dst, n_directed=n_directed)

    @staticmethod
    def from_networkx(g: "networkx.Graph") -> "Graph":
        import networkx as nx  # local import; nx is a test/bench dependency

        mapping = {v: i for i, v in enumerate(g.nodes())}
        edges = np.array([[mapping[u], mapping[v]] for u, v in g.edges()], dtype=np.int64)
        return Graph.from_edges(edges, n_nodes=g.number_of_nodes())

    # -- views --------------------------------------------------------------
    @property
    def edge_valid(self) -> np.ndarray:
        """bool [padded]: True for real directed entries."""
        mask = np.zeros(self.src.shape[0], dtype=bool)
        mask[: self.n_directed] = True
        return mask

    def degrees(self) -> np.ndarray:
        """int32 [n_nodes] vertex degrees."""
        deg = np.bincount(self.src[: self.n_directed], minlength=self.n_nodes)
        return deg.astype(np.int32)

    def density(self) -> float:
        """Paper Definition 1: rho(G) = |E| / |V|."""
        return self.n_edges / max(self.n_nodes, 1)

    def dst_sorted(self) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) reordered so dst is ascending (sentinel pads stay last).

        The layout the sorted segment-sum kernel requires (each vertex's
        in-edges form one contiguous run, kernels/segsum.py). Cached on
        first call.
        """
        cache = getattr(self, "_dst_sorted_cache", None)
        if cache is None:
            order = np.argsort(self.dst, kind="stable")
            cache = (self.src[order].copy(), self.dst[order].copy())
            object.__setattr__(self, "_dst_sorted_cache", cache)
        return cache

    def to_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """Returns (indptr [n_nodes+1], indices [2|E|]) neighbor lists."""
        order = np.argsort(self.src[: self.n_directed], kind="stable")
        indices = self.dst[: self.n_directed][order].astype(np.int32)
        counts = np.bincount(self.src[: self.n_directed], minlength=self.n_nodes)
        indptr = np.zeros(self.n_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return indptr, indices

    def to_networkx(self) -> "networkx.Graph":
        import networkx as nx

        g = nx.Graph()
        g.add_nodes_from(range(self.n_nodes))
        half = self.n_directed // 2
        g.add_edges_from(zip(self.src[:half].tolist(), self.dst[:half].tolist()))
        return g

    def subgraph_density(self, mask: np.ndarray) -> float:
        """Density of the subgraph induced by boolean vertex ``mask``."""
        mask = np.asarray(mask, dtype=bool)
        nv = int(mask.sum())
        if nv == 0:
            return 0.0
        s, d = self.src[: self.n_directed], self.dst[: self.n_directed]
        ne = int((mask[s] & mask[d]).sum()) // 2
        return ne / nv

    def induced_subgraph(self, mask: np.ndarray) -> "Graph":
        """New Graph on the same vertex-ID space induced by ``mask``."""
        mask = np.asarray(mask, dtype=bool)
        half = self.n_directed // 2
        s, d = self.src[:half], self.dst[:half]
        keep = mask[s] & mask[d]
        return Graph.from_edges(
            np.stack([s[keep], d[keep]], axis=1), n_nodes=self.n_nodes
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"Graph(|V|={self.n_nodes}, |E|={self.n_edges}, rho={self.density():.3f})"
