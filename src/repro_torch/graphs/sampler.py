"""Fanout neighbor sampler (minibatch_lg) with optional core-ordered bias.

Produces fixed-shape "blocks" (GraphSAGE-style): for seed nodes B and
fanout (f1, f2, ...), layer l samples f_l neighbors per frontier node (with
replacement when deg < f_l; sentinel-padded when deg == 0). Shapes are
static: a step sees one shape per (B, fanout).

Core-ordered mode biases sampling toward high-coreness neighbors (the
paper-technique integration: k-core/CBDS-P output drives the data layer):
neighbors are ranked by coreness and the top f_l are taken.

A copy of the JAX package's ``graphs/sampler.py`` (numpy only): the same
blocks for the same graph, seed and coreness.

Output block dict (flat relabeled ids 0..n_block-1):
  node_ids   [n_block] original vertex ids (sentinel = -1 padding)
  src, dst   [n_edges] block-local directed edges (child -> parent)
  n_layers   frontier sizes per layer (B, B*f1, ...)
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.graph import Graph


class NeighborSampler:
    def __init__(self, graph: Graph, fanout: tuple[int, ...],
                 coreness: np.ndarray | None = None, seed: int = 0):
        self.graph = graph
        self.fanout = tuple(fanout)
        self.indptr, self.indices = graph.to_csr()
        self.rng = np.random.default_rng(seed)
        self.coreness = coreness
        if coreness is not None:
            # pre-sort each adjacency list by descending coreness once
            # stable segment sort: sort (row, -coreness) lexicographically
            rows = np.repeat(np.arange(graph.n_nodes),
                             np.diff(self.indptr))
            lex = np.lexsort((-coreness[self.indices], rows))
            self.indices = self.indices[lex]
            del rows, lex

    def block_shape(self, batch_nodes: int) -> tuple[int, int]:
        """(n_block_nodes, n_block_edges) for a given seed-batch size."""
        nodes, total, edges = batch_nodes, batch_nodes, 0
        for f in self.fanout:
            edges += nodes * f
            nodes *= f
            total += nodes
        return total, edges

    def sample(self, seeds: np.ndarray) -> dict:
        seeds = np.asarray(seeds, dtype=np.int64)
        b = seeds.shape[0]
        node_ids = [seeds]
        src_blocks, dst_blocks = [], []
        frontier = seeds
        offset = 0
        for f in self.fanout:
            nf = frontier.shape[0]
            childs = np.empty(nf * f, dtype=np.int64)
            for i, v in enumerate(frontier):
                if v < 0:
                    childs[i * f:(i + 1) * f] = -1
                    continue
                lo, hi = self.indptr[v], self.indptr[v + 1]
                deg = hi - lo
                if deg == 0:
                    childs[i * f:(i + 1) * f] = -1
                elif self.coreness is not None:
                    take = self.indices[lo:lo + min(f, deg)]
                    reps = -(-f // take.shape[0])
                    childs[i * f:(i + 1) * f] = np.tile(take, reps)[:f]
                else:
                    idx = self.rng.integers(0, deg, size=f)
                    childs[i * f:(i + 1) * f] = self.indices[lo + idx]
            child_pos = offset + nf + np.arange(nf * f)
            parent_pos = offset + np.repeat(np.arange(nf), f)
            valid = childs >= 0
            src_blocks.append(child_pos[valid])
            dst_blocks.append(parent_pos[valid])
            node_ids.append(childs)
            offset += nf
            frontier = childs
        n_block, n_edges = self.block_shape(b)
        ids = np.concatenate(node_ids)
        src = np.full(n_edges, n_block, dtype=np.int32)  # sentinel pad
        dst = np.full(n_edges, n_block, dtype=np.int32)
        s = np.concatenate(src_blocks).astype(np.int32)
        d = np.concatenate(dst_blocks).astype(np.int32)
        src[:s.shape[0]] = s
        dst[:d.shape[0]] = d
        return {"node_ids": ids.astype(np.int64), "src": src, "dst": dst,
                "n_nodes": n_block, "n_seeds": b}


__all__ = ["NeighborSampler"]
