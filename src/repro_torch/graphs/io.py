"""SNAP edge-list IO: the paper's datasets load directly when present.

Format: whitespace-separated ``u v`` pairs, ``#`` comment lines — exactly
what snap.stanford.edu ships (ca-GrQc.txt etc.). Vertex ids are densified
on load (the paper's hash-map motivation, handled once on host)."""
from __future__ import annotations

import gzip
import os

import numpy as np

from repro_torch.graphs.graph import Graph


def load_snap_edgelist(path: str) -> Graph:
    opener = gzip.open if path.endswith(".gz") else open
    rows = []
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            u, v = line.split()[:2]
            rows.append((int(u), int(v)))
    edges = np.asarray(rows, dtype=np.int64)
    # densify ids (SNAP graphs routinely skip ids — the paper's "super map")
    uniq, inv = np.unique(edges, return_inverse=True)
    edges = inv.reshape(edges.shape)
    return Graph.from_edges(edges, n_nodes=uniq.shape[0])


def save_edgelist(graph: Graph, path: str) -> None:
    half = graph.n_directed // 2
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# |V|={graph.n_nodes} |E|={graph.n_edges}\n")
        for u, v in zip(graph.src[:half], graph.dst[:half]):
            f.write(f"{u}\t{v}\n")


__all__ = ["load_snap_edgelist", "save_edgelist"]
