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


# ---------------------------------------------------------------------------
# edge streams (the dynamic-graph subsystem's wire format, stream/)
# ---------------------------------------------------------------------------
def load_edge_stream(path: str, batch_size: int = 256):
    """Yield ``(insert [k,2], delete [m,2])`` int64 batches from a stream file.

    Format, one event per line (``#`` comments skipped):
        u v        insert {u, v}        (bare SNAP row == insertion stream)
        + u v      insert {u, v}
        - u v      delete {u, v}
    A batch closes after ``batch_size`` events. Within a batch the *last*
    event per edge wins (an insert followed by a delete nets to absent), so
    replaying batches through ``EdgeBuffer.apply`` — which retracts before
    asserting — reproduces the stream's final state exactly.
    """
    opener = gzip.open if path.endswith(".gz") else open
    net: dict[tuple[int, int], str] = {}

    def flush():
        ins = [e for e, op in net.items() if op == "+"]
        dels = [e for e, op in net.items() if op == "-"]
        net.clear()
        return (
            np.asarray(ins, dtype=np.int64).reshape(-1, 2),
            np.asarray(dels, dtype=np.int64).reshape(-1, 2),
        )

    n_events = 0
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            try:
                if parts[0] in ("+", "-"):
                    op, u, v = parts[0], parts[1], parts[2]
                else:
                    op, u, v = "+", parts[0], parts[1]
                u, v = int(u), int(v)
            except (IndexError, ValueError):
                raise ValueError(f"bad stream line {line.rstrip()!r}") from None
            net[(min(u, v), max(u, v))] = op
            n_events += 1
            if n_events >= batch_size:
                n_events = 0
                yield flush()
    if net:
        yield flush()


def save_edge_stream(events, path: str) -> None:
    """Write ``(op, u, v)`` events (op in {'+', '-'}) in stream format."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("# edge stream: '+ u v' insert, '- u v' delete\n")
        for op, u, v in events:
            if op not in ("+", "-"):
                raise ValueError(f"bad stream op {op!r}")
            f.write(f"{op} {int(u)} {int(v)}\n")


__all__ = ["load_snap_edgelist", "save_edgelist", "load_edge_stream",
           "save_edge_stream"]
