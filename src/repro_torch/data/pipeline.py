"""Deterministic synthetic data pipelines, produced on the host in numpy.

``lm_token_batches`` and ``recsys_batches`` are copies of the JAX package's
``data/pipeline.py`` generators: the same arrays for the same arguments and
seed. Each is an infinite iterator whose step k's batch depends on k alone,
so a checkpoint restart resumes the stream exactly (``launch/train.py``).
``gnn_batch`` and ``GraphBatcher`` are copies of its GNN batches, over the
port's ``Graph``.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.graphs.graph import Graph


def lm_token_batches(vocab: int, batch: int, seq: int, seed: int = 0,
                     start_step: int = 0) -> Iterator[dict]:
    """Infinite stream of {tokens, labels} int32 [batch, seq].

    Synthetic Zipf-ish unigram stream with a deterministic per-step seed so
    step k's batch is reproducible regardless of restart point.
    """
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    step = start_step
    while True:
        rng = np.random.default_rng(seed * 1_000_003 + step)
        toks = rng.choice(vocab, size=(batch, seq + 1), p=probs).astype(np.int32)
        yield {"step": step, "tokens": toks[:, :-1], "labels": toks[:, 1:]}
        step += 1


def recsys_batches(cfg, batch: int, seed: int = 0,
                   start_step: int = 0) -> Iterator[dict]:
    """Infinite stream of DCN-v2 batches; CTR labels from a planted linear
    model so training has signal."""
    step = start_step
    w_dense = np.random.default_rng(seed).normal(size=cfg.n_dense)
    while True:
        rng = np.random.default_rng(seed * 7_000_003 + step)
        dense = rng.normal(size=(batch, cfg.n_dense)).astype(np.float32)
        ids = rng.integers(0, cfg.table_rows,
                           size=(batch, cfg.n_sparse, cfg.multi_hot)).astype(np.int32)
        logit = dense @ w_dense + 0.1 * rng.normal(size=batch)
        labels = (logit > 0).astype(np.int32)
        yield {"step": step, "dense": dense, "sparse_ids": ids, "labels": labels}
        step += 1


def gnn_batch(graph: Graph, *, d_feat: int | None = None, n_classes: int = 7,
              geometric: bool = False, n_graphs: int = 1,
              graph_id: np.ndarray | None = None, seed: int = 0) -> dict:
    """Build a model-ready batch dict from a Graph (features synthesized)."""
    rng = np.random.default_rng(seed)
    n = graph.n_nodes
    batch: dict = {
        "src": graph.src, "dst": graph.dst,
        "graph_id": (graph_id if graph_id is not None
                     else np.zeros(n, np.int32)),
        "node_mask": np.ones(n, bool),
        "n_graphs": n_graphs,
    }
    if geometric:
        batch["atom_type"] = rng.integers(0, 10, n).astype(np.int32)
        batch["pos"] = rng.normal(size=(n, 3)).astype(np.float32)
        batch["energy"] = rng.normal(size=n_graphs).astype(np.float32)
    if d_feat is not None:
        batch["node_feat"] = rng.normal(size=(n, d_feat)).astype(np.float32)
        batch["labels"] = rng.integers(0, n_classes, n).astype(np.int32)
        batch["label_mask"] = rng.random(n) < 0.1
    return batch


class GraphBatcher:
    """Batch many small graphs into one flat padded graph (molecule shape)."""

    def __init__(self, n_nodes_per: int, n_edges_per: int, batch: int):
        self.np_, self.ep_, self.b = n_nodes_per, n_edges_per, batch

    def random_batch(self, seed: int = 0, geometric: bool = True) -> dict:
        rng = np.random.default_rng(seed)
        n_tot = self.np_ * self.b
        e_half = self.ep_ * self.b
        src = np.empty(2 * e_half, np.int32)
        dst = np.empty(2 * e_half, np.int32)
        for g in range(self.b):
            off_n, off_e = g * self.np_, g * self.ep_
            u = rng.integers(0, self.np_, self.ep_) + off_n
            v = rng.integers(0, self.np_, self.ep_) + off_n
            src[off_e:off_e + self.ep_] = u
            dst[off_e:off_e + self.ep_] = v
            src[e_half + off_e:e_half + off_e + self.ep_] = v
            dst[e_half + off_e:e_half + off_e + self.ep_] = u
        gid = np.repeat(np.arange(self.b, dtype=np.int32), self.np_)
        batch = {
            "src": src, "dst": dst, "graph_id": gid,
            "node_mask": np.ones(n_tot, bool), "n_graphs": self.b,
        }
        if geometric:
            batch["atom_type"] = rng.integers(0, 10, n_tot).astype(np.int32)
            batch["pos"] = rng.normal(size=(n_tot, 3)).astype(np.float32)
            batch["energy"] = rng.normal(size=self.b).astype(np.float32)
        return batch


__all__ = ["lm_token_batches", "recsys_batches", "gnn_batch", "GraphBatcher"]
