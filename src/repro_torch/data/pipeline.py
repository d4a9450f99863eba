"""Deterministic synthetic data pipelines, produced on the host in numpy.

``lm_token_batches`` and ``recsys_batches`` are copies of the JAX package's
``data/pipeline.py`` generators: the same arrays for the same arguments and
seed. Each is an infinite iterator whose step k's batch depends on k alone,
so a checkpoint restart resumes the stream exactly (``launch/train.py``).
The GNN batches come with their slice (ROADMAP.md section 1, item 6c).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


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


__all__ = ["lm_token_batches", "recsys_batches"]
