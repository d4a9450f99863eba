"""Deterministic synthetic data pipelines, produced on the host in numpy.

``recsys_batches`` is a copy of the JAX package's ``data/pipeline.py``
generator: the same arrays for the same config, batch and seed. The LM
token stream and the GNN batches come with their slices (ROADMAP.md section
1, item 13).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


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


__all__ = ["recsys_batches"]
