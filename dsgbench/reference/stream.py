"""A tenant's edge set under the stream's semantics, in plain NumPy, and the
cold peel of it that every answer of the service is held to.

An event batch is applied as the service states it: each pair taken as
the undirected edge (min, max), self-loops dropped; the deletes first
(absent edges ignored), then the inserts that are not present (repeats
ignored).
"""
from __future__ import annotations

import numpy as np

from dsgbench.reference.peel import pbahmani_ref


def edge_keys(pairs, n: int) -> np.ndarray:
    """Sorted unique int64 keys ``u * n + v`` (``u < v``) of the edges among
    ``pairs`` ([k, 2] or None)."""
    if pairs is None:
        return np.zeros(0, dtype=np.int64)
    p = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    u, v = np.minimum(p[:, 0], p[:, 1]), np.maximum(p[:, 0], p[:, 1])
    keep = u != v
    return np.unique(u[keep] * n + v[keep])


class EdgeSet:
    """One tenant's edges on ``n`` vertices, as sorted keys."""

    def __init__(self, n: int, seed_pairs=None):
        self.n = int(n)
        self.keys = edge_keys(seed_pairs, self.n)

    def _found(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Where ``keys`` would sit in the set, and which of them are in it."""
        pos = np.searchsorted(self.keys, keys)
        found = np.zeros(keys.size, dtype=bool)
        inside = pos < self.keys.size
        found[inside] = self.keys[pos[inside]] == keys[inside]
        return pos, found

    def apply(self, insert=None, delete=None) -> None:
        pos, found = self._found(edge_keys(delete, self.n))
        self.keys = np.delete(self.keys, pos[found])
        keys = edge_keys(insert, self.n)
        pos, found = self._found(keys)
        self.keys = np.insert(self.keys, pos[~found], keys[~found])

    def lanes(self) -> tuple[np.ndarray, np.ndarray]:
        """Symmetric directed lanes ``(src, dst)``, each edge twice."""
        u, v = self.keys // self.n, self.keys % self.n
        return np.concatenate([u, v]), np.concatenate([v, u])

    def cold_peel(self, eps: float, precision: str = "float32"):
        """``(density, mask, passes)`` of P-Bahmani from scratch."""
        src, dst = self.lanes()
        return pbahmani_ref(self.n, src, dst, eps, precision)


__all__ = ["edge_keys", "EdgeSet"]
