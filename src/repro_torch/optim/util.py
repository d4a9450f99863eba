"""Gradient utilities over a tree of tensors (the JAX package's
``optim/util.py``; leaves in its order, ``utils/tree.py``)."""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, summed leaf by
    leaf in the tree's order (a float32 0-d tensor on the leaves' device)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))


def clip_by_global_norm(tree, max_norm: float):
    """(``tree`` scaled so its global norm is at most ``max_norm``, the norm
    before scaling). Each leaf keeps its dtype."""
    g = global_norm(tree)
    # a true quotient (``scalar / tensor`` is a reciprocal times the scalar)
    scale = torch.clamp(torch.full_like(g, max_norm) / torch.clamp(g, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.to(torch.float32) * scale).to(x.dtype), tree), g


__all__ = ["global_norm", "clip_by_global_norm"]
