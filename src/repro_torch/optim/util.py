"""Gradient utilities over a tree of tensors (the JAX package's
``optim/util.py``; leaves in its order, ``utils/tree.py``)."""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def global_norm(tree, layout=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, summed leaf by
    leaf in the tree's order (a float32 0-d tensor on the leaves' device).

    ``layout`` ``(mesh, specs)``: ``tree`` is a dict of this rank's slices,
    ``specs`` their specs by the same keys. Each leaf counts once: the
    slices' sums of squares summed over the axes their spec names (one
    ``collective.all_reduce_sum`` for each set of axes), a whole leaf's
    taken as it is; the norm is the same on every rank."""
    if layout is None:
        leaves = tree_leaves(tree)
        if not leaves:
            return torch.zeros((), dtype=torch.float32)
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))
    from repro_torch.core import collective
    from repro_torch.models.shard import spec_axes

    mesh, specs = layout
    by_axes: dict = {}
    for name in sorted(tree):
        axes = mesh.axes_of(spec_axes(specs[name]))
        by_axes.setdefault(axes, []).append(torch.sum(torch.square(tree[name].to(torch.float32))))
    total = None
    for axes, parts in by_axes.items():
        part = sum(parts)
        if axes:
            part = collective.all_reduce_sum(part, mesh, axes)
        total = part if total is None else total + part
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """(``tree`` scaled so its global norm is at most ``max_norm``, the norm
    before scaling). Each leaf keeps its dtype."""
    g = global_norm(tree)
    # a true quotient (``scalar / tensor`` is a reciprocal times the scalar)
    scale = torch.clamp(torch.full_like(g, max_norm) / torch.clamp(g, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.to(torch.float32) * scale).to(x.dtype), tree), g


__all__ = ["global_norm", "clip_by_global_norm"]
