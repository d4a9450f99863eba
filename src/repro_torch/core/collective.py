"""The sharded tier's mesh and its collectives.

A leaf module: ``core/dispatch.py`` sums its per-rank edge stages through
:func:`all_reduce_sum`, ``optim/compress.py`` takes the ranks' max scale
through :func:`all_reduce_max`, and ``core/distributed.py`` builds meshes and
the sharded entry points on top of them. These two functions are the port's
only collective sites (the linter's RPR401), and both count their calls in
``collectives``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

collectives = 0  # all_reduce_sum and all_reduce_max calls over a mesh: the collectives made


@dataclass(frozen=True)
class Mesh:
    """The ranks a tenant's edge lanes are split across.

    ``group`` is the ``torch.distributed`` process group, or None for a world
    of one with no group (JAX's 1-device mesh: its all-reduce returns its
    input). ``shape`` and ``axis_names`` name the ranks' layout, flattened
    row-major: a rank's flat index is its rank in the group. ``device`` is
    where this rank's lanes and the replicated state live. Two meshes over
    the same group, layout and device are equal, so their tenants share a
    fused bucket."""

    group: object
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    rank: int
    size: int
    device: torch.device


def all_reduce_sum(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``t`` summed over the mesh's ranks: the site of the sharded paths that
    makes a collective, counted in ``collectives``. ``t`` itself without a
    mesh (uncounted) or for a world of one with no group."""
    global collectives
    if mesh is None:
        return t
    collectives += 1
    if mesh.group is None:
        return t
    t = t.contiguous()
    dist.all_reduce(t, group=mesh.group)
    return t


def all_reduce_max(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``t``'s elementwise max over the mesh's ranks, counted in
    ``collectives`` as :func:`all_reduce_sum` is."""
    global collectives
    if mesh is None:
        return t
    collectives += 1
    if mesh.group is None:
        return t
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t


__all__ = ["Mesh", "all_reduce_max", "all_reduce_sum", "collectives"]
