"""The sharded tier's mesh and its one collective.

A leaf module: ``core/dispatch.py`` sums its per-rank edge stages through
:func:`all_reduce_sum`, and ``core/distributed.py`` builds meshes and the
sharded entry points on top of both.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

collectives = 0  # all_reduce_sum calls over a mesh: the collectives the sharded paths make


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
    """``t`` summed over the mesh's ranks: the one site of the sharded paths
    that makes a collective, counted in ``collectives``. ``t`` itself
    without a mesh (uncounted) or for a world of one with no group."""
    global collectives
    if mesh is None:
        return t
    collectives += 1
    if mesh.group is None:
        return t
    t = t.contiguous()
    dist.all_reduce(t, group=mesh.group)
    return t


__all__ = ["Mesh", "all_reduce_sum", "collectives"]
