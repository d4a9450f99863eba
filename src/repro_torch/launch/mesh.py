"""Mesh layouts and their helpers (the JAX package's ``launch/mesh.py``).

``dp_axes`` and ``n_devices`` read a mesh's axes: a ``core.collective.Mesh``
of live ranks, or a :class:`MeshLayout`, which names a shape and its axes
with no ranks behind it (the reference's 2 x 4 test mesh, or the 16 x 16
production mesh, described on a box that runs one process). The spec
functions of ``models/transformer.py`` and the ``meta`` of
``launch.steps.build_step`` take either; running a step needs the ranks.
``make_local_mesh`` lays out the current process group (a world of one
without one). ``make_production_mesh`` is the reference's 16 x 16 pod or
2 x 16 x 16 two-pod layout, and ``dry_mesh`` rank 0 of a layout as a
``collective.Mesh`` with no process group, whose collectives count and
communicate nothing (``launch/dryrun.py`` runs each cell's step on it, on
the meta device).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class MeshLayout:
    """A mesh's shape and axis names without ranks: ``shape`` maps each
    axis to its size, as ``Mesh.shape`` does in JAX."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"{self.sizes} does not name one size an axis of "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``MeshLayout`` or a ``collective.Mesh``."""
    if isinstance(mesh, MeshLayout):
        return mesh.shape
    return dict(zip(mesh.axis_names, mesh.shape))


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """16 x 16 single pod (256 chips) or 2 x 16 x 16 two-pod (512 chips)."""
    if multi_pod:
        return MeshLayout((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout((16, 16), ("data", "model"))


def dry_mesh(layout: MeshLayout):
    """Rank 0 of ``layout`` as a dry ``collective.Mesh`` on the meta device:
    no process group; its collectives are counted and return tensors of
    their output's shape."""
    import torch

    from repro_torch.core.collective import Mesh

    return Mesh(group=None, shape=tuple(layout.sizes), axis_names=tuple(layout.axis_names),
                rank=0, size=math.prod(layout.sizes), device=torch.device("meta"), dry=True)


def make_local_mesh(model: int = 1, device=None):
    """The current group's ranks as a ``("data", "model")`` mesh of
    ``(world / model, model)`` (a world of one without a process group).
    ``device`` None means the GPU, and raises without one."""
    import torch.distributed as dist

    from repro_torch.core.distributed import make_mesh

    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n % model:
        raise ValueError(f"{n} ranks do not split into a model axis of {model}")
    return make_mesh((n // model, model), ("data", "model"), device=device)


def dp_axes(mesh) -> tuple[str, ...]:
    """The batch axes of a mesh (everything except 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def n_devices(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


__all__ = ["MeshLayout", "axis_sizes", "dry_mesh", "make_local_mesh", "make_production_mesh",
           "dp_axes", "n_devices"]
