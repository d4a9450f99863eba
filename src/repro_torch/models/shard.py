"""A rank's shards of tensors laid out by a spec over a mesh.

A spec is the port's form of JAX's ``PartitionSpec``: a tuple with one entry
a dimension, each None (whole), an axis name, or a tuple of axis names (the
dimension split over their ranks, the first axis major); missing trailing
entries are None. A rank's shard of a dimension split over axes ``A`` is
block ``i`` of ``prod(|A|)`` equal blocks, ``i`` its row-major index along
``A``. The port keeps the axes of a dimension in the mesh's order, the
order in which ``collective.all_gather`` over them lays blocks out.

:func:`local_slice` cuts a whole array (numpy or tensor) to a rank's shard;
:func:`gather` puts shards back together over some or all of their axes
(``collective.all_gather``, differentiable); :func:`gather_dim` and
:func:`split_dim` gather and split one dimension.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import collective


def norm_spec(spec, ndim: int) -> tuple[tuple[str, ...], ...]:
    """``spec`` with each entry a tuple of axis names (``()`` for None),
    padded to ``ndim`` entries."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dimensions")
    out = []
    for entry in spec + (None,) * (ndim - len(spec)):
        if entry is None:
            out.append(())
        elif isinstance(entry, str):
            out.append((entry,))
        else:
            out.append(tuple(entry))
    return tuple(out)


def spec_axes(spec) -> tuple[str, ...]:
    """Every axis a spec names, in the order it names them."""
    return tuple(a for entry in norm_spec(spec, len(tuple(spec))) for a in entry)


def _sizes(mesh) -> dict:
    from repro_torch.launch.mesh import axis_sizes

    return axis_sizes(mesh)


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape of a rank's shard of a ``shape`` array (every split even)."""
    sizes = _sizes(mesh)
    out = []
    for n, axes in zip(shape, norm_spec(spec, len(shape))):
        k = math.prod(sizes[a] for a in axes)
        if n % k:
            raise ValueError(f"dimension {n} of {tuple(shape)} does not split into {k} "
                             f"equal blocks over {axes} (spec {tuple(spec)})")
        out.append(n // k)
    return tuple(out)


def _in_mesh_order(mesh, axes: tuple[str, ...]) -> None:
    if axes != mesh.axes_of(axes):
        raise ValueError(f"axes {axes} are not in the mesh's order {mesh.axis_names}")


def local_slice(a, spec, mesh):
    """A rank's shard of the whole array ``a`` (numpy: a view; a tensor: a
    ``narrow`` view) by ``spec`` over ``mesh`` (a ``collective.Mesh``)."""
    shape = tuple(a.shape)
    local = local_shape(shape, spec, mesh)
    for dim, axes in enumerate(norm_spec(spec, len(shape))):
        if not axes:
            continue
        _in_mesh_order(mesh, axes)
        w = local[dim]
        start = mesh.axis_index(axes) * w
        if isinstance(a, torch.Tensor):
            a = a.narrow(dim, start, w)
        else:
            a = a[(slice(None),) * dim + (slice(start, start + w),)]
    return a


def gather_dim(t: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """``t``'s blocks along ``dim`` from the ranks of ``axes``, concatenated
    in their order (``collective.all_gather``; backward: the summed
    cotangents' own block)."""
    if mesh.axis_size(axes) == 1:
        return t
    if dim == 0:
        return collective.all_gather(t, mesh, axes)
    out = collective.all_gather(t.movedim(dim, 0).contiguous(), mesh, axes)
    return out.movedim(0, dim)


def split_dim(t: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over ``axes``
    (``collective.split``; backward: the ranks' cotangent blocks gathered)."""
    if mesh.axis_size(axes) == 1:
        return t
    if dim == 0:
        return collective.split(t, mesh, axes)
    return collective.split(t.movedim(dim, 0), mesh, axes).movedim(0, dim)


def gather(t: torch.Tensor, spec, mesh, axes=None) -> torch.Tensor:
    """``t`` (a rank's shard by ``spec``) gathered over ``axes`` (None:
    every axis the spec names), dimension by dimension. A dimension split
    over axes of which only some are gathered keeps the others' split."""
    want = None if axes is None else set(axes)
    for dim, names in enumerate(norm_spec(spec, t.dim())):
        pick = tuple(a for a in names if want is None or a in want)
        if not pick:
            continue
        if pick != names[len(names) - len(pick):]:
            raise ValueError(f"cannot gather {pick} alone out of {names}: only the minor "
                             f"axes of a dimension gather into contiguous blocks")
        t = gather_dim(t, dim, mesh, pick)
    return t


__all__ = ["norm_spec", "spec_axes", "local_shape", "local_slice", "gather", "gather_dim",
           "split_dim"]
