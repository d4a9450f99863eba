"""The sharded tier's mesh and its collectives.

A leaf module: ``core/dispatch.py`` sums its per-rank edge stages through
:func:`all_reduce_sum`, ``optim/compress.py`` takes the ranks' max scale
through :func:`all_reduce_max`, ``models/moe.py`` exchanges token replicas
through :func:`all_to_all`, and ``core/distributed.py`` builds meshes and the
sharded entry points on top of them. :func:`all_reduce_sum`,
:func:`all_reduce_max`, :func:`all_gather` and :func:`all_to_all` are the
port's only collective sites (the linter's RPR401). Each call of one counts
once in ``collectives`` and once in ``calls`` under its site's name and the
axes it ran over; a backward that makes a collective counts it the same way.
Where its slice holds more than one rank, it also adds one call and its
output's bytes on this rank to ``traffic`` under its kind, as
``launch/hlo_analysis.py`` names XLA's collectives (``all_reduce_sum`` and
``all_reduce_max``: ``"all-reduce"``, ``all_gather``: ``"all-gather"``,
``all_to_all``: ``"all-to-all"``): the reference's dry run counts "the op's
output shape per device" the same way.

A *dry* mesh (``Mesh(..., dry=True)``, ``launch.mesh.dry_mesh``) stands for
one rank of a layout with no process group behind it: its collectives are
counted as a live mesh's are and return tensors of the right shape on the
input's device (the meta device in ``launch/dryrun.py``), communicating
nothing.

``axes`` names the mesh axes a collective runs over: the ranks that differ
from this one only along those axes (JAX's ``psum(x, axes)`` inside a
``shard_map``). None means every axis. Axes are taken in the mesh's order,
and the ranks of a slice in row-major order over them, as a rank's flat
index is.

The collectives are differentiable, by the rule of Megatron-LM's tensor
parallel regions: every rank backpropagates the loss of the whole step, so
the cotangent of a tensor that every rank of a group holds alike is the same
on every rank of that group.

* :func:`all_reduce_sum` gives every rank of the group the same sum: its
  backward is the identity, each summand's cotangent the sum's.
* :func:`all_gather` hands every rank the same concatenation, which the
  ranks then use each in its own way (a node feature gathered by the edges
  this rank holds): its backward sums the ranks' cotangents and keeps this
  rank's slice (JAX's ``psum_scatter``).
* :func:`all_to_all`'s backward is the same all-to-all, which sends each
  cotangent block back to the rank it came from.
* :func:`sum_grad` is the identity whose backward sums the cotangent over
  ``axes``: for a tensor every rank of those axes holds alike, each using it
  for its own share of the work (``moe_tp``'s tokens through a ``d_ff``
  slice of the experts).
* :func:`split` keeps this rank's block of a tensor every rank of the
  slice holds alike (no collective); its backward gathers the ranks'
  cotangent blocks (one :func:`all_gather`), so that what the tensor fed
  before the split (a sum's summands) gets the whole cotangent. After an
  :func:`all_reduce_sum` it is Megatron's reduce-scatter.
* :func:`all_reduce_max` has no backward.
"""
from __future__ import annotations

import itertools
import math
from collections import Counter
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

collectives = 0  # collective calls over a mesh, whatever their kind
calls: Counter = Counter()  # (site, axes) -> its calls: ("all_to_all", ("model",)) -> 3
# kind -> {"count": calls over more than one rank, "bytes": their output bytes here}
traffic: dict = {}
_KINDS = {"all_reduce_sum": "all-reduce", "all_reduce_max": "all-reduce",
          "all_gather": "all-gather", "all_to_all": "all-to-all"}


@dataclass(frozen=True)
class Mesh:
    """The ranks a tenant's edge lanes, or a layer's tokens and weights,
    are split across.

    ``group`` is the ``torch.distributed`` process group, or None for a world
    of one with no group (JAX's 1-device mesh: its collectives return their
    input). ``shape`` and ``axis_names`` name the ranks' layout, flattened
    row-major: a rank's flat index is its rank in the group. ``device`` is
    where this rank's lanes and the replicated state live. ``subgroups``
    holds, for each set of axes a collective may run over short of the
    whole group, the group of this rank's slice along them
    (``distributed.make_mesh`` builds them). Two meshes over the same group,
    layout and device are equal, so their tenants share a fused bucket.
    ``dry`` marks a mesh with no ranks behind it (module docstring)."""

    group: object
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    rank: int
    size: int
    device: torch.device
    subgroups: dict = field(default_factory=dict, compare=False, repr=False)
    dry: bool = False

    def axes_of(self, axes) -> tuple[str, ...]:
        """``axes`` (a name, a tuple of names, or None for every axis) as a
        tuple in the mesh's order."""
        if axes is None:
            return self.axis_names
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"axes {unknown} are not axes of the mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def coords(self) -> tuple[int, ...]:
        """This rank's index along each axis (its flat index unravelled)."""
        return _unravel(self.rank, self.shape)

    def axis_size(self, axes=None) -> int:
        """The ranks of one slice along ``axes``."""
        return math.prod(self.shape[self.axis_names.index(a)] for a in self.axes_of(axes))

    def axis_index(self, axes=None) -> int:
        """This rank's row-major index within its slice along ``axes``."""
        coords = _unravel(self.rank, self.shape)
        idx = 0
        for a in self.axes_of(axes):
            i = self.axis_names.index(a)
            idx = idx * self.shape[i] + coords[i]
        return idx

    def group_of(self, axes=None):
        """The process group of this rank's slice along ``axes``: None when
        the slice is this rank alone, the mesh's group when it is every
        rank."""
        n = self.axis_size(axes)
        if n == 1:
            return None
        if n == self.size:
            return self.group
        return self.subgroups[self.axes_of(axes)]


def _unravel(flat: int, shape: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(flat % s)
        flat //= s
    return tuple(reversed(out))


def slices(shape: tuple[int, ...], axis_names: tuple[str, ...]):
    """Every set of axes whose slices are neither one rank nor the whole
    mesh, each with its slices as lists of flat indices, in one fixed order
    (by the number of axes, then the axes' positions, then the slices'
    row-major order): the groups every rank creates together."""
    size = math.prod(shape)
    for k in range(1, len(shape)):
        for pick in itertools.combinations(range(len(shape)), k):
            n = math.prod(shape[i] for i in pick)
            if n in (1, size):
                continue
            rest = [i for i in range(len(shape)) if i not in pick]
            members = {}
            for flat in range(size):
                c = _unravel(flat, shape)
                members.setdefault(tuple(c[i] for i in rest), []).append(flat)
            yield (tuple(axis_names[i] for i in pick),
                   [members[key] for key in sorted(members)])


def _count(site: str, mesh: Mesh, axes, out_bytes: int) -> None:
    global collectives
    collectives += 1
    calls[(site, mesh.axes_of(axes))] += 1
    if mesh.axis_size(axes) > 1:
        kind = traffic.setdefault(_KINDS[site], {"count": 0, "bytes": 0})
        kind["count"] += 1
        kind["bytes"] += out_bytes


def _nbytes(t: torch.Tensor, parts: int = 1) -> int:
    return parts * t.numel() * t.element_size()


def _wants_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def all_reduce_sum(t: torch.Tensor, mesh: Mesh | None, axes=None) -> torch.Tensor:
    """``t`` summed over the ranks of this rank's slice along ``axes``
    (None: every rank), counted in ``collectives``. ``t`` itself without a
    mesh (uncounted), or where the slice is this rank alone. Without a
    gradient the sum is written into ``t`` when ``t`` is contiguous.

    Backward: the identity. Every rank of the slice holds the same sum, so
    each backpropagates the same cotangent ``g``, and ``g`` is each
    summand's cotangent; no collective."""
    if mesh is None:
        return t
    if _wants_grad(t):
        return _AllReduceSum.apply(t, mesh, axes)
    _count("all_reduce_sum", mesh, axes, _nbytes(t))
    group = None if mesh.dry else mesh.group_of(axes)
    if group is None:
        return t
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def all_reduce_max(t: torch.Tensor, mesh: Mesh | None, axes=None) -> torch.Tensor:
    """``t``'s elementwise max over the slice along ``axes``, counted in
    ``collectives`` as :func:`all_reduce_sum` is. No backward: ``t`` must
    not require a gradient under grad mode."""
    if mesh is None:
        return t
    if _wants_grad(t):
        raise NotImplementedError("all_reduce_max has no backward")
    _count("all_reduce_max", mesh, axes, _nbytes(t))
    group = None if mesh.dry else mesh.group_of(axes)
    if group is None:
        return t
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def all_gather(t: torch.Tensor, mesh: Mesh | None, axes=None) -> torch.Tensor:
    """The ranks' ``t`` concatenated on dim 0 in their order along ``axes``
    (JAX's ``all_gather(t, axes, tiled=True)``), counted in
    ``collectives``. Where the slice is this rank alone, ``t`` itself.

    Backward: the ranks' cotangents summed (one :func:`all_reduce_sum`) and
    a copy of this rank's slice of the sum kept."""
    if mesh is None:
        return t
    if _wants_grad(t):
        return _AllGather.apply(t, mesh, axes)
    n = mesh.axis_size(axes)
    _count("all_gather", mesh, axes, _nbytes(t, n))
    if n == 1:
        return t
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    if mesh.dry:
        return out
    dist.all_gather_into_tensor(out, t.contiguous(), group=mesh.group_of(axes))
    return out


def all_to_all(t: torch.Tensor, mesh: Mesh | None, axes=None) -> torch.Tensor:
    """Block j of ``t``'s dim 0 to the rank j of this rank's slice along
    ``axes``, and block i of the result from rank i: JAX's
    ``all_to_all(t, axes, split_axis=0, concat_axis=0, tiled=False)``, with
    dim 0 the slice's size. Counted in ``collectives``; ``t`` itself where
    the slice is this rank alone.

    Backward: the same all-to-all, which returns each cotangent block to the
    rank that sent its value."""
    if mesh is None:
        return t
    n = mesh.axis_size(axes)
    if t.shape[0] != n:
        raise ValueError(f"all_to_all over {mesh.axes_of(axes)} needs dim 0 of {n}, "
                         f"got {tuple(t.shape)}")
    if _wants_grad(t):
        return _AllToAll.apply(t, mesh, axes)
    _count("all_to_all", mesh, axes, _nbytes(t))
    group = None if mesh.dry else mesh.group_of(axes)
    if group is None:
        return t if n == 1 or not mesh.dry else torch.empty_like(t)
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def split(t: torch.Tensor, mesh: Mesh | None, axes=None) -> torch.Tensor:
    """This rank's block of ``t``'s dim 0 along ``axes`` (the slice's
    size must divide it): no collective. Backward: the ranks' cotangent
    blocks gathered (one :func:`all_gather`), for a ``t`` every rank of the
    slice holds alike. ``t`` itself where the slice is this rank alone."""
    if mesh is None:
        return t
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    if t.shape[0] % n:
        raise ValueError(f"split over {mesh.axes_of(axes)}: dim 0 of {tuple(t.shape)} does "
                         f"not divide into {n} blocks")
    if _wants_grad(t):
        return _Split.apply(t, mesh, axes)
    rows = t.shape[0] // n
    return t.narrow(0, mesh.axis_index(axes) * rows, rows)


def sum_grad(t: torch.Tensor, mesh: Mesh | None, axes=None) -> torch.Tensor:
    """``t`` itself, whose backward sums the cotangent over ``axes`` (one
    :func:`all_reduce_sum`): for a tensor every rank of those axes holds
    alike and uses for its own share of the work, so that each rank's
    gradient of it is whole."""
    if mesh is None or not _wants_grad(t):
        return t
    return _SumGrad.apply(t, mesh, axes)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return all_reduce_sum(t.clone(memory_format=torch.contiguous_format), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes, ctx.rows = mesh, axes, t.shape[0]
        out = all_gather(t, mesh, axes)
        return out.view_as(out)  # a world of one returns its input

    @staticmethod
    def backward(ctx, g):
        total = all_reduce_sum(g.clone(memory_format=torch.contiguous_format), ctx.mesh,
                               ctx.axes)
        i = ctx.mesh.axis_index(ctx.axes)
        # a copy: a view would hold the whole sum as long as the gradient
        # (a weight gathered whole, |axes| times its own gradient's bytes)
        return total[i * ctx.rows:(i + 1) * ctx.rows].clone(), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        out = all_to_all(t, mesh, axes)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.mesh, ctx.axes), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        rows = t.shape[0] // mesh.axis_size(axes)
        return t.narrow(0, mesh.axis_index(axes) * rows, rows).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.mesh, ctx.axes), None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(memory_format=torch.contiguous_format), ctx.mesh,
                              ctx.axes), None, None


__all__ = ["Mesh", "all_gather", "all_reduce_max", "all_reduce_sum", "all_to_all", "calls",
           "collectives", "slices", "split", "sum_grad", "traffic"]
