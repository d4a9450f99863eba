"""Public kernel ops over the sorted segment-sum (K1), the fused peel edge
stage (K2) and the fused gather-and-segment-sum (K5), and the
vertex-partitioned segment-sum of a mesh's ranks (K1 on each rank).

Edges must be sorted by the segment id for the kernel. ``Graph`` caches a
dst-sorted view (``graphs.graph.Graph.dst_sorted``, uploaded once by
``graphs.convert.to_device``); other callers can pass ``presorted=False``
to sort on the fly. That sort happens inside every such call, so it bumps
``unsorted_fallback_count``: the counter is how a caller notices a hot path
quietly re-sorting every pass.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.embed import segment_embed_sorted
from repro_torch.kernels.peel import peel_edges_sorted
from repro_torch.kernels.ref import segment_sum_ref
from repro_torch.kernels.segsum import segment_sum_sorted

unsorted_fallback_count = 0  # full sorts: presorted=False calls, the GNN forward's edge sort


def segment_sum(
    values: torch.Tensor,
    seg_ids: torch.Tensor,
    *,
    num_segments: int,
    presorted: bool = True,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Deterministic segment-sum; see ``segsum.segment_sum_sorted``."""
    global unsorted_fallback_count
    if not presorted:
        unsorted_fallback_count += 1
        # stable, so equal ids keep their order and float sums stay
        # deterministic; the permutation is int64 because torch.sort makes it so
        seg_ids, order = torch.sort(seg_ids, stable=True)
        values = values.index_select(0, order)
    return segment_sum_sorted(values, seg_ids, num_segments=num_segments,
                              out_dtype=out_dtype)


def peel_update(
    src: torch.Tensor,
    dst: torch.Tensor,
    failed: torch.Tensor,
    *,
    n_nodes: int,
    presorted: bool = True,
) -> torch.Tensor:
    """Paper part 2 (the OpenMP atomicSub loop): per-vertex count of failed
    neighbors, **int32** (the peel recurrence's type). ``src``/``dst`` are
    the symmetric COO lanes (sentinel-padded); for the kernel they must be
    sorted by ``dst`` (``presorted=False`` sorts them first, stably, and
    counts it). The JAX package's contract: every valid lane counts, with no
    live mask; it is K2 with ``active=None``. Exact at any size."""
    global unsorted_fallback_count
    if not presorted:
        unsorted_fallback_count += 1
        dst, order = torch.sort(dst, stable=True)
        src = src.index_select(0, order)
    return peel_edges_sorted(src, dst, None, failed, n_nodes=n_nodes)[0]


def segment_embed(
    table: torch.Tensor,
    gather_ids: torch.Tensor,
    seg_ids: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    num_segments: int,
    presorted: bool = True,
) -> torch.Tensor:
    """Gather + weighted segment-sum: the EmbeddingBag (and, later, GNN
    message passing); see ``embed.segment_embed_sorted``.

        out[s, :] = sum over e with seg_ids[e]==s of weights[e] * table[gather_ids[e], :]

    ``table`` may be [T, R, D] with [T, E] ids, or a [T, E1, E2] view of
    them (one call for all tables, [V, T, D] out). ``presorted=False`` sorts
    the shared ``seg_ids`` once, stably, and carries every table's ids and
    weights along with it."""
    global unsorted_fallback_count
    if not presorted:
        unsorted_fallback_count += 1
        if table.dim() == 3 and gather_ids.dim() == 3:
            gather_ids = gather_ids.reshape(gather_ids.shape[0], -1)
            weights = None if weights is None else weights.reshape(weights.shape[0], -1)
        seg_ids, order = torch.sort(seg_ids, stable=True)
        gather_ids = gather_ids.index_select(-1, order)
        if weights is not None:
            weights = weights.index_select(-1, order)
    return segment_embed_sorted(table, gather_ids, seg_ids, weights,
                                num_segments=num_segments)


# ---------------------------------------------------------------------------
# vertex-partitioned aggregation: with the edge lanes split over a mesh and
# partitioned by dst block (graphs.partition.partition_by_dst_block), each
# rank sums its own lanes onto its own block of output rows, and only the
# ranks holding sub-shards of one block's lanes sum their blocks: a
# [block, D] all-reduce over the sub-axes instead of the whole [N, D].
# ---------------------------------------------------------------------------
_SEG_OUT_HINT: list = []  # stack of (mesh, node axes, min_segments)


@contextlib.contextmanager
def segment_output_sharding(mesh, axes: tuple, min_segments: int = 65536):
    """Within this context, :func:`vp_segment_sum` sums onto ``mesh``'s
    node blocks along ``axes``, and :func:`_hint_active` says which segment
    sums the hint covers (``num_segments >= min_segments`` and a multiple of
    the block count). The JAX package's hint also constrains the output
    sharding of a plain ``segment_sum`` under GSPMD; a rank of the port
    runs its own sums, so there is nothing to constrain.

    ``axes`` go in the mesh's order, the order in which
    ``collective.all_gather`` over them lays the blocks out."""
    if tuple(axes) != mesh.axes_of(axes):
        raise ValueError(f"node axes {tuple(axes)} are not in the mesh's order "
                         f"{mesh.axis_names}")
    _SEG_OUT_HINT.append((mesh, tuple(axes), min_segments))
    try:
        yield
    finally:
        _SEG_OUT_HINT.pop()


def active_sharding():
    """(mesh, node axes, min_segments) of the innermost
    :func:`segment_output_sharding`, or None outside one."""
    return _SEG_OUT_HINT[-1] if _SEG_OUT_HINT else None


def _hint_active(num_segments: int) -> bool:
    if not _SEG_OUT_HINT:
        return False
    mesh, axes, min_seg = _SEG_OUT_HINT[-1]
    return num_segments >= min_seg and num_segments % mesh.axis_size(axes) == 0


class _BlockSum(torch.autograd.Function):
    """A rank's block-local sum of float32 ``vals`` onto ``block`` rows by
    ``rel`` (ids outside ``[0, block)`` dropped): K1 on sorted ``rel`` with
    the kernel on, ``segment_sum_ref`` off. Its backward is the sum's
    transpose, ``g[rel]`` where ``rel`` is a row and zero elsewhere: the
    gradient of the JAX package's ``where(ok) + clip`` sum, and no K1
    backward (K1 has none)."""

    @staticmethod
    def forward(ctx, vals, rel, block, on):
        ctx.save_for_backward(rel)
        ctx.block, ctx.dtype = block, vals.dtype
        vals = vals.detach().float()
        if on:
            return segment_sum_sorted(vals, rel, num_segments=block)
        return segment_sum_ref(vals, rel, block)

    @staticmethod
    def backward(ctx, g):
        (rel,) = ctx.saved_tensors
        ok = (rel >= 0) & (rel < ctx.block)
        gv = g.index_select(0, rel.clamp(0, max(ctx.block - 1, 0)))
        gv = torch.where(ok[:, None], gv, torch.zeros((), dtype=gv.dtype, device=gv.device))
        return gv.to(ctx.dtype), None, None, None


def vp_segment_sum(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int, *,
                   kernel: bool | None = None) -> torch.Tensor:
    """Vertex-partitioned segment-sum over the active
    :func:`segment_output_sharding` hint ``(mesh, node_axes)``: the JAX
    package's ``vp_segment_sum`` in SPMD form.

    ``values`` ([E_r] or [E_r, D]) and ``seg_ids`` ([E_r]) are this rank's
    share of the edge lanes, split over every mesh axis in row-major order
    (the reference's ``P(all_axes)``) after
    ``graphs.partition.partition_by_dst_block``: the lanes of the ranks
    along the node axes target their own block of ``num_segments / n_blocks``
    rows. Returns this rank's block, float32 ``[block]`` or ``[block, D]``:
    its lanes summed onto ``rel = seg_ids - start`` (ids outside the block
    dropped), then summed over the sub-axes, the mesh axes that are not node
    axes (one ``collective.all_reduce_sum``, none where the sub-axes hold
    one rank).

    With the kernel on (``kernel=None``: on for CUDA tensors) the
    block-local sum is K1's ``segment_sum_sorted`` on ``rel``; lanes that do
    not ascend are sorted first, stably, and counted in
    ``unsorted_fallback_count``. With it off, ``segment_sum_ref``.
    Differentiable in ``values``: the gradient of a lane is its row's, with
    no collective (``collective.all_reduce_sum``'s backward is the
    identity)."""
    global unsorted_fallback_count
    from repro_torch.core import collective
    from repro_torch.core.dispatch import resolve_kernel

    if not _SEG_OUT_HINT:
        raise RuntimeError("vp_segment_sum runs inside segment_output_sharding(mesh, axes)")
    mesh, node_axes, _ = _SEG_OUT_HINT[-1]
    sub_axes = tuple(a for a in mesh.axis_names if a not in node_axes)
    block = num_segments // mesh.axis_size(node_axes)
    idx = mesh.axis_index(node_axes)

    squeeze = values.dim() == 1
    vals = values[:, None] if squeeze else values
    on = resolve_kernel(kernel, values.device)
    rel = seg_ids.to(torch.int32) - idx * block
    if on and rel.shape[0] > 1 and bool((rel[1:] < rel[:-1]).any()):
        unsorted_fallback_count += 1
        rel, order = torch.sort(rel, stable=True)
        vals = vals.index_select(0, order)
    out = _BlockSum.apply(vals, rel, block, on)
    if mesh.axis_size(sub_axes) > 1:
        out = collective.all_reduce_sum(out, mesh, sub_axes)
    return out[:, 0] if squeeze else out


__all__ = ["active_sharding", "segment_output_sharding", "segment_sum", "peel_update", "segment_embed",
           "vp_segment_sum"]
