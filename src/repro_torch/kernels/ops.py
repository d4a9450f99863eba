"""Public kernel ops over the sorted segment-sum (K1), the fused peel edge
stage (K2) and the fused gather-and-segment-sum (K5).

Edges must be sorted by the segment id for the kernel. ``Graph`` caches a
dst-sorted view (``graphs.graph.Graph.dst_sorted``, uploaded once by
``graphs.convert.to_device``); other callers can pass ``presorted=False``
to sort on the fly. That sort happens inside every such call, so it bumps
``unsorted_fallback_count``: the counter is how a caller notices a hot path
quietly re-sorting every pass.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embed import segment_embed_sorted
from repro_torch.kernels.peel import peel_edges_sorted
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


__all__ = ["segment_sum", "peel_update", "segment_embed"]
