"""Plain PyTorch versions of the kernel ops: the targets the kernels are
held against, and what the wrappers run for tensors on the CPU.

Semantics follow the JAX package's ``kernels/ref.py``: segment ids outside
``[0, num_segments)`` (the sentinel padding ``n_nodes`` and negative ids)
contribute nothing, and the output is exactly ``[num_segments, ...]``.
"""
from __future__ import annotations

import torch


def segment_sum_ref(
    values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """out[v] = sum of values[e] over seg_ids[e] == v; other ids dropped.

    Accumulates in ``out_dtype``: float32 (the JAX package's only type), or
    int32 for exact integer counts.
    """
    squeeze = values.dim() == 1
    if squeeze:
        values = values[:, None]
    valid = (seg_ids >= 0) & (seg_ids < num_segments)
    vals = torch.where(valid[:, None], values.to(out_dtype), 0)
    ids = seg_ids.clamp(0, max(num_segments - 1, 0))
    out = torch.zeros((num_segments, vals.shape[1]), dtype=out_dtype,
                      device=values.device)
    out.index_add_(0, ids, vals)
    return out[:, 0] if squeeze else out


def peel_edges_ref(
    src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor | None,
    failed: torch.Tensor, n_nodes: int, charge: bool = False,
) -> tuple[torch.Tensor, ...]:
    """The peel's edge stage over symmetric COO lanes (ids in [0, n_nodes],
    n_nodes the sentinel): a lane is live when both ends are valid and
    active (``active`` None: every vertex), ``fs``/``fd`` when its src/dst
    failed too. Returns int32 ``(delta, removed)``, with ``delta[v]`` the
    ``fs`` lanes onto dst v and ``removed`` the count of ``fs | fd`` lanes;
    with ``charge`` also ``inc[v]``, the lanes onto v that charge their
    dying edge to v (``fd & (~fs | dst < src)``, refinement's loads)."""
    src_c = src.clamp(max=n_nodes - 1)
    dst_c = dst.clamp(max=n_nodes - 1)
    live = (src < n_nodes) & (dst < n_nodes)
    if active is not None:
        live = live & active.index_select(0, src_c) & active.index_select(0, dst_c)
    fail_s = failed.index_select(0, src_c) & live
    fail_d = failed.index_select(0, dst_c) & live
    out = (segment_sum_ref(fail_s, dst, n_nodes, torch.int32),
           (fail_s | fail_d).sum(dtype=torch.int32))
    if not charge:
        return out
    assign_d = fail_d & (~fail_s | (dst_c < src_c))
    return out + (segment_sum_ref(assign_d, dst, n_nodes, torch.int32),)


def segment_sum_rows_ref(
    values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
) -> torch.Tensor:
    """``segment_sum_ref`` of each row: [G, L] bool or int32 values and int32
    ids (each row's ids on their own) onto int32 ``[G, num_segments]``; ids
    outside ``[0, num_segments)`` drop."""
    out = torch.zeros((seg_ids.shape[0], num_segments), dtype=torch.int32,
                      device=seg_ids.device)
    for r in range(seg_ids.shape[0]):
        out[r] = segment_sum_ref(values[r], seg_ids[r], num_segments, torch.int32)
    return out


def peel_edges_rows_ref(
    src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor | None,
    failed: torch.Tensor, n_nodes: int, charge: bool = False,
) -> tuple[torch.Tensor, ...]:
    """``peel_edges_ref`` of each row: [G, L] lanes with [G, n_nodes] vertex
    masks (``active`` None: every vertex). Returns int32 ``(delta [G, V],
    removed [G])``, with ``charge`` also ``inc [G, V]``."""
    rows = [peel_edges_ref(src[r], dst[r], None if active is None else active[r],
                           failed[r], n_nodes, charge) for r in range(src.shape[0])]
    if not rows:
        z = torch.zeros((0, n_nodes), dtype=torch.int32, device=src.device)
        return (z, torch.zeros(0, dtype=torch.int32, device=src.device)) + ((z,) if charge else ())
    return tuple(torch.stack(parts) for parts in zip(*rows))


def peel_update_ref(
    src: torch.Tensor, dst: torch.Tensor, failed: torch.Tensor, n_nodes: int,
) -> torch.Tensor:
    """Paper part 2: delta[v] = # failed neighbors of v (atomicSub analogue),
    int32 (the peel recurrence's type)."""
    return peel_edges_ref(src, dst, None, failed, n_nodes)[0]


def segment_embed_ref(
    table: torch.Tensor, gather_ids: torch.Tensor, seg_ids: torch.Tensor,
    weights: torch.Tensor | None, num_segments: int,
) -> torch.Tensor:
    """out[s] = sum_e w[e] * table[gather_ids[e]] over seg_ids[e] == s.

    ``table`` [R, D] with ``gather_ids`` (and ``weights``) [E] gives [V, D];
    the batched form, [T, R, D] tables with [T, E] ids (or a [T, E1, E2]
    view, flattened here to [T, E1 * E2] row-major, as the kernel reads it)
    and one shared ``seg_ids`` [E], gives [V, T, D] (table t's sums at
    ``out[:, t]``). As the
    JAX package's ``segment_embed_ref``: gather ids are clamped to R - 1, rows
    whose id is outside [0, R) are zeroed after the weights are applied,
    segment ids outside [0, V) drop, and the sums are float32.
    """
    single = table.dim() == 2
    if single:
        table, gather_ids = table[None], gather_ids[None]
        weights = None if weights is None else weights[None]
    elif gather_ids.dim() == 3:
        gather_ids = gather_ids.reshape(gather_ids.shape[0], -1)
        weights = None if weights is None else weights.reshape(weights.shape[0], -1)
    n_tables, n_rows, d = table.shape
    ids = gather_ids.long().clamp(0, max(n_rows - 1, 0))
    rows = table[torch.arange(n_tables, device=table.device)[:, None], ids].float()
    if weights is not None:
        rows = rows * weights[..., None].float()
    valid = (gather_ids >= 0) & (gather_ids < n_rows)
    rows = torch.where(valid[..., None], rows, 0.0)               # [T, E, D]
    lanes = rows.permute(1, 0, 2).reshape(seg_ids.shape[0], n_tables * d)
    out = segment_sum_ref(lanes, seg_ids, num_segments).view(num_segments, n_tables, d)
    return out[:, 0] if single else out


def prefix_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D bool or int32 tensor, int32 out."""
    return torch.cumsum(x, 0, dtype=torch.int32)


def stream_compact_ref(
    values: torch.Tensor, live: torch.Tensor, out_size: int, fill: int,
) -> torch.Tensor:
    """``full(out_size, fill)`` with ``out[cumsum(live) - 1] = values[live]``
    for int32 ``[E]`` or ``[E, D]`` values; survivors past ``out_size``
    drop."""
    out = torch.full((out_size,) + tuple(values.shape[1:]), fill,
                     dtype=torch.int32, device=values.device)
    pos = prefix_sum_ref(live) - 1
    keep = live & (pos < out_size)
    out.index_put_((pos[keep].long(),), values[keep])
    return out


__all__ = ["segment_sum_ref", "segment_sum_rows_ref", "peel_edges_ref",
           "peel_edges_rows_ref", "peel_update_ref",
           "segment_embed_ref", "prefix_sum_ref", "stream_compact_ref"]
