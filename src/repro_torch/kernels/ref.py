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


def peel_update_ref(
    src: torch.Tensor, dst: torch.Tensor, failed: torch.Tensor, n_nodes: int,
) -> torch.Tensor:
    """Paper part 2: delta[v] = # failed neighbors of v (atomicSub analogue),
    int32 (the peel recurrence's type)."""
    src_c = src.clamp(max=n_nodes - 1)
    valid = (src < n_nodes) & (dst < n_nodes)
    vals = failed.index_select(0, src_c) & valid
    return segment_sum_ref(vals, dst, n_nodes, out_dtype=torch.int32)


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


__all__ = ["segment_sum_ref", "peel_update_ref", "prefix_sum_ref",
           "stream_compact_ref"]
