"""Density primitives shared by all densest-subgraph algorithms.

Density follows the paper (Definition 1): rho(S) = |E(S)| / |S|.
All device-side helpers operate on the padded symmetric COO lanes produced by
:class:`repro_torch.graphs.Graph` (sentinel vertex = n_nodes, see
graphs/graph.py), as int32 tensors on any device.
"""
from __future__ import annotations

import numpy as np
import torch


def degrees_from_coo(src: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """int32 [n_nodes] degrees from symmetric directed src lanes (padded)."""
    deg = torch.zeros(n_nodes + 1, dtype=torch.int32, device=src.device)
    deg.index_add_(0, src, torch.ones_like(src))
    return deg[:n_nodes]


def masked_degrees(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                   n_nodes: int) -> torch.Tensor:
    """Degrees within the subgraph induced by boolean vertex ``mask``."""
    src_c = src.clamp(max=n_nodes)
    live = (mask.index_select(0, src.clamp(max=n_nodes - 1))
            & mask.index_select(0, dst.clamp(max=n_nodes - 1)))
    live &= (src < n_nodes) & (dst < n_nodes)
    deg = torch.zeros(n_nodes + 1, dtype=torch.int32, device=src.device)
    deg.index_add_(0, src_c, live.to(torch.int32))
    return deg[:n_nodes]


def live_lane_count(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                    n_nodes: int) -> torch.Tensor:
    """int32 count of the lanes with both ends in ``mask``: twice |E(S)| on
    the whole lanes (a sharded caller sums its ranks' counts, then halves)."""
    valid = (src < n_nodes) & (dst < n_nodes)
    live = (valid & mask.index_select(0, src.clamp(max=n_nodes - 1))
            & mask.index_select(0, dst.clamp(max=n_nodes - 1)))
    return live.sum(dtype=torch.int32)


def live_lane_count_rows(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                         n_nodes: int) -> torch.Tensor:
    """``live_lane_count`` of each of G rows (lanes [G, L], masks [G, V]):
    int32 ``[G]``."""
    base = torch.arange(src.shape[0], dtype=src.dtype, device=src.device)[:, None] * n_nodes
    m = mask.reshape(-1)
    live = ((src < n_nodes) & (dst < n_nodes)
            & m.index_select(0, (base + src.clamp(max=n_nodes - 1)).reshape(-1)).view_as(src)
            & m.index_select(0, (base + dst.clamp(max=n_nodes - 1)).reshape(-1)).view_as(src))
    return live.sum(dim=1, dtype=torch.int32)


def induced_edge_count(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                       n_nodes: int) -> torch.Tensor:
    """|E(S)| for S = mask (undirected count), int32 scalar."""
    return live_lane_count(src, dst, mask, n_nodes) // 2


def subgraph_density(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                     n_nodes: int) -> torch.Tensor:
    """rho(S) as float32; 0 for empty S."""
    ne = induced_edge_count(src, dst, mask, n_nodes)
    nv = mask.sum(dtype=torch.int32)
    rho = ne.to(torch.float32) / nv.clamp(min=1).to(torch.float32)
    return torch.where(nv > 0, rho, 0.0)


def density_np(n_edges: int, n_nodes: int) -> float:
    return n_edges / max(n_nodes, 1)


def check_approx_bound(approx: float, exact: float, alpha: float, tol: float = 1e-5) -> bool:
    """Definition 3: alpha-approximation iff rho(S~) >= rho*/alpha."""
    return approx >= exact / alpha - tol


def peel_threshold(n_e: torch.Tensor, n_v: torch.Tensor, eps: float) -> torch.Tensor:
    """Bahmani peeling threshold 2(1+eps)·rho as float32.

    Bit-identical to the JAX package, which evaluates ``2.0 * (1.0 + eps)``
    in Python double and multiplies it, rounded to float32, by the float32
    rho: the constant is rounded to float32 here before the one float32
    multiply, so no step runs wider or fused.
    """
    rho = n_e.to(torch.float32) / n_v.to(torch.float32).clamp(min=1.0)
    return rho * float(np.float32(2.0 * (1.0 + eps)))


__all__ = [
    "degrees_from_coo",
    "masked_degrees",
    "live_lane_count",
    "live_lane_count_rows",
    "induced_edge_count",
    "subgraph_density",
    "density_np",
    "check_approx_bound",
    "peel_threshold",
]
