"""The Graph500 Kronecker generator (graph500.org, Benchmark 1,
``kronecker_generator.m``), drawn on the device with a ``torch.Generator``.

Each of ``edgefactor * 2**scale`` edges picks one quadrant a bit level,
with the initiator probabilities A, B, C, D; the vertex labels are then
permuted by a random permutation, as the specification's generator does.
Kernel 1's cleaning follows, as ``Graph.from_edges`` does it: self-loops and
duplicate pairs dropped, each pair stored as (min, max) in lexicographic
order, the lanes symmetrised (``src = [u | v]``, ``dst = [v | u]``) and
padded to a multiple of 256 with the sentinel vertex ``n``.

The edge draw takes ``graph_seed`` from the configuration and the label
permutation takes the run's seed: every seed peels the same graph, whose
work (passes, levels, fixpoint iterations) does not change, under other
labels and so another lane order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PAD_MULTIPLE = 256


@dataclass(frozen=True)
class GraphLanes:
    """A cleaned graph as host arrays: ``u < v`` pairs in lexicographic
    order, and the padded symmetric int32 lanes built from them."""

    n_nodes: int
    n_edges: int
    u: np.ndarray        # int32 [n_edges]
    v: np.ndarray        # int32 [n_edges]
    src: np.ndarray      # int32 [padded], sentinel n_nodes past 2 * n_edges
    dst: np.ndarray      # int32 [padded]

    @property
    def n_directed(self) -> int:
        return 2 * self.n_edges


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def kronecker_pairs(scale: int, edgefactor: int, a: float, b: float, c: float,
                    gen: torch.Generator, device) -> torch.Tensor:
    """int64 ``[2, edgefactor * 2**scale]`` endpoints before cleaning and
    before the label permutation."""
    m = edgefactor << scale
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ij = torch.zeros(2, m, dtype=torch.int64, device=device)
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        thr = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(m, generator=gen, device=device) > thr
        ij[0] += ii.to(torch.int64) << bit
        ij[1] += jj.to(torch.int64) << bit
    return ij


def clean(n: int, ends: torch.Tensor) -> GraphLanes:
    """Kernel 1's cleaning of int64 ``[2, m]`` endpoints, on their device,
    then one copy to the host."""
    u = torch.minimum(ends[0], ends[1])
    v = torch.maximum(ends[0], ends[1])
    keep = u != v
    keys = torch.unique(u[keep] * n + v[keep], sorted=True)
    m = int(keys.numel())
    u, v = (keys // n).to(torch.int32), (keys % n).to(torch.int32)
    padded = max(-(-2 * m // PAD_MULTIPLE) * PAD_MULTIPLE, PAD_MULTIPLE)
    src = torch.full((padded,), n, dtype=torch.int32, device=ends.device)
    dst = torch.full((padded,), n, dtype=torch.int32, device=ends.device)
    src[:m], src[m:2 * m] = u, v
    dst[:m], dst[m:2 * m] = v, u
    return GraphLanes(n_nodes=n, n_edges=m, u=u.cpu().numpy(), v=v.cpu().numpy(),
                      src=src.cpu().numpy(), dst=dst.cpu().numpy())


def graph500(cfg: dict, seed: int, device) -> GraphLanes:
    """The configuration's Kronecker graph with labels permuted by ``seed``."""
    if abs(cfg["A"] + cfg["B"] + cfg["C"] + cfg["D"] - 1.0) > 1e-9:
        raise ValueError("the initiator's A, B, C and D must sum to 1")
    n = 1 << int(cfg["scale"])
    ends = kronecker_pairs(int(cfg["scale"]), int(cfg["edgefactor"]), float(cfg["A"]),
                           float(cfg["B"]), float(cfg["C"]),
                           generator(cfg["graph_seed"], device), device)
    perm = torch.randperm(n, generator=generator(seed, device), device=device)
    return clean(n, perm[ends])


__all__ = ["GraphLanes", "PAD_MULTIPLE", "generator", "kronecker_pairs", "clean", "graph500"]
