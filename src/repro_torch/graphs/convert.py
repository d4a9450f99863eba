"""Carrying a graph onto the device.

The graph is this system's counterpart of a model's weights: built once on
the host, uploaded once, then read by every pass. ``to_device`` caches each
upload on the graph itself, keyed by device and lane layout, so no pass ever
re-uploads or re-sorts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.graph import Graph


def graph_from_arrays(n_nodes: int, n_edges: int, src, dst, n_directed: int) -> Graph:
    """Build a :class:`Graph` from another graph container's fields.

    Takes the five fields of the JAX package's ``Graph`` (or any object with
    the same layout: int32 symmetric COO, sentinel ``n_nodes`` padding), so
    state moves across without this package importing that one.
    """
    return Graph(
        n_nodes=int(n_nodes),
        n_edges=int(n_edges),
        src=np.asarray(src, dtype=np.int32),
        dst=np.asarray(dst, dtype=np.int32),
        n_directed=int(n_directed),
    )


def prune_plan_from_fields(**fields):
    """Build the port's ``core.prune.PrunePlan`` from another plan's fields
    (for example ``dataclasses.asdict`` of the JAX package's plan), so a
    plan sized elsewhere drives the port's bucket peel."""
    from repro_torch.core.prune import PrunePlan

    return PrunePlan(**fields)


def to_device(
    graph: Graph, device: torch.device | str, sorted: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 ``(src, dst)`` lanes of ``graph`` on ``device``, uploaded once.

    ``sorted=True`` gives the dst-sorted view (``Graph.dst_sorted``), the
    layout the sorted segment-sum kernel needs; ``False`` the construction
    order. Each (device, layout) pair is uploaded on first use and cached on
    the graph.
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cache = getattr(graph, "_device_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(graph, "_device_cache", cache)
    key = (device, bool(sorted))
    if key not in cache:
        src, dst = graph.dst_sorted() if sorted else (graph.src, graph.dst)
        cache[key] = (torch.from_numpy(np.ascontiguousarray(src)).to(device),
                      torch.from_numpy(np.ascontiguousarray(dst)).to(device))
    return cache[key]


__all__ = ["graph_from_arrays", "prune_plan_from_fields", "to_device"]
