"""Distributed densest-subgraph engine: SPMD ranks over an edge-sharded mesh.

The pod-scale form of the paper's shared-memory algorithm: the edge lanes
are split across the ranks of a ``torch.distributed`` group, one process a
rank; the |V|-sized degree and mask state is replicated. One peeling pass is

    per rank     local_delta[v] = sum over this rank's lanes (u,v) of failed[u]
    all ranks    delta = all_reduce(local_delta)     <- the paper's atomicSub
    replicated   deg' = deg - delta; masks, counts, density bookkeeping

i.e. the paper's part-1/part-2 split with the barrier realized as one
all-reduce. The same engine runs P-Bahmani (threshold = 2(1+eps)·rho), the
PKC level fixpoint of CBDS-P, the pruned bucket peel and the Greedy++
refinement rounds: every pass of them takes a ``mesh`` and routes its edge
stage through ``core/dispatch.py`` (``peel_edges(..., mesh=)``), which runs
this rank's stage (K2 with the kernel on) and makes the pass's one
collective, ``collective.all_reduce_sum`` of ``delta`` and ``removed`` packed as
int32 ``[V + 1]`` (``[G, V + 1]`` for a bucket of G tenants). Every sum is
int32, so the results equal the single-device peel's bit for bit on any
rank count.

Every loop condition (``n_v > 0``, the level fixpoint's ``any``, the bucket
ladder's fit test) is read from replicated or all-reduced state, so every
rank makes the same collectives in the same order; a condition read from a
rank's own lanes would deadlock the group.

This is the JAX package's ``core/distributed.py`` with the roles of its
``shard_map``/``psum`` and ``utils/compat.py:make_mesh_auto`` taken by
:class:`Mesh`, :func:`make_mesh` and ``collective.all_reduce_sum``. The JAX package
runs one program that places shards on devices; here every rank is a
process that runs the same code on its own block of lanes. Its per-shard
pass bodies (``_local_delta``/``_peel_pass_body``, ``make_kcore_level``,
``_warm_peel_shard_body`` and its vmapped form, the sharded refine and
bucket-peel rounds) are the single-device bodies here, called with
``mesh=``: ``pbahmani_pass``, ``kcore._level_fixpoint``,
``delta._warm_peel``/``_batched_warm_peel``, ``loads.refine_pass`` and
``prune._bucket_peel``. The JAX package's psums that only move a count
(the warm-mask and legit-pair edge counts) are ``all_reduce_sum`` calls
too.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.cbds import _cbds
from repro_torch.core.collective import Mesh, slices
from repro_torch.core.dispatch import (
    assert_exact_envelope, lane_degrees, resolve_device, resolve_kernel,
)
from repro_torch.core.pbahmani import pbahmani_pass, state_from_degrees
from repro_torch.graphs.graph import Graph

def make_mesh(shape: tuple[int, ...] | None = None, axis_names: tuple[str, ...] = ("shard",),
              group=None, device: torch.device | str | None = None) -> Mesh:
    """The mesh of ``group`` (None: the default group when
    ``torch.distributed`` is initialized, else a world of one with no group).

    ``shape`` defaults to one flat axis over every rank and must multiply
    out to the group's size. ``device=None`` means ``cuda:{rank %
    device_count}`` and raises where there is no CUDA, as every entry point
    does; pass ``device="cpu"`` for the plain PyTorch path (gloo). Every
    rank of the group calls this together.

    A mesh of more than one axis also gets a group for each slice along
    each set of axes short of the whole mesh (the ``"model"`` ranks {0, 1}
    and {2, 3} of a ``(2, 2)`` mesh over ``("data", "model")``), for the
    collectives over sub-axes. Every rank creates every one of them, in one
    fixed order (``collective.slices``), as ``torch.distributed.new_group``
    asks of every process of the job: such a mesh's group must be the
    default group. The groups are made once for a layout of the default
    group, so two meshes over them share them (and compare equal)."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    rank = dist.get_rank(group) if group is not None else 0
    size = dist.get_world_size(group) if group is not None else 1
    if device is None:
        resolve_device(None)  # raises without CUDA
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = _indexed(device)
    shape = (size,) if shape is None else tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names) or math.prod(shape) != size:
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does not lay out "
                         f"{size} ranks")
    return Mesh(group=group, shape=shape, axis_names=axis_names, rank=rank, size=size,
                device=device, subgroups=_subgroups(group, shape, axis_names, rank))


_SUBGROUPS: dict = {}  # (shape, axis names) -> {axes: this rank's slice group}
_subgroups_of = None  # the group whose slices _SUBGROUPS holds


def _subgroups(group, shape: tuple[int, ...], axis_names: tuple[str, ...], rank: int) -> dict:
    """This rank's sub-axis groups of ``group``'s ``shape`` layout, made on
    the first call and cached for that group only: a mesh over another
    group (a new default group after ``destroy_process_group``) empties the
    cache, so it keeps no destroyed job's groups past the next mesh."""
    global _subgroups_of
    plan = list(slices(shape, axis_names))
    if group is None or not plan:
        return {}
    if dist.get_world_size(group) != dist.get_world_size():
        raise ValueError("a mesh with sub-axes needs the default group: every process "
                         "of the job creates the sub-axis groups together")
    if _subgroups_of is not group:
        _SUBGROUPS.clear()
        _subgroups_of = group
    key = (shape, axis_names)
    if key not in _SUBGROUPS:
        backend = dist.get_backend(group)
        out = {}
        for axes, members in plan:
            for ranks in members:
                sub = dist.new_group(ranks, backend=backend)
                if rank in ranks:
                    out[axes] = sub
        _SUBGROUPS[key] = out
    return _SUBGROUPS[key]


def _indexed(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def mesh_device(mesh, device) -> torch.device:
    """The device of a call given ``mesh`` and ``device``: the mesh's (then
    ``device`` must be None or the same), else ``resolve_device(device)``."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and _indexed(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
    return mesh.device


def mesh_device_count(mesh) -> int:
    return math.prod(mesh.shape)


def validate_stream_mesh(mesh, capacity: int) -> int:
    """The sharded streaming engine partitions pow-2 slot spaces, so the
    rank count must be a power of two that divides every shard target (edge
    lanes 2*capacity, update batches, prune buckets)."""
    n_dev = mesh_device_count(mesh)
    if n_dev & (n_dev - 1):
        raise ValueError(
            f"sharded streaming needs a power-of-two device count, got {n_dev}")
    if n_dev > 2 * capacity:
        raise ValueError(
            f"mesh has {n_dev} devices but the buffer exposes only "
            f"{2 * capacity} edge lanes; raise the edge capacity")
    return n_dev


def lane_block(a, mesh: Mesh):
    """This rank's contiguous block of a lane array (numpy or torch, the lane
    axis last) whose width the rank count divides: block r for the rank whose
    flat (row-major) index in ``mesh.shape`` is r, its rank in the group."""
    width = a.shape[-1] // mesh.size
    return a[..., mesh.rank * width:(mesh.rank + 1) * width]


def shard_edges(graph: Graph, mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's block of the graph's dst-sorted lanes, sentinel-padded to
    a multiple of the rank count, on the mesh's device (cached on the
    graph). A block of dst-sorted lanes is dst-sorted, so K1 and K2 run on
    it as they do on the whole graph."""
    cache = getattr(graph, "_device_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(graph, "_device_cache", cache)
    key = ("shard", mesh.device, mesh.rank, mesh.size)
    if key not in cache:
        src, dst = graph.dst_sorted()
        pad = np.full((-src.shape[0]) % mesh.size, graph.n_nodes, np.int32)
        cache[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(lane_block(np.concatenate([a, pad]), mesh)))
            .to(mesh.device) for a in (src, dst))
    return cache[key]


def pbahmani_distributed(graph: Graph, mesh: Mesh | None = None, eps: float = 0.0,
                         max_passes: int | None = None, kernel: bool | None = None
                         ) -> tuple[float, np.ndarray, int]:
    """P-Bahmani over the mesh's ranks, every rank calling it with the same
    graph: the triple of ``core.pbahmani``, bit for bit. The degrees are
    ``lane_degrees`` of this rank's block (K1 with the kernel on) and one
    all-reduce; each pass is one edge stage (K2) and one all-reduce.
    ``mesh=None`` means ``make_mesh()`` (the default group on the GPU; it
    raises where there is none); ``kernel=None`` means on for a CUDA
    device."""
    mesh = make_mesh() if mesh is None else mesh
    kernel = resolve_kernel(kernel, mesh.device)
    if graph.n_nodes == 0:
        return 0.0, np.zeros(0, dtype=bool), 0
    if kernel:
        assert_exact_envelope(graph.src.shape[0], graph.n_nodes)
    src, dst = shard_edges(graph, mesh)
    n = graph.n_nodes
    state = state_from_degrees(lane_degrees(src, dst, n, kernel, mesh), graph.n_edges)
    cap = float("inf") if max_passes is None else int(max_passes)
    while True:
        # repro: allow RPR101 -- the one host sync of each pass, on replicated counts
        n_v, passes = torch.stack([state.n_v, state.passes]).tolist()
        if not (n_v > 0 and passes < cap):
            break
        state = pbahmani_pass(state, src, dst, n, float(eps), kernel, mesh)
    return float(state.best_density), state.best_mask.cpu().numpy(), int(state.passes)


def cbds_distributed(graph: Graph, mesh: Mesh | None = None, rounds: int = 1,
                     kernel: bool | None = None) -> dict:
    """CBDS-P (phases 1 and 2) over the mesh's ranks: the dict of the JAX
    package's ``cbds_distributed``, ``coreness`` included. The degrees are
    ``lane_degrees`` and one all-reduce, every fixpoint iteration one edge
    stage and one all-reduce, every augmentation round two (``e_into``
    summed onto dst by the mirror identity, then the legit pairs). ``mesh``
    and ``kernel`` resolve as in :func:`pbahmani_distributed`."""
    mesh = make_mesh() if mesh is None else mesh
    kernel = resolve_kernel(kernel, mesh.device)
    src, dst = shard_edges(graph, mesh)
    core, member, density, n_legit = _cbds(src, dst, graph.n_nodes, graph.n_edges,
                                           rounds, kernel, mesh)
    return {
        "density": float(density),
        "core_density": float(core.best_density),
        "k_star": int(core.best_k),
        "member_mask": member.cpu().numpy(),
        "coreness": core.coreness.cpu().numpy(),
        "n_legit": int(n_legit),
    }


__all__ = ["Mesh", "make_mesh", "mesh_device", "mesh_device_count",
           "validate_stream_mesh", "lane_block", "shard_edges",
           "pbahmani_distributed", "cbds_distributed"]
