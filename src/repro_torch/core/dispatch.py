"""Device and kernel-tier dispatch for the peel hot loop.

Every peel-family pass runs the same edge stage: mark the live lanes,
gather which of their ends failed, reduce the failed-src lanes onto their
destination vertex (the paper's part-2 atomicSub) and count the dying
lanes. Two implementations:

  * **scatter** — elementwise ops and gathers over the lanes, then int32
    ``index_add_`` over ``n_nodes + 1`` segments with the sentinel row
    dropped, on any device;
  * **kernel** — the fused edge-stage kernel K2
    (``kernels.peel.peel_edges_sorted``) for the pass, the sorted
    segment-sum K1 (``kernels.ops.segment_sum``) for a lone reduction: the
    CUDA kernels on a CUDA tensor, their plain versions on a CPU tensor.
    They need dst-sorted lanes, which ``graphs.convert.to_device``
    supplies.

:func:`peel_edges` is the single switch point ``pbahmani_pass``,
``kcore._level_fixpoint`` and ``refine_pass`` route through;
:func:`peel_delta` reduces one per-lane boolean. :func:`peel_edges_rows`
and :func:`lane_degrees_rows` are their row-batched twins for G independent
peels ([G, L] lanes, [G, V] vertices: the fused tenants' batched passes),
one launch of K2's or K1's rows entry with the kernel on. Both paths count in int32,
so (density, mask, passes) triples match bit for bit with the knob on or
off. The kernels' int32 sums are exact at any size; the 2^24 envelope of
the JAX kernel's float32 sums is still asserted at the same API points, so
both packages accept and refuse the same graphs.

Every reduction here takes ``mesh`` (``core.collective.Mesh``): the lanes
are then this rank's block of a sharded graph, and the per-rank sums are
summed over the mesh by ``collective.all_reduce_sum``, one collective a
call. A pass's ``delta``, ``removed`` and ``inc`` go together, int32 ``[V +
1]`` (``[2V + 1]`` with the charges; ``[G, ...]`` for the rows entries).
"""
from __future__ import annotations

import torch

from repro_torch.core import collective
from repro_torch.core.density import degrees_from_coo
from repro_torch.kernels import ops, peel, segsum

# float32 integer-exactness envelope of the JAX package's kernel tier
EXACT_ENVELOPE = 1 << 24


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` means the GPU. Without CUDA that is an error that names the
    way out; an entry point never carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU by default; "
                "pass device='cpu' to run the plain PyTorch path")
        device = "cuda"
    return torch.device(device)


def resolve_kernel(kernel: bool | None, device: torch.device) -> bool:
    """``None`` -> on for a CUDA device, off elsewhere; else bool(kernel)."""
    return device.type == "cuda" if kernel is None else bool(kernel)


def assert_exact_envelope(*counts: int) -> None:
    """Fail fast (host-side, at the entry point) if any capacity could push
    the JAX kernel tier's float32 sums past exact-integer range."""
    for c in counts:
        if int(c) >= EXACT_ENVELOPE:
            raise ValueError(
                f"capacity {int(c)} >= 2^24 breaks the kernel tier's "
                f"float32 exactness envelope; shard the tenant or force "
                f"kernel=False")


def peel_delta(
    fail: torch.Tensor, dst: torch.Tensor, n_nodes: int, kernel: bool, mesh=None,
) -> torch.Tensor:
    """Sum a per-edge-lane boolean onto its dst vertex: int32 ``[n_nodes]``.

    ``fail`` is any per-lane bool (failed-src edges for the degree
    decrement); sentinel lanes (dst >= n_nodes) drop on both paths. With
    ``kernel`` the lanes must be dst-sorted.
    """
    if kernel:
        return collective.all_reduce_sum(
            ops.segment_sum(fail, dst, num_segments=n_nodes, out_dtype=torch.int32), mesh)
    out = torch.zeros(n_nodes + 1, dtype=torch.int32, device=dst.device)
    out.index_add_(0, dst.clamp(max=n_nodes), fail.to(torch.int32))
    return collective.all_reduce_sum(out[:n_nodes], mesh)


def lane_degrees(
    src: torch.Tensor, dst: torch.Tensor, n_nodes: int, kernel: bool, mesh=None,
) -> torch.Tensor:
    """int32 ``[n_nodes]`` degrees of symmetric lanes. With ``kernel`` one K1
    launch over dst-sorted lanes: a vertex's lanes in are the mirrors of its
    lanes out, so the count onto dst is ``Graph.degrees``, and sentinel
    lanes drop in the kernel instead of piling atomics onto one row. Without,
    the histogram of src (``density.degrees_from_coo``)."""
    if kernel:
        # repro: allow RPR304 -- the switch itself; its callers' entry points assert the envelope
        return peel_delta(dst < n_nodes, dst, n_nodes, True, mesh)
    return collective.all_reduce_sum(degrees_from_coo(src, n_nodes), mesh)


def peel_edges(
    src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor,
    failed: torch.Tensor, n_nodes: int, kernel: bool, charge: bool = False,
    mesh=None,
) -> tuple[torch.Tensor, ...]:
    """The edge stage of one peel pass: int32 ``(delta, removed)``, with
    ``charge`` also ``inc`` (``ref.peel_edges_ref`` defines them).

    ``delta[v]`` counts v's live neighbours that failed, ``removed`` the
    directed lanes that die, ``inc[v]`` the dying edges charged to v. With
    ``kernel`` this is one K2 call over dst-sorted lanes; without, the
    elementwise ops and two or three ``index_add_`` scatters. With ``mesh``
    the lanes are this rank's, and the stage's outputs are summed over the
    mesh by one all-reduce.
    """
    out = _peel_edges_local(src, dst, active, failed, n_nodes, kernel, charge)
    if mesh is None:
        return out
    buf = collective.all_reduce_sum(torch.cat([out[0], out[1].reshape(1)] + list(out[2:])), mesh)
    return (buf[:n_nodes], buf[n_nodes]) + ((buf[n_nodes + 1:],) if charge else ())


def _peel_edges_local(src, dst, active, failed, n_nodes, kernel, charge):
    if kernel:
        return peel.peel_edges_sorted(src, dst, active, failed, n_nodes=n_nodes,
                                      charge=charge)
    src_c = src.clamp(max=n_nodes - 1)
    dst_c = dst.clamp(max=n_nodes - 1)
    live_edge = ((src < n_nodes) & (dst < n_nodes) & active.index_select(0, src_c)
                 & active.index_select(0, dst_c))
    fail_s = failed.index_select(0, src_c) & live_edge
    fail_d = failed.index_select(0, dst_c) & live_edge
    # fail_s aggregated on *dst* counts, per survivor, its failed neighbors
    # (the mirror entry of every (u failed -> v) edge lands the same
    # information symmetrically)
    # repro: allow RPR304 -- the switch itself; its callers' entry points assert the envelope
    out = (peel_delta(fail_s, dst, n_nodes, False),
           (fail_s | fail_d).sum(dtype=torch.int32))
    if not charge:
        return out
    # edge charging: (u->v) charges u iff u failed and (v survived or u<v);
    # exactly one of the two directed entries charges. Aggregated on *dst*
    # via the mirror identity (lane (v->u) has its src-side charge equal to
    # this lane's assign_d), so every reduction runs onto dst.
    assign_d = fail_d & (~fail_s | (dst_c < src_c))
    # repro: allow RPR304 -- the switch itself; its callers' entry points assert the envelope
    return out + (peel_delta(assign_d, dst, n_nodes, False),)


def _row_keys(ids: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Flat keys ``r * (n_nodes + 1) + min(id, n_nodes)`` of [G, L] ids: the
    scatter tier's one segment space for G rows, sentinel column last."""
    rows = torch.arange(ids.shape[0], dtype=ids.dtype, device=ids.device)[:, None]
    return (rows * (n_nodes + 1) + ids.clamp(max=n_nodes)).reshape(-1)


def _rows_sum(values: torch.Tensor, ids: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """int32 ``[G, n_nodes]`` sums of [G, L] values onto their rows' ids: one
    ``index_add_`` over ``[G * (n_nodes + 1)]``, the sentinel column dropped."""
    g = ids.shape[0]
    out = torch.zeros(g * (n_nodes + 1), dtype=torch.int32, device=ids.device)
    out.index_add_(0, _row_keys(ids, n_nodes), values.reshape(-1).to(torch.int32))
    return out.view(g, n_nodes + 1)[:, :n_nodes]


def lane_degrees_rows(
    src: torch.Tensor, dst: torch.Tensor, n_nodes: int, kernel: bool, mesh=None,
) -> torch.Tensor:
    """``lane_degrees`` of G rows of symmetric lanes ([G, L], ids in
    [0, n_nodes]): int32 ``[G, n_nodes]``. With ``kernel`` one launch of K1's
    rows entry over dst-sorted rows; without, one histogram of src over the
    flattened ``[G * (n_nodes + 1)]`` space."""
    if kernel:
        out = segsum.segment_sum_rows_sorted(dst < n_nodes, dst, num_segments=n_nodes)
    else:
        out = _rows_sum(torch.ones_like(src), src, n_nodes)
    return collective.all_reduce_sum(out, mesh)


def peel_edges_rows(
    src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor,
    failed: torch.Tensor, n_nodes: int, kernel: bool, charge: bool = False,
    mesh=None,
) -> tuple[torch.Tensor, ...]:
    """The edge stage of G independent passes, ``peel_edges`` of each row:
    lanes [G, L], masks [G, n_nodes]. Returns int32 ``(delta [G, V],
    removed [G])``, with ``charge`` also ``inc [G, V]``. With ``kernel`` one
    launch of K2's rows entry for the whole group (rows dst-sorted); without,
    the elementwise ops over all rows at once and one ``index_add_`` a
    reduction over the flattened ``[G * (n_nodes + 1)]`` space. With ``mesh``
    the lanes are this rank's and the group's outputs are summed over the
    mesh by one ``[G, V + 1]`` (``[G, 2V + 1]``) all-reduce."""
    out = _peel_edges_rows_local(src, dst, active, failed, n_nodes, kernel, charge)
    if mesh is None:
        return out
    buf = collective.all_reduce_sum(
        torch.cat([out[0], out[1][:, None]] + list(out[2:]), dim=1), mesh)
    return ((buf[:, :n_nodes], buf[:, n_nodes])
            + ((buf[:, n_nodes + 1:],) if charge else ()))


def _peel_edges_rows_local(src, dst, active, failed, n_nodes, kernel, charge):
    if kernel:
        # repro: allow RPR304 -- the switch itself; its callers' entry points assert the envelope
        return peel.peel_edges_rows(src, dst, active, failed, n_nodes=n_nodes,
                                    charge=charge)
    g = src.shape[0]
    base = torch.arange(g, dtype=src.dtype, device=src.device)[:, None] * n_nodes
    fs_idx = (base + src.clamp(max=n_nodes - 1)).reshape(-1)
    fd_idx = (base + dst.clamp(max=n_nodes - 1)).reshape(-1)
    act, fail = active.reshape(-1), failed.reshape(-1)
    live = ((src < n_nodes) & (dst < n_nodes) & act.index_select(0, fs_idx).view_as(src)
            & act.index_select(0, fd_idx).view_as(src))
    fail_s = fail.index_select(0, fs_idx).view_as(src) & live
    fail_d = fail.index_select(0, fd_idx).view_as(src) & live
    out = (_rows_sum(fail_s, dst, n_nodes), (fail_s | fail_d).sum(dim=1, dtype=torch.int32))
    if not charge:
        return out
    assign_d = fail_d & (~fail_s | (dst < src))
    return out + (_rows_sum(assign_d, dst, n_nodes),)


__all__ = ["EXACT_ENVELOPE", "resolve_device", "resolve_kernel",
           "assert_exact_envelope", "lane_degrees", "lane_degrees_rows",
           "peel_delta", "peel_edges", "peel_edges_rows"]
