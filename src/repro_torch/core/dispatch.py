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
:func:`peel_delta` reduces one per-lane boolean. Both paths count in int32,
so (density, mask, passes) triples match bit for bit with the knob on or
off. The kernels' int32 sums are exact at any size; the 2^24 envelope of
the JAX kernel's float32 sums is still asserted at the same API points, so
both packages accept and refuse the same graphs.
"""
from __future__ import annotations

import torch

from repro_torch.core.density import degrees_from_coo
from repro_torch.kernels import ops, peel

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
    fail: torch.Tensor, dst: torch.Tensor, n_nodes: int, kernel: bool
) -> torch.Tensor:
    """Sum a per-edge-lane boolean onto its dst vertex: int32 ``[n_nodes]``.

    ``fail`` is any per-lane bool (failed-src edges for the degree
    decrement); sentinel lanes (dst >= n_nodes) drop on both paths. With
    ``kernel`` the lanes must be dst-sorted.
    """
    if kernel:
        return ops.segment_sum(fail, dst, num_segments=n_nodes,
                               out_dtype=torch.int32)
    out = torch.zeros(n_nodes + 1, dtype=torch.int32, device=dst.device)
    out.index_add_(0, dst.clamp(max=n_nodes), fail.to(torch.int32))
    return out[:n_nodes]


def lane_degrees(
    src: torch.Tensor, dst: torch.Tensor, n_nodes: int, kernel: bool
) -> torch.Tensor:
    """int32 ``[n_nodes]`` degrees of symmetric lanes. With ``kernel`` one K1
    launch over dst-sorted lanes: a vertex's lanes in are the mirrors of its
    lanes out, so the count onto dst is ``Graph.degrees``, and sentinel
    lanes drop in the kernel instead of piling atomics onto one row. Without,
    the histogram of src (``density.degrees_from_coo``)."""
    if kernel:
        return peel_delta(dst < n_nodes, dst, n_nodes, True)
    return degrees_from_coo(src, n_nodes)


def peel_edges(
    src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor,
    failed: torch.Tensor, n_nodes: int, kernel: bool, charge: bool = False,
) -> tuple[torch.Tensor, ...]:
    """The edge stage of one peel pass: int32 ``(delta, removed)``, with
    ``charge`` also ``inc`` (``ref.peel_edges_ref`` defines them).

    ``delta[v]`` counts v's live neighbours that failed, ``removed`` the
    directed lanes that die, ``inc[v]`` the dying edges charged to v. With
    ``kernel`` this is one K2 call over dst-sorted lanes; without, the
    elementwise ops and two or three ``index_add_`` scatters.
    """
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
    out = (peel_delta(fail_s, dst, n_nodes, False),
           (fail_s | fail_d).sum(dtype=torch.int32))
    if not charge:
        return out
    # edge charging: (u->v) charges u iff u failed and (v survived or u<v);
    # exactly one of the two directed entries charges. Aggregated on *dst*
    # via the mirror identity (lane (v->u) has its src-side charge equal to
    # this lane's assign_d), so every reduction runs onto dst.
    assign_d = fail_d & (~fail_s | (dst_c < src_c))
    return out + (peel_delta(assign_d, dst, n_nodes, False),)


__all__ = ["EXACT_ENVELOPE", "resolve_device", "resolve_kernel",
           "assert_exact_envelope", "lane_degrees", "peel_delta", "peel_edges"]
