"""Row-batched peeling: G independent peels advanced together, one launch a pass.

The JAX package batches its peels over tenants with ``jax.vmap``
(``stream/fused.py``): the pass body runs on ``[G, ...]`` arrays, and the
batched ``while_loop`` runs it while ANY row is live, freezing the converged
rows through ``select``. This module writes that batch dimension out:

  * :func:`pbahmani_pass_rows` is ``pbahmani_pass`` on a :class:`PeelState`
    whose tensors carry a leading row axis (``deg``/``active``/``best_mask``
    ``[G, V]``, the scalars ``[G]``). The float32 threshold is elementwise,
    so every row's bits equal the single pass's; the edge stage is one call
    of ``dispatch.peel_edges_rows`` (one launch of K2's rows entry with the
    kernel on), and ``n_e`` drops by each row's own ``removed // 2``;
  * :func:`peel_rows_to_end` loops ``while (n_v > 0).any()``, one host sync
    a pass as ``prune._peel_to_end`` has, and keeps a row that had converged
    before the pass as it was (``torch.where``), so ``passes`` advances only
    for live rows: vmap's ``while_loop`` semantics, each row's triple equal
    to the single peel of that row;
  * :func:`dense_pass_rows` is the dense-adjacency pass of the fused small
    buckets (``fused.py``'s ``_dense_pass``), its edge sums as batched
    float32 products, exact below 2^24.
"""
from __future__ import annotations

import torch

from repro_torch.core.density import peel_threshold
from repro_torch.core.dispatch import peel_edges_rows
from repro_torch.core.pbahmani import PeelState


def select_rows(live: torch.Tensor, new, old):
    """Field by field ``where(live, new, old)`` of two row-batched NamedTuple
    states: rows where ``live`` ([G] bool) is False keep ``old``."""
    def pick(a, b):
        cond = live.view(live.shape + (1,) * (a.dim() - 1))
        return torch.where(cond, a, b)

    return type(old)(*(pick(a, b) for a, b in zip(new, old)))


def require_exact_matmul() -> None:
    """The dense passes count edges with float32 products; they are exact
    integers only in full float32 (TF32 keeps 10 mantissa bits)."""
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the dense peel counts edges with float32 matrix products, exact only in "
            "full float32; torch.get_float32_matmul_precision() is "
            f"{torch.get_float32_matmul_precision()!r}: set it to 'highest'")


def _fold_rows(state: PeelState, n_e_new, n_v_new, active_new, deg_new) -> PeelState:
    rho_new = n_e_new.to(torch.float32) / n_v_new.clamp(min=1).to(torch.float32)
    rho_new = torch.where(n_v_new > 0, rho_new, 0.0)
    better = rho_new > state.best_density
    return PeelState(
        deg=deg_new,
        active=active_new,
        n_v=n_v_new,
        n_e=n_e_new,
        best_density=torch.where(better, rho_new, state.best_density),
        best_mask=torch.where(better[:, None], active_new, state.best_mask),
        passes=state.passes + 1,
    )


def pbahmani_pass_rows(
    state: PeelState, src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
    eps: float, kernel: bool = False, mesh=None,
) -> PeelState:
    """One peeling pass of every row: lanes ``[G, L]`` (each row dst-sorted
    with ``kernel``), state tensors ``[G, V]`` and ``[G]``. With ``mesh`` the
    lanes are this rank's blocks and the group's pass makes one ``[G, V +
    1]`` all-reduce."""
    thr = peel_threshold(state.n_e, state.n_v, eps)
    failed = state.active & (state.deg.to(torch.float32) <= thr[:, None])
    # repro: allow RPR304 -- batched pass body; its callers assert the envelope
    delta, removed = peel_edges_rows(src, dst, state.active, failed, n_nodes, kernel,
                                     mesh=mesh)
    active_new = state.active & ~failed
    return _fold_rows(
        state, state.n_e - removed // 2, state.n_v - failed.sum(dim=1, dtype=torch.int32),
        active_new, torch.where(active_new, state.deg - delta, 0))


def dense_pass_rows(state: PeelState, adj: torch.Tensor, eps: float) -> PeelState:
    """``pbahmani_pass_rows`` off the dense adjacency ``[G, V, V]`` float32:
    ``adj @ failed`` counts each vertex's failed neighbours and
    ``2 f.(A a) - f.(A f)`` the dying directed lanes (the paper's atomicSub
    round as batched products). Every float32 sum is over integers below
    2^24, hence exact in any order: the trajectory equals the lane pass's."""
    thr = peel_threshold(state.n_e, state.n_v, eps)
    failed = state.active & (state.deg.to(torch.float32) <= thr[:, None])
    f = failed.to(torch.float32)
    a = state.active.to(torch.float32)
    af = torch.bmm(adj, f[:, :, None])[:, :, 0]
    aa = torch.bmm(adj, a[:, :, None])[:, :, 0]
    removed = (2.0 * (f * aa).sum(dim=1) - (f * af).sum(dim=1)).to(torch.int32)
    active_new = state.active & ~failed
    return _fold_rows(
        state, state.n_e - removed // 2, state.n_v - failed.sum(dim=1, dtype=torch.int32),
        active_new, torch.where(active_new, state.deg - af.to(torch.int32), 0))


def run_rows(state, step, live=lambda s: s.n_v > 0):
    """Apply ``step`` while any row is ``live`` (one host sync a pass),
    keeping rows that were not live before a step as they were."""
    while True:
        alive = live(state)
        if not bool(alive.any()):  # repro: allow RPR101 -- the one host sync of each pass
            return state
        state = select_rows(alive, step(state), state)


def peel_rows_to_end(
    state: PeelState, src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
    eps: float, kernel: bool = False, mesh=None,
) -> PeelState:
    """Every row peeled to an empty live set: ``prune._peel_to_end`` of each
    row, one batched pass for the group."""
    return run_rows(state, lambda s: pbahmani_pass_rows(s, src, dst, n_nodes, eps, kernel,
                                                        mesh))


def init_rows(deg: torch.Tensor, n_edges: torch.Tensor) -> PeelState:
    """The peel's state from maintained degrees ``[G, V]`` and edge counts
    ``[G]`` (int32): ``init_state`` of each row without its histogram."""
    active = deg > 0
    n_v = active.sum(dim=1, dtype=torch.int32)
    n_e = n_edges.to(torch.int32)
    return PeelState(
        deg=deg.to(torch.int32), active=active, n_v=n_v, n_e=n_e,
        best_density=n_e.to(torch.float32) / n_v.clamp(min=1).to(torch.float32),
        best_mask=active, passes=torch.zeros_like(n_v))


__all__ = ["select_rows", "require_exact_matmul", "pbahmani_pass_rows", "dense_pass_rows",
           "run_rows", "peel_rows_to_end", "init_rows"]
