"""TP-within-expert MoE (for n_experts < |model| axis, e.g. Grok-1's 8).

The port of the JAX package's ``models/moe_tp.py``: the token replicas
sorted by expert, one SwiGLU product per expert over its contiguous rows
(the reference's ``ragged_dot``, ``moe._ragged_swiglu``: one host read of
the group sizes a call), and the combine with the gates in float32
(``view(t, k, d).sum(1)``, as in ``moe.py``). Over a mesh every rank holds
every expert's ``d_ff / |tp|`` slice and the same tokens as the other
``tp`` ranks (no all-to-all): its products over its slice are partial
``wo`` contractions, summed over ``tp`` by one
``collective.all_reduce_sum`` in the compute dtype (the reference's
``psum``). The tokens enter the experts through ``collective.sum_grad``, so
that every ``tp`` rank's gradient of them sums the slices' shares; ``aux``
is averaged over ``dp`` only (``moe.token_mean``: the ``tp`` ranks' values
are equal).
"""
from __future__ import annotations

import torch

from repro_torch.core import collective
from repro_torch.models.moe import (
    MoEConfig, _group_sizes, _ragged_swiglu, _route, _shared_ffn, _token_ids, token_mean,
)

F32 = torch.float32


def _moe_tp_local(x2d, router, wg, wi, wo, cfg: MoEConfig, mesh=None, tp: str = "model"):
    t, d = x2d.shape
    e = cfg.n_experts
    gates, idx, aux = _route(x2d, router, cfg)

    eid = idx.reshape(-1)
    gate_r = gates.reshape(-1)
    tok_r = _token_ids(t, cfg.top_k, x2d.device)

    order = torch.sort(eid, stable=True).indices
    xs = collective.sum_grad(x2d, mesh, tp)[tok_r[order]].to(cfg.compute_dtype)   # [tk, D]
    group_sizes = _group_sizes(eid[order], e)

    ys = _ragged_swiglu(xs, wg, wi, wo, group_sizes, cfg.compute_dtype)
    if mesh is not None:
        ys = collective.all_reduce_sum(ys, mesh, tp)   # partial over the d_ff slices
    y_rep = torch.zeros_like(ys).index_copy_(0, order, ys)
    y = (y_rep.to(F32) * gate_r[:, None]).view(t, cfg.top_k, d).sum(1)
    return y.to(x2d.dtype), aux


def moe_tp(x: torch.Tensor, p, cfg: MoEConfig, *, mesh=None, dp: tuple[str, ...] = ("data",),
           tp: str = "model", sp: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """[B,S,D] -> ([B,S,D], aux): the reference's TP-within-expert layer.

    Without a mesh, its single-device body. Over ``mesh``, this rank's
    share: ``x`` its ``[B / |dp|, S, D]`` block, ``p`` the router and shared
    experts whole, ``wg`` and ``wi`` their last dim's i-th ``1 / |tp|``
    slice and ``wo`` its middle dim's, for rank i along ``tp``. ``sp`` is
    accepted and dropped, as the reference drops it: ``d_ff`` and the
    sequence cannot split the same axis."""
    del sp
    b, s, d = x.shape
    y2d, aux = _moe_tp_local(x.reshape(-1, d), p["router"], p["wg"], p["wi"], p["wo"], cfg,
                             mesh=mesh, tp=tp)
    if mesh is not None:
        aux = token_mean(aux, mesh, tuple(dp))
    y = y2d.reshape(b, s, d)
    if cfg.n_shared:
        y = y + _shared_ffn(x.reshape(-1, d), p, cfg).to(x.dtype).reshape(b, s, d)
    return y, aux


__all__ = ["moe_tp"]
