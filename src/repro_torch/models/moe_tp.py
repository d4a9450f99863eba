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

With ``sp`` (the transformer's sequence-parallel training and prefill) a
rank holds its ``[B / |dp|, S / |tp|, D]`` block, and the layer does what
the reference's enclosing program does around it: it gathers the sequence
over ``tp`` (``collective.all_gather``, whose backward sums the slices'
shares of the tokens, so no ``sum_grad``), routes and multiplies every
token of its batch block, sums the partial products over ``tp``, and keeps
its own sequence block of the replicas (``collective.split``: the summed
products get the whole cotangent) to combine with its own tokens' gates.
Every ``tp`` rank routes the same tokens, so ``aux`` is averaged over
``tp`` too: the same value, and each rank's router gets its share of the
aux gradient, which the train step's sum over the token axes adds up.
"""
from __future__ import annotations

import torch

from repro_torch.core import collective
from repro_torch.models.moe import (
    MoEConfig, _group_sizes, _ragged_swiglu, _route, _shared_ffn, _token_ids, token_mean,
)
from repro_torch.models.shard import gather_dim, split_dim

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


def _moe_tp_sp(x, p, cfg: MoEConfig, mesh, dp: tuple[str, ...], tp: str):
    """``moe_tp`` on this rank's sequence block (see the module docstring)."""
    b, s_rank, d = x.shape
    xf = gather_dim(x, 1, mesh, tp)                       # [B, S, D]
    x2d = xf.reshape(-1, d)
    t, k = x2d.shape[0], cfg.top_k
    gates, idx, aux = _route(x2d, p["router"], cfg)
    eid = idx.reshape(-1)
    order = torch.sort(eid, stable=True).indices
    xs = x2d[_token_ids(t, k, x.device)[order]].to(cfg.compute_dtype)
    ys = _ragged_swiglu(xs, p["wg"], p["wi"], p["wo"], _group_sizes(eid[order], cfg.n_experts),
                        cfg.compute_dtype)
    ys = collective.all_reduce_sum(ys, mesh, tp)          # partial over the d_ff slices
    y_rep = torch.zeros_like(ys).index_copy_(0, order, ys).view(b, xf.shape[1], k, d)
    y_rep = split_dim(y_rep, 1, mesh, tp)                 # this rank's sequence block
    g = gates.view(b, xf.shape[1], k).narrow(1, mesh.axis_index(tp) * s_rank, s_rank)
    y = (y_rep.to(F32) * g[..., None]).sum(2)
    return y.to(x.dtype), token_mean(aux, mesh, dp + (tp,))


def moe_tp(x: torch.Tensor, p, cfg: MoEConfig, *, mesh=None, dp: tuple[str, ...] = ("data",),
           tp: str = "model", sp: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """[B,S,D] -> ([B,S,D], aux): the reference's TP-within-expert layer.

    Without a mesh, its single-device body. Over ``mesh``, this rank's
    share: ``x`` its ``[B / |dp|, S, D]`` block (``[B / |dp|, S / |tp|, D]``
    with ``sp``), ``p`` the router and shared experts whole, ``wg`` and
    ``wi`` their last dim's i-th ``1 / |tp|`` slice and ``wo`` its middle
    dim's, for rank i along ``tp``. ``d_ff`` and the sequence cannot split
    the same axis: with ``sp`` the layer gathers the sequence and splits its
    output (the reference's enclosing program does)."""
    b, s, d = x.shape
    if mesh is not None and sp and mesh.axis_size(tp) > 1:
        y, aux = _moe_tp_sp(x, p, cfg, mesh, tuple(dp), tp)
        if cfg.n_shared:
            y = y + _shared_ffn(x.reshape(-1, d), p, cfg).to(x.dtype).reshape(b, s, d)
        return y, aux
    y2d, aux = _moe_tp_local(x.reshape(-1, d), p["router"], p["wg"], p["wi"], p["wo"], cfg,
                             mesh=mesh, tp=tp)
    if mesh is not None:
        aux = token_mean(aux, mesh, tuple(dp))
    y = y2d.reshape(b, s, d)
    if cfg.n_shared:
        y = y + _shared_ffn(x.reshape(-1, d), p, cfg).to(x.dtype).reshape(b, s, d)
    return y, aux


__all__ = ["moe_tp"]
