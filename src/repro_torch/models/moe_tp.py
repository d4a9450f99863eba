"""TP-within-expert MoE (for n_experts < |model| axis, e.g. Grok-1's 8).

The port of the JAX package's ``models/moe_tp.py`` for one device: the
token replicas sorted by expert, one SwiGLU product per expert over its
contiguous rows (the reference's ``ragged_dot``, ``moe._ragged_swiglu``: one
host read of the group sizes a call), and the combine with the gates in
float32 (``view(t, k, d).sum(1)``, as in ``moe.py``). ``mesh=`` (each device
holding a d_ff slice, one ``psum`` over the model axis) raises
``NotImplementedError``: it comes with the sharded zoo (ROADMAP.md section
1, item 6c-ii).
"""
from __future__ import annotations

import torch

from repro_torch.models.moe import (
    MoEConfig, _group_sizes, _ragged_swiglu, _route, _shared_ffn, _token_ids,
)

F32 = torch.float32


def _moe_tp_local(x2d, router, wg, wi, wo, cfg: MoEConfig):
    t, d = x2d.shape
    e = cfg.n_experts
    gates, idx, aux = _route(x2d, router, cfg)

    eid = idx.reshape(-1)
    gate_r = gates.reshape(-1)
    tok_r = _token_ids(t, cfg.top_k, x2d.device)

    order = torch.sort(eid, stable=True).indices
    xs = x2d[tok_r[order]].to(cfg.compute_dtype)            # [tk, D]
    group_sizes = _group_sizes(eid[order], e)

    ys = _ragged_swiglu(xs, wg, wi, wo, group_sizes, cfg.compute_dtype)
    y_rep = torch.zeros_like(ys).index_copy_(0, order, ys)
    y = (y_rep.to(F32) * gate_r[:, None]).view(t, cfg.top_k, d).sum(1)
    return y.to(x2d.dtype), aux


def moe_tp(x: torch.Tensor, p, cfg: MoEConfig, *, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """[B,S,D] -> ([B,S,D], aux): the single-device body of the reference's
    TP-within-expert layer."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_tp over a mesh (d_ff sharded over 'model', one psum) is not ported yet: "
            "it comes with the sharded zoo, ROADMAP.md section 1, item 6c-ii")
    b, s, d = x.shape
    y2d, aux = _moe_tp_local(x.reshape(-1, d), p["router"], p["wg"], p["wi"], p["wo"], cfg)
    y = y2d.reshape(b, s, d)
    if cfg.n_shared:
        y = y + _shared_ffn(x.reshape(-1, d), p, cfg).to(x.dtype).reshape(b, s, d)
    return y, aux


__all__ = ["moe_tp"]
