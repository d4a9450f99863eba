"""Functional optimizers: AdamW, Adafactor, SGD-momentum.

The port of the JAX package's ``optim/optimizers.py``, with its API over a
tree of tensors (``utils/tree.py``: JAX's leaf order):

    opt = adamw(lr_schedule, ...)
    state = opt.init(params)
    new_params, new_state = opt.update(grads, state, params)

The state is JAX's tree, key for key (``{"step", "mu", "nu"}``; Adafactor's
``{"step", "v"}`` with ``{"vr", "vc"}`` or ``{"v"}`` a leaf; SGD-momentum's
``{"step", "m"}``), so a checkpoint of either package names the same leaves.
Nothing is updated in place: ``update`` returns new tensors, and the train
loop's straggler re-dispatch (``launch/train.py``) reruns a step from the
state it was given, which an in-place ``torch.optim`` step would have
changed. The arithmetic keeps JAX's order: the clip folded into each leaf's
update, bias corrections ``1 - b**step`` in float32, and each new parameter
cast back to its parameter's dtype (bf16 parameters stay bf16).

Adafactor keeps *factored* second moments for >=2-D weights (row + column
accumulators instead of a full moment tensor); the factoring follows Shazeer
& Stern 2018 (factor the trailing two dims).

JAX's ``_map3`` threads an ``optimization_barrier`` between leaf updates and
``SCAN_LAYER_UPDATES`` scans big layer-stacked leaves; both steer XLA's
scheduling of one fused program and have no counterpart here: eager torch
already updates one leaf at a time, so the float32 temporaries alive at once
are one leaf's, and each update reuses its own temporaries in place (the
same operations in the same order, so the same bits) to keep them few: at
grok-1's widths one expert leaf's float32 copy is 6.4 GB.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.optim.schedule import constant
from repro_torch.optim.util import global_norm
from repro_torch.utils.tree import tree_leaves, tree_map

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _cast_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return x.to(ref.dtype)


def _map_n(fn, n: int, params, *others) -> tuple:
    """``fn(p, *o)`` over the leaves of ``params``, each ``o`` the matching
    subtree of another tree; returns n trees, one per output of ``fn``."""
    outs = tree_map(fn, params, *others)
    return tuple(tree_map(lambda _p, o, i=i: o[i], params, outs) for i in range(n))


def _lr_fn(lr):
    return lr if callable(lr) else constant(lr)


def _clip_scale(grads, grad_clip: float | None, device) -> torch.Tensor:
    if grad_clip is None:
        return torch.tensor(1.0, dtype=F32, device=device)
    gn = global_norm(grads)
    return torch.clamp(torch.full_like(gn, grad_clip) / torch.clamp(gn, min=1e-9), max=1.0)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=F32)


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          grad_clip: float | None = 1.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"step": _step0(params), "mu": tree_map(_zeros, params),
                "nu": tree_map(_zeros, params)}

    def update(grads, state, params):
        # clip folded into the per-leaf update: no scaled copy of the grads
        step = state["step"] + 1
        clip_scale = _clip_scale(grads, grad_clip, step.device)
        lr_t = lr_fn(step)
        c1 = 1.0 - b1 ** step.to(F32)
        c2 = 1.0 - b2 ** step.to(F32)

        def upd(p, g, mu, nu):
            # JAX's expression, op for op: mhat / (sqrt(nhat) + eps) + wd * p,
            # then p - lr * step; the in-place ops write only this leaf's own
            # float32 temporaries, so fewer of them are alive at once
            g = g.to(F32) * clip_scale
            mu = b1 * mu + (1 - b1) * g
            g2 = (1 - b2) * g
            nu = (b2 * nu).add_(g2.mul_(g))
            del g, g2
            step_t = mu / c1                                   # mhat
            den = (nu / c2).sqrt_().add_(eps)                  # sqrt(nhat) + eps
            step_t.div_(den)
            del den
            pf = p.to(F32)
            step_t.add_(weight_decay * pf).mul_(lr_t)
            return _cast_like(pf - step_t, p), mu, nu

        new_p, new_mu, new_nu = _map_n(upd, 3, params, grads, state["mu"], state["nu"])
        return new_p, {"step": step, "mu": new_mu, "nu": new_nu}

    return Optimizer(init, update)


def adafactor(lr: Callable | float, decay: float = 0.99, eps: float = 1e-30,
              weight_decay: float = 0.0, grad_clip: float | None = 1.0,
              min_dim_factored: int = 128) -> Optimizer:
    """Factored second moments for tensors whose trailing two dims are both
    >= ``min_dim_factored``; small tensors fall back to full moments."""
    lr_fn = _lr_fn(lr)

    def _factored(p):
        return (p.dim() >= 2 and p.shape[-1] >= min_dim_factored
                and p.shape[-2] >= min_dim_factored)

    def init(params):
        def leaf(p):
            if _factored(p):
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=F32, device=p.device),  # row
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32,
                                      device=p.device),                          # col
                }
            return {"v": _zeros(p)}
        return {"step": _step0(params), "v": tree_map(leaf, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        clip_scale = _clip_scale(grads, grad_clip, step.device)
        lr_t = lr_fn(step)

        def upd(p, g, v):
            # JAX's expression, op for op; the in-place ops write only this
            # leaf's own float32 temporaries (see adamw)
            g = g.to(F32) * clip_scale
            g2 = (g * g).add_(eps)
            if "vr" in v:
                vr = decay * v["vr"] + (1 - decay) * torch.mean(g2, dim=-1)
                vc = decay * v["vc"] + (1 - decay) * torch.mean(g2, dim=-2)
                del g2
                denom = (vr[..., None] * vc[..., None, :]).div_(
                    torch.clamp(torch.mean(vr, dim=-1, keepdim=True)[..., None], min=eps)).sqrt_()
                new_v = {"vr": vr, "vc": vc}
            else:
                vv = decay * v["v"] + (1 - decay) * g2
                del g2
                denom = torch.sqrt(vv)
                new_v = {"v": vv}
            upd_t = g.div_(denom.clamp_(min=eps))
            del denom
            pf = p.to(F32)
            upd_t.add_(weight_decay * pf).mul_(lr_t)
            return _cast_like(pf - upd_t, p), new_v

        new_p, new_v = _map_n(upd, 2, params, grads, state["v"])
        return new_p, {"step": step, "v": new_v}

    return Optimizer(init, update)


def sgdm(lr: Callable | float, momentum: float = 0.9,
         grad_clip: float | None = None) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"step": _step0(params), "m": tree_map(_zeros, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        cs = _clip_scale(grads, grad_clip, step.device)
        lr_t = lr_fn(step)
        new_m = tree_map(lambda m, g: momentum * m + g.to(F32) * cs, state["m"], grads)
        new_p = tree_map(lambda p, m: _cast_like(p.to(F32) - lr_t * m, p), params, new_m)
        return new_p, {"step": step, "m": new_m}

    return Optimizer(init, update)


__all__ = ["Optimizer", "adamw", "adafactor", "sgdm"]
