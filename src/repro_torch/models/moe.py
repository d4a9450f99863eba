"""Mixture-of-Experts layer: dense oracle + the expert-parallel path.

The port of the JAX package's ``models/moe.py``:

* ``moe_dense`` — one-hot combine over all experts (the numerical oracle);
* ``moe_ep`` — ``_moe_local``: top-k routing, the replicas bucketed by the
  rank that owns their expert into fixed-capacity send buffers (replicas
  past the capacity drop, as in the reference), sorted by expert, one
  SwiGLU product per expert over its contiguous rows (the reference's
  ``lax.ragged_dot``), and the combine with the renormalized gates. Over a
  mesh (``mesh=``, the reference's ``shard_map``) a rank holds its share of
  the tokens (split over ``dp``, and over ``tp`` on the sequence when
  ``sp``) and ``E / |tp|`` experts; two ``collective.all_to_all`` calls over
  ``tp`` send the replicas and their expert ids, one brings the outputs
  back. Without ``sp`` the ``tp`` ranks hold the same tokens and each sends
  its own copy, as the reference does.

The per-expert products need each expert's row count on the host: one read
of ``group_sizes`` a MoE layer a call (``_ragged_swiglu``), the one host
sync of the layer. Under training with ``remat`` (``models/transformer.py``)
the block's forward runs again in the backward, and so does that read: two
host syncs a MoE layer a microbatch, and no other. ``lax.top_k`` puts the
lower index first on ties; the port takes the top k of a stable descending
``torch.sort``, which does the same. The combine ``segment_sum(y_rep,
repeat(arange(t), k))`` sums each token's k consecutive replicas, so it is
``y_rep.view(t, k, d).sum(1)`` in float32: no scatter, whose float atomics
on the card would make serving non-repeatable.

Everything is differentiable, as ``jax.grad`` of the reference is: the
router gets its gradient through the renormalized top-k gates (the sort's
values) and through ``aux``; the expert weights through the per-expert
products. Each backward sums in a fixed order, so a train step on the card
is bitwise repeatable: the k replicas of a token are an ``expand`` of its
row (the backward a sum over k), not a gather by repeated token ids (an
``index_put_`` accumulation); the other gathers and scatters are
permutations, or write zeros (dropped replicas) beside one value.

Over a mesh the gradients follow ``core/collective.py``'s rule (every rank
backpropagates the loss of the whole step): a rank's expert weights get
their gradient from its data shard's tokens, and a weight held alike over
an axis that splits the tokens (``dp``; ``tp`` with ``sp``) gets its own
tokens' share, which the train step's data-parallel sum adds up. Without
``sp`` the ``tp`` ranks send the same replicas, so an expert receives each
one ``|tp|`` times: its weights' gradient is scaled by ``1 / |tp|``
(``_scale_grad``). ``aux`` is the mean over the ranks holding different
tokens (the reference's ``pmean`` over ``tp``, then each ``dp`` axis; the
mean over ``tp`` of the equal values of ``tp`` ranks that hold the same
tokens is left out, so that every rank's gradient of ``aux`` is whole).

Parameters are a mapping of tensors under the reference's keys
(``router``, ``wg``, ``wi``, ``wo``, ``shared_wg``, ...): a MoE block's
``nn.ParameterDict`` (``models/transformer.py``), or ``init_moe_params``'s
dict; over a mesh, this rank's shard (``models.convert.moe_params_from_jax``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import collective
from repro_torch.core.dispatch import resolve_device
from repro_torch.models.layers import _scalar

F32 = torch.float32


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                  # per-expert hidden
    n_shared: int = 0          # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    compute_dtype: Any = torch.float32


# ---------------------------------------------------------------------------
# routing (shared by every path)
# ---------------------------------------------------------------------------
def _route(x2d: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """Returns (gates [T,k] f32 renormalized, idx [T,k] int64, aux_loss f32)."""
    logits = x2d.to(F32) @ router.to(F32)
    probs = torch.softmax(logits, dim=-1)                        # [T, E]
    # lax.top_k: the k largest, the lower index first on ties
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top.values[:, :cfg.top_k], top.indices[:, :cfg.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * mean_e(frac_tokens_e * mean_prob_e)
    t = _scalar(x2d.shape[0], probs)
    one_hot = F.one_hot(idx[:, 0], cfg.n_experts).to(F32)
    frac = (one_hot.sum(0) / t) * (probs.sum(0) / t)
    aux = cfg.n_experts * (frac.sum() / _scalar(cfg.n_experts, frac))
    return gates, idx, aux


def _shared_ffn(x2d: torch.Tensor, p, cfg: MoEConfig) -> torch.Tensor:
    cd = cfg.compute_dtype
    xc = x2d.to(cd)
    g = F.silu(xc @ p["shared_wg"].to(cd))
    h = g * (xc @ p["shared_wi"].to(cd))
    return h @ p["shared_wo"].to(cd)


def _group_sizes(sorted_ids: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Rows of each id in ``[0, n_groups)`` of ascending ``sorted_ids`` (ids
    past the groups last): a search of the group bounds, where ``bincount``
    on the card would read the ids' maximum back to the host."""
    bounds = torch.searchsorted(sorted_ids, torch.arange(n_groups + 1, device=sorted_ids.device))
    return bounds[1:] - bounds[:-1]


def _token_ids(t: int, k: int, device) -> torch.Tensor:
    """``repeat(arange(t), k)`` without ``repeat_interleave``, which reads
    its output length back to the host on the card."""
    return torch.arange(t, device=device)[:, None].expand(t, k).reshape(-1)


def _ragged_swiglu(xs: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                   group_sizes: torch.Tensor, cd) -> torch.Tensor:
    """``ragged_dot``'s grouped SwiGLU: rows ``[off_e, off_e + n_e)`` of
    ``xs`` (sorted by expert) through expert e, rows past the last group
    zero. One plain product per expert with rows; the row counts are read
    on the host once. On the meta device (``launch/dryrun.py``), which has no
    sizes to read, every row goes through expert 0's weights: the static
    ``ragged_dot``'s shape and FLOPs, no values."""
    if xs.device.type == "meta":
        sizes = [xs.shape[0]] + [0] * (wg.shape[0] - 1)
    else:
        sizes = group_sizes.tolist()  # the layer's one host read (see the module docstring)
    ys = torch.zeros((xs.shape[0], wo.shape[-1]), dtype=cd, device=xs.device)
    off = 0
    for e, n in enumerate(sizes):
        if n:
            rows = xs[off:off + n]
            h = F.silu(rows @ wg[e].to(cd)) * (rows @ wi[e].to(cd))
            ys[off:off + n] = h @ wo[e].to(cd)
            off += n
    return ys


# ---------------------------------------------------------------------------
# dense oracle
# ---------------------------------------------------------------------------
def moe_dense(x: torch.Tensor, p, cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """[B,S,D] -> ([B,S,D], aux_loss). All-experts compute; oracle only."""
    b, s, d = x.shape
    x2d = x.reshape(-1, d)
    gates, idx, aux = _route(x2d, p["router"], cfg)
    comb = torch.zeros((x2d.shape[0], cfg.n_experts), dtype=F32, device=x.device)
    for j in range(cfg.top_k):
        comb = comb + F.one_hot(idx[:, j], cfg.n_experts).to(F32) * gates[:, j:j + 1]
    cd = cfg.compute_dtype
    xc = x2d.to(cd)
    gh = F.silu(torch.einsum("td,edf->tef", xc, p["wg"].to(cd)))
    hh = gh * torch.einsum("td,edf->tef", xc, p["wi"].to(cd))
    ye = torch.einsum("tef,efd->ted", hh, p["wo"].to(cd))
    y = torch.einsum("ted,te->td", ye.to(F32), comb)
    if cfg.n_shared:
        y = y + _shared_ffn(x2d, p, cfg).to(F32)
    return y.to(x.dtype).reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# the expert-parallel path's body
# ---------------------------------------------------------------------------
class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, scale):
        ctx.scale = scale
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _scale_grad(t: torch.Tensor, scale: float) -> torch.Tensor:
    """``t``, whose gradient is scaled by ``scale``."""
    if scale == 1 or not (torch.is_grad_enabled() and t.requires_grad):
        return t
    return _GradScale.apply(t, scale)


def capacity(tk: int, model_size: int, capacity_factor: float) -> int:
    """The replicas a peer takes from a rank routing ``tk`` replicas over
    ``model_size`` peers: ``round(tk / model_size * capacity_factor)``
    rounded up to a multiple of 8, at least 8."""
    cap = int(round(tk / model_size * capacity_factor))
    return max(8, -(-cap // 8) * 8)


def _moe_local(x2d, router, wg, wi, wo, cfg: MoEConfig, model_size: int = 1,
               mesh=None, tp: str = "model", copies: int = 1):
    """The reference's per-device body: ``model_size`` ranks along ``tp``
    own ``e_loc`` experts each. With ``model_size = 1`` the send buffer is
    the receive buffer (no all-to-all); else ``mesh`` carries the three
    all-to-alls. ``copies`` is how many ``tp`` ranks send these same
    replicas (``_scale_grad``)."""
    t, d = x2d.shape
    dev = x2d.device
    e_loc = wg.shape[0]
    gates, idx, aux = _route(x2d, router, cfg)

    tk = t * cfg.top_k
    eid = idx.reshape(-1)                            # [tk] global expert id
    gate_r = gates.reshape(-1)                       # [tk]
    peer = torch.div(eid, e_loc, rounding_mode="floor")   # destination device

    cap = capacity(tk, model_size, cfg.capacity_factor)

    # position of each replica inside its peer bucket (stable order)
    order = torch.sort(peer, stable=True).indices
    peer_s = peer[order]
    start = torch.searchsorted(peer_s, torch.arange(model_size, device=dev))
    pos_s = torch.arange(tk, device=dev) - start[peer_s]
    pos = torch.empty_like(pos_s).scatter_(0, order, pos_s)   # unsorted view
    keep = pos < cap

    # mode="drop": a replica past the capacity writes to a spare slot `cap`,
    # which is cut off (valid (peer, pos) pairs are unique)
    slot = torch.where(keep, pos, cap)
    send = torch.zeros((model_size, cap + 1, d), dtype=x2d.dtype, device=dev)
    x_rep = x2d[:, None, :].expand(t, cfg.top_k, d).reshape(tk, d)   # x2d[repeat(arange(t), k)]
    send[peer, slot] = torch.where(keep[:, None], x_rep, _scalar(0, x2d, x2d.dtype))
    send_eid = torch.full((model_size, cap + 1), -1, dtype=torch.int64, device=dev)
    send_eid[peer, slot] = torch.where(keep, eid % e_loc, -1)

    recv, recv_eid = send[:, :cap], send_eid[:, :cap]
    if model_size > 1:
        recv = collective.all_to_all(recv, mesh, tp)
        recv_eid = collective.all_to_all(recv_eid, mesh, tp)
        wg, wi, wo = (_scale_grad(w, 1 / copies) for w in (wg, wi, wo))

    r = model_size * cap
    xr = recv.reshape(r, d)
    er = recv_eid.reshape(r)
    er_sort_key = torch.where(er < 0, e_loc, er)     # invalid slots last
    ord2 = torch.sort(er_sort_key, stable=True).indices
    cd = cfg.compute_dtype
    xs = xr[ord2].to(cd)
    es = er_sort_key[ord2]
    group_sizes = _group_sizes(es, e_loc)

    ys = _ragged_swiglu(xs, wg, wi, wo, group_sizes, cd)
    ys = torch.where((es < e_loc)[:, None], ys, _scalar(0, ys, ys.dtype))

    yr = torch.zeros_like(ys).index_copy_(0, ord2, ys).reshape(model_size, cap, d)
    if model_size > 1:
        yr = collective.all_to_all(yr, mesh, tp)
    y_rep = yr[peer, torch.clamp(pos, max=cap - 1)]  # [tk, D]; a gather clamps, as JAX's
    y_rep = torch.where(keep[:, None], y_rep, _scalar(0, y_rep, y_rep.dtype)) \
        * gate_r[:, None].to(yr.dtype)
    y = y_rep.to(F32).view(t, cfg.top_k, d).sum(1)
    return y.to(x2d.dtype), aux


def token_mean(aux: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """``aux`` averaged over the ranks along ``axes`` (those holding
    different tokens): one ``all_reduce_sum``, none where they are one
    rank."""
    n = mesh.axis_size(axes)
    if n == 1:
        return aux
    return collective.all_reduce_sum(aux, mesh, axes) / n


def moe_ep(x: torch.Tensor, p, cfg: MoEConfig, *, mesh=None, dp: tuple[str, ...] = ("data",),
           tp: str = "model", sp: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """[B,S,D] -> ([B,S,D], aux): the reference's expert-parallel layer.

    Without a mesh, its single-device body. Over ``mesh`` (a
    ``core.collective.Mesh`` with axes ``dp`` and ``tp``), this rank's
    share: ``x`` its ``[B / |dp|, S, D]`` block (``[B / |dp|, S / |tp|, D]``
    with ``sp``), ``p`` the router and shared experts whole and ``wg``,
    ``wi``, ``wo`` its ``E / |tp|`` experts (rank i along ``tp`` the i-th
    block); returns its block of the output and the mean ``aux``."""
    b, s, d = x.shape
    if mesh is None:
        y2d, aux = _moe_local(x.reshape(-1, d), p["router"], p["wg"], p["wi"], p["wo"], cfg)
    else:
        dp = tuple(dp)
        model_size = mesh.axis_size(tp)
        if p["wg"].shape[0] * model_size != cfg.n_experts:
            raise ValueError(f"{p['wg'].shape[0]} experts a rank over |{tp}| = {model_size} "
                             f"is not the config's {cfg.n_experts}")
        y2d, aux = _moe_local(x.reshape(-1, d), p["router"], p["wg"], p["wi"], p["wo"], cfg,
                              model_size=model_size, mesh=mesh, tp=tp,
                              copies=1 if sp else model_size)
        aux = token_mean(aux, mesh, dp + (tp,) if sp else dp)
    y = y2d.reshape(b, s, d)
    if cfg.n_shared:
        y = y + _shared_ffn(x.reshape(-1, d), p, cfg).to(x.dtype).reshape(b, s, d)
    return y, aux


def init_moe_params(cfg: MoEConfig, n_layers: int, param_dtype=torch.float32, *,
                    device=None, generator: torch.Generator | None = None) -> dict:
    """Stacked-over-layers MoE params with the reference's distributions
    (not its random values), drawn from ``generator`` on ``device`` (None
    means the GPU)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(shape, scale):
        w = torch.empty(shape, dtype=param_dtype, device=device)
        return w.normal_(generator=generator).mul_(scale)

    p = {"router": normal((n_layers, d, e), d ** -0.5),
         "wg": normal((n_layers, e, d, f), d ** -0.5),
         "wi": normal((n_layers, e, d, f), d ** -0.5),
         "wo": normal((n_layers, e, f, d), f ** -0.5)}
    if cfg.n_shared:
        fs = cfg.d_ff * cfg.n_shared
        p["shared_wg"] = normal((n_layers, d, fs), d ** -0.5)
        p["shared_wi"] = normal((n_layers, d, fs), d ** -0.5)
        p["shared_wo"] = normal((n_layers, fs, d), fs ** -0.5)
    return p


__all__ = ["MoEConfig", "moe_dense", "moe_ep", "init_moe_params", "token_mean", "capacity"]
