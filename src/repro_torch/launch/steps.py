"""Step factory: (arch, shape) -> a step that runs on the device.

The port of the JAX package's ``launch/steps.py`` (``make_optimizer``, the
LM ``prefill`` and ``decode`` kinds, ``_recsys_step``, ``_gnn_train`` and
``build_step``) for one device: no mesh, so n_dev = 1 and the model axis is
1 in JAX's formulas. Kinds:

  prefill   fn(model, tokens) -> (last_logits [B, V], kv_cache)
  decode    fn(model, cache, tokens, cache_len) -> (logits [B, V], cache')
  train     fn(params, opt_state, batch) -> (params', opt_state', loss)
  serve     fn(model, batch) -> CTR logits [B]
  retrieval fn(model, batch) -> scores [Q, C]

The LM serving kinds take a ``models.transformer.Transformer`` and run it
with the step's config (``arch.full`` with the reference's changes:
``flash_q_chunk = seq`` for prefill, a 4,096-entry sliding window for
long_500k on the GQA archs), under ``torch.inference_mode()``. Prefill
computes the logits of the last position only (``transformer.prefill``):
the same output as the reference's ``logits[:, -1]``. The decode kind
writes the cache in place (the reference donates it); give it
``init_cache(cfg, batch, seq)`` of the step's config.

The LM ``train`` kind is the reference's ``_lm_train`` at n_dev = 1: the
"zero3" layout (``arch.train_layout``; qwen2.5, phi3) runs ``flash_q_chunk
= flash_k_chunk = min(1024, seq)``, every other arch ``flash_q_chunk =
seq`` and ``flash_k_chunk = min(1024, seq)``. The ``[gb, seq]`` batch's
rows split into ``arch.microbatches`` microbatches; each one's gradient
``g`` is added as ``(g / m)`` cast to ``arch.grad_accum_dtype`` (bfloat16
for deepseek-v3 and grok-1) and its loss as ``loss / m``; then one update by
the arch's optimizer. It takes ``train_state``'s ``{"params", "opt"}`` of a
``Transformer`` and a ``data.lm_token_batches`` batch.

The serve kinds take the model (``models.recsys.DCNv2``, which carries its
config: ``multi_hot`` and ``kernel`` are the model's) and a batch of numpy
arrays or tensors, move the batch to the step's device and run under
``torch.inference_mode()``. The train kind (the LMs' ``train_4k``, DCN-v2's
``train_batch``, every shape of the GNN archs) is pure: it takes a
``named_parameters`` dict
(``train_state`` builds the first ``{"params", "opt"}`` from a model), runs
the arch's loss on a skeleton of the config through
``torch.func.functional_call``, differentiates it and returns new tensors
from the arch's optimizer; nothing it is given changes, so the train loop
may run it twice from one state. It differentiates the plain path, as the
JAX package's step does with ``impl="xla"``: K5 and K1 have no backward, so
a config that asks for them (a multi-hot DCN-v2 with the kernel on, a GNN
with ``kernel=True``) raises ``NotImplementedError`` rather than change
path; ``kernel=None`` trains on the plain path. A GNN step takes the batch
of ``data.gnn_batch`` / ``GraphBatcher`` / a sampled block at its own size
(JAX's static shapes pad it to the padded sizes in ``meta``) and the
shape's ``n_graphs``. Every kind runs its float32 products in full float32.
``meta`` carries the analytic ``model_flops`` and ``model_bytes_dev`` of
the config, and ``tokens`` (LM), ``rows`` (recsys; for retrieval the number
of candidates) or ``nodes`` and ``edges`` (GNN, padded as JAX pads them).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.common import Arch, Shape, sampled_subgraph_dims
from repro_torch.core.dispatch import resolve_device, resolve_kernel
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as rec_mod
from repro_torch.models import transformer as lm_mod
from repro_torch.models.layers import _scalar
from repro_torch.optim import Optimizer, adafactor, adamw, sgdm


@dataclass
class StepBundle:
    name: str
    kind: str
    fn: Callable
    meta: dict
    cfg: object = None   # the config an LM step runs (its cache is init_cache of it)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _param_bytes(cfg: rec_mod.DCNConfig) -> int:
    """Bytes of DCN-v2's float32 parameters (JAX's ``_tree_bytes``)."""
    d_in = cfg.d_in
    w = 2 * d_in * cfg.cross_rank if cfg.cross_rank else d_in * d_in
    dims = [d_in, *cfg.mlp, 1]
    mlp = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
    return 4 * (cfg.n_sparse * cfg.table_rows * cfg.embed_dim
                + cfg.n_cross_layers * (w + d_in) + mlp)


def make_optimizer(name: str) -> Optimizer:
    if name == "adamw":
        return adamw(3e-4)
    if name == "adafactor":
        return adafactor(1e-3)
    return sgdm(1e-2)


def train_state(model: torch.nn.Module, opt: Optimizer) -> dict:
    """The train kind's first state, ``{"params", "opt"}``: the model's
    parameters by name (detached; the step never writes them) and
    ``opt.init`` of them."""
    params = {k: v.detach() for k, v in model.named_parameters()}
    return {"params": params, "opt": opt.init(params)}


def _check_on(name: str, device: torch.device, on: torch.device, what: str) -> None:
    """A step's inputs must be on the step's device (the GPU's index may be
    left out)."""
    if on.type != device.type or device.index not in (None, on.index):
        raise ValueError(f"{name} runs on {device}; {what} on {on}")


def _check_precision() -> None:
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the steps run their float32 products in full float32, as the JAX "
            "reference does; torch.get_float32_matmul_precision() is "
            f"{torch.get_float32_matmul_precision()!r} (TF32): set it to 'highest'")


def _train_step(arch: Arch, skeleton: torch.nn.Module, loss_fn: Callable, extra: dict,
                device: torch.device, name: str, meta: dict) -> StepBundle:
    """The pure train kind: ``loss_fn(skeleton, batch, params)`` (the
    arch's loss on a config's skeleton) differentiated with respect to
    ``params`` and stepped by the arch's optimizer. The batch's arrays move
    to ``device``; ``extra`` overrides its other entries (JAX's static
    ``n_graphs``)."""
    opt = make_optimizer(arch.optimizer)

    def train(params, opt_state, batch):
        _check_precision()
        _check_on(name, device, next(iter(params.values())).device, "the parameters are")
        feed = {k: torch.as_tensor(v, device=device)
                if isinstance(v, (np.ndarray, torch.Tensor)) else v
                for k, v in batch.items()}
        feed.update(extra)
        loss, grads = _value_and_grad(lambda leaves: loss_fn(skeleton, feed, leaves), params)
        new_p, new_o = opt.update(grads, opt_state, params)
        return new_p, new_o, loss

    return StepBundle(name=name, kind="train", fn=train, meta=meta)


def _value_and_grad(loss_of: Callable, params: dict) -> tuple[torch.Tensor, dict]:
    """(``loss_of(params)`` detached, its gradient by name): ``jax.value_and_grad``
    over a dict of tensors, which stay untouched. A leaf the loss does not
    reach (EGNN's last phi_x) has a zero gradient, as in ``jax.grad``."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        loss = loss_of(leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


def _dcn_train(arch: Arch, cfg: rec_mod.DCNConfig, b: int, per_row: float,
               device: torch.device, name: str) -> StepBundle:
    if cfg.multi_hot > 1 and resolve_kernel(cfg.kernel, device):
        raise NotImplementedError(
            f"{name}: a multi-hot bag with the kernel on runs K5 "
            f"(kernels/ops.py:segment_embed), which has no backward, as the JAX "
            f"package's Pallas kernel has none; train with kernel=False")
    return _train_step(
        arch, rec_mod.DCNv2(cfg, device="meta"), rec_mod.dcn_loss, {}, device, name,
        meta={"model_flops": 3.0 * b * per_row,
              "model_bytes_dev": (8.0 * _param_bytes(cfg)        # opt RMW on tables
                                  + 3.0 * b * (cfg.n_sparse * cfg.embed_dim + cfg.d_in) * 4),
              "rows": b})


def _recsys_step(arch: Arch, shape: Shape, device: torch.device) -> StepBundle:
    cfg = arch.full
    d_in = cfg.d_in
    cross = cfg.n_cross_layers * 2.0 * d_in * d_in
    dims = [d_in] + list(cfg.mlp) + [1]
    mlp = sum(2.0 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    per_row = cross + mlp
    b = shape.dims["batch"]
    name = f"{arch.name}:{shape.name}"

    if shape.kind == "train":
        return _dcn_train(arch, cfg, b, per_row, device, name)

    def run(model, batch, keys, forward):
        _check_precision()
        _check_on(name, device, model.tables.device, "the model is")
        with torch.inference_mode():
            return forward(model, {k: torch.as_tensor(batch[k], device=device)
                                   for k in keys})

    if shape.kind == "serve":
        def serve(model, batch):
            return run(model, batch, ("dense", "sparse_ids"), rec_mod.dcn_forward)
        return StepBundle(
            name=name, kind="serve", fn=serve,
            meta={"model_flops": b * per_row,
                  "model_bytes_dev": _param_bytes(cfg) + b * d_in * 4 * 2,
                  "rows": b})

    # retrieval: 1 query vs 1M candidates (rounded up as JAX rounds for its mesh)
    c = _round_up(shape.dims["n_candidates"], 512)

    def retrieval(model, batch):
        return run(model, batch, ("dense", "sparse_ids", "candidates"),
                   rec_mod.retrieval_score)
    return StepBundle(
        name=name, kind="retrieval", fn=retrieval,
        meta={"model_flops": 2.0 * b * c * cfg.embed_dim + b * per_row,
              "model_bytes_dev": c * cfg.embed_dim * 4 * 2,
              "rows": c})


# ===========================================================================
# LM family
# ===========================================================================
def _nbytes(tensors) -> int:
    """Bytes of tensors (on the meta device: shapes only; JAX's ``_tree_bytes``)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def _lm_param_bytes(cfg: lm_mod.TransformerConfig) -> int:
    return _nbytes(lm_mod.Transformer(cfg, device="meta").parameters())


def _lm_cache_bytes(cfg: lm_mod.TransformerConfig, batch: int, seq: int) -> int:
    return _nbytes(lm_mod.init_cache(cfg, batch, seq, device="meta").values())


def _lm_model_flops(cfg: lm_mod.TransformerConfig, kind: str, batch: int, seq: int) -> float:
    """Analytic step FLOPs (JAX's formula): 6*N_active*D (+causal
    attention) for train, 2*N_active*D (+attention) for prefill/decode."""
    n_act = cfg.n_active_params()
    if cfg.attn == "mla":
        attn_tok = 2 * cfg.n_heads * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
    else:
        attn_tok = 4 * cfg.n_heads * cfg.hd
    if kind == "train":
        attn = 3 * cfg.n_layers * batch * seq * (seq / 2) * attn_tok / 2
        return 6.0 * n_act * batch * seq + attn
    if kind == "prefill":
        attn = cfg.n_layers * batch * seq * (seq / 2) * attn_tok / 2
        return 2.0 * n_act * batch * seq + attn
    s_eff = min(seq, cfg.sliding_window or seq)
    attn = cfg.n_layers * batch * s_eff * attn_tok
    return 2.0 * n_act * batch + attn


def _lm_model_bytes(cfg: lm_mod.TransformerConfig, kind: str, batch: int, seq: int,
                    p_bytes: int, cache_bytes: int = 0, m: int = 1) -> float:
    """Analytic HBM traffic of one step (JAX's ``_lm_model_bytes`` at n_dev
    = 1 and a model axis of 1): parameter streams (for train, forward and
    backward reads a microbatch plus the optimizer's read-modify-write),
    activations, logits, the KV cache."""
    n_dev = tp = 1
    p_dev = p_bytes / n_dev
    ab = 2  # bf16 activations
    if kind == "train":
        t_sp = batch * seq / max(n_dev, 1)
        param_traffic = p_dev * (4 * m + 6)
        act = 10 * cfg.n_layers * t_sp * cfg.d_model * ab
        logits = 3.0 * batch * seq / (n_dev / tp) * (cfg.vocab / tp) * 4
        return param_traffic + act + logits
    cache = cache_bytes / n_dev
    if kind == "prefill":
        t_dev = batch * seq / n_dev
        return 2 * p_dev + 8 * cfg.n_layers * t_dev * cfg.d_model * ab + cache
    return p_dev + 2 * cache + batch * cfg.d_model * cfg.n_layers * ab / n_dev


def _lm_check_model(model, name: str, device: torch.device) -> None:
    _check_precision()
    _check_on(name, device, model.embed.device, "the model is")


def _lm_prefill(arch: Arch, shape: Shape, device: torch.device) -> StepBundle:
    gb, seq = shape.dims["global_batch"], shape.dims["seq_len"]
    cfg = replace(arch.full, flash_q_chunk=seq, flash_k_chunk=1024)
    name = f"{arch.name}:{shape.name}"

    def prefill(model, tokens):
        _lm_check_model(model, name, device)
        with torch.inference_mode():
            return lm_mod.prefill(model, torch.as_tensor(tokens, device=device), cfg)

    return StepBundle(
        name=name, kind="prefill", fn=prefill,
        meta={"model_flops": _lm_model_flops(cfg, "prefill", gb, seq),
              "model_bytes_dev": _lm_model_bytes(cfg, "prefill", gb, seq, _lm_param_bytes(cfg),
                                                 _lm_cache_bytes(cfg, gb, seq)),
              "tokens": gb * seq}, cfg=cfg)


def _lm_decode(arch: Arch, shape: Shape, device: torch.device) -> StepBundle:
    gb, seq = shape.dims["global_batch"], shape.dims["seq_len"]
    cfg = arch.full
    if seq > 100_000 and cfg.attn != "mla":
        cfg = replace(cfg, sliding_window=4096)   # the adapted long_500k cell
    name = f"{arch.name}:{shape.name}"

    def decode(model, cache, tokens, cache_len):
        _lm_check_model(model, name, device)
        with torch.inference_mode():
            return lm_mod.decode_step(model, cache, torch.as_tensor(tokens, device=device),
                                      cache_len, cfg)

    return StepBundle(
        name=name, kind="decode", fn=decode,
        meta={"model_flops": _lm_model_flops(cfg, "decode", gb, seq),
              "model_bytes_dev": _lm_model_bytes(cfg, "decode", gb, seq, _lm_param_bytes(cfg),
                                                 _lm_cache_bytes(cfg, gb, seq)),
              "tokens": gb}, cfg=cfg)


def _lm_train(arch: Arch, shape: Shape, device: torch.device) -> StepBundle:
    gb, seq = shape.dims["global_batch"], shape.dims["seq_len"]
    if arch.train_layout == "zero3":   # n_dev = 1 divides every batch
        cfg = replace(arch.full, flash_q_chunk=min(1024, seq), flash_k_chunk=min(1024, seq))
    else:
        cfg = replace(arch.full, flash_q_chunk=seq, flash_k_chunk=min(1024, seq))
    m = arch.microbatches
    if gb % m:
        raise ValueError(f"{arch.name}: global batch {gb} is not a multiple of "
                         f"{m} microbatches")
    name = f"{arch.name}:{shape.name}"
    opt = make_optimizer(arch.optimizer)
    acc_dt = getattr(torch, arch.grad_accum_dtype)   # "float32" or "bfloat16"
    skeleton = lm_mod.Transformer(cfg, device="meta")

    def grad(tok, lab, params):
        return _value_and_grad(lambda leaves: lm_mod.loss_fn(skeleton, tok, lab, cfg, leaves),
                               params)

    def train(params, opt_state, batch):
        _check_precision()
        _check_on(name, device, next(iter(params.values())).device, "the parameters are")
        tokens = torch.as_tensor(batch["tokens"], device=device)
        labels = torch.as_tensor(batch["labels"], device=device)
        if m == 1:
            loss, grads = grad(tokens, labels, params)
        else:
            toks = tokens.reshape(m, gb // m, seq)
            labs = labels.reshape(m, gb // m, seq)
            # the accumulator is the step's own: added to in place, leaf by leaf
            grads = {k: torch.zeros(v.shape, dtype=acc_dt, device=device)
                     for k, v in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(m):
                loss_i, g = grad(toks[i], labs[i], params)
                for k in grads:
                    gk = g.pop(k)
                    grads[k].add_((gk / _scalar(m, gk, gk.dtype)).to(acc_dt))
                loss = loss + loss_i / _scalar(m, loss_i)
        new_p, new_o = opt.update(grads, opt_state, params)
        return new_p, new_o, loss

    return StepBundle(
        name=name, kind="train", fn=train,
        meta={"model_flops": _lm_model_flops(cfg, "train", gb, seq),
              "model_bytes_dev": _lm_model_bytes(cfg, "train", gb, seq, _lm_param_bytes(cfg),
                                                 m=m),
              "tokens": gb * seq}, cfg=cfg)


def _lm_step(arch: Arch, shape: Shape, device: torch.device) -> StepBundle:
    if shape.kind == "prefill":
        return _lm_prefill(arch, shape, device)
    if shape.kind == "decode":
        return _lm_decode(arch, shape, device)
    return _lm_train(arch, shape, device)


# ===========================================================================
# GNN family
# ===========================================================================
_GNN_FNS = {
    gnn_mod.GCNConfig: (gnn_mod.GCN, gnn_mod.gcn_loss),
    gnn_mod.SchNetConfig: (gnn_mod.SchNet, gnn_mod.schnet_loss),
    gnn_mod.EGNNConfig: (gnn_mod.EGNN, gnn_mod.egnn_loss),
    gnn_mod.MACEConfig: (gnn_mod.MACE, gnn_mod.mace_loss),
}


def _gnn_dims(shape: Shape, n_dev: int) -> tuple[int, int, int, int]:
    """(n_nodes_padded, n_directed_padded, n_graphs, d_feat)."""
    d = shape.dims
    if shape.name == "minibatch_lg":
        n, e = sampled_subgraph_dims(d["batch_nodes"], d["fanout"])
        e_dir = e          # sampler emits child->parent single direction
        feat = 602         # Reddit-style features for the sampled benchmark
    elif shape.name == "molecule":
        n = d["n_nodes"] * d["batch"]
        e_dir = 2 * d["n_edges"] * d["batch"]
        feat = 32
    else:
        n = d["n_nodes"]
        e_dir = 2 * d["n_edges"]
        feat = d.get("d_feat", 100)
    n_pad = _round_up(n, 512)
    e_pad = _round_up(e_dir, max(512, n_dev))
    n_graphs = d.get("batch", 1)
    return n_pad, e_pad, n_graphs, feat


def _gnn_model_flops(cfg, n: int, e: int, kind_train: bool) -> float:
    mult = 3.0 if kind_train else 1.0
    if isinstance(cfg, gnn_mod.GCNConfig):
        dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
        fwd = sum(2.0 * n * dims[i] * dims[i + 1] + 2.0 * e * dims[i + 1]
                  for i in range(cfg.n_layers))
    elif isinstance(cfg, gnn_mod.SchNetConfig):
        dh = cfg.d_hidden
        fwd = cfg.n_interactions * (
            2.0 * e * (cfg.n_rbf * dh + dh * dh + 2 * dh) + 2.0 * n * 2 * dh * dh)
    elif isinstance(cfg, gnn_mod.EGNNConfig):
        dh = cfg.d_hidden
        fwd = cfg.n_layers * (2.0 * e * (2 * dh + 1) * dh + 2.0 * e * dh * dh
                              + 2.0 * n * 2 * dh * dh)
    else:  # MACE
        dh, m = cfg.d_hidden, (cfg.l_max + 1) ** 2
        n_inv = (cfg.l_max + 1) * cfg.correlation
        fwd = cfg.n_layers * (
            2.0 * e * (cfg.n_rbf * dh + m * dh) + 2.0 * n * n_inv * dh * dh
            + 2.0 * n * 2 * dh * dh)
    return mult * fwd


def _gnn_model_bytes(cfg, n: int, e: int, n_dev: int) -> float:
    """Per-device traffic: edge gathers/scatters (x3 fwd/bwd/recomp)
    + node arrays read per layer."""
    d = getattr(cfg, "d_hidden", 16)
    L = getattr(cfg, "n_layers", getattr(cfg, "n_interactions", 2))
    feat = getattr(cfg, "d_feat", 0)
    e_dev = e / n_dev
    return 3 * (n * feat * 4 + L * (e_dev * d * 8 + n * d * 8))


def _gnn_train(arch: Arch, shape: Shape, device: torch.device) -> StepBundle:
    n, e, n_graphs, feat = _gnn_dims(shape, 1)
    cfg = arch.full
    if isinstance(cfg, gnn_mod.GCNConfig):
        cfg = replace(cfg, d_feat=feat)
    name = f"{arch.name}:{shape.name}"
    if cfg.kernel:
        raise NotImplementedError(
            f"{name}: kernel=True sums the messages with K1 "
            f"(kernels/segsum.py:segment_sum_sorted), which has no backward, as "
            f"jax.grad through the JAX package's Pallas kernel raises; train with "
            f"kernel=None or False (the plain path)")
    model_cls, loss_fn = _GNN_FNS[type(cfg)]
    return _train_step(
        arch, model_cls(replace(cfg, kernel=False), device="meta"), loss_fn,
        {"n_graphs": n_graphs}, device, name,
        meta={"model_flops": _gnn_model_flops(cfg, n, e, True),
              "model_bytes_dev": _gnn_model_bytes(cfg, n, e, 1),
              "nodes": n, "edges": e})


def build_step(arch_name: str, shape_name: str, device=None) -> StepBundle:
    """The step of one cell on ``device`` (None means the GPU, and raises
    without one)."""
    device = resolve_device(device)
    arch = get_arch(arch_name)
    shape = arch.shape(shape_name)
    if arch.family == "lm":
        return _lm_step(arch, shape, device)
    if arch.family == "gnn":
        return _gnn_train(arch, shape, device)
    return _recsys_step(arch, shape, device)


__all__ = ["StepBundle", "build_step", "make_optimizer", "train_state"]
