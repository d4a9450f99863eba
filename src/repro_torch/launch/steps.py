"""Step factory: (arch, shape) -> a step that runs on the device.

The port of the JAX package's ``launch/steps.py`` (``make_optimizer``, the
LM ``prefill``, ``decode`` and ``train`` kinds, ``_recsys_step``,
``_gnn_train``, ``build_step`` and ``all_cells``), on one device (n_dev = 1
and the model axis 1 in JAX's formulas) or over a mesh (below). Kinds:

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

``build_step(arch, shape, mesh=...)`` builds the reference's step over a
mesh for every kind. ``mesh`` is a
``core.collective.Mesh`` of live ranks (every rank builds and calls the
step together; the step runs on the mesh's device), or a
``launch.mesh.MeshLayout`` for ``meta`` alone (calling its ``fn`` raises).
Each kind takes the same global inputs as on one device and uses this
rank's share; parameters, optimizer states and caches are this rank's
slices (``step.specs``, ``step.cache_specs``):

  prefill   fn(model, tokens [gb, S]) -> (this rank's batch block's last
            logits, cache slices in ``transformer.cache_specs``' layout)
  decode    fn(model, cache, tokens [gb], cache_len) -> (this rank's
            tokens' logits, cache), the cache in ``decode_cache_specs``'
            layout (``init_cache(step.cfg, gb, S, mesh=, specs=step.cache_specs)``)
  train     fn(params, opt_state, batch) -> (params', opt_state', loss):
            the LMs' ``_lm_train`` layout choice (zero3 only where the
            batch covers the mesh, its batch axes trimmed; tp_sp else),
            ``step.grad(params, batch)`` its (loss, gradients) and
            ``step.opt`` its optimizer (``opt.init(params, (mesh,
            step.specs))``); the GNNs' parameters replicated, its lanes and
            node rows split over the mesh, under
            ``ops.segment_output_sharding`` (``ogb_products``: the reference's
            node blocks over the batch axes; the others: none), K1 on each
            rank with the kernel on; DCN-v2's tables' rows over ``"model"``
            (``recsys.param_specs``), the rest whole, its batch's rows over
            the batch axes, the loss the global mean and every gradient summed
            over the batch axes (the tables' too; none over ``"model"``)
  serve     fn(model, batch) -> this rank's block of the [B] logits, the
            batch's rows over the batch axes, the model a ``DCNv2`` over the
            step's mesh (this rank's table rows; K5 on them for multi-hot
            bags with the kernel on)
  retrieval fn(model, batch) -> this rank's [Q, C / n_dev] columns, the
            candidates' rows split over every axis, the query whole

The LM train kind gathers every weight it uses once a step (over its FSDP
axes, or the whole mesh for zero3), accumulates the microbatches' gradients
of the gathered weights in ``grad_accum_dtype``, and then sums each over
the ranks that hold a part of it (``transformer.grad_sum_axes``) and keeps
this rank's slice: the reference's gradients, summed once a step rather
than once a microbatch.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

import math

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.common import Arch, Shape, sampled_subgraph_dims
from repro_torch.core import collective
from repro_torch.core.dispatch import resolve_device, resolve_kernel
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import axis_sizes, dp_axes, n_devices
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as rec_mod
from repro_torch.models import transformer as lm_mod
from repro_torch.models.layers import ShardCtx, _scalar
from repro_torch.models.shard import local_slice, norm_spec
from repro_torch.optim import Optimizer, adafactor, adamw, sgdm


@dataclass
class StepBundle:
    name: str
    kind: str
    fn: Callable
    meta: dict
    cfg: object = None   # the config an LM step runs (its cache is init_cache of it)
    mesh: object = None  # the mesh the step runs over (None: one device)
    ctx: object = None   # the LM kinds' ShardCtx over the mesh
    specs: dict | None = None        # parameter specs by name over the mesh
    cache_specs: dict | None = None  # the LM serving kinds' cache specs
    grad: Callable | None = None     # the train kind's (params, batch) -> (loss, grads)
    opt: Optimizer | None = None     # the train kind's optimizer


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


def train_state(model: torch.nn.Module, opt: Optimizer, layout=None) -> dict:
    """The train kind's first state, ``{"params", "opt"}``: the model's
    parameters by name (detached; the step never writes them) and
    ``opt.init`` of them. Over a mesh, ``model`` holds this rank's slices
    and ``layout`` is ``(mesh, step.specs)``."""
    params = {k: v.detach() for k, v in model.named_parameters()}
    return {"params": params, "opt": opt.init(params, layout)}


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

    def value_and_grad(params, batch):
        _check_precision()
        _check_on(name, device, next(iter(params.values())).device, "the parameters are")
        feed = {k: torch.as_tensor(v, device=device)
                if isinstance(v, (np.ndarray, torch.Tensor)) else v
                for k, v in batch.items()}
        feed.update(extra)
        return _value_and_grad(lambda leaves: loss_fn(skeleton, feed, leaves), params)

    def train(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch)
        new_p, new_o = opt.update(grads, opt_state, params)
        return new_p, new_o, loss

    return StepBundle(name=name, kind="train", fn=train, meta=meta, grad=value_and_grad,
                      opt=opt)


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


def _block(a, mesh, axes):
    """This rank's block of rows of ``a`` (numpy or a tensor) along ``axes``
    (every axis for None; all of them for no axes)."""
    n = mesh.axis_size(axes)
    if a.shape[0] % n:
        raise ValueError(f"{a.shape[0]} rows do not split over {mesh.axes_of(axes)} "
                         f"({n} ranks)")
    w = a.shape[0] // n
    i = mesh.axis_index(axes)
    return a[i * w:(i + 1) * w]


def _dcn_train(arch: Arch, cfg: rec_mod.DCNConfig, device: torch.device, name: str,
               meta: dict, mesh=None, specs=None) -> StepBundle:
    if cfg.multi_hot > 1 and resolve_kernel(cfg.kernel, device):
        raise NotImplementedError(
            f"{name}: a multi-hot bag with the kernel on runs K5 "
            f"(kernels/ops.py:segment_embed), which has no backward, as the JAX "
            f"package's Pallas kernel has none; train with kernel=False")
    if mesh is None:
        return _train_step(arch, rec_mod.DCNv2(cfg, device="meta"), rec_mod.dcn_loss, {},
                           device, name, meta)
    dp = dp_axes(mesh)
    # a layout (no ranks) has no skeleton: its fn refuses to run
    skeleton = (rec_mod.DCNv2(cfg, device="meta", mesh=mesh)
                if isinstance(mesh, collective.Mesh) else None)
    opt = make_optimizer(arch.optimizer)
    layout = (mesh, specs)

    def value_and_grad(params, batch):
        m = _ranks_of(mesh, name)
        _check_precision()
        _check_on(name, device, next(iter(params.values())).device, "the parameters are")
        rows = batch["labels"].shape[0]
        feed = {k: torch.as_tensor(_block(batch[k], m, dp), device=device)
                for k in ("dense", "sparse_ids", "labels")}
        # this rank's rows' terms over the global batch; the loss and every
        # gradient summed over the batch axes in one all-reduce
        loss, grads = _value_and_grad(
            lambda leaves: rec_mod.dcn_loss(skeleton, feed, leaves, divisor=rows), params)
        flat = collective.all_reduce_sum(
            torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads.values()]), m, dp)
        out, at = {}, 1
        for k, g in grads.items():
            out[k] = flat[at:at + g.numel()].view_as(g)
            at += g.numel()
        return flat[0].clone(), out   # the loss holds no view of the gradients

    def train(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch)
        new_p, new_o = opt.update(grads, opt_state, params, layout)
        return new_p, new_o, loss

    return StepBundle(name=name, kind="train", fn=train, meta=meta, mesh=mesh, specs=specs,
                      grad=value_and_grad, opt=opt)


def _recsys_step(arch: Arch, shape: Shape, device: torch.device, mesh=None) -> StepBundle:
    cfg = arch.full
    d_in = cfg.d_in
    cross = cfg.n_cross_layers * 2.0 * d_in * d_in
    dims = [d_in] + list(cfg.mlp) + [1]
    mlp = sum(2.0 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    per_row = cross + mlp
    b = shape.dims["batch"]
    name = f"{arch.name}:{shape.name}"
    # the reference's formulas: n_dev devices, the tables' rows over |model|
    n_dev = n_devices(mesh) if mesh is not None else 1
    tp = axis_sizes(mesh)["model"] if mesh is not None else 1
    specs = rec_mod.param_specs(cfg) if mesh is not None else None
    p_bytes = _param_bytes(cfg)

    if shape.kind == "train":
        return _dcn_train(arch, cfg, device, name, mesh=mesh, specs=specs, meta={
            "model_flops": 3.0 * b * per_row,
            "model_bytes_dev": (8.0 * p_bytes / tp           # opt RMW on tables
                                + 3.0 * (b / n_dev) * (cfg.n_sparse * cfg.embed_dim + d_in) * 4),
            "rows": b})

    def run(model, batch, keys, forward, split):
        m = _ranks_of(mesh, name)
        _check_precision()
        _check_on(name, device, model.tables.device, "the model is")
        if model.mesh != m:
            raise ValueError(f"{name} runs over {m}; the model holds its tables over "
                             f"{model.mesh}")
        feed = {k: batch[k] if m is None or k not in split else _block(batch[k], m, split[k])
                for k in keys}
        with torch.inference_mode():
            return forward(model, {k: torch.as_tensor(v, device=device)
                                   for k, v in feed.items()})

    if shape.kind == "serve":
        dp = dp_axes(mesh) if mesh is not None else ()

        def serve(model, batch):
            return run(model, batch, ("dense", "sparse_ids"), rec_mod.dcn_forward,
                       {"dense": dp, "sparse_ids": dp})
        return StepBundle(
            name=name, kind="serve", fn=serve, mesh=mesh, specs=specs,
            meta={"model_flops": b * per_row,
                  "model_bytes_dev": p_bytes / tp + (b / n_dev) * d_in * 4 * 2,
                  "rows": b})

    # retrieval: 1 query vs 1M candidates, rounded up as JAX rounds for its mesh
    c = _round_up(shape.dims["n_candidates"], max(512, n_dev))

    def retrieval(model, batch):
        return run(model, batch, ("dense", "sparse_ids", "candidates"),
                   rec_mod.retrieval_score, {"candidates": None})
    return StepBundle(
        name=name, kind="retrieval", fn=retrieval, mesh=mesh, specs=specs,
        meta={"model_flops": 2.0 * b * c * cfg.embed_dim + b * per_row,
              "model_bytes_dev": (c / n_dev) * cfg.embed_dim * 4 * 2,
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
                    p_bytes: int, cache_bytes: int = 0, m: int = 1, n_dev: int = 1,
                    tp: int = 1) -> float:
    """Analytic per-device HBM traffic of one step (JAX's
    ``_lm_model_bytes``; one device: n_dev = tp = 1): parameter streams (for
    train, forward and backward reads a microbatch plus the optimizer's
    read-modify-write), activations, logits, the KV cache."""
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


def _ranks_of(mesh, name: str):
    """``mesh`` (None: one device), refused where it is a ``MeshLayout``
    (no ranks to run over)."""
    if mesh is not None and not isinstance(mesh, collective.Mesh):
        raise ValueError(f"{name} was built over a layout for its meta; build it over a "
                         f"core.collective.Mesh to run it")
    return mesh


def _lm_mesh_meta(cfg, kind: str, gb: int, seq: int, mesh, m: int = 1, cache=None) -> dict:
    n_dev = n_devices(mesh) if mesh is not None else 1
    tp = axis_sizes(mesh)["model"] if mesh is not None else 1
    cache_bytes = _lm_cache_bytes(cfg, gb, seq) if cache else 0
    return {"model_flops": _lm_model_flops(cfg, kind, gb, seq),
            "model_bytes_dev": _lm_model_bytes(cfg, kind, gb, seq, _lm_param_bytes(cfg),
                                               cache_bytes, m, n_dev, tp),
            "tokens": gb * seq if kind != "decode" else gb}


def _lm_prefill(arch: Arch, shape: Shape, device: torch.device, mesh=None) -> StepBundle:
    gb, seq = shape.dims["global_batch"], shape.dims["seq_len"]
    cfg = replace(arch.full, flash_q_chunk=seq, flash_k_chunk=1024)
    name = f"{arch.name}:{shape.name}"
    ctx = specs = cspecs = None
    if mesh is not None:
        dp = dp_axes(mesh)
        ctx = ShardCtx(mesh=mesh, dp=dp, sp=True)   # sequence-parallel prefill
        specs, cspecs = lm_mod.param_specs(cfg, mesh), lm_mod.cache_specs(cfg, dp)

    def prefill(model, tokens):
        m = _ranks_of(mesh, name)
        _lm_check_model(model, name, device)
        tokens = torch.as_tensor(tokens, device=device)
        with torch.inference_mode():
            if m is None:
                return lm_mod.prefill(model, tokens, cfg)
            return lm_mod.prefill(model, _block(tokens, m, ctx.dp), cfg, ctx=ctx, mesh=m)

    return StepBundle(name=name, kind="prefill", fn=prefill,
                      meta=_lm_mesh_meta(cfg, "prefill", gb, seq, mesh, cache=True), cfg=cfg,
                      mesh=mesh, ctx=ctx, specs=specs, cache_specs=cspecs)


def _lm_decode(arch: Arch, shape: Shape, device: torch.device, mesh=None) -> StepBundle:
    gb, seq = shape.dims["global_batch"], shape.dims["seq_len"]
    cfg = arch.full
    if seq > 100_000 and cfg.attn != "mla":
        cfg = replace(cfg, sliding_window=4096)   # the adapted long_500k cell
    name = f"{arch.name}:{shape.name}"
    ctx = specs = cspecs = None
    if mesh is not None:
        # gb=1 cannot split over the batch axes: replicated-token decode
        ctx = ShardCtx(mesh=mesh, dp=dp_axes(mesh) if gb > 1 else ())
        specs = lm_mod.param_specs(cfg, mesh)
        cspecs = lm_mod.decode_cache_specs(cfg, mesh, gb)

    def decode(model, cache, tokens, cache_len):
        m = _ranks_of(mesh, name)
        _lm_check_model(model, name, device)
        tokens = torch.as_tensor(tokens, device=device)
        with torch.inference_mode():
            if m is None:
                return lm_mod.decode_step(model, cache, tokens, cache_len, cfg)
            return lm_mod.decode_step(model, cache, _block(tokens, m, ctx.dp), cache_len, cfg,
                                      ctx=ctx, mesh=m)

    return StepBundle(name=name, kind="decode", fn=decode,
                      meta=_lm_mesh_meta(cfg, "decode", gb, seq, mesh, cache=True), cfg=cfg,
                      mesh=mesh, ctx=ctx, specs=specs, cache_specs=cspecs)


def _reduce_grad(g: torch.Tensor, spec, ctx: ShardCtx, mesh) -> torch.Tensor:
    """A rank's gradient of a weight it gathered for its use, as its
    slice's gradient (``transformer.grad_sum_axes``)."""
    summed, gathered, repeat = lm_mod.grad_sum_axes(spec, ctx, mesh)
    if summed:
        g = collective.all_reduce_sum(g.contiguous(), mesh, summed)
    if gathered:
        keep = tuple(tuple(a for a in names if a in gathered) or None
                     for names in norm_spec(spec, g.dim()))
        g = local_slice(g, keep, mesh).contiguous()
    if repeat > 1:
        g = g / _scalar(repeat, g, g.dtype)
    return g


def _lm_train(arch: Arch, shape: Shape, device: torch.device, mesh=None) -> StepBundle:
    gb, seq = shape.dims["global_batch"], shape.dims["seq_len"]
    # zero3 only where the batch covers the mesh (n_dev = 1 covers every
    # batch); else tp_sp with one q block a sequence
    zero3 = arch.train_layout == "zero3" and gb % (n_devices(mesh) if mesh else 1) == 0
    if zero3:
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
    ctx = specs = None
    if mesh is not None:
        if zero3:
            # pure DP: the batch over as many mesh axes as divide it (a
            # microbatch's rows: the reference's arches with zero3 take one),
            # the state split over the whole mesh whatever they are
            axes = list(mesh.axis_names)
            sizes = axis_sizes(mesh)
            while axes and (gb // m) % math.prod(sizes[a] for a in axes):
                axes.pop()
            ctx = ShardCtx(mesh=mesh, dp=tuple(axes), tp=None, sp=False)
            specs = lm_mod.param_specs_zero3(cfg, mesh)
        else:
            ctx = ShardCtx(mesh=mesh, dp=dp_axes(mesh), sp=True)
            specs = lm_mod.param_specs(cfg, mesh)

    def accumulate(tokens, labels, params):
        """(loss, gradients of ``params``) over the microbatches: each one's
        gradient added as (g / m) in ``acc_dt``, its loss as loss / m.
        Over a mesh, this rank's rows of each microbatch."""
        kw = {} if mesh is None else {"ctx": ctx, "mesh": mesh}
        if tokens.shape[0] % m:
            raise ValueError(f"{name}: a batch of {tokens.shape[0]} rows is not a multiple of "
                             f"{m} microbatches")
        rows = tokens.shape[0] // m
        per, first = rows, 0
        if mesh is not None:
            nb = mesh.axis_size(ctx.dp)
            if rows % nb:
                raise ValueError(f"{name}: a microbatch of {rows} rows does not split over "
                                 f"{ctx.dp} ({nb} ranks)")
            per = rows // nb
            first = mesh.axis_index(ctx.dp) * per

        def grad(i, leaves):
            tok = tokens[i * rows + first:i * rows + first + per]
            lab = labels[i * rows + first:i * rows + first + per]
            return _value_and_grad(
                lambda lv: lm_mod.loss_fn(skeleton, tok, lab, cfg, lv, **kw), leaves)

        if m == 1:
            return grad(0, params)
        # the accumulator is the step's own: added to in place, leaf by leaf
        grads = {k: torch.zeros(v.shape, dtype=acc_dt, device=v.device)
                 for k, v in params.items()}
        loss = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(m):
            loss_i, g = grad(i, params)
            for k in grads:
                gk = g.pop(k)
                grads[k].add_((gk / _scalar(m, gk, gk.dtype)).to(acc_dt))
            loss = loss + loss_i / _scalar(m, loss_i)
        return loss, grads

    def value_and_grad(params, batch):
        _ranks_of(mesh, name)
        _check_precision()
        _check_on(name, device, next(iter(params.values())).device, "the parameters are")
        tokens = torch.as_tensor(batch["tokens"], device=device)
        labels = torch.as_tensor(batch["labels"], device=device)
        if mesh is None:
            return accumulate(tokens, labels, params)
        ranks = lm_mod._Ranks(cfg, ctx, mesh)
        # every weight gathered once a step for this rank's use
        work = {k: ranks.weight(k, v.detach()) for k, v in params.items()}
        loss, grads = accumulate(tokens, labels, work)
        del work
        return loss, {k: _reduce_grad(grads.pop(k), specs[k], ctx, mesh) for k in params}

    layout = None if mesh is None else (mesh, specs)

    def train(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch)
        new_p, new_o = opt.update(grads, opt_state, params, layout)
        return new_p, new_o, loss

    return StepBundle(name=name, kind="train", fn=train,
                      meta=_lm_mesh_meta(cfg, "train", gb, seq, mesh, m=m), cfg=cfg,
                      mesh=mesh, ctx=ctx, specs=specs, grad=value_and_grad, opt=opt)


def _lm_step(arch: Arch, shape: Shape, device: torch.device, mesh=None) -> StepBundle:
    if shape.kind == "prefill":
        return _lm_prefill(arch, shape, device, mesh)
    if shape.kind == "decode":
        return _lm_decode(arch, shape, device, mesh)
    return _lm_train(arch, shape, device, mesh)


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


_GNN_LANES = ("src", "dst")      # split over every mesh axis
_GNN_GRAPHS = ("energy",)        # whole on every rank; the other arrays are node rows


def _gnn_share(batch: dict, mesh, device: torch.device) -> dict:
    """This rank's share of a GNN batch (numpy arrays or tensors; the
    integers stay as they are): the lanes and the node rows each split over
    every mesh axis in rank order, the per-graph arrays whole."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, (np.ndarray, torch.Tensor)):
            out[k] = v
            continue
        if k not in _GNN_GRAPHS:
            if v.shape[0] % mesh.size:
                raise ValueError(f"{k}: {v.shape[0]} rows do not split over {mesh.size} ranks")
            w = v.shape[0] // mesh.size
            v = v[mesh.rank * w:(mesh.rank + 1) * w]
        out[k] = torch.as_tensor(v, device=device)
    return out


def _gnn_train(arch: Arch, shape: Shape, device: torch.device, mesh=None) -> StepBundle:
    n, e, n_graphs, feat = _gnn_dims(shape, n_devices(mesh) if mesh is not None else 1)
    cfg = arch.full
    if isinstance(cfg, gnn_mod.GCNConfig):
        cfg = replace(cfg, d_feat=feat)
    name = f"{arch.name}:{shape.name}"
    model_cls, loss_fn = _GNN_FNS[type(cfg)]
    meta = {"model_flops": _gnn_model_flops(cfg, n, e, True),
            "model_bytes_dev": _gnn_model_bytes(cfg, n, e,
                                                n_devices(mesh) if mesh is not None else 1),
            "nodes": n, "edges": e}
    if mesh is None:
        if cfg.kernel:
            raise NotImplementedError(
                f"{name}: kernel=True sums the messages with K1 "
                f"(kernels/segsum.py:segment_sum_sorted), which has no backward on one "
                f"device, as jax.grad through the JAX package's Pallas kernel raises; train "
                f"with kernel=None or False (the plain path), or over a mesh, where K1 runs "
                f"in ops.vp_segment_sum with its backward")
        return _train_step(arch, model_cls(replace(cfg, kernel=False), device="meta"), loss_fn,
                           {"n_graphs": n_graphs}, device, name, meta)
    # vp aggregation at ogb_products: node blocks over the batch axes (the
    # reference's hint); the other shapes keep no node blocks, so every
    # rank sums its lanes onto every node row
    big = shape.name == "ogb_products"
    node_axes = dp_axes(mesh) if big else ()
    skeleton = model_cls(cfg, device="meta")
    opt = make_optimizer(arch.optimizer)

    def value_and_grad(params, batch):
        m = _ranks_of(mesh, name)
        _check_precision()
        _check_on(name, device, next(iter(params.values())).device, "the parameters are")
        feed = _gnn_share(batch, m, device)
        feed["n_graphs"] = n_graphs
        # every node-sized sum under the hint (a rank holds its node rows
        # only); the per-graph readouts sum over the ranks without it
        with kops.segment_output_sharding(m, node_axes, min_segments=1):
            loss, grads = _value_and_grad(lambda leaves: loss_fn(skeleton, feed, leaves),
                                          params)
        # every rank's gradient is its share: one sum over the mesh
        flat = collective.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads.values()]),
                                         m)
        out, at = {}, 0
        for k, g in grads.items():
            out[k] = flat[at:at + g.numel()].view_as(g)
            at += g.numel()
        return loss, out

    def train(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch)
        new_p, new_o = opt.update(grads, opt_state, params)
        return new_p, new_o, loss

    return StepBundle(name=name, kind="train", fn=train, meta=meta, mesh=mesh,
                      grad=value_and_grad, opt=opt)


def build_step(arch_name: str, shape_name: str, device=None, mesh=None) -> StepBundle:
    """The step of one cell on ``device`` (None means the GPU, and raises
    without one), or over ``mesh`` (a ``core.collective.Mesh``, on its
    device; a ``launch.mesh.MeshLayout`` for ``meta`` only)."""
    arch = get_arch(arch_name)
    shape = arch.shape(shape_name)
    if mesh is not None:
        device = mesh.device if isinstance(mesh, collective.Mesh) else torch.device("meta")
    else:
        device = resolve_device(device)
    if arch.family == "lm":
        return _lm_step(arch, shape, device, mesh)
    if arch.family == "gnn":
        return _gnn_train(arch, shape, device, mesh)
    return _recsys_step(arch, shape, device, mesh)


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) cell, in the registry's order."""
    return [(a, s.name) for a in ARCH_IDS for s in get_arch(a).shapes]


__all__ = ["StepBundle", "all_cells", "build_step", "make_optimizer", "train_state"]
