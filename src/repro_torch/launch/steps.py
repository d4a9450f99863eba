"""Step factory: (arch, shape) -> a step that runs on the device.

The port of the recsys part of the JAX package's ``launch/steps.py``
(``make_optimizer``, ``_recsys_step`` and ``build_step``) for one device: no
mesh, so n_dev = 1 and the model axis is 1 in JAX's formulas. Kinds:

  train     fn(params, opt_state, batch) -> (params', opt_state', loss)
  serve     fn(model, batch) -> CTR logits [B]
  retrieval fn(model, batch) -> scores [Q, C]

The serve kinds take the model (``models.recsys.DCNv2``, which carries its
config: ``multi_hot`` and ``kernel`` are the model's) and a batch of numpy
arrays or tensors, move the batch to the step's device and run under
``torch.inference_mode()``. The train kind is pure: it takes a
``named_parameters`` dict (``train_state`` builds the first ``{"params",
"opt"}`` from a model), runs ``dcn_loss`` on a skeleton of the config
through ``torch.func.functional_call``, differentiates it and returns new
tensors from the arch's optimizer; nothing it is given changes, so the
train loop may run it twice from one state. It differentiates the plain bag,
as the JAX package's step does with ``impl="xla"``: K5 has no backward, so a
multi-hot config with the kernel on raises ``NotImplementedError`` rather
than change path. Every kind runs its float32 products in full float32.
``meta`` carries the analytic ``model_flops``, ``model_bytes_dev`` and
``rows`` of the config (for retrieval, ``rows`` is the number of
candidates). The LM and GNN families are not ported yet: they raise
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.common import Arch, Shape
from repro_torch.core.dispatch import resolve_device, resolve_kernel
from repro_torch.models import recsys as rec_mod
from repro_torch.optim import Optimizer, adafactor, adamw, sgdm


@dataclass
class StepBundle:
    name: str
    kind: str
    fn: Callable
    meta: dict


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


def train_state(model: rec_mod.DCNv2, opt: Optimizer) -> dict:
    """The train kind's first state, ``{"params", "opt"}``: the model's
    parameters by name (detached; the step never writes them) and
    ``opt.init`` of them."""
    params = {k: v.detach() for k, v in model.named_parameters()}
    return {"params": params, "opt": opt.init(params)}


def _check_precision() -> None:
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "DCN-v2's steps run their float32 products in full float32, as the JAX "
            "reference does; torch.get_float32_matmul_precision() is "
            f"{torch.get_float32_matmul_precision()!r} (TF32): set it to 'highest'")


def _train_step(arch: Arch, cfg: rec_mod.DCNConfig, b: int, per_row: float,
                device: torch.device, name: str) -> StepBundle:
    if cfg.multi_hot > 1 and resolve_kernel(cfg.kernel, device):
        raise NotImplementedError(
            f"{name}: a multi-hot bag with the kernel on runs K5 "
            f"(kernels/ops.py:segment_embed), which has no backward, as the JAX "
            f"package's Pallas kernel has none; train with kernel=False")
    opt = make_optimizer(arch.optimizer)
    skeleton = rec_mod.DCNv2(cfg, device="meta")  # the structure; params come in

    def train(params, opt_state, batch):
        _check_precision()
        on = params["tables"].device
        if on.type != device.type or device.index not in (None, on.index):
            raise ValueError(f"{name} runs on {device}; the parameters are on {on}")
        feed = {k: torch.as_tensor(batch[k], device=device)
                for k in ("dense", "sparse_ids", "labels")}
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            loss = rec_mod.dcn_loss(skeleton, feed, leaves)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        new_p, new_o = opt.update(dict(zip(leaves, grads)), opt_state, params)
        return new_p, new_o, loss.detach()

    return StepBundle(
        name=name, kind="train", fn=train,
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
        return _train_step(arch, cfg, b, per_row, device, name)

    def run(model, batch, keys, forward):
        _check_precision()
        on = model.tables.device
        if on.type != device.type or device.index not in (None, on.index):
            raise ValueError(f"{name} runs on {device}; the model is on {on}")
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


def build_step(arch_name: str, shape_name: str, device=None) -> StepBundle:
    """The step of one cell on ``device`` (None means the GPU, and raises
    without one). Archs that are not ported raise ``NotImplementedError``."""
    device = resolve_device(device)
    arch = get_arch(arch_name)  # only the recsys family is ported
    return _recsys_step(arch, arch.shape(shape_name), device)


__all__ = ["StepBundle", "build_step", "make_optimizer", "train_state"]
