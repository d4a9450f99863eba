"""Step factory: (arch, shape) -> a step that runs on the device.

The port of the recsys part of the JAX package's ``launch/steps.py``
(``_recsys_step`` and ``build_step``) for one device: no mesh, so n_dev = 1
and the model axis is 1 in JAX's formulas. Kinds:

  serve     fn(model, batch) -> CTR logits [B]
  retrieval fn(model, batch) -> scores [Q, C]

``fn`` takes the model (``models.recsys.DCNv2``, which carries its config:
``multi_hot`` and ``kernel`` are the model's) and a batch of numpy arrays or
tensors, moves the batch to the step's device and runs under
``torch.inference_mode()``. ``meta`` carries the analytic ``model_flops``,
``model_bytes_dev`` and ``rows`` of the arch's full config (for retrieval,
``rows`` is the number of candidates). The ``train`` kind (it needs K5's backward) and the LM and GNN
families are not ported yet: they raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.common import Arch, Shape
from repro_torch.core.dispatch import resolve_device
from repro_torch.models import recsys as rec_mod


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


def _check_precision() -> None:
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "DCN-v2's steps run their float32 products in full float32, as the JAX "
            "reference does; torch.get_float32_matmul_precision() is "
            f"{torch.get_float32_matmul_precision()!r} (TF32): set it to 'highest'")


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
        raise NotImplementedError(
            f"{name}: training is not ported yet; it needs K5's backward, the "
            f"optimizers and the train loop (ROADMAP.md section 1, item 13)")

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


__all__ = ["StepBundle", "build_step"]
