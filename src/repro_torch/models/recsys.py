"""DCN-v2 (Wang et al. 2021, arXiv:2008.13535) with an EmbeddingBag over the
fused gather-and-segment-sum K5.

The port of the JAX package's ``models/recsys.py``. The parameters live in
an ``nn.Module`` (``DCNv2``): the stacked ``[n_sparse, rows, dim]`` tables,
the cross layers and the MLP. The JAX functions keep their names as thin
functions over it (``dcn_init``, ``embedding_bag``, ``dcn_forward``,
``retrieval_score``). ``models/convert.py`` carries the JAX package's
parameters across; the linear layers store the transposes of JAX's
``[in, out]`` matrices, as ``nn.Linear`` does.

Multi-hot bags go through K5 (``kernels.ops.segment_embed``) in one call for
all tables when the kernel is on, and through the plain
``ref.segment_embed_ref`` when it is off. ``DCNConfig.kernel`` None means on
for a CUDA device (``core.dispatch.resolve_kernel``). ``multi_hot == 1``
takes a plain gather, as in JAX, and never reaches K5. The dense products
(cross, MLP, retrieval) are float32 matrix products; run them with TF32 off
(``torch.get_float32_matmul_precision() == "highest"``, PyTorch's default)
to match the JAX package's float32. K5 has no backward (nor has the JAX
package's Pallas kernel: its train step differentiates ``impl="xla"``):
serve under ``torch.inference_mode()`` (``launch.steps`` does), and train
with the kernel off, as ``launch.steps``'s train kind requires. The one-hot
gather is ``F.embedding`` on the flattened tables, whose CUDA backward sorts
the ids and sums each row's gradients in a fixed order: the table gradient,
and so a training run, is bitwise repeatable (``index_select``'s backward is
an atomic ``index_add_``).

Over a mesh (``DCNv2(cfg, mesh=)``, the JAX package's ``P(None, "model",
None)`` layout) each rank holds its ``[T, R / |model|, D]`` rows of the
tables, from row ``r0 = axis_index("model") * R / |model|``, and the cross
layers and the MLP whole. ``embedding_bag(..., mesh=)`` computes the
reference's global EmbeddingBag: this rank's contribution, then one
``collective.all_reduce_sum`` of the ``[B, T * D]`` result over
``"model"``. A multi-hot bag runs K5 (or its plain version) on this rank's
rows with the ids shifted by ``-r0``: K5 drops an id outside ``[0, rows)``,
so an id on another rank adds nothing here, and an invalid global id adds
nothing on any rank, the reference's semantics. A one-hot id is wrapped by
the global ``R`` first (``jnp.take``'s ids in ``[-R, 0)``), the rows in this
rank's range are gathered and the rest zeroed, the ranks' rows summed (one
rank adds the row, the others 0.0: exact), and only then does a global id
out of range read NaN. The sum's backward is the identity
(``core/collective.py``): each rank's table rows get the gradient of the
batch rows it was given.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import collective
from repro_torch.core.dispatch import resolve_device, resolve_kernel
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import segment_embed_ref


@dataclass(frozen=True)
class DCNConfig:
    name: str = "dcn-v2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    table_rows: int = 1_000_000     # rows per sparse table
    n_cross_layers: int = 3
    mlp: tuple = (1024, 1024, 512)
    cross_rank: int = 0             # 0 = full-rank DCN-v2 W
    multi_hot: int = 1              # ids per bag (1 = one-hot lookup)
    kernel: bool | None = None      # K5 for multi-hot bags; None = on for CUDA

    @property
    def d_in(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim


def param_specs(cfg: DCNConfig) -> dict:
    """The spec of every parameter by name over a mesh (the reference's
    ``_recsys_step``): the tables' rows over ``"model"``, the rest whole."""
    return {name: (None, "model", None) if name == "tables" else ()
            for name, _ in DCNv2(cfg, device="meta").named_parameters()}


def _row_block(cfg: DCNConfig, mesh) -> tuple[int, int]:
    """(first row, rows) of this rank's block of every table."""
    m = mesh.axis_size("model")
    if cfg.table_rows % m:
        raise ValueError(f"{cfg.name}: {cfg.table_rows} table rows do not split over a model "
                         f"axis of {m}")
    rows = cfg.table_rows // m
    return mesh.axis_index("model") * rows, rows


class DCNv2(nn.Module):
    """DCN-v2's parameters and forward. The parameters are allocated, not
    initialised: ``dcn_init`` draws them, ``convert.dcn_params_from_jax``
    copies JAX's. ``device`` None means the GPU (the mesh's device over a
    mesh), and raises without one. Over ``mesh`` (a ``core.collective.Mesh``)
    the module holds this rank's rows of the tables."""

    def __init__(self, cfg: DCNConfig, *, device=None, mesh=None):
        super().__init__()
        device = resolve_device(mesh.device if mesh is not None and device is None else device)
        self.cfg = cfg
        self.mesh = mesh
        d_in = cfg.d_in
        rows = cfg.table_rows if mesh is None else _row_block(cfg, mesh)[1]
        self.tables = nn.Parameter(torch.empty(cfg.n_sparse, rows, cfg.embed_dim,
                                               device=device))
        # x_{l+1} = x0 * (x_l W + b) + x_l; low rank: W = U V
        self.cross = nn.ModuleList(
            nn.Sequential(nn.Linear(d_in, cfg.cross_rank, bias=False, device=device),
                          nn.Linear(cfg.cross_rank, d_in, device=device))
            if cfg.cross_rank else nn.Linear(d_in, d_in, device=device)
            for _ in range(cfg.n_cross_layers))
        dims = [d_in, *cfg.mlp, 1]
        self.mlp = nn.ModuleList(nn.Linear(dims[i], dims[i + 1], device=device)
                                 for i in range(len(dims) - 1))

    def embed(self, sparse_ids: torch.Tensor) -> torch.Tensor:
        return embedding_bag(self.tables, sparse_ids, self.cfg, self.mesh)

    def cross_net(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for layer in self.cross:
            x = x0 * layer(x) + x                  # DCN-v2 cross
        return x

    def head(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.mlp):
            x = lin(x)
            if i < len(self.mlp) - 1:
                x = torch.relu(x)
        return x[:, 0]

    def forward(self, dense: torch.Tensor, sparse_ids: torch.Tensor) -> torch.Tensor:
        x0 = torch.cat([dense, self.embed(sparse_ids)], dim=-1)
        return self.head(self.cross_net(x0))


def dcn_init(cfg: DCNConfig, *, device=None,
             generator: torch.Generator | None = None, mesh=None) -> DCNv2:
    """A DCN-v2 with JAX's initial distributions, drawn from ``generator``
    (on ``device``; default seeded 0). It does not reproduce JAX's random
    values: parity goes through ``convert.dcn_params_from_jax``. ``device``
    None means the GPU (the mesh's device over a mesh), and raises without
    one. Over ``mesh`` the whole tables are drawn, as on one device, and this
    rank's rows kept: every rank holds its slice of the one-device model."""
    device = resolve_device(mesh.device if mesh is not None and device is None else device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = DCNv2(cfg, device=device, mesh=mesh)
    d_in = cfg.d_in
    with torch.no_grad():
        if mesh is None:
            model.tables.normal_(0.0, 0.01, generator=generator)
        else:
            whole = torch.empty(cfg.n_sparse, cfg.table_rows, cfg.embed_dim, device=device)
            r0, rows = _row_block(cfg, mesh)
            model.tables.copy_(whole.normal_(0.0, 0.01, generator=generator)[:, r0:r0 + rows])
            del whole
        for layer in model.cross:
            if cfg.cross_rank:
                u, v = layer
                u.weight.normal_(0.0, d_in ** -0.5, generator=generator)
                v.weight.normal_(0.0, cfg.cross_rank ** -0.5, generator=generator)
                v.bias.zero_()
            else:
                layer.weight.normal_(0.0, d_in ** -0.5, generator=generator)
                layer.bias.zero_()
        for lin in model.mlp:
            lin.weight.normal_(0.0, lin.in_features ** -0.5, generator=generator)
            lin.bias.zero_()
    return model


def embedding_bag(tables: torch.Tensor, ids: torch.Tensor, cfg: DCNConfig,
                  mesh=None) -> torch.Tensor:
    """ids [B, n_sparse, multi_hot] int32 -> [B, n_sparse * embed_dim].

    EmbeddingBag(mode="sum"): with ``multi_hot > 1`` one K5 call sums the
    bags of every table (kernel on), or the plain version does (kernel off).
    Over ``mesh``, ``tables`` is this rank's row block and ``ids`` global:
    the bags are summed over the ``"model"`` ranks (module docstring).
    """
    if mesh is not None:
        return _embedding_bag_rows(tables, ids, cfg, mesh)
    b = ids.shape[0]
    t, r, d = tables.shape
    if cfg.multi_hot == 1:
        # fast path: plain gather, with jnp.take's semantics: ids in [-R, 0)
        # count from the end, other ids outside [0, R) read NaN
        i = ids[..., 0].long()
        i = torch.where(i < 0, i + r, i)
        ok = (i >= 0) & (i < r)
        flat = i.clamp(0, r - 1) + torch.arange(t, device=ids.device) * r     # [B, T]
        rows = F.embedding(flat, tables.reshape(t * r, d))                     # [B, T, D]
        return torch.where(ok[..., None], rows, float("nan")).reshape(b, -1)
    # multi-hot: bag e of row b sums `multi_hot` rows of each table. The ids
    # go as a [T, B, M] view (no copy; K5 reads them through the strides),
    # and the bag ids ascend as built, so nothing is sorted.
    ids_t = ids.permute(1, 0, 2)                                   # [T, B, M], a view
    bag = torch.arange(b, dtype=torch.int32, device=ids.device)[:, None].expand(
        b, cfg.multi_hot).contiguous().view(-1)                    # [B*M], ascending
    if resolve_kernel(cfg.kernel, tables.device):
        out = kops.segment_embed(tables, ids_t, bag, num_segments=b)   # [B, T, D]
    else:
        out = segment_embed_ref(tables, ids_t, bag, None, b)
    return out.reshape(b, -1)


def _embedding_bag_rows(tables: torch.Tensor, ids: torch.Tensor, cfg: DCNConfig,
                        mesh) -> torch.Tensor:
    """``embedding_bag`` of the global ids over this rank's rows
    ``[r0, r0 + rows)`` of every table, summed over ``"model"``."""
    b = ids.shape[0]
    t, rows, d = tables.shape
    r0, want = _row_block(cfg, mesh)
    if rows != want:
        raise ValueError(f"{cfg.name}: this rank holds {rows} rows a table, its block over "
                         f"'model' is {want}")
    r = cfg.table_rows
    if cfg.multi_hot == 1:
        i = ids[..., 0].long()
        i = torch.where(i < 0, i + r, i)             # jnp.take's wrap, by the global R
        ok = (i >= 0) & (i < r)
        local = i - r0
        mine = (local >= 0) & (local < rows)
        flat = local.clamp(0, rows - 1) + torch.arange(t, device=ids.device) * rows
        got = F.embedding(flat, tables.reshape(t * rows, d))                  # [B, T, D]
        got = torch.where(mine[..., None], got, 0.0).reshape(b, -1)
        out = collective.all_reduce_sum(got, mesh, "model").view(b, t, d)
        return torch.where(ok[..., None], out, float("nan")).reshape(b, -1)
    shifted = ids - torch.tensor(r0, dtype=ids.dtype, device=ids.device)    # [B, T, M]
    out = embedding_bag(tables, shifted, cfg)    # ids outside [0, rows) add nothing
    return collective.all_reduce_sum(out, mesh, "model")


def dcn_forward(model: DCNv2, batch: dict) -> torch.Tensor:
    """batch: dense [B, n_dense] f32, sparse_ids [B, n_sparse, multi_hot] i32.
    Returns CTR logits [B]."""
    return model(batch["dense"], batch["sparse_ids"])


def dcn_loss(model: DCNv2, batch: dict, params: dict | None = None,
             divisor: int | None = None) -> torch.Tensor:
    """The JAX package's ``dcn_loss``, the mean logistic loss of the CTR
    logits in its stable form: batch adds labels [B] int32 to
    ``dcn_forward``'s. ``params`` (a ``named_parameters`` dict) stands in
    for the model's own parameters, through ``torch.func.functional_call``,
    so a train step can differentiate a state it does not own. ``divisor``
    (the global batch, for a rank's block of it) takes the sum of the
    terms over it in place of their mean."""
    args = (batch["dense"], batch["sparse_ids"])
    logits = (model(*args) if params is None
              else torch.func.functional_call(model, params, args)).to(torch.float32)
    y = batch["labels"].to(torch.float32)
    terms = (torch.maximum(logits, torch.zeros_like(logits)) - logits * y
             + torch.log1p(torch.exp(-torch.abs(logits))))
    return torch.mean(terms) if divisor is None else torch.sum(terms) / divisor


def retrieval_score(model: DCNv2, batch: dict) -> torch.Tensor:
    """Score queries against a candidate embedding matrix.

    batch: dense [Q, n_dense], sparse_ids [Q, n_sparse, M],
           candidates [C, embed_dim]. Returns [Q, C] scores (one matmul).
    """
    x = torch.cat([batch["dense"], model.embed(batch["sparse_ids"])], dim=-1)
    # project the query into embed_dim with the first MLP weight slice
    w0 = model.mlp[0].weight[:model.cfg.embed_dim]                # [D, d_in]
    q = x @ w0.T                                                   # [Q, D]
    return q @ batch["candidates"].T                               # [Q, C]


__all__ = ["DCNConfig", "DCNv2", "dcn_init", "dcn_forward", "dcn_loss", "embedding_bag",
           "param_specs", "retrieval_score"]
