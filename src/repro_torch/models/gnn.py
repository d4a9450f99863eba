"""GNN zoo: GCN, SchNet, EGNN, MACE, all on the sorted segment-sum K1.

The port of the JAX package's ``models/gnn.py``. Message passing is the
paper's peeling inner loop in another guise: a gather over the edge lanes,
then a per-vertex segment reduction. Every reduction goes through ``_seg``:
with the kernel on, K1 at ``[E, D]`` float32 (``kernels.ops.segment_sum``);
with the kernel off, the plain ``ref.segment_sum_ref`` (``index_add_``).
K1 wants its ids ascending. The JAX package sorts them in each Pallas call;
the port sorts the edge lanes by ``dst`` once a forward (``_by_dst``,
stable, counted in ``ops.unsorted_fallback_count``), makes every message in
that order and hands each edge sum to K1 as it is. That gives the same sums
in the same order as a stable sort in each call, without the sort and the
``[E, D]`` permutation gather of each call. The readout sums over
``graph_id`` sort in the call (``presorted=False``). ``*Config.kernel``
None means on for a CUDA device (``core.dispatch.resolve_kernel``), as
``DCNConfig.kernel`` does; it stands in for JAX's ``impl`` ("pallas" /
"xla"). The gathers are ``index_select`` on every path, as the JAX package
gathers with ``jnp.take``.

K1 has no backward, nor has the JAX package's Pallas kernel (``jax.grad``
through it raises). So with the kernel on, run the forward under
``torch.no_grad()`` or ``torch.inference_mode()``: the wrapper raises on
values that require a gradient. The train kind of ``launch.steps``
differentiates the plain path, as the JAX package's step does with
``impl="xla"``. With the kernel off on the card the sums are atomic
``index_add_``, in the forward and in ``index_select``'s backward: right to
float32 rounding, but not bitwise repeatable; K1 is.

Each model's parameters live in an ``nn.Module`` whose parameter names
follow the JAX pytree's keys; its MLPs are ``nn.Linear`` stacks, which hold
the transposes of JAX's ``[in, out]`` matrices (``models/convert.py`` carries
JAX's values across). ``*_init(cfg, device=None, generator=None)`` draws
JAX's initial distributions from a ``torch.Generator``; it does not
reproduce JAX's random values. ``*_forward(model, batch)`` and
``*_loss(model, batch, params=None)`` keep the JAX names; ``params`` (a
``named_parameters`` dict) stands in for the model's own parameters through
``torch.func.functional_call``. Run the float32 products with TF32 off
(``torch.get_float32_matmul_precision() == "highest"``) to match JAX's
float32.

Graph batch convention (all four models; tensors on one device, the
integers int32):
  node_feat [N, F] f32  or  atom_type [N] (geometric models)
  pos       [N, 3] f32  (geometric models)
  src, dst  [E] edge endpoints (directed; symmetric for undirected)
  graph_id  [N] graph membership for batched readout (0 for single graph)
  node_mask [N] bool; edge padding uses src/dst == N (sentinel)
  n_graphs  a Python int, the readout's segments

Over a mesh (inside ``kernels.ops.segment_output_sharding(mesh,
node_axes)``, the reference's hint) every rank holds its share of the
batch: the edge lanes split over every mesh axis in rank order (with
``node_axes``, partitioned by dst block as
``graphs/partition.py:partition_by_dst_block`` lays them out), and the node
rows split over every axis in rank order (its sub-block of its node block).
A node-sized edge sum (``ops._hint_active``) is ``ops.vp_segment_sum`` (K1
with the kernel on, and its backward) on this rank's lanes, then this
rank's rows of its block (``collective.split``); node features are
gathered over the mesh (``collective.all_gather``) before a gather by
``src`` or ``dst``; the per-graph readout and the GCN loss's masked sums are
summed over the ranks. Every rank's gradient is then its own share of
every parameter's, which the train kind (``launch.steps``) sums over the
mesh, as it keeps the parameters replicated.

MACE note (the JAX package's documented adaptation, kept): the full
Clebsch–Gordan coupled B-basis is simplified to channel-wise invariant
contractions of the A-basis (per-l norms and their products up to
correlation order 3). This preserves O(3) invariance of outputs and the
computational shape (radial × Y_lm edge embedding, higher-order node
products).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import collective
from repro_torch.core.dispatch import resolve_device, resolve_kernel
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import segment_sum_ref


def _layout():
    """(mesh, node axes) of the active ``segment_output_sharding`` hint, or
    None: one device."""
    hint = kops.active_sharding()
    return None if hint is None else hint[:2]


def _n_nodes(h: torch.Tensor) -> int:
    """The batch's node count from this rank's rows."""
    lay = _layout()
    return h.shape[0] * (1 if lay is None else lay[0].size)


def _seg(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
         kernel: bool | None, presorted: bool = False) -> torch.Tensor:
    """The per-vertex (or per-graph) sum of ``values`` [E] or [E, D] over
    ``seg_ids``; ids outside ``[0, num_segments)`` drop. ``presorted``: the
    ids are ascending (the lanes of ``_by_dst``), for the kernel. Under the
    hint, a node-sized sum is ``vp_segment_sum`` and returns this rank's
    rows."""
    if kops._hint_active(num_segments):
        mesh, node_axes = _layout()
        out = kops.vp_segment_sum(values, seg_ids, num_segments, kernel=kernel)
        return collective.split(out, mesh, tuple(a for a in mesh.axis_names
                                                 if a not in node_axes))
    if _layout() is not None:
        raise ValueError(f"a sum onto {num_segments} nodes under segment_output_sharding "
                         f"that the hint does not cover (min_segments, or a block count "
                         f"that does not divide it)")
    if resolve_kernel(kernel, values.device):
        return kops.segment_sum(values, seg_ids, num_segments=num_segments,
                                presorted=presorted)
    return segment_sum_ref(values, seg_ids, num_segments, values.dtype)


def _by_dst(src: torch.Tensor, dst: torch.Tensor,
            kernel: bool | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The edge lanes a forward runs on: with the kernel on, stably sorted
    by ``dst`` (one sort a forward, counted as ``presorted=False`` counts
    it), so the edge sums pass ``presorted=True``; off, as given."""
    if not resolve_kernel(kernel, dst.device):
        return src, dst
    kops.unsorted_fallback_count += 1
    dst, order = torch.sort(dst, stable=True)
    return src.index_select(0, order), dst


def _gather_nodes(h: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    # the sentinel lane (idx == n) reads row n - 1; callers mask it out. Over
    # a mesh h is this rank's rows: every rank's, gathered, are the batch's
    lay = _layout()
    if lay is not None:
        h = collective.all_gather(h, lay[0])
    return h.index_select(0, idx.clamp(max=n - 1))


def _readout(values: torch.Tensor, graph_id: torch.Tensor, n_graphs: int,
             kernel: bool | None) -> torch.Tensor:
    """The per-graph sum of this rank's node ``values``: over a mesh, the
    plain sum of its rows summed over the ranks (every rank holds the
    whole ``[n_graphs]``)."""
    lay = _layout()
    if lay is None:
        return _seg(values, graph_id, n_graphs, kernel)
    out = segment_sum_ref(values, graph_id, n_graphs, values.dtype)
    return collective.all_reduce_sum(out, lay[0])


def _mesh_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the mesh's ranks (itself on one device)."""
    lay = _layout()
    return t if lay is None else collective.all_reduce_sum(t, lay[0])


def _call(model: nn.Module, batch: dict, params: dict | None):
    return model(batch) if params is None else torch.func.functional_call(
        model, params, (batch,))


class MLP(nn.ModuleList):
    """JAX's ``_mlp``: linear layers with SiLU between them (none after the
    last). ``dims`` [in, hidden..., out]."""

    def __init__(self, dims, device):
        super().__init__(nn.Linear(dims[i], dims[i + 1], device=device)
                         for i in range(len(dims) - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self):
            x = lin(x)
            if i < len(self) - 1:
                x = F.silu(x)
        return x


def _block(**mlps: MLP) -> nn.Module:
    """One layer's MLPs, by the JAX pytree's keys (MACE's ``update`` would
    clash with ``nn.ModuleDict.update``)."""
    block = nn.Module()
    for key, mlp in mlps.items():
        block.add_module(key, mlp)
    return block


def _init_mlps(model: nn.Module, generator: torch.Generator) -> None:
    """JAX's ``_mlp_init`` on every MLP of ``model``: weights N(0, 1/in),
    biases 0."""
    for mlp in model.modules():
        if isinstance(mlp, MLP):
            for lin in mlp:
                lin.weight.normal_(0.0, lin.in_features ** -0.5, generator=generator)
                lin.bias.zero_()


def _generator(device: torch.device, generator: torch.Generator | None) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0) if generator is None else generator


def _embed(table: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, z.clamp(max=table.shape[0] - 1))


def _rbf_centers(n_rbf: int, cutoff: float, device: torch.device) -> torch.Tensor:
    """``jnp.linspace(0.0, cutoff, n_rbf)`` bit for bit. JAX's linspace is
    ``start * (1 - t) + stop * t`` with ``t = iota / (n - 1)``, and XLA folds
    it (start 0, stop a scalar) into ``iota * fl(stop * fl(1 / (n - 1)))``,
    each step rounded to float32, with the last entry set to ``stop``. The
    scalar is computed on the host in numpy float32; the product with a
    float32 scalar rounds alike on the CPU and the card (a quotient by a
    Python scalar would not: CUDA takes its reciprocal)."""
    if n_rbf < 2:
        return torch.zeros(n_rbf, dtype=torch.float32, device=device)
    step = float(np.float32(cutoff) * (np.float32(1.0) / np.float32(n_rbf - 1)))
    centers = torch.arange(n_rbf, dtype=torch.float32, device=device) * step
    centers[-1] = cutoff
    return centers


def _rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    centers = _rbf_centers(n_rbf, cutoff, dist.device).to(dist.dtype)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


def _cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    return 0.5 * (torch.cos(math.pi * torch.clamp(dist / cutoff, max=1.0)) + 1.0)


# ===========================================================================
# GCN (Kipf & Welling) — SpMM regime
# ===========================================================================
@dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_hidden: int = 16
    d_feat: int = 1433
    n_classes: int = 7
    kernel: bool | None = None      # K1 for the sums; None = on for CUDA


class GCN(nn.Module):
    """GCN's weights ``w`` (JAX's ``[in, out]`` matrices, no bias) and
    forward. Allocated, not initialised: ``gcn_init`` draws them,
    ``convert.gnn_params_from_jax`` copies JAX's. ``device`` None means the
    GPU, and raises without one."""

    def __init__(self, cfg: GCNConfig, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
        self.w = nn.ParameterList(torch.empty(dims[i], dims[i + 1], device=device)
                                  for i in range(cfg.n_layers))

    def forward(self, batch: dict) -> torch.Tensor:
        """Symmetric-normalized GCN: H' = D^-1/2 (A+I) D^-1/2 H W. Returns
        the logits [N, n_classes]."""
        h = batch["node_feat"]
        n = _n_nodes(h)
        kernel = self.cfg.kernel
        src, dst = _by_dst(batch["src"], batch["dst"], kernel)
        valid = (src < n) & (dst < n)
        deg = _seg(valid.to(h.dtype), dst, n, kernel, presorted=True) + 1.0  # +self loop
        inv_sqrt = torch.rsqrt(deg)[:, None]
        for li, w in enumerate(self.w):
            hw = h @ w
            msg = _gather_nodes(hw * inv_sqrt, src, n)
            msg = torch.where(valid[:, None], msg, 0.0)
            agg = _seg(msg, dst, n, kernel, presorted=True)
            h = (agg + hw * inv_sqrt) * inv_sqrt  # + self loop
            if li < len(self.w) - 1:
                h = torch.relu(h)
        return h


def gcn_init(cfg: GCNConfig, *, device=None,
             generator: torch.Generator | None = None) -> GCN:
    device = resolve_device(device)
    generator = _generator(device, generator)
    model = GCN(cfg, device=device)
    with torch.no_grad():
        for w in model.w:
            w.normal_(0.0, w.shape[0] ** -0.5, generator=generator)
    return model


def gcn_forward(model: GCN, batch: dict) -> torch.Tensor:
    return model(batch)


def gcn_loss(model: GCN, batch: dict, params: dict | None = None) -> torch.Tensor:
    """Masked mean cross-entropy of the logits against ``labels`` [N] over
    ``label_mask`` [N]."""
    logits = _call(model, batch, params).float()
    labels = batch["labels"].long()
    mask = batch["label_mask"].to(logits.dtype)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[:, None])[:, 0]
    return _mesh_sum(torch.sum((lse - ll) * mask)) / torch.clamp(_mesh_sum(torch.sum(mask)),
                                                                  min=1.0)


# ===========================================================================
# SchNet — triplet-free cfconv (rbf filters on distances)
# ===========================================================================
@dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 100
    kernel: bool | None = None


class SchNet(nn.Module):
    def __init__(self, cfg: SchNetConfig, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d = cfg.d_hidden
        self.embed = nn.Parameter(torch.empty(cfg.n_species, d, device=device))
        self.inter = nn.ModuleList(_block(
            filter=MLP([cfg.n_rbf, d, d], device),
            in_w=MLP([d, d], device),
            out=MLP([d, d, d], device),
        ) for _ in range(cfg.n_interactions))
        self.readout = MLP([d, d // 2, 1], device)

    def forward(self, batch: dict) -> torch.Tensor:
        """Returns per-graph energy [n_graphs]."""
        cfg, kernel = self.cfg, self.cfg.kernel
        z, pos, gid = batch["atom_type"], batch["pos"], batch["graph_id"]
        src, dst = _by_dst(batch["src"], batch["dst"], kernel)
        n = _n_nodes(z)
        valid = (src < n) & (dst < n)
        d_vec = _gather_nodes(pos, dst, n) - _gather_nodes(pos, src, n)
        dist = torch.sqrt(torch.sum(d_vec * d_vec, -1) + 1e-12)
        rbf = _rbf_expand(dist, cfg.n_rbf, cfg.cutoff)
        fcut = _cosine_cutoff(dist, cfg.cutoff)
        h = _embed(self.embed, z)
        for blk in self.inter:
            w_edge = blk.filter(rbf) * fcut[:, None]          # [E, D]
            hj = blk.in_w(_gather_nodes(h, src, n))
            msg = torch.where(valid[:, None], hj * w_edge, 0.0)
            agg = _seg(msg, dst, n, kernel, presorted=True)
            h = h + blk.out(agg)
        atom_e = self.readout(h)[:, 0]                            # [N]
        atom_e = atom_e * batch["node_mask"].to(atom_e.dtype)
        return _readout(atom_e, gid, batch["n_graphs"], kernel)


def schnet_init(cfg: SchNetConfig, *, device=None,
                generator: torch.Generator | None = None) -> SchNet:
    device = resolve_device(device)
    generator = _generator(device, generator)
    model = SchNet(cfg, device=device)
    with torch.no_grad():
        model.embed.normal_(0.0, 0.1, generator=generator)
        _init_mlps(model, generator)
    return model


def schnet_forward(model: SchNet, batch: dict) -> torch.Tensor:
    return model(batch)


def schnet_loss(model: SchNet, batch: dict, params: dict | None = None) -> torch.Tensor:
    e = _call(model, batch, params)
    return torch.mean((e - batch["energy"]) ** 2)


# ===========================================================================
# EGNN (Satorras et al.) — E(n)-equivariant
# ===========================================================================
@dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    n_species: int = 100
    kernel: bool | None = None


class EGNN(nn.Module):
    def __init__(self, cfg: EGNNConfig, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d = cfg.d_hidden
        self.embed = nn.Parameter(torch.empty(cfg.n_species, d, device=device))
        self.layers = nn.ModuleList(_block(
            phi_e=MLP([2 * d + 1, d, d], device),
            phi_x=MLP([d, d, 1], device),
            phi_h=MLP([2 * d, d, d], device),
        ) for _ in range(cfg.n_layers))
        self.readout = MLP([d, d, 1], device)

    def forward(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (per-graph energy [G], updated positions [N, 3])."""
        kernel = self.cfg.kernel
        z, pos, gid = batch["atom_type"], batch["pos"], batch["graph_id"]
        src, dst = _by_dst(batch["src"], batch["dst"], kernel)
        n = _n_nodes(z)
        valid = ((src < n) & (dst < n)).to(pos.dtype)
        h = _embed(self.embed, z)
        x = pos
        for lp in self.layers:
            xi, xj = _gather_nodes(x, dst, n), _gather_nodes(x, src, n)
            hi, hj = _gather_nodes(h, dst, n), _gather_nodes(h, src, n)
            diff = xi - xj
            d2 = torch.sum(diff * diff, -1, keepdim=True)
            m = lp.phi_e(torch.cat([hi, hj, d2], -1)) * valid[:, None]
            # coordinate update (E(n)-equivariant): mean over neighbors
            cnt = _seg(valid, dst, n, kernel, presorted=True) + 1.0
            xw = diff * torch.tanh(lp.phi_x(m))  # tanh bounds the step
            x = x + _seg(xw * valid[:, None], dst, n, kernel, presorted=True) / cnt[:, None]
            agg = _seg(m, dst, n, kernel, presorted=True)
            h = h + lp.phi_h(torch.cat([h, agg], -1))
        atom_e = self.readout(h)[:, 0] * batch["node_mask"].to(h.dtype)
        return _readout(atom_e, gid, batch["n_graphs"], kernel), x


def egnn_init(cfg: EGNNConfig, *, device=None,
              generator: torch.Generator | None = None) -> EGNN:
    device = resolve_device(device)
    generator = _generator(device, generator)
    model = EGNN(cfg, device=device)
    with torch.no_grad():
        model.embed.normal_(0.0, 0.1, generator=generator)
        _init_mlps(model, generator)
    return model


def egnn_forward(model: EGNN, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    return model(batch)


def egnn_loss(model: EGNN, batch: dict, params: dict | None = None) -> torch.Tensor:
    e, _ = _call(model, batch, params)
    return torch.mean((e - batch["energy"]) ** 2)


# ===========================================================================
# MACE (simplified invariant B-basis; see module docstring)
# ===========================================================================
@dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 100
    kernel: bool | None = None


def _spherical_harmonics(u: torch.Tensor, l_max: int) -> torch.Tensor:
    """Real Y_lm up to l_max (2) for unit vectors u [E,3] -> [E, (l_max+1)^2]."""
    x, y, z = u[:, 0], u[:, 1], u[:, 2]
    s3 = 3.0 ** 0.5
    out = [torch.ones_like(x)]                   # l=0
    if l_max >= 1:
        out += [y, z, x]                         # l=1
    if l_max >= 2:                               # l=2 (normalized so that
        out += [s3 * x * y, s3 * y * z,          #  sum_m Y_2m^2 is invariant)
                0.5 * (3 * z * z - 1.0), s3 * x * z,
                0.5 * s3 * (x * x - y * y)]
    return torch.stack(out, dim=-1)


class MACE(nn.Module):
    def __init__(self, cfg: MACEConfig, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        n_l = cfg.l_max + 1
        n_inv = n_l * cfg.correlation             # invariants per channel-block
        d = cfg.d_hidden
        self.embed = nn.Parameter(torch.empty(cfg.n_species, d, device=device))
        self.layers = nn.ModuleList(_block(
            radial=MLP([cfg.n_rbf, d, n_l * d], device),
            mix=MLP([n_inv * d, d], device),
            update=MLP([2 * d, d, d], device),
        ) for _ in range(cfg.n_layers))
        self.readout = MLP([d, d // 2, 1], device)

    def forward(self, batch: dict) -> torch.Tensor:
        """Returns per-graph energy [n_graphs]."""
        cfg, kernel = self.cfg, self.cfg.kernel
        z, pos, gid = batch["atom_type"], batch["pos"], batch["graph_id"]
        src, dst = _by_dst(batch["src"], batch["dst"], kernel)
        n = _n_nodes(z)
        d_vec = _gather_nodes(pos, dst, n) - _gather_nodes(pos, src, n)
        dist = torch.sqrt(torch.sum(d_vec * d_vec, -1) + 1e-12)
        # degenerate edges (self/padding, d_vec=0) must contribute NOTHING: the
        # constant term of Y_2,0 would otherwise break O(3) invariance.
        valid = ((src < n) & (dst < n) & (dist > 1e-6)).to(pos.dtype)
        u = d_vec / dist[:, None]
        ylm = _spherical_harmonics(u, cfg.l_max)                   # [E, M]
        rbf = _rbf_expand(dist, cfg.n_rbf, cfg.cutoff)
        fcut = _cosine_cutoff(dist, cfg.cutoff)
        n_l = cfg.l_max + 1
        m = ylm.shape[1]
        h = _embed(self.embed, z)
        d = cfg.d_hidden
        for lp in self.layers:
            r = lp.radial(rbf).reshape(-1, n_l, d) * fcut[:, None, None]
            hj = _gather_nodes(h, src, n)                           # [E, D]
            # JAX's R[:, l_of_m, :]: block l repeated for its 2l + 1 m's
            r_m = torch.cat([r[:, l:l + 1, :].expand(-1, 2 * l + 1, -1)
                             for l in range(n_l)], dim=1)
            # A-basis: A_i[m, c] = sum_j R_l(r) Y_lm(u) h_j[c]
            edge_feat = r_m * ylm[:, :, None] * hj[:, None, :]
            edge_feat = edge_feat * valid[:, None, None]
            a = _seg(edge_feat.reshape(-1, m * d), dst, n, kernel, presorted=True)
            a = a.reshape(a.shape[0], m, d)
            # invariant contractions per l: ||A_l||^2 summed over m
            a2 = a * a
            inv1 = torch.stack([a2[:, l * l:(l + 1) * (l + 1), :].sum(dim=1)
                                for l in range(n_l)], dim=1)       # [N, n_l, D]
            inv1 = torch.sqrt(inv1 + 1e-12)
            # correlation powers 1..nu (simplified B-basis)
            feats = [inv1 ** p for p in range(1, cfg.correlation + 1)]
            b = torch.cat(feats, dim=1).reshape(a.shape[0], -1)    # [N, n_l*nu*D]
            msg = lp.mix(b)
            h = h + lp.update(torch.cat([h, msg], -1))
        atom_e = self.readout(h)[:, 0] * batch["node_mask"].to(h.dtype)
        return _readout(atom_e, gid, batch["n_graphs"], kernel)


def mace_init(cfg: MACEConfig, *, device=None,
              generator: torch.Generator | None = None) -> MACE:
    device = resolve_device(device)
    generator = _generator(device, generator)
    model = MACE(cfg, device=device)
    with torch.no_grad():
        model.embed.normal_(0.0, 0.1, generator=generator)
        _init_mlps(model, generator)
    return model


def mace_forward(model: MACE, batch: dict) -> torch.Tensor:
    return model(batch)


def mace_loss(model: MACE, batch: dict, params: dict | None = None) -> torch.Tensor:
    e = _call(model, batch, params)
    return torch.mean((e - batch["energy"]) ** 2)


__all__ = [
    "MLP",
    "GCNConfig", "GCN", "gcn_init", "gcn_forward", "gcn_loss",
    "SchNetConfig", "SchNet", "schnet_init", "schnet_forward", "schnet_loss",
    "EGNNConfig", "EGNN", "egnn_init", "egnn_forward", "egnn_loss",
    "MACEConfig", "MACE", "mace_init", "mace_forward", "mace_loss",
]
