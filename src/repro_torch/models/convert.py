"""Carrying the JAX package's model parameters across to the port.

``dcn_params_from_jax`` takes the pytree of ``repro.models.recsys.dcn_init``
as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns a
``DCNv2`` holding the same values: the tables as they are, and each
``[in, out]`` matrix transposed into ``nn.Linear``'s ``[out, in]``. Both the
full-rank cross weights and the low-rank ``(u, v)`` pairs are taken.
``gnn_params_from_jax`` does the same for the four GNNs of
``repro.models.gnn`` (GCN's bare ``[in, out]`` weights stay as they are).
``lm_params_from_jax`` takes the pytree of ``repro.models.transformer.
init_params`` and unstacks each ``[L, ...]`` leaf into its layer's
parameter; the transformer keeps JAX's ``[in, out]`` layout, so nothing is
transposed. A bfloat16 leaf goes through float32 (exact) into the
parameter's dtype.

``moe_params_from_jax`` takes one MoE layer's tree of
``repro.models.moe.init_moe_params`` (a layer of its ``[L, ...]`` stacks)
and returns this rank's shard of it for ``moe_ep`` (its block of experts) or
``moe_tp`` (every expert's ``d_ff`` slice), or the whole layer without a
mesh.

``lm_state_to_jax`` and ``lm_state_from_jax`` carry a whole LM train state
(``{"params", "opt"}``, the optimizer's state any of JAX's three trees) to
and from JAX's layout: the port's per-layer leaves (``dense_blocks.3.attn.wq``)
stacked into JAX's ``[L, ...]`` leaves (``dense_blocks/attn/wq``), and back,
with no change of value or dtype. ``LM_STATE_LAYOUT`` is that pair for the
checkpoint manager, so the LM train loop's checkpoints hold JAX's keys,
shapes and bytes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint import Layout
from repro_torch.core.dispatch import resolve_device
from repro_torch.models import gnn
from repro_torch.models.recsys import DCNConfig, DCNv2
from repro_torch.models.transformer import Transformer, TransformerConfig


def _put(param: torch.Tensor, array, name: str, transpose: bool = False) -> None:
    value = torch.from_numpy(np.array(array, dtype=np.float32))  # a writable copy
    if transpose:
        value = value.T
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{name}: JAX gives {tuple(value.shape)}, the port holds "
                         f"{tuple(param.shape)}")
    param.copy_(value)


def dcn_params_from_jax(tree: dict, cfg: DCNConfig, device=None) -> DCNv2:
    """A ``DCNv2`` on ``device`` (None means the GPU) with the parameters of
    the JAX pytree ``tree`` (numpy leaves) for ``cfg``."""
    model = DCNv2(cfg, device=resolve_device(device))
    if len(tree["cross_w"]) != cfg.n_cross_layers or len(tree["mlp"]) != len(model.mlp):
        raise ValueError(f"the tree has {len(tree['cross_w'])} cross and "
                         f"{len(tree['mlp'])} MLP layers; {cfg.name} needs "
                         f"{cfg.n_cross_layers} and {len(model.mlp)}")
    with torch.no_grad():
        _put(model.tables, tree["tables"], "tables")
        for i, (layer, w, b) in enumerate(zip(model.cross, tree["cross_w"], tree["cross_b"])):
            if isinstance(w, (tuple, list)) != bool(cfg.cross_rank):
                raise ValueError(f"cross layer {i}: the tree's rank does not match "
                                 f"cross_rank={cfg.cross_rank}")
            if cfg.cross_rank:
                _put(layer[0].weight, w[0], f"cross_w[{i}][0]", transpose=True)
                _put(layer[1].weight, w[1], f"cross_w[{i}][1]", transpose=True)
                _put(layer[1].bias, b, f"cross_b[{i}]")
            else:
                _put(layer.weight, w, f"cross_w[{i}]", transpose=True)
                _put(layer.bias, b, f"cross_b[{i}]")
        for i, (lin, (w, b)) in enumerate(zip(model.mlp, tree["mlp"])):
            _put(lin.weight, w, f"mlp[{i}][0]", transpose=True)
            _put(lin.bias, b, f"mlp[{i}][1]")
    return model


_GNN_MODELS = {gnn.GCNConfig: gnn.GCN, gnn.SchNetConfig: gnn.SchNet,
               gnn.EGNNConfig: gnn.EGNN, gnn.MACEConfig: gnn.MACE}


def _put_mlp(mlp: gnn.MLP, layers, name: str) -> None:
    if len(layers) != len(mlp):
        raise ValueError(f"{name}: the tree has {len(layers)} layers, the port {len(mlp)}")
    for i, (lin, (w, b)) in enumerate(zip(mlp, layers)):
        _put(lin.weight, w, f"{name}[{i}][0]", transpose=True)
        _put(lin.bias, b, f"{name}[{i}][1]")


def gnn_params_from_jax(tree: dict, cfg, device=None):
    """The port's model for ``cfg`` (a ``GCNConfig``, ``SchNetConfig``,
    ``EGNNConfig`` or ``MACEConfig``) on ``device`` (None means the GPU)
    with the parameters of the JAX pytree ``tree`` (numpy leaves) of the
    matching ``repro.models.gnn.*_init``."""
    model = _GNN_MODELS[type(cfg)](cfg, device=resolve_device(device))
    blocks = {gnn.SchNet: "inter", gnn.EGNN: "layers", gnn.MACE: "layers"}.get(type(model))
    with torch.no_grad():
        if isinstance(model, gnn.GCN):
            if len(tree["w"]) != len(model.w):
                raise ValueError(f"the tree has {len(tree['w'])} layers; {cfg.name} "
                                 f"needs {len(model.w)}")
            for i, (param, w) in enumerate(zip(model.w, tree["w"])):
                _put(param, w, f"w[{i}]")
            return model
        _put(model.embed, tree["embed"], "embed")
        _put_mlp(model.readout, tree["readout"], "readout")
        ours = getattr(model, blocks)
        if len(tree[blocks]) != len(ours):
            raise ValueError(f"the tree has {len(tree[blocks])} {blocks}; {cfg.name} "
                             f"needs {len(ours)}")
        for i, (block, layer) in enumerate(zip(ours, tree[blocks])):
            mlps = dict(block.named_children())
            if set(mlps) != set(layer):
                raise ValueError(f"{blocks}[{i}]: the tree has {sorted(layer)}, the port "
                                 f"{sorted(mlps)}")
            for key, mlp in mlps.items():
                _put_mlp(mlp, layer[key], f"{blocks}[{i}][{key!r}]")
    return model


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


def lm_params_from_jax(tree: dict, cfg: TransformerConfig, device=None) -> Transformer:
    """A ``Transformer`` for ``cfg`` on ``device`` (None means the GPU) with
    the parameters of the JAX pytree ``tree`` (numpy leaves) of
    ``repro.models.transformer.init_params``: ``dense_blocks.<key>[i]`` into
    ``dense_blocks.<i>.<key>`` (the same for ``moe_blocks``), the MTP
    block's one-layer stack into ``mtp.block``, the rest as it is. Every
    name and shape is checked."""
    model = Transformer(cfg, device=resolve_device(device))
    want = {}
    for name, leaf in _flatten(tree).items():
        group, _, rest = name.partition(".")
        if group in ("dense_blocks", "moe_blocks"):
            want.update({f"{group}.{i}.{rest}": leaf[i] for i in range(leaf.shape[0])})
        elif name.startswith("mtp.block."):
            if leaf.shape[0] != 1:
                raise ValueError(f"{name}: the MTP block stacks {leaf.shape[0]} layers, not 1")
            want[name] = leaf[0]
        else:
            want[name] = leaf
    params = dict(model.named_parameters())
    if want.keys() != params.keys():
        raise ValueError(f"{cfg.name}: the tree lacks {sorted(params.keys() - want.keys())} "
                         f"and has no place for {sorted(want.keys() - params.keys())}")
    with torch.no_grad():
        for name, param in params.items():
            _put(param, want[name], name)
    return model


def moe_params_from_jax(tree: dict, cfg, *, layout: str = "ep", mesh=None,
                        device=None) -> dict:
    """One MoE layer's parameters (numpy leaves of JAX's keys: ``router``
    ``[D, E]``, ``wg``/``wi`` ``[E, D, F]``, ``wo`` ``[E, F, D]``, the shared
    experts' ``shared_*``) as float32 tensors on ``device`` (the mesh's
    when given; None means the GPU). Over ``mesh``, rank i of the
    ``"model"`` axis keeps its shard of the experts, as the reference's
    ``shard_map`` specs split them: ``layout="ep"`` (``moe_ep``) the i-th
    block of ``E / |model|`` experts, ``layout="tp"`` (``moe_tp``) the i-th
    ``F / |model|`` slice of ``wg``'s and ``wi``'s last dim and of ``wo``'s
    middle dim. The router and the shared experts stay whole."""
    if layout not in ("ep", "tp"):
        raise ValueError(f"layout must be 'ep' or 'tp', got {layout!r}")
    want = {"router": (cfg.d_model, cfg.n_experts),
            "wg": (cfg.n_experts, cfg.d_model, cfg.d_ff),
            "wi": (cfg.n_experts, cfg.d_model, cfg.d_ff),
            "wo": (cfg.n_experts, cfg.d_ff, cfg.d_model)}
    if cfg.n_shared:
        fs = cfg.d_ff * cfg.n_shared
        want.update(shared_wg=(cfg.d_model, fs), shared_wi=(cfg.d_model, fs),
                    shared_wo=(fs, cfg.d_model))
    if set(tree) != set(want):
        raise ValueError(f"the tree has {sorted(tree)}; {cfg} needs {sorted(want)}")
    n, i = (1, 0) if mesh is None else (mesh.axis_size("model"), mesh.axis_index("model"))
    split = cfg.n_experts if layout == "ep" else cfg.d_ff
    if split % n:
        raise ValueError(f"{split} {'experts' if layout == 'ep' else 'd_ff'} do not split "
                         f"over {n} ranks")
    w = split // n
    cut = {"ep": {k: (0,) for k in ("wg", "wi", "wo")},
           "tp": {"wg": (2,), "wi": (2,), "wo": (1,)}}[layout]
    device = mesh.device if mesh is not None else resolve_device(device)
    out = {}
    for key, shape in want.items():
        leaf = np.asarray(tree[key])
        if tuple(leaf.shape) != shape:
            raise ValueError(f"{key}: JAX gives {tuple(leaf.shape)}, {cfg} needs {shape}")
        for axis in cut.get(key, ()):
            leaf = np.take(leaf, np.arange(i * w, (i + 1) * w), axis=axis)
        out[key] = torch.from_numpy(np.array(leaf, dtype=np.float32)).to(device)
    return out


_BLOCKS = ("dense_blocks", "moe_blocks")


def _jax_place(name: str) -> tuple[tuple, int | None]:
    """(JAX's key path, layer index or None) of a port parameter name:
    ``dense_blocks.3.attn.wq`` -> (("dense_blocks", "attn", "wq"), 3), the
    MTP block's ``mtp.block.ln1`` -> (("mtp", "block", "ln1"), 0) (a stack
    of one), ``embed`` -> (("embed",), None)."""
    parts = name.split(".")
    if parts[0] in _BLOCKS:
        return (parts[0], *parts[2:]), int(parts[1])
    if parts[:2] == ["mtp", "block"]:
        return tuple(parts), 0
    return tuple(parts), None


def _stack(items: list):
    """The leaves of like subtrees stacked on a new leading axis (numpy or
    torch, as the leaves are)."""
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return (torch.stack if isinstance(items[0], torch.Tensor) else np.stack)(items)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _named_to_jax(named: dict) -> dict:
    """A dict by port parameter name (each value a leaf or a subtree, as an
    Adafactor moment's ``{"vr", "vc"}``) as JAX's nested tree."""
    layers: dict = {}
    out: dict = {}
    for name, value in named.items():
        path, i = _jax_place(name)
        if i is None:
            _set(out, path, value)
        else:
            layers.setdefault(path, {})[i] = value
    for path, by_layer in layers.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{'/'.join(path)}: layers {sorted(by_layer)} are not 0..L-1")
        _set(out, path, _stack([by_layer[i] for i in range(len(by_layer))]))
    return out


def _param_names(params: dict, prefix: tuple = ()) -> list[tuple[str, tuple, int | None]]:
    """(port name, JAX path, layer index) of every parameter of JAX's
    nested parameter tree (array leaves)."""
    out = []
    for key, value in params.items():
        path = prefix + (key,)
        if isinstance(value, dict):
            out += _param_names(value, path)
        elif path[0] in _BLOCKS:
            out += [(f"{path[0]}.{i}.{'.'.join(path[1:])}", path, i) for i in range(value.shape[0])]
        elif path[:2] == ("mtp", "block"):
            if value.shape[0] != 1:
                raise ValueError(f"{'/'.join(path)}: the MTP block stacks {value.shape[0]} "
                                 f"layers, not 1")
            out.append((".".join(path), path, 0))
        else:
            out.append((".".join(path), path, None))
    return out


def lm_state_to_jax(state: dict) -> dict:
    """The port's LM train state ``{"params": {name: leaf}, "opt": {"step",
    <moment>: {name: leaf or subtree}}}`` in JAX's layout: per-layer leaves
    stacked into JAX's ``[L, ...]`` leaves under JAX's nested keys (the
    optimizer's moments as its tree over the parameters). Leaves may be
    tensors (any device, ``"meta"`` for shapes only) or numpy arrays; the
    stack is of the same kind."""
    opt = {k: _named_to_jax(v) if isinstance(v, dict) else v for k, v in state["opt"].items()}
    return {"params": _named_to_jax(state["params"]), "opt": opt}


def lm_state_from_jax(tree: dict) -> dict:
    """JAX's LM train state (``{"params", "opt"}`` of JAX's trees, numpy or
    tensor leaves) in the port's layout, by parameter name: each stacked
    leaf's layer ``i`` (a view) under ``<group>.<i>.<key>``. The inverse of
    ``lm_state_to_jax``."""
    names = _param_names(tree["params"])

    def named(t: dict) -> dict:
        return {name: (_get(t, path) if i is None else _index(_get(t, path), i))
                for name, path, i in names}

    opt = {k: named(v) if isinstance(v, dict) else v for k, v in tree["opt"].items()}
    return {"params": named(tree["params"]), "opt": opt}


LM_STATE_LAYOUT = Layout(lm_state_to_jax, lm_state_from_jax)


__all__ = ["dcn_params_from_jax", "gnn_params_from_jax", "lm_params_from_jax",
           "moe_params_from_jax", "lm_state_to_jax", "lm_state_from_jax", "LM_STATE_LAYOUT"]
