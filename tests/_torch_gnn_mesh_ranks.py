"""One rank of the port's GNN train kind over a mesh on the CPU: the
sequence that tests/test_torch_gnn_mesh.py runs at world sizes 1 (in
process), 2 and 4 (one process a rank over a gloo group) and holds against
the JAX package.

    python tests/_torch_gnn_mesh_ranks.py RANK WORLD INIT_METHOD REF.npz OUT.npz

For every mesh of its world over ``("data", "model")``, a GCN and a SchNet
train step (``launch.steps.build_step(mesh=)``, the registry patched to the
small configs below) on the JAX package's parameters and batches (read from
``REF.npz``), in both layouts: ``ogb_products``' node blocks over "data"
(the edge lanes partitioned by dst block, the reference's
``segment_output_sharding`` hint) and the other shapes' (no node blocks), K1
on (its plain version on the CPU) and off. It returns the loss, the
gradients and the updated parameters (every rank holds them whole), and K1's
calls. With ``-`` for ``REF.npz`` it runs :func:`card` on cuda:0
(tests/test_torch_gpu.py). It imports torch and the port only.
"""
from __future__ import annotations

import sys

import numpy as np

AXES = ("data", "model")
MESHES = {1: [(1, 1)], 2: [(2, 1), (1, 2)], 4: [(2, 2)]}
N_GCN, F_GCN, N_CLASSES = 64, 8, 3
GRAPHS, ATOMS = 4, 8           # SchNet: 4 molecules of 8 atoms, N = 32
LAYOUTS = {"blocks": "ogb_products", "whole": "molecule"}   # shape name of each layout


def tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def gnn_configs(gcn_config, schnet_config) -> dict:
    return {"gcn": gcn_config(name="gcn-small", n_layers=2, d_hidden=8, d_feat=F_GCN,
                              n_classes=N_CLASSES),
            "schnet": schnet_config(name="schnet-small", n_interactions=2, d_hidden=8,
                                    n_rbf=6, cutoff=5.0, n_species=10)}


def lanes(src: np.ndarray, dst: np.ndarray, n: int, shape) -> tuple[np.ndarray, np.ndarray]:
    """The edge lanes as the reference's hint takes them over ``shape``
    (tests/test_distributed.py:184's layout): sorted by dst, cut into
    ``shape[0]`` dst blocks, each padded with the sentinel ``n`` to the same
    multiple of ``shape[1]`` lanes."""
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    blocks, sub = shape
    bounds = np.searchsorted(dst, np.arange(0, n + 1, n // blocks))
    per = int(np.ceil(max(np.diff(bounds).max(), 1) / sub) * sub)
    s = np.full(per * blocks, n, np.int32)
    d = np.full(per * blocks, n, np.int32)
    for b in range(blocks):
        lo, hi = bounds[b], bounds[b + 1]
        s[b * per:b * per + hi - lo] = src[lo:hi]
        d[b * per:b * per + hi - lo] = dst[lo:hi]
    return s, d


def gcn_batch(shape) -> dict:
    rng = np.random.default_rng(11)
    src = rng.integers(0, N_GCN, 320).astype(np.int32)
    dst = rng.integers(0, N_GCN, 320).astype(np.int32)
    s, d = lanes(np.concatenate([src, dst]), np.concatenate([dst, src]), N_GCN, shape)
    return {"src": s, "dst": d,
            "node_feat": rng.normal(size=(N_GCN, F_GCN)).astype(np.float32),
            "labels": rng.integers(0, N_CLASSES, N_GCN).astype(np.int32),
            "label_mask": rng.random(N_GCN) < 0.6,
            "graph_id": np.zeros(N_GCN, np.int32),
            "node_mask": np.ones(N_GCN, bool)}


def schnet_batch(shape) -> dict:
    rng = np.random.default_rng(12)
    n = GRAPHS * ATOMS
    src, dst = [], []
    for g in range(GRAPHS):
        for i in range(ATOMS):
            for j in range(ATOMS):
                if i != j and rng.random() < 0.5:
                    src.append(g * ATOMS + i)
                    dst.append(g * ATOMS + j)
    s, d = lanes(np.array(src, np.int32), np.array(dst, np.int32), n, shape)
    return {"src": s, "dst": d,
            "atom_type": rng.integers(0, 10, n).astype(np.int32),
            "pos": (rng.normal(size=(n, 3)) * 1.5).astype(np.float32),
            "graph_id": np.repeat(np.arange(GRAPHS), ATOMS).astype(np.int32),
            "node_mask": np.ones(n, bool),
            "energy": rng.normal(size=GRAPHS).astype(np.float32)}


def batches(shape) -> dict:
    return {"gcn": gcn_batch(shape), "schnet": schnet_batch(shape)}


def build(cfg, shape_name: str, mesh, n_graphs: int):
    """The GNN train kind of a config not in the registry."""
    from repro_torch.configs.common import Arch, Shape
    from repro_torch.launch import steps

    dims = {"ogb_products": dict(n_nodes=64, n_edges=320, d_feat=F_GCN, batch=n_graphs),
            "molecule": dict(n_nodes=ATOMS, n_edges=32, batch=n_graphs)}[shape_name]
    arch = Arch(name=cfg.name, family="gnn", full=cfg, smoke=cfg, optimizer="adamw",
                shapes=(Shape(shape_name, "train", dims),))
    saved = steps.get_arch
    steps.get_arch = lambda name: arch
    try:
        return steps.build_step(cfg.name, shape_name, device="cpu", mesh=mesh)
    finally:
        steps.get_arch = saved


def params_of(name: str, cfg, ref: dict):
    from repro_torch.models import gnn_params_from_jax

    pre = f"p/{name}/"
    tree = _unflatten({k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})
    return gnn_params_from_jax(tree, cfg, device="cpu")


def scripted(mesh, ref: dict) -> dict:
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import train_state
    from repro_torch.models import GCNConfig, SchNetConfig

    torch.set_float32_matmul_precision("highest")
    key, out = tag(mesh.shape), {}
    calls = []
    real = ops.segment_sum_sorted   # what vp_segment_sum calls for K1

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    ops.segment_sum_sorted = counted
    try:
        for name, cfg in gnn_configs(GCNConfig, SchNetConfig).items():
            data = {k.split("/")[-1]: v for k, v in ref.items()
                    if k.startswith(f"b/{key}/{name}/")}
            for layout, shape_name in LAYOUTS.items():
                for kernel in (False, True):
                    c = dataclasses.replace(cfg, kernel=kernel)
                    step = build(c, shape_name, mesh, GRAPHS)
                    state = train_state(params_of(name, c, ref), step.opt)
                    del calls[:]
                    loss, grads = step.grad(state["params"], data)
                    base = f"{key}/{name}/{layout}/k{int(kernel)}"
                    out[f"{base}/k1_calls"] = np.array(len(calls))
                    out[f"{base}/loss"] = np.array(float(loss))
                    out.update({f"{base}/g/{k}": g.numpy() for k, g in grads.items()})
                    new_p, _, _ = step.fn(state["params"], state["opt"], data)
                    out.update({f"{base}/new/{k}": v.numpy() for k, v in new_p.items()})
    finally:
        ops.segment_sum_sorted = real
    return out


def _unflatten(flat: dict) -> dict:
    """``{"a/0/b": leaf}`` as nested dicts and lists (digit keys index lists)."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(out)


def seeded_gcn(device="cpu"):
    """The small GCN drawn from seed 0 (the card mode's and its CPU
    answer's, no JAX)."""
    import dataclasses

    import torch

    from repro_torch.models import GCNConfig, SchNetConfig, gcn_init

    cfg = dataclasses.replace(gnn_configs(GCNConfig, SchNetConfig)["gcn"], kernel=None)
    return cfg, gcn_init(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))


def card(shape) -> dict:
    """The card mode: the seeded GCN's train step over ``shape`` with every
    rank on cuda:0 and K1 on (``kernel=None``): loss, gradients, K1's
    launches on this rank, bitwise repeatability."""
    import torch

    from repro_torch.core.distributed import make_mesh
    from repro_torch.kernels import segsum
    from repro_torch.launch.steps import train_state

    torch.set_float32_matmul_precision("highest")
    # the gathers' backward (index_add_) in its sorted, repeatable form
    torch.use_deterministic_algorithms(True, warn_only=True)
    mesh = make_mesh(shape, AXES, device="cuda:0")
    cfg, model = seeded_gcn()
    model = model.to(mesh.device)
    step = build(cfg, "ogb_products", mesh, 1)
    state = train_state(model, step.opt)
    batch = gcn_batch(shape)
    before = segsum.launches
    loss, grads = step.grad(state["params"], batch)
    key = tag(shape)
    out = {f"{key}/k1_launches": np.array(segsum.launches - before),
           f"{key}/loss": np.array(float(loss))}
    out.update({f"{key}/g/{k}": g.cpu().numpy() for k, g in grads.items()})
    again = step.grad(state["params"], batch)
    out[f"{key}/bitwise"] = np.array(bool(torch.equal(again[0], loss) and all(
        torch.equal(again[1][k], g) for k, g in grads.items())))
    return out


def main(argv: list[str]) -> int:
    """``REF.npz`` ``-`` is the card mode (:func:`card`): world 2 over (2,
    1) and (1, 2), every rank on cuda:0."""
    rank, world, init, ref_path, out_path = argv
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import make_mesh

    torch.set_num_threads(1)
    on_card = ref_path == "-"
    if on_card:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, world_size=int(world), rank=int(rank))
    try:
        out = {}
        if on_card:
            for shape in MESHES[int(world)]:
                out.update(card(shape))
        else:
            ref = dict(np.load(ref_path))
            for shape in MESHES[int(world)]:
                out.update(scripted(make_mesh(shape, AXES, device="cpu"), ref))
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
