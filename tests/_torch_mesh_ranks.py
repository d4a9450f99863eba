"""One rank of the port's sub-axis meshes on the CPU: the sequence that
tests/test_torch_mesh.py runs at world sizes 1 (in process), 2 and 4 (one
process a rank over a gloo group) and holds against the JAX package.

    python tests/_torch_mesh_ranks.py RANK WORLD INIT_METHOD REF.npz OUT.npz
    python tests/_torch_mesh_ranks.py RANK WORLD INIT_METHOD - OUT.npz   # the card

For every mesh of its world over ``("data", "model")`` it runs the four
collectives over every axis set, with their backward; ``moe_ep`` (``sp``
both ways) and ``moe_tp`` with their gradients; and ``vp_segment_sum``
with the kernel off and on (on the CPU, K1's plain version), with its
gradient. The inputs are the JAX package's, read from ``REF.npz`` (the
parameters, tokens and edge lanes), or drawn from numpy seeds
(:func:`coll_input`). :func:`scripted` returns a flat dict of arrays; a rank
writes it to ``OUT.npz``. With ``-`` for ``REF.npz`` it runs only the
collectives, in float32 and bfloat16, every rank on cuda:0
(tests/test_torch_gpu.py). It imports torch and the port only.
"""
from __future__ import annotations

import sys

import numpy as np

AXES = ("data", "model")
MESHES = {1: [(1, 1)], 2: [(1, 2), (2, 1)], 4: [(2, 2), (4, 1)]}
MOE_MESHES = [(1, 1), (1, 2), (2, 2)]     # the JAX reference's moe meshes
COLL_AXES = {"all": None, "data": ("data",), "model": ("model",)}
VP_N, VP_D = 512, 16


def tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def moe_cases():
    """(name, layout, sp) of every MoE case."""
    return [("ep", "ep", False), ("ep", "ep", True), ("tp", "tp", False)]


def moe_cfg(name: str, dtype):
    """tests/test_distributed.py's two MoE configs, built by ``MoEConfig``
    of either package."""
    if name == "ep":
        return dtype(n_experts=8, top_k=2, d_model=16, d_ff=32, n_shared=1,
                     capacity_factor=8.0)
    return dtype(n_experts=6, top_k=2, d_model=16, d_ff=32, capacity_factor=8.0)


def coll_input(kind: str, rank: int, rows: int) -> np.ndarray:
    """Rank ``rank``'s operand (or cotangent) of collective ``kind``."""
    rng = np.random.default_rng(100 * rank + sum(map(ord, kind)) + rows)
    return rng.normal(size=(rows, 3)).astype(np.float32)


def token_block(a: np.ndarray, shape, coords, sp: bool) -> np.ndarray:
    """A rank's block of ``[B, S, ...]``: B split over "data", S over
    "model" with ``sp``."""
    b = a.shape[0] // shape[0]
    a = a[coords[0] * b:(coords[0] + 1) * b]
    if sp:
        s = a.shape[1] // shape[1]
        a = a[:, coords[1] * s:(coords[1] + 1) * s]
    return a


def vp_block(a: np.ndarray, shape, rank: int) -> np.ndarray:
    """A rank's share of the partitioned edge lanes: ``P(all_axes)``."""
    w = a.shape[0] // (shape[0] * shape[1])
    return a[rank * w:(rank + 1) * w]


def slice_of(shape, rank: int, axes) -> list[int]:
    """The ranks of ``rank``'s slice along ``axes`` (None: every axis), in
    their row-major order."""
    coords = [divmod(r, shape[1]) for r in range(shape[0] * shape[1])]
    fixed = [i for i, a in enumerate(AXES) if axes is not None and a not in axes]
    return [r for r in range(len(coords)) if all(coords[r][i] == coords[rank][i] for i in fixed)]


def expected_collectives(shape, rank: int, label: str) -> dict:
    """The numpy closed forms of :func:`collectives`' answers on ``rank``:
    each kind's value and its operand's gradient."""
    members = slice_of(shape, rank, COLL_AXES[label])
    me, n = members.index(rank), len(members)
    ins = {k: [coll_input(k, m, rows) for m in members]
           for k, rows in (("sum", 2), ("max", 2), ("gather", 2), ("a2a", n), ("sum_grad", 2))}
    ct = {k: [coll_input(k + "/ct", m, rows) for m in members]
          for k, rows in (("sum", 2), ("gather", 2 * n), ("a2a", n), ("sum_grad", 2))}
    return {"sum": sum(ins["sum"]), "max": np.max(ins["max"], axis=0),
            "gather": np.concatenate(ins["gather"]),
            "a2a": np.stack([x[me] for x in ins["a2a"]]), "sum_grad": ins["sum_grad"][me],
            "sum/grad": ct["sum"][me], "gather/grad": sum(ct["gather"])[2 * me:2 * me + 2],
            "a2a/grad": np.stack([c[me] for c in ct["a2a"]]),
            "sum_grad/grad": sum(ct["sum_grad"])}


def _counted(fn):
    from repro_torch.core import collective

    before = dict(collective.calls)
    res = fn()
    return res, {f"{k[0]}/{'+'.join(k[1])}": n - before.get(k, 0)
                 for k, n in collective.calls.items() if n != before.get(k, 0)}


def collectives(mesh, dtype=None) -> dict:
    """The collectives alone over every axis set of ``mesh``, on operands of
    ``dtype`` (float32 by default) on the mesh's device: their values, their
    operands' gradients and the calls each made."""
    import torch

    from repro_torch.core import collective

    dtype = dtype or torch.float32
    key, rank, out = tag(mesh.shape), mesh.rank, {}
    for label, axes in COLL_AXES.items():
        n = mesh.axis_size(axes)
        base = f"{key}/coll/{label}"
        for kind, rows, fn in (
                ("sum", 2, lambda t: collective.all_reduce_sum(t, mesh, axes)),
                ("max", 2, lambda t: collective.all_reduce_max(t, mesh, axes)),
                ("gather", 2, lambda t: collective.all_gather(t, mesh, axes)),
                ("a2a", n, lambda t: collective.all_to_all(t, mesh, axes)),
                ("sum_grad", 2, lambda t: collective.sum_grad(t, mesh, axes))):
            x = torch.from_numpy(coll_input(kind, rank, rows)).to(mesh.device, dtype)
            if kind != "max":
                x.requires_grad_(True)
            y, calls = _counted(lambda: fn(x.clone() if kind == "max" else x))
            out[f"{base}/{kind}"] = y.detach().float().cpu().numpy()
            out[f"{base}/{kind}/calls"] = np.array(sum(calls.values()))
            if kind != "max":
                c = torch.from_numpy(coll_input(kind + "/ct", rank, y.shape[0])).to(
                    mesh.device, dtype)
                (g,), calls = _counted(lambda: torch.autograd.grad(y, x, c))
                out[f"{base}/{kind}/grad"] = g.float().cpu().numpy()
                out[f"{base}/{kind}/grad_calls"] = np.array(sum(calls.values()))
    return out


def scripted(mesh, ref: dict) -> dict:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import moe_ep, moe_params_from_jax, moe_tp
    from repro_torch.models.moe import MoEConfig

    shape, rank = mesh.shape, mesh.rank
    coords = mesh.coords()
    key = tag(shape)
    out = collectives(mesh)

    # moe_ep and moe_tp
    if tuple(shape) in MOE_MESHES:
        w_all = ref["w"]
        for name, layout, sp in moe_cases():
            cfg = moe_cfg(name, MoEConfig)
            tree = {k.split("/")[-1]: v for k, v in ref.items() if k.startswith(f"{name}/p/")}
            p = moe_params_from_jax(tree, cfg, layout=layout, mesh=mesh)
            for v in p.values():
                v.requires_grad_(True)
            x = torch.from_numpy(token_block(ref["x"], shape, coords, sp).copy())
            x.requires_grad_(True)
            w = torch.from_numpy(token_block(w_all, shape, coords, sp).copy())
            fn = moe_ep if layout == "ep" else moe_tp
            (y, aux), fwd = _counted(lambda: fn(x, p, cfg, mesh=mesh, sp=sp))
            names = sorted(p)
            grads, bwd = _counted(lambda: torch.autograd.grad(
                (y * w).sum(), [x] + [p[k] for k in names], retain_graph=True))
            (g_aux,) = torch.autograd.grad(aux, p["router"])
            base = f"{key}/{name}/sp{int(sp)}"
            out[f"{base}/y"] = y.detach().numpy()
            out[f"{base}/aux"] = aux.detach().numpy()
            out[f"{base}/g/x"] = grads[0].numpy()
            for k, g in zip(names, grads[1:]):
                out[f"{base}/g/{k}"] = g.numpy()
            out[f"{base}/g_aux/router"] = g_aux.numpy()
            for k, v in fwd.items():
                out[f"{base}/fwd/{k}"] = np.array(v)
            for k, v in bwd.items():
                out[f"{base}/bwd/{k}"] = np.array(v)

    # vp_segment_sum, kernel off and on, its gradient, unsorted lanes
    ids = torch.from_numpy(vp_block(ref[f"vp/{key}/ids"], shape, rank).copy())
    vals_np = vp_block(ref[f"vp/{key}/vals"], shape, rank)
    blk = VP_N // shape[0]
    w = torch.from_numpy(ref["vp/w"][coords[0] * blk:(coords[0] + 1) * blk].copy())
    with ops.segment_output_sharding(mesh, ("data",), min_segments=1):
        for kernel in (False, True):
            vals = torch.from_numpy(vals_np.copy()).requires_grad_(True)
            o, calls = _counted(lambda: ops.vp_segment_sum(vals, ids, VP_N, kernel=kernel))
            (g,), bwd = _counted(lambda: torch.autograd.grad((o * w).sum(), vals))
            base = f"{key}/vp/k{int(kernel)}"
            out[f"{base}/out"] = o.detach().numpy()
            out[f"{base}/grad"] = g.numpy()
            out[f"{base}/calls"] = np.array(sum(calls.values()))
            out[f"{base}/grad_calls"] = np.array(sum(bwd.values()))
        flip = torch.flip(torch.arange(ids.shape[0]), [0])
        before = ops.unsorted_fallback_count
        o = ops.vp_segment_sum(torch.from_numpy(vals_np)[flip], ids[flip], VP_N, kernel=True)
        out[f"{key}/vp/unsorted/out"] = o.numpy()
        out[f"{key}/vp/unsorted/fallbacks"] = np.array(ops.unsorted_fallback_count - before)
        o = ops.vp_segment_sum(torch.from_numpy(vals_np[:, 0].copy()), ids, VP_N, kernel=True)
        out[f"{key}/vp/flat/out"] = o.numpy()
    return out


def main(argv: list[str]) -> int:
    """``REF.npz`` ``-`` runs the collectives alone, in float32 and
    bfloat16, on cuda:0 (every rank on the one card, gloo)."""
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
        ref = None if on_card else dict(np.load(ref_path))
        for shape in MESHES[int(world)]:
            if on_card:
                mesh = make_mesh(shape, AXES, device="cuda:0")
                for dt in (torch.float32, torch.bfloat16):
                    out.update({f"{dt}/{k}": v for k, v in collectives(mesh, dt).items()})
            else:
                out.update(scripted(make_mesh(shape, AXES, device="cpu"), ref))
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
