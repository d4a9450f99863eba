"""One rank of the port's sharded tier on the CPU: the scripted sequence that
tests/test_torch_distributed.py runs at world sizes 1 (in process), 2 and 4
(one process a rank over a gloo group) and holds against the JAX package.

    python tests/_torch_ranks.py RANK WORLD INIT_METHOD OUT.npz

Every input comes from a numpy seed, so every rank (and the JAX reference)
builds the same graphs and the same batches. :func:`scripted` returns a flat
dict of int arrays (float32 densities as their bits); a rank writes it to
``OUT.npz``. It imports torch and the port only.
"""
from __future__ import annotations

import sys

import numpy as np


def graphs(Graph, gen) -> dict:
    """The static graphs, from either package's ``Graph`` and generators."""
    star = np.array([(0, i) for i in range(1, 41)] + [(1, 2), (2, 3)])
    rng = np.random.default_rng(9)
    islands = rng.integers(0, 40, (150, 2))  # vertices 40..79 isolated
    return {"er": gen.erdos_renyi(300, 0.05, seed=3),
            "planted": gen.planted_dense(400, 30, seed=5)[0],
            "star": Graph.from_edges(star, n_nodes=41),
            "isolated": Graph.from_edges(islands, n_nodes=80)}


STREAM_N = 120
STREAM_ENGINES = {"pruned": dict(eps=0.1, refresh_every=4),
                  "warm": dict(eps=0.1, refresh_every=4, pruned=False)}
REFINE = dict(refine=True, target_gap=-1.0, max_refine_rounds=3)


def stream_batches():
    """6 mixed batches: uniform inserts, and from the second on deletes of a
    third of the present edges."""
    rng = np.random.default_rng(3)
    edges, out = set(), []
    for step in range(6):
        ins = rng.integers(0, STREAM_N, (40, 2))
        dels = None
        if edges and step % 2:
            pool = np.asarray(sorted(edges))
            dels = pool[rng.random(len(pool)) < 0.3]
            edges -= {(int(u), int(v)) for u, v in dels}
        edges |= {(min(int(u), int(v)), max(int(u), int(v))) for u, v in ins if u != v}
        out.append((ins, dels))
    return out


FUSED_N = 96
FUSED_TENANTS = ["a", "b", "c", "d"]


def fused_updates(step: int) -> dict:
    """Each tenant's batch at ``step`` (tests/test_shard.py's traffic): 40
    pairs, and from step 3 on a delete of the previous step's inserts."""
    ups = {}
    for i, t in enumerate(FUSED_TENANTS):
        e = np.random.default_rng(100 + 7 * step + i).integers(0, FUSED_N, (40, 2))
        dele = None
        if step >= 3:
            prev = np.random.default_rng(100 + 7 * (step - 1) + i).integers(0, FUSED_N, (40, 2))
            dele = prev[prev[:, 0] != prev[:, 1]]
        ups[t] = (e[e[:, 0] != e[:, 1]], dele)
    return ups


def bits(x) -> int:
    return int(np.float32(x).view(np.int32))


def record_query(out: dict, key: str, q) -> None:
    out[key] = np.array([bits(q.density), bits(q.warm_density), q.passes, q.refreshed,
                         q.pruned], np.int64)
    out[key + "/mask"] = np.asarray(q.mask)
    out[key + "/warm_mask"] = np.asarray(q.warm_mask)


def record_refined(out: dict, key: str, q) -> None:
    c = q.certificate
    out[key] = np.array([bits(q.density), c.best_ne, c.best_nv, c.dual_num, c.dual_den,
                         q.passes, q.refine_rounds], np.int64)
    out[key + "/mask"] = np.asarray(q.mask)


def record_cbds(out: dict, key: str, c: dict) -> None:
    out[key] = np.array([bits(c["density"]), bits(c["core_density"]), c["k_star"],
                         c["n_legit"]], np.int64)
    out[key + "/member"] = np.asarray(c["member_mask"])


def scripted(mesh) -> dict:
    """The whole sequence on ``mesh``: P-Bahmani and CBDS-P over the static
    graphs, two sharded engines through the stream with every query kind
    after each batch, and a fused+sharded bucket of four tenants. ``coll/``
    keys hold the collectives counted around the static calls,
    ``collectives`` those of the whole sequence."""
    from repro_torch.core import collective, distributed
    from repro_torch.graphs import generators
    from repro_torch.graphs.graph import Graph
    from repro_torch.stream import DeltaEngine, GraphRegistry, ingest_group, query_group

    out, start = {}, collective.collectives
    for name, g in graphs(Graph, generators).items():
        for eps in (0.0, 0.1):
            before = collective.collectives
            d, mask, passes = distributed.pbahmani_distributed(g, mesh, eps=eps)
            out[f"pb/{name}/{eps}"] = np.array([bits(d), passes], np.int64)
            out[f"pb/{name}/{eps}/mask"] = mask
            out[f"coll/pb/{name}/{eps}"] = np.array([collective.collectives - before, passes])
        c = distributed.cbds_distributed(g, mesh, rounds=2)
        record_cbds(out, f"cbds/{name}", c)
        out[f"cbds/{name}/coreness"] = c["coreness"]

    engines = {k: DeltaEngine(STREAM_N, sharded=True, mesh=mesh, **kw)
               for k, kw in STREAM_ENGINES.items()}
    for step, (ins, dels) in enumerate(stream_batches()):
        for k, eng in engines.items():
            eng.apply_updates(insert=ins, delete=dels)
            record_query(out, f"stream/{k}/{step}", eng.query())
            record_refined(out, f"stream/{k}/{step}/refine", eng.query(**REFINE))
            record_cbds(out, f"stream/{k}/{step}/cbds", eng.cbds())

    reg = GraphRegistry(fused=True, sharded=True, mesh=mesh, eps=0.1, refresh_every=4)
    for t in FUSED_TENANTS:
        reg.register(t, n_nodes=FUSED_N, pruned=t in ("a", "b"))
    for step in range(6):
        ingest_group(fused_updates(step), reg.engines())
        res = query_group(reg.engines())
        for t in FUSED_TENANTS:
            record_query(out, f"fused/{t}/{step}", res[t])
    res = query_group(reg.engines(), **REFINE)
    for t in FUSED_TENANTS:
        record_refined(out, f"fused/{t}/refine", res[t])
        record_cbds(out, f"fused/{t}/cbds", reg.get(t).cbds())
    out["collectives"] = np.array([collective.collectives - start])
    return out


def main(argv: list[str]) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import make_mesh

    rank, world, init, path = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        np.savez(path, **scripted(make_mesh(device="cpu")))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
