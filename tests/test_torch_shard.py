"""The port's sharded tier over a mesh of one, in this process, against the
JAX package's sharded tier on its 1-device mesh (``make_mesh_auto((1,),
("shard",))``), bit for bit on the CPU: the sharded ``DeltaEngine`` step by
step (as tests/test_shard.py holds JAX's to its single-device engine, and
here to the port's single-device engine as well), ``make_sharded_plan``'s
integers, the sharded bucket peel, the sharded refinement round and its
certificate, ``pbahmani_distributed`` and ``cbds_distributed``, the
validation errors, the registry and service opt-in, and
``graphs/partition.py``. Every pass counts one collective; a real gloo group
of one rank runs the static peels too. tests/test_torch_distributed.py runs
2 and 4 ranks. Every input comes from a numpy seed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import distributed as jdist  # noqa: E402
from repro.core import prune as jprune  # noqa: E402
from repro.core.cbds import cbds_np as j_cbds_np  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.graphs import partition as jpartition  # noqa: E402
from repro.graphs.graph import Graph as JGraph  # noqa: E402
from repro.refine.engine import refine_resident as j_refine_resident  # noqa: E402
from repro.stream import DeltaEngine as JEngine  # noqa: E402
from repro.utils.compat import make_mesh_auto  # noqa: E402
from repro_torch.core import collective, distributed, prune  # noqa: E402
from repro_torch.core.distributed import Mesh, make_mesh  # noqa: E402
from repro_torch.core.pbahmani import pbahmani, pbahmani_np  # noqa: E402
from repro_torch.graphs import partition  # noqa: E402
from repro_torch.graphs.convert import graph_from_arrays, to_device  # noqa: E402
from repro_torch.refine.engine import refine_resident  # noqa: E402
from repro_torch.stream import (  # noqa: E402
    DeltaEngine, GraphRegistry, StreamService, query_group,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small graphs: torch's intra-op threads cost more than they save and
    oversubscribe the parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh_auto((1,), ("shard",))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(device="cpu")


def _bits(x):
    return np.float32(x).view(np.int32)


def port(g):
    return graph_from_arrays(g.n_nodes, g.n_edges, g.src, g.dst, g.n_directed)


GRAPHS = {"er": lambda: jgen.erdos_renyi(300, 0.05, seed=3),
          "planted": lambda: jgen.planted_dense(600, 40, seed=11)[0],
          "ba": lambda: jgen.barabasi_albert(400, 3, seed=2)}


def _same_query(got, want, where):
    assert _bits(got.density) == _bits(want.density), (where, got.density, want.density)
    assert got.passes == want.passes, where
    assert np.array_equal(np.asarray(got.mask), np.asarray(want.mask)), where
    assert _bits(got.warm_density) == _bits(want.warm_density), where
    assert np.array_equal(np.asarray(got.warm_mask), np.asarray(want.warm_mask)), where
    assert (got.refreshed, got.pruned, got.refine_rounds) == (
        want.refreshed, want.pruned, want.refine_rounds), where
    if want.certificate is not None:
        assert dataclasses.asdict(got.certificate) == dataclasses.asdict(want.certificate)


def _same_cbds(got, want, where):
    for k in ("density", "core_density"):
        assert _bits(got[k]) == _bits(want[k]), (where, k)
    assert (got["k_star"], got["n_legit"]) == (want["k_star"], want["n_legit"]), where
    assert np.array_equal(np.asarray(got["member_mask"]), np.asarray(want["member_mask"]))


def stream_steps(rng, n_nodes, n_batches, max_batch):
    """tests/test_shard.py's stream: inserts, and every other batch deletes
    of a third of the present edges."""
    edges: set = set()
    for step in range(n_batches):
        ins = rng.integers(0, n_nodes, (int(rng.integers(1, max_batch)), 2))
        dels = None
        if edges and step % 2:
            pool = np.asarray(sorted(edges))
            dels = pool[rng.random(len(pool)) < 0.3]
            edges -= {(int(u), int(v)) for u, v in dels}
        edges |= {(min(int(u), int(v)), max(int(u), int(v))) for u, v in ins if u != v}
        yield ins, dels, edges


# ---------------------------------------------------------------------------
# the sharded engine, step by step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pruned", [True, False])
def test_sharded_bit_identical_on_one_device_mesh(pruned, mesh, jmesh):
    """The port's sharded engine == JAX's sharded engine on its 1-device mesh
    == the port's single-device engine, after every batch: the query (warm,
    pruned and the epoch refresh), a fixed-round refined query and cbds."""
    rng = np.random.default_rng(42)
    n = 200
    sh = DeltaEngine(n, refresh_every=4, pruned=pruned, sharded=True, mesh=mesh)
    single = DeltaEngine(n, refresh_every=4, pruned=pruned, device="cpu")
    j = JEngine(n_nodes=n, refresh_every=4, pruned=pruned, sharded=True, mesh=jmesh)
    assert sh.n_shards == j.n_shards == 1 and sh.kind == j.kind == "sharded"
    for step, (ins, dels, edges) in enumerate(stream_steps(rng, n, 8, 50)):
        for eng in (sh, single, j):
            eng.apply_updates(insert=ins, delete=dels)
        q = sh.query()
        _same_query(q, j.query(), step)
        _same_query(q, single.query(), step)
        rho, _, passes = pbahmani_np(port(JGraph.from_edges(
            np.asarray(sorted(edges)).reshape(-1, 2), n_nodes=n)))
        assert q.density == pytest.approx(rho, rel=1e-6, abs=1e-9) and q.passes == passes
        kw = dict(refine=True, target_gap=-1.0, max_refine_rounds=3)
        r = sh.query(**kw)
        _same_query(r, j.query(**kw), step)
        _same_query(r, single.query(**kw), step)
        _same_cbds(sh.cbds(2), j.cbds(2), step)
        assert np.array_equal(sh._deg.numpy(), np.asarray(j._deg)), step
    assert sh.metrics.n_refreshes == j.metrics.n_refreshes >= 1
    assert (sh.metrics.n_pruned_queries > 0) == pruned


def test_sharded_engine_validation():
    """A rank count that is not a power of two, or more ranks than edge
    lanes, is refused as the JAX package refuses it; so is a layout that
    does not cover the group."""
    fake3 = Mesh(group=None, shape=(3,), axis_names=("shard",), rank=0, size=3,
                 device=torch.device("cpu"))
    with pytest.raises(ValueError, match="power-of-two") as terr:
        DeltaEngine(50, sharded=True, mesh=fake3)
    with pytest.raises(ValueError) as jerr:
        jdist.validate_stream_mesh(_FakeMesh(), 64)
    assert str(terr.value) == str(jerr.value)
    fake = dataclasses.replace(fake3, shape=(4096,), size=4096)
    with pytest.raises(ValueError, match="raise the edge capacity"):
        DeltaEngine(50, sharded=True, mesh=fake, capacity=256)
    assert distributed.validate_stream_mesh(fake, 4096) == 4096
    with pytest.raises(ValueError, match="does not lay out"):
        make_mesh((2,), device="cpu")
    assert make_mesh((1, 1), ("data", "model"), device="cpu").shape == (1, 1)


class _FakeMesh:
    shape = {"shard": 3}
    axis_names = ("shard",)


# ---------------------------------------------------------------------------
# the pieces: plan, bucket peel, refinement round, static peels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sharded_plan_integers(name, mesh, jmesh):
    """``make_sharded_plan`` of the port == JAX's, from no previous mask and
    from a previous best mask."""
    jg = GRAPHS[name]()
    g = port(jg)
    src, dst = distributed.shard_edges(g, mesh)
    jsrc, jdst = jdist.shard_edges(jg, jmesh)
    run, jrun = prune.make_sharded_plan(mesh, g.n_nodes), jprune.make_sharded_plan(
        jmesh, jg.n_nodes)
    for prev in (np.zeros(g.n_nodes, bool), pbahmani_np(g, 0.1)[1]):
        got = run(src, dst, torch.from_numpy(prev), g.n_edges)
        want = jrun(jsrc, jdst, prev, np.int32(jg.n_edges))
        assert _bits(got[0]) == _bits(want[0])
        assert [int(x) for x in got[1:2] + got[3:]] == [int(x) for x in want[1:2] + want[3:]]
        assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("kernel", [False, True], ids=["scatter", "kernel"])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_sharded_bucket_peel(eps, kernel, mesh, jmesh):
    """``pruned_peel_host(mesh=...)``, the bucket peel sharded with its
    per-rank ladder: the port's (K2 and K3/K4 plain versions with the
    kernel) == JAX's sharded one == the unpruned peel."""
    jg = GRAPHS["planted"]()
    g = port(jg)
    plan = prune.plan_for_graph(g, device="cpu")
    assert plan.enabled
    u, v = prune.slot_arrays(g)
    deg = g.degrees().astype(np.int32)
    got = prune.pruned_peel_host(u, v, deg, g.n_edges, eps, plan, mesh=mesh, kernel=kernel)
    jplan = jprune.PrunePlan(**dataclasses.asdict(plan))
    want = jprune.pruned_peel_host(u, v, deg, jg.n_edges, eps, jplan, mesh=jmesh)
    assert _bits(got[0]) == _bits(want[0]) and got[2] == want[2] and got[3] == want[3]
    assert np.array_equal(got[1], want[1]) and got[4] == prune.PrunePlan(
        **dataclasses.asdict(want[4]))
    cold = pbahmani(g, eps=eps, device="cpu")
    assert _bits(got[0]) == _bits(cold[0]) and got[2] == cold[2]
    # a rank count that does not divide the bucket's lanes: no pruned answer
    fake = dataclasses.replace(mesh, shape=(3,), size=3)
    assert prune.pruned_peel_host(u, v, deg, g.n_edges, eps, plan, mesh=fake) is None


@pytest.mark.parametrize("kernel", [False, True], ids=["scatter", "kernel"])
def test_sharded_refine_round_and_certificate(kernel, mesh, jmesh):
    """``refine_resident(mesh=...)`` == JAX's sharded round, round for round:
    the certificate's integers, the mask, the passes and the history."""
    jg = GRAPHS["er"]()
    g = port(jg)
    seed_d, seed_mask, seed_passes = pbahmani_np(g, 0.1)
    half = g.n_directed // 2
    lv = np.concatenate([seed_mask, [False]])
    seed_ne = int((lv[g.src[:half]] & lv[g.dst[:half]]).sum())
    deg = g.degrees().astype(np.int32)
    src, dst = distributed.shard_edges(g, mesh)
    args = (g.n_edges, g.n_nodes, 0.1, seed_ne, int(seed_mask.sum()), seed_mask,
            seed_passes, -1.0, 4)
    got = refine_resident(src, dst, torch.from_numpy(deg), *args, kernel, mesh=mesh)
    jsrc, jdst = jdist.shard_edges(jg, jmesh)
    want = j_refine_resident(jsrc, jdst, deg, *args, mesh=jmesh)
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    assert np.array_equal(got[1], np.asarray(want[1])) and got[2:4] == want[2:4]
    assert [dataclasses.asdict(h) for h in got[4]] == [dataclasses.asdict(h) for h in want[4]]
    single = refine_resident(*to_device(g, "cpu", sorted=kernel), torch.from_numpy(deg),
                             *args, kernel)
    assert dataclasses.asdict(single[0]) == dataclasses.asdict(got[0])


@pytest.mark.parametrize("kernel", [False, True], ids=["scatter", "kernel"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pbahmani_distributed_matches_jax(name, kernel, mesh, jmesh):
    jg = GRAPHS[name]()
    g = port(jg)
    for eps, cap in ((0.0, None), (0.1, None), (0.1, 2)):
        before = collective.collectives
        got = distributed.pbahmani_distributed(g, mesh, eps=eps, max_passes=cap, kernel=kernel)
        assert collective.collectives - before == got[2] + 1  # degrees + one a pass
        want = jdist.pbahmani_distributed(jg, jmesh, eps=eps, max_passes=cap)
        assert _bits(got[0]) == _bits(want[0]) and got[2] == want[2]
        assert np.array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("rounds", [1, 3])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_cbds_distributed_matches_np(name, rounds, mesh, jmesh):
    """``cbds_distributed`` == the numpy oracle == JAX's, coreness too."""
    jg = GRAPHS[name]()
    got = distributed.cbds_distributed(port(jg), mesh, rounds=rounds)
    want = jdist.cbds_distributed(jg, jmesh, rounds=rounds)
    _same_cbds(got, want, name)
    assert np.array_equal(got["coreness"], np.asarray(want["coreness"]))
    ref = j_cbds_np(jg, rounds=rounds)
    assert got["density"] == pytest.approx(ref["density"], rel=1e-5)
    assert got["k_star"] == ref["k_star"]


def test_sharded_cbds_matches_np(mesh):
    """CBDS on a sharded tenant == the oracle (tests/test_shard.py)."""
    rng = np.random.default_rng(11)
    n = 100
    eng = DeltaEngine(n_nodes=n, sharded=True, mesh=mesh)
    edges = None
    for ins, dels, edges in stream_steps(rng, n, 4, 60):
        eng.apply_updates(insert=ins, delete=dels)
    res = eng.cbds()
    ref = j_cbds_np(JGraph.from_edges(np.asarray(sorted(edges)), n_nodes=n))
    assert res["density"] == pytest.approx(ref["density"], rel=1e-5)


def test_one_collective_a_pass(mesh, monkeypatch):
    """Every pass of the sharded tier makes one all-reduce: ``[V + 1]`` for
    one tenant, ``[G, V + 1]`` for a bucket of G, whatever G is."""
    from repro_torch.core import dispatch

    shapes, stages = [], []
    real_sum, real_rows = collective.all_reduce_sum, dispatch._peel_edges_rows_local

    def counted_sum(t, m):
        if m is not None:
            shapes.append(tuple(t.shape))
        return real_sum(t, m)

    monkeypatch.setattr(collective, "all_reduce_sum", counted_sum)
    monkeypatch.setattr(dispatch, "_peel_edges_rows_local",
                        lambda *a: stages.append(1) or real_rows(*a))
    g = port(GRAPHS["er"]())
    _, _, passes = distributed.pbahmani_distributed(g, mesh, eps=0.1)
    assert shapes == [(g.n_nodes,)] + [(g.n_nodes + 1,)] * passes
    reg = GraphRegistry(fused=True, sharded=True, mesh=mesh, pruned=False)
    rng = np.random.default_rng(5)
    for t in "abc":
        reg.register(t, n_nodes=200).apply_updates(insert=rng.integers(0, 200, (300, 2)))
    shapes.clear()
    stages.clear()
    res = query_group(reg.engines())
    assert shapes.count((3, 257)) == len(stages) == max(q.passes for q in res.values())
    assert len(shapes) == len(stages) + 1  # and the warm seeds' edge count


def test_all_reduce_sum_without_a_group(mesh):
    """No mesh: ``t`` back and nothing counted. A mesh of one with no group:
    ``t`` back, one collective counted."""
    t = torch.arange(4, dtype=torch.int32)
    before = collective.collectives
    assert collective.all_reduce_sum(t, None) is t and collective.collectives == before
    assert collective.all_reduce_sum(t, mesh) is t and collective.collectives == before + 1


def test_one_rank_gloo_group(tmp_path):
    """A real gloo group of one rank: ``make_mesh`` takes the default group,
    its collectives run through ``torch.distributed`` and the static peels
    equal the single-device port's."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.group is not None and (mesh.rank, mesh.size) == (0, 1)
        g = port(GRAPHS["planted"]())
        got = distributed.pbahmani_distributed(g, mesh, eps=0.1)
        want = pbahmani(g, eps=0.1, device="cpu")
        assert _bits(got[0]) == _bits(want[0]) and got[2] == want[2]
        assert np.array_equal(got[1], want[1])
        c = distributed.cbds_distributed(g, mesh)
        assert c["k_star"] == j_cbds_np(GRAPHS["planted"]())["k_star"]
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# registry and service opt-in (tests/test_shard.py), partition.py
# ---------------------------------------------------------------------------
def test_registry_and_service_sharded_opt_in():
    reg = GraphRegistry(max_tenants=4, device="cpu")
    a = reg.register("plain", n_nodes=64)
    b = reg.register("sharded", n_nodes=64, sharded=True)
    assert not a.sharded and a.n_shards == 1
    assert b.sharded and b.n_shards >= 1
    st = reg.stats("sharded")
    assert st.sharded and st.n_shards == b.n_shards and st.placement == "sharded"
    # re-registering with a conflicting sharded flag raises, like n_nodes/eps
    assert reg.register("sharded", n_nodes=64, sharded=True) is b
    with pytest.raises(ValueError, match="sharded"):
        reg.register("plain", n_nodes=64, sharded=True)
    with pytest.raises(ValueError, match="sharded"):
        reg.register("sharded", n_nodes=64, sharded=False)

    svc = StreamService(max_tenants=4, device="cpu")
    r = svc.create_tenant("t", n_nodes=64, sharded=True)
    assert r.ok and r.value["n_shards"] >= 1 and r.value["placement"] == "sharded"
    svc.apply_updates("t", insert=np.array([[0, 1], [1, 2], [0, 2]]))
    d = svc.density("t")
    assert d.ok and d.value["density"] == pytest.approx(1.0)
    st = svc.stats("t")
    assert st.ok and st.value.sharded
    f = svc.create_tenant("f", n_nodes=64, sharded=True, fused=True)
    assert f.ok and f.value["placement"] == "fused+sharded"
    # a service-wide default, and the per-tenant override of it
    svc = StreamService(sharded=True, fused=True, device="cpu")
    assert svc.create_tenant("x", n_nodes=32).value["placement"] == "fused+sharded"
    assert svc.create_tenant("y", n_nodes=32, sharded=False).value["placement"] == "fused"


@pytest.mark.parametrize("n_parts", [1, 3, 4])
def test_partition_matches_jax(n_parts):
    for n_items in (0, 7, 100):
        assert np.array_equal(partition.contiguous_bounds(n_items, n_parts),
                              jpartition.contiguous_bounds(n_items, n_parts))
    jg = GRAPHS["er"]()
    got = partition.partition_by_dst_block(port(jg), n_parts)
    want = jpartition.partition_by_dst_block(jg, n_parts)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
