"""The pruned query's resident prep (core/prune.py:prepare_pruned_peel_resident:
pass 0 and the compaction on the device) against the port's host prep and
the JAX package's ``prepare_pruned_peel``, field for field, on the CPU with
the kernels on (the plain versions of K1-K4) and off: every integer, the
bits of ``best_d1``, the masks, ``perm`` where ``a1`` holds, the plan and
the bucket arrays lane for lane. Then the whole resident query against the
JAX triple, the device merge against the host merge, and a run that shows
``pbahmani_pruned`` no longer reaches the host half.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import prune as jprune  # noqa: E402
from repro.graphs.generators import (  # noqa: E402
    barabasi_albert, erdos_renyi, planted_dense, rmat, small_named,
)
from repro.graphs.graph import Graph as JGraph  # noqa: E402
from repro_torch.core import prune as tprune  # noqa: E402
from repro_torch.graphs.convert import (  # noqa: E402
    graph_from_arrays, prune_plan_from_fields, to_device,
)
from repro_torch.graphs.graph import Graph as TGraph  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small graphs: torch's intra-op threads cost more than they save and
    oversubscribe the parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port(g):
    return graph_from_arrays(g.n_nodes, g.n_edges, g.src, g.dst, g.n_directed)


def _bits(x):
    return np.float32(x).view(np.int32)


def _plans(g, kind):
    """(port plan, JAX plan) for graph ``g``: the graph's own plan, or one
    forced to make the prep regrow, shrink or use the smallest buckets."""
    lanes = g.src.shape[0]
    if kind == "own":
        plan = jprune.plan_for_graph(g)
    elif kind == "tiny":    # the smallest buckets: the handoff regrows them
        plan = jprune.build_plan(1.0, 1, g.n_nodes, g.n_edges, g.n_nodes, lanes,
                                 observed=(32, 128))
    elif kind == "shrink":  # sized from a large handoff: a small one shrinks it
        plan = jprune.build_plan(1.0, 1, g.n_nodes, g.n_edges, g.n_nodes, lanes,
                                 observed=(g.n_nodes, lanes))
    elif kind == "no_basis":  # no sizing basis: a regrow takes the graph's own
        plan = dataclasses.replace(
            jprune.build_plan(1.0, 1, g.n_nodes, g.n_edges, g.n_nodes, lanes,
                              observed=(32, 128)), node_width=0, lane_width=0)
    return prune_plan_from_fields(**dataclasses.asdict(plan)), plan


def _preps(g, eps, kind):
    """(JAX host prep, port host prep, port resident preps kernel off/on)."""
    tg = port(g)
    tplan, jplan = _plans(g, kind)
    u, v = tprune.slot_arrays(tg)
    deg = tg.degrees().astype(np.int32)
    want = jprune.prepare_pruned_peel(u, v, deg, g.n_edges, eps, jplan)
    host = tprune.prepare_pruned_peel(u, v, deg, g.n_edges, eps, tplan)
    src, dst = to_device(tg, "cpu", sorted=True)
    resident = [tprune.prepare_pruned_peel_resident(src, dst, g.n_nodes, g.n_edges, eps,
                                                    tplan, kernel)
                for kernel in (False, True)]
    return want, host, resident


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_prep(got, want):
    """Every field of two preps equal: the dispatch, the finished result of
    an edgeless graph, or None."""
    if want is None or isinstance(want, tuple):
        if want is None:
            assert got is None
            return
        assert isinstance(got, tuple) and len(got) == len(want)
        assert _bits(got[0]) == _bits(want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:4] == want[2:4]
        assert dataclasses.asdict(got[4]) == dataclasses.asdict(want[4])
        return
    assert (got.n_v1, got.n_e1, got.better1, got.observed, got.eps) == (
        want.n_v1, want.n_e1, want.better1, tuple(want.observed), want.eps)
    assert isinstance(got.best_d1, np.float32)
    assert _bits(got.best_d1) == _bits(want.best_d1)
    assert dataclasses.asdict(got.plan) == dataclasses.asdict(want.plan)
    a1 = _np(got.a1)
    np.testing.assert_array_equal(a1, want.a1)
    np.testing.assert_array_equal(_np(got.active0), want.active0)
    np.testing.assert_array_equal(_np(got.perm)[a1], np.asarray(want.perm)[want.a1])
    for name in ("b_src", "b_dst"):
        lanes = _np(getattr(got, name))
        assert lanes.dtype == np.int32 and lanes.shape == (got.plan.bucket_e,)
        np.testing.assert_array_equal(lanes, getattr(want, name))
    assert (np.diff(_np(got.b_dst)) >= 0).all()  # dst-sorted: K2's precondition


def check_prep(g, eps, kind="own"):
    want, host, resident = _preps(g, eps, kind)
    assert_same_prep(host, want)
    for got in resident:
        assert_same_prep(got, want)
    return want


def assert_same_triple(got, want):
    assert _bits(got[0]) == _bits(want[0])
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])


def check_query(g, eps, kind="own"):
    """The resident query (pbahmani_pruned, kernels off and on) == JAX's."""
    tplan, jplan = _plans(g, kind)
    want = jprune.pbahmani_pruned(g, eps=eps, plan=jplan, kernel=False)
    for kernel in (False, True):
        assert_same_triple(tprune.pbahmani_pruned(port(g), eps=eps, plan=tplan,
                                                  kernel=kernel, device="cpu"), want)


def _cycle(n):
    return JGraph.from_edges(np.array([(i, (i + 1) % n) for i in range(n)]))


def _graphs():
    k4 = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    k5 = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    cases = {
        "star": JGraph.from_edges(np.array([[0, i] for i in range(1, 12)])),
        "single_edge": JGraph.from_edges(np.array([[0, 1]]), n_nodes=6),
        "lollipop": JGraph.from_edges(np.array(k4 + [(3, 4), (4, 5), (5, 6), (6, 3)])),
        "disjoint_k5": JGraph.from_edges(np.array(k5 + [(5 + a, 5 + b) for a, b in k5])),
        "cycle_all_fail": _cycle(40),          # every vertex fails pass 0: n_v1 == 0
        "er": erdos_renyi(150, 0.08, seed=3),
        "ba": barabasi_albert(300, 4, seed=2),
        "rmat": rmat(9, 8, seed=4),
        "planted": planted_dense(600, 30, seed=5)[0],
    }
    for name in ("triangle_plus_path", "k4_plus_star", "two_cliques", "petersen"):
        cases[name] = small_named(name)
    return cases


GRAPHS = _graphs()


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_resident_prep_matches_host_and_jax(name, eps):
    want = check_prep(GRAPHS[name], eps)
    if name == "cycle_all_fail":  # the host emits an empty bucket; so does the card
        assert want.n_v1 == 0 and (want.b_dst == want.plan.bucket_v).all()


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_resident_prep_random(seed):
    rng = np.random.default_rng(seed)
    g = erdos_renyi(int(rng.integers(8, 200)), float(rng.uniform(0.02, 0.35)), seed=seed)
    check_prep(g, [0.0, 0.1, 0.5][seed % 3])


@pytest.mark.parametrize("kind,eps,change", [
    ("tiny", 0.0, "regrow"), ("no_basis", 0.0, "regrow"), ("shrink", 0.25, "shrink"),
    ("tiny", 0.25, "none"), ("shrink", 0.0, "none"),
])
def test_resident_prep_resized_plans(kind, eps, change):
    """A regrow from the smallest buckets (with and without the plan's own
    sizing basis), a shrink of an observed plan far too large for the
    handoff, and both plans where the handoff leaves them as they are."""
    g = GRAPHS["er"]
    want = check_prep(g, eps, kind)
    assert isinstance(want, jprune.PrunedDispatch)
    before = _plans(g, kind)[0].bucket_e
    assert {"regrow": want.plan.bucket_e > before, "shrink": want.plan.bucket_e < before,
            "none": want.plan.bucket_e == before}[change]


def test_resident_prep_edgeless_and_overflow():
    """n_v0 == 0 gives the finished result; a handoff no bucket holds gives
    None, in all three preps."""
    g = JGraph.from_edges(np.zeros((0, 2), np.int64), n_nodes=9)
    plan = jprune.build_plan(1.0, 1, 9, 0, 9, 256, observed=(32, 128))
    u, v = tprune.slot_arrays(port(g))
    deg = np.zeros(9, np.int32)
    want = jprune.prepare_pruned_peel(u, v, deg, 0, 0.0, plan)
    assert isinstance(want, tuple) and want[2] == 0
    tplan = prune_plan_from_fields(**dataclasses.asdict(plan))
    src, dst = to_device(port(g), "cpu", sorted=True)
    for kernel in (False, True):
        assert_same_prep(tprune.prepare_pruned_peel_resident(src, dst, 9, 0, 0.0, tplan,
                                                             kernel), want)
    assert_same_prep(tprune.prepare_pruned_peel(u, v, deg, 0, 0.0, tplan), want)
    g = rmat(11, 21, seed=0)  # pass 0 leaves more lanes than the largest bucket
    for eps in (0.0, 0.1):
        want, host, resident = _preps(g, eps, "own")
        assert want is None and host is None and resident == [None, None]


@pytest.mark.parametrize("name", ["cycle_all_fail", "ba", "rmat", "star", "petersen"])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_resident_query_matches_jax(name, eps):
    check_query(GRAPHS[name], eps)


@pytest.mark.parametrize("kind,eps", [("tiny", 0.0), ("no_basis", 0.0), ("shrink", 0.25)])
def test_resident_query_resized_plans_match_jax(kind, eps):
    check_query(GRAPHS["er"], eps, kind)


def test_device_merge_matches_host_merge():
    """Both merge branches, with the strict ``>``: a bucket density above
    best_d1 takes the mapped bucket mask, one equal to it keeps a1/active0."""
    g = GRAPHS["planted"]
    tg = port(g)
    tplan, _ = _plans(g, "own")
    u, v = tprune.slot_arrays(tg)
    host = tprune.prepare_pruned_peel(u, v, tg.degrees(), g.n_edges, 0.0, tplan)
    src, dst = to_device(tg, "cpu", sorted=True)
    res = tprune.prepare_pruned_peel_resident(src, dst, g.n_nodes, g.n_edges, 0.0, tplan)
    mask_b = np.random.default_rng(0).random(host.plan.bucket_v) < 0.5
    for d in (np.nextafter(host.best_d1, np.float32(np.inf)), host.best_d1):
        want = tprune.merge_pruned_peel(host, d, mask_b, 9)
        got = tprune.merge_pruned_peel_resident(
            res, torch.tensor(d, dtype=torch.float32), torch.from_numpy(mask_b),
            torch.tensor(9, dtype=torch.int32))
        assert _bits(got[0]) == _bits(want[0]) and got[2:] == want[2:]
        np.testing.assert_array_equal(got[1], want[1])


def test_pbahmani_pruned_skips_the_host_half(monkeypatch):
    """The resident query reads no host slots or degrees, simulates no pass
    0 on the host, sorts nothing and uploads no bucket."""
    g = GRAPHS["planted"]
    tg = port(g)
    for sorted_ in (False, True):  # the graph's cached uploads, made before
        to_device(tg, "cpu", sorted=sorted_)
    want = jprune.pbahmani_pruned(g, eps=0.1, kernel=False)

    def forbidden(name):
        def fail(*a, **k):
            raise AssertionError(f"the resident query called {name}")
        return fail

    for name in ("_emit_buckets", "_induced_slots", "_pass0_host", "slot_arrays",
                 "upload_buckets", "compact_candidates", "prepare_pruned_peel",
                 "merge_pruned_peel"):
        monkeypatch.setattr(tprune, name, forbidden(name))
    monkeypatch.setattr(TGraph, "degrees", forbidden("Graph.degrees"))
    monkeypatch.setattr(np, "argsort", forbidden("np.argsort"))
    for kernel in (False, True):
        got = tprune.pbahmani_pruned(tg, eps=0.1, kernel=kernel, device="cpu")
        assert_same_triple(got, want)
