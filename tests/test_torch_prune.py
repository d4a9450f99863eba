"""The port's candidate-pruned peel (core/prune.py) against the JAX package,
bit for bit, on the CPU: plan fields, pass-0 simulation, host compaction,
and the (density, mask, passes) triple, with the kernels on (the plain
versions of K1 and K4, on dst-sorted lanes, whose order the CPU path of K1
checks) and off (the scatter tier). The cases are those of
tests/test_prune.py: adversarial structure, forced tiny buckets (a JAX-built
plan drives the port's bucket peel), random graphs and a planted block; and
a small RMAT graph whose pass-0 survivors overflow the bucket, so both
packages fall back to the unpruned peel.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.core import prune as jprune  # noqa: E402
from repro.graphs.generators import erdos_renyi, planted_dense, rmat  # noqa: E402
from repro.graphs.graph import Graph as JGraph  # noqa: E402
from repro.graphs.generators import small_named  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import prune as tprune  # noqa: E402
from repro_torch.graphs.convert import graph_from_arrays, prune_plan_from_fields  # noqa: E402


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


def assert_same_triple(got, want):
    assert _bits(got[0]) == _bits(want[0])
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])


def port_plan(plan):
    return prune_plan_from_fields(**dataclasses.asdict(plan))


def check_pruned(g, eps, plan=None):
    """Port pruned (kernel on and off) == JAX pruned == port unpruned
    (JAX's pruned == unpruned is tests/test_prune.py's claim)."""
    want = jprune.pbahmani_pruned(g, eps=eps, plan=plan, kernel=False)
    tg = port(g)
    assert_same_triple(tcore.pbahmani(tg, eps=eps, kernel=False, device="cpu"), want)
    for kernel in (False, True):
        got = tprune.pbahmani_pruned(tg, eps=eps, plan=None if plan is None else port_plan(plan),
                                     kernel=kernel, device="cpu")
        assert_same_triple(got, want)


def _adversarial_graphs():
    k5a = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    k5b = [(5 + i, 5 + j) for i in range(5) for j in range(i + 1, 5)]
    k4 = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    cases = {
        "disjoint_equal_k5": JGraph.from_edges(np.array(k5a + k5b)),
        "star": JGraph.from_edges(np.array([[0, i] for i in range(1, 12)])),
        "empty": JGraph.from_edges(np.zeros((0, 2), np.int64), n_nodes=0),
        "edgeless": JGraph.from_edges(np.zeros((0, 2), np.int64), n_nodes=9),
        "single_edge": JGraph.from_edges(np.array([[0, 1]]), n_nodes=6),
        "core_boundary_lollipop": JGraph.from_edges(np.array(
            k4 + [(3, 4), (4, 5), (5, 6), (6, 3)])),
    }
    for name in ["triangle_plus_path", "k4_plus_star", "two_cliques", "petersen"]:
        cases[name] = small_named(name)
    return cases


@pytest.mark.parametrize("name,graph", sorted(_adversarial_graphs().items()))
@pytest.mark.parametrize("eps", [0.0, 0.25])
def test_pruned_parity_adversarial(name, graph, eps):
    check_pruned(graph, eps)


@pytest.mark.parametrize("eps", [0.0, 0.25])
def test_pruned_parity_forced_tiny_buckets(eps):
    """A JAX-built plan with the smallest buckets drives the port: the
    ladder fires mid-trajectory and the in-flight regrow path runs."""
    g = erdos_renyi(150, 0.08, seed=3)
    tiny = jprune.build_plan(1.0, 1, g.n_nodes, g.n_edges, g.n_nodes,
                             g.src.shape[0], observed=(32, 128))
    assert tiny.bucket_v == jprune.MIN_BUCKET_V and tiny.bucket_e == jprune.MIN_BUCKET_E
    assert port_plan(tiny) == tprune.build_plan(
        1.0, 1, g.n_nodes, g.n_edges, g.n_nodes, g.src.shape[0], observed=(32, 128))
    check_pruned(g, eps, plan=tiny)


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234, 9999])
def test_pruned_parity_random(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 140))
    g = erdos_renyi(n, float(rng.uniform(0.02, 0.35)), seed=seed)
    check_pruned(g, [0.0, 0.1, 0.5][seed % 3])


def test_pruned_parity_planted_and_jax_kernel_tier():
    """The planted block at eps 0 and 0.1; JAX's own kernel tier (Pallas in
    interpret mode) gives the same triple too."""
    g, _, _ = planted_dense(600, 30, seed=5)
    check_pruned(g, 0.0)
    check_pruned(g, 0.1)
    assert_same_triple(tprune.pbahmani_pruned(port(g), eps=0.1, kernel=True, device="cpu"),
                       jprune.pbahmani_pruned(g, eps=0.1, kernel=True))


@pytest.mark.parametrize("which", ["er", "planted", "two_cliques", "rmat"])
def test_plan_for_graph_matches_jax(which, er_graph, planted):
    g = {"er": er_graph, "planted": planted[0], "two_cliques": small_named("two_cliques"),
         "rmat": rmat(10, 16, seed=0)}[which]
    prev = np.random.default_rng(1).random(g.n_nodes) < 0.2
    for kw in ({}, {"prev_mask": prev, "observed": (100, 900)}):
        want = dataclasses.asdict(jprune.plan_for_graph(g, **kw))
        for kernel in (False, True):
            got = dataclasses.asdict(tprune.plan_for_graph(port(g), kernel=kernel,
                                                           device="cpu", **kw))
            assert got == want
            assert _bits(got["rho_lb"]) == _bits(want["rho_lb"])


def test_plan_helpers_match_jax():
    for args, kw in [((3.2, 4, 100, 400, 4096, 131072), {}),
                     ((3.2, 4, 100, 400, 4096, 131072), {"observed": (3000, 40000)}),
                     ((0.0, 1, 0, 0, 8, 256), {})]:
        want = jprune.build_plan(*args, **kw)
        assert dataclasses.asdict(tprune.build_plan(*args, **kw)) == dataclasses.asdict(want)
        for n_v1, lanes1 in [(10, 40), (2000, 30000), (1, 1)]:
            j = jprune.maybe_shrink_plan(dataclasses.replace(want, from_observed=True),
                                         n_v1, lanes1)
            t = tprune.maybe_shrink_plan(port_plan(dataclasses.replace(
                want, from_observed=True)), n_v1, lanes1)
            assert (t is None) == (j is None)
            assert t is None or dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("eps", [0.0, 0.1, 0.5])
def test_pass0_and_compaction_match_jax(planted, eps):
    g = planted[0]
    deg = g.degrees().astype(np.int32)
    for got, want in zip(tprune._pass0_host(deg, g.n_edges, eps),
                         jprune._pass0_host(deg, g.n_edges, eps)):
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype
    u, v = tprune.slot_arrays(port(g))
    live = tprune._pass0_host(deg, g.n_edges, eps)[1]
    got = tprune.compact_candidates(u, v, live, 2048, 1 << 15)
    want = jprune.compact_candidates(u, v, live, 2048, 1 << 15)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (np.diff(got[2]) >= 0).all()  # the bucket is emitted dst-sorted


def test_compact_candidates_remap_matches_jax():
    u = np.array([0, 1, 0, 2, 5], dtype=np.int64)   # 5 == sentinel (hole)
    v = np.array([1, 2, 2, 3, 5], dtype=np.int64)
    live = np.array([True, True, True, False, False])
    for a, b in zip(tprune.compact_candidates(u, v, live, 4, 16),
                    jprune.compact_candidates(u, v, live, 4, 16)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_rmat_overflow_falls_back_like_jax(monkeypatch, eps):
    """rmat(11, 21): the pass-0 survivors' lanes exceed the largest bucket
    (half the padded lane width), so both packages return None from the
    host half and run the unpruned peel; the triples agree."""
    g = rmat(11, 21, seed=0)
    tg = port(g)
    u, v = tprune.slot_arrays(tg)
    deg = g.degrees().astype(np.int32)
    plan = tprune.plan_for_graph(tg, device="cpu")
    assert tprune.prepare_pruned_peel(u, v, deg, g.n_edges, eps, plan) is None
    assert jprune.prepare_pruned_peel(u, v, deg, g.n_edges, eps,
                                      jprune.plan_for_graph(g)) is None
    calls = []
    monkeypatch.setattr(tprune, "_bucket_peel", lambda *a, **k: calls.append(a))
    check_pruned(g, eps)
    assert calls == []  # the bucket peel never ran


def test_ladder_runs_k4_twice_even_when_nothing_is_left(monkeypatch, planted):
    """Kernel mode: one bucket peel makes exactly two K4 calls (edge repack
    and degree pull) whether or not the live set is empty by then, as the
    JAX package's traced program does, after the resident prep's one edge
    call; all equal the scatter tier."""
    calls = []
    real = tprune.stream_compact

    def counting(values, live, **kw):
        calls.append(int(live.sum()))
        return real(values, live, **kw)

    monkeypatch.setattr(tprune, "stream_compact", counting)
    g = port(planted[0])
    for eps in (0.0, 0.1, 0.5):
        calls.clear()
        on = tprune.pbahmani_pruned(g, eps=eps, kernel=True, device="cpu")
        assert len(calls) == 3  # the prep's edge call, then the ladder's two
        off = tprune.pbahmani_pruned(g, eps=eps, kernel=False, device="cpu")
        assert len(calls) == 3
        assert_same_triple(on, off)


def test_pbahmani_pruned_entry_matches_jax(er_graph):
    for eps in (0.0, 0.1):
        want = jcore.pbahmani(er_graph, eps=eps, pruned=True)
        for kernel in (False, True):
            got = tcore.pbahmani(port(er_graph), eps=eps, pruned=True, kernel=kernel,
                                 device="cpu")
            assert_same_triple(got, want)
