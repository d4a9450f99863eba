"""The port's copies of the paper's baselines, Charikar's serial greedy and
the exact Goldberg-flow solver, against the JAX package's on the
``small_named`` graphs, the conftest graphs and the <= 8-vertex graphs of
tests/test_oracle_properties.py (where brute force is the oracle). Both are
host numpy, so every output is compared exactly."""
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core  # noqa: E402,F401
import repro_torch.core  # noqa: E402,F401
from repro.graphs.generators import erdos_renyi, small_named  # noqa: E402
from repro_torch.graphs.convert import graph_from_arrays  # noqa: E402

# the packages export functions of the same names as these modules
jcharikar, jexact = sys.modules["repro.core.charikar"], sys.modules["repro.core.exact"]
tcharikar, texact = (sys.modules["repro_torch.core.charikar"],
                     sys.modules["repro_torch.core.exact"])

NAMED = ["triangle_plus_path", "k4_plus_star", "two_cliques", "petersen"]


def port(g):
    return graph_from_arrays(g.n_nodes, g.n_edges, g.src, g.dst, g.n_directed)


def _brute_force_densest(g) -> float:
    half = g.n_directed // 2
    s, d = g.src[:half].astype(np.int64), g.dst[:half].astype(np.int64)
    best = 0.0
    for bits in range(1, 1 << g.n_nodes):
        mask = (bits >> np.arange(g.n_nodes)) & 1 == 1
        best = max(best, int((mask[s] & mask[d]).sum()) / int(mask.sum()))
    return best


def assert_same_baselines(g):
    tg = port(g)
    got, want = tcharikar.charikar(tg), jcharikar.charikar(g)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(tcharikar.degeneracy_order(tg),
                                  jcharikar.degeneracy_order(g))
    got, want = texact.exact_densest(tg), jexact.exact_densest(g)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    return got


@pytest.mark.parametrize("name", NAMED)
def test_baselines_match_jax_named(name):
    assert_same_baselines(small_named(name))


def test_charikar_matches_jax_conftest_graphs(er_graph, planted):
    """Charikar only: the flow solver takes seconds at these sizes."""
    for g in (er_graph, planted[0]):
        got, want = tcharikar.charikar(port(g)), jcharikar.charikar(g)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", range(10))
def test_baselines_match_jax_and_brute_force_small(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))  # <= 8 vertices: at most 255 subsets
    g = erdos_renyi(n, float(rng.uniform(0.2, 0.9)), seed=seed)
    rho_star, mask = assert_same_baselines(g)
    rho_brute = _brute_force_densest(g)
    assert rho_star == pytest.approx(rho_brute, abs=1e-9)
    if g.n_edges:
        assert port(g).subgraph_density(mask) == pytest.approx(rho_brute, abs=1e-9)
        assert tcharikar.charikar(port(g))[0] >= rho_brute / 2 - 1e-9
