"""The port's host graph layer (a copy of repro.graphs) produces the same
arrays as the JAX package's, and carries a graph onto a device once."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graphs import generators as jgen  # noqa: E402
from repro.graphs import io as jio  # noqa: E402
from repro_torch.graphs import generators as tgen  # noqa: E402
from repro_torch.graphs import io as tio  # noqa: E402
from repro_torch.graphs.convert import graph_from_arrays, to_device  # noqa: E402


def _assert_same_graph(tg, jg):
    assert (tg.n_nodes, tg.n_edges, tg.n_directed) == (jg.n_nodes, jg.n_edges, jg.n_directed)
    for got, want in [(tg.src, jg.src), (tg.dst, jg.dst),
                      (tg.dst_sorted()[0], jg.dst_sorted()[0]),
                      (tg.dst_sorted()[1], jg.dst_sorted()[1])]:
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,args", [
    ("erdos_renyi", (400, 0.03, 7)),       # conftest er_graph
    ("erdos_renyi", (120, 0.06, 3)),
    ("erdos_renyi", (5000, 0.0004, 2)),    # the n > 4096 sampling branch
    ("barabasi_albert", (300, 3, 5)),
    ("rmat", (10, 8, 0)),
    ("rmat", (12, 16, 0)),
])
def test_generators_match_jax(name, args):
    _assert_same_graph(getattr(tgen, name)(*args), getattr(jgen, name)(*args))


def test_planted_dense_matches_jax():
    tg, tmask, trho = tgen.planted_dense(1200, 45, seed=11)  # conftest planted
    jg, jmask, jrho = jgen.planted_dense(1200, 45, seed=11)
    _assert_same_graph(tg, jg)
    np.testing.assert_array_equal(tmask, jmask)
    assert trho == jrho


@pytest.mark.parametrize("name", ["triangle_plus_path", "k4_plus_star",
                                  "two_cliques", "petersen"])
def test_small_named_match_jax(name):
    _assert_same_graph(tgen.small_named(name), jgen.small_named(name))


@pytest.mark.parametrize("n,m,lo", [(12, 300, 0), (300, 4000, 0), (2**20, 50_000, 0),
                                    (40, 500, 7), (3, 50, 0)])
def test_from_edges_dedup_matches_jax(n, m, lo):
    """``Graph.from_edges`` dedups on int64 keys; its arrays stay the JAX
    package's on pairs with duplicates, both orientations of one edge and
    self-loops (a few vertices and many pairs make all three common), and
    when the smallest id is not 0."""
    from repro.graphs.graph import Graph as JGraph
    from repro_torch.graphs.graph import Graph

    rng = np.random.default_rng(n + m)
    pairs = rng.integers(lo, lo + n, (m, 2))
    pairs = np.r_[pairs, pairs[:m // 4, ::-1], np.repeat(pairs[:3, :1], 2, axis=1)]
    for n_nodes in (None, lo + n + 2):
        tg, jg = Graph.from_edges(pairs, n_nodes), JGraph.from_edges(pairs, n_nodes)
        _assert_same_graph(tg, jg)
        assert tg.n_edges < len(pairs)


@pytest.mark.parametrize("pair", [(-1, 5), (3, 2**31 - 1), (0, 2**40)])
def test_from_edges_refuses_ids_outside_int32(pair):
    """src, dst and the sentinel ``n_nodes`` are int32: an id that would
    wrap is refused, not stored."""
    from repro_torch.graphs.graph import Graph

    with pytest.raises(ValueError, match="vertex ids"):
        Graph.from_edges(np.array([pair, (1, 2)]))


def test_small_named_rejects_unknown():
    with pytest.raises(ValueError):
        tgen.small_named("k7")


def test_graph_from_arrays_round_trip(planted):
    jg = planted[0]
    tg = graph_from_arrays(jg.n_nodes, jg.n_edges, jg.src, jg.dst, jg.n_directed)
    _assert_same_graph(tg, jg)
    np.testing.assert_array_equal(tg.degrees(), jg.degrees())
    assert tg.density() == jg.density()
    ip_t, ix_t = tg.to_csr()
    ip_j, ix_j = jg.to_csr()
    np.testing.assert_array_equal(ip_t, ip_j)
    np.testing.assert_array_equal(ix_t, ix_j)
    mask = np.arange(jg.n_nodes) < 45
    assert tg.subgraph_density(mask) == jg.subgraph_density(mask)
    _assert_same_graph(tg.induced_subgraph(mask), jg.induced_subgraph(mask))


def test_snap_edgelist_round_trip(tmp_path, er_graph):
    """save_edgelist then load_snap_edgelist gives back the graph (ids are
    dense already), and the two packages load the same file alike."""
    path = str(tmp_path / "g.txt")
    tg = tgen.erdos_renyi(400, 0.03, seed=7)
    tio.save_edgelist(tg, path)
    back = tio.load_snap_edgelist(path)
    _assert_same_graph(back, jio.load_snap_edgelist(path))
    _assert_same_graph(back, er_graph)
    # sparse SNAP ids and comments densify identically
    snap = tmp_path / "snap.txt"
    snap.write_text("# comment\n10 20\n20 30\n\n30 10\n10 99\n")
    _assert_same_graph(tio.load_snap_edgelist(str(snap)),
                       jio.load_snap_edgelist(str(snap)))


def test_to_device_uploads_once_per_layout():
    g = tgen.rmat(8, 8, seed=1)
    src, dst = to_device(g, "cpu")
    assert src.dtype == torch.int32 and dst.dtype == torch.int32
    np.testing.assert_array_equal(src.numpy(), g.src)
    src_s, dst_s = to_device(g, "cpu", sorted=True)
    np.testing.assert_array_equal(dst_s.numpy(), g.dst_sorted()[1])
    assert bool((dst_s[1:] >= dst_s[:-1]).all())
    assert to_device(g, "cpu")[0] is src
    assert to_device(g, torch.device("cpu"), sorted=True)[1] is dst_s
