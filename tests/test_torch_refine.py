"""The port's refinement (refine/) against the JAX package, bit for bit, on
the CPU: each round's loads and best state, the per-round history, and the
exact-rational certificate, with K1 on (its plain version on dst-sorted
lanes) and off; and ``pbahmani(pruned=..., refine_rounds=...)``. The cases
follow tests/test_refine.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.graphs.generators import erdos_renyi, planted_dense  # noqa: E402
from repro.graphs.graph import Graph as JGraph  # noqa: E402
from repro.refine import certify as jcertify  # noqa: E402
from repro.refine import engine as jengine  # noqa: E402
from repro.refine.loads import _refine_round_jit  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.graphs.convert import graph_from_arrays  # noqa: E402
from repro_torch.refine import certify as tcertify  # noqa: E402
from repro_torch.refine import engine as tengine  # noqa: E402
from repro_torch.refine.loads import _refine_round, refine_threshold  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port(g):
    return graph_from_arrays(g.n_nodes, g.n_edges, g.src, g.dst, g.n_directed)


def _bits(x):
    return np.float32(x).view(np.int32)


def assert_same_result(got, want):
    """Every field of two RefineResults, the float32-derived ones by bits."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "mask":
            np.testing.assert_array_equal(a, b)
        elif f.name == "certificate":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        elif f.name == "history":
            assert [dataclasses.asdict(r) for r in a] == [dataclasses.asdict(r) for r in b]
        else:
            assert a == b, (f.name, a, b)


def test_refine_threshold_bits_match_numpy_oracle():
    rng = np.random.default_rng(0)
    load_sum = rng.integers(0, 1 << 24, 5000).astype(np.int32)
    n_e = rng.integers(0, 1 << 22, 5000).astype(np.int32)
    n_v = rng.integers(0, 1 << 20, 5000).astype(np.int32)
    for eps in (0.0, 0.1, 0.5, 1 / 3):
        got = refine_threshold(*(torch.from_numpy(a) for a in (load_sum, n_e, n_v)), eps)
        want = np.float32(1.0 + eps) * ((load_sum + 2 * n_e).astype(np.float32)
                                        / np.maximum(n_v, 1).astype(np.float32))
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_rounds_match_jax_and_numpy_oracle(planted, eps):
    """Four rounds chained on the same state: loads, best (density bits, ne,
    nv, mask) and passes equal JAX's round and ``refine_round_np``."""
    g = planted[0]
    n = g.n_nodes
    deg = g.degrees().astype(np.int32)
    j_loads = np.zeros(n, np.int32)
    j_best = (np.float32(0.0), 0, 0, np.zeros(n, bool))
    j_passes = 0
    t_state = {k: None for k in (False, True)}
    for _ in range(4):
        out = _refine_round_jit(
            jnp.asarray(g.src), jnp.asarray(g.dst), jnp.asarray(deg),
            jnp.asarray(g.n_edges, jnp.int32), jnp.asarray(j_loads),
            jnp.asarray(j_best[0], jnp.float32), jnp.asarray(j_best[1], jnp.int32),
            jnp.asarray(j_best[2], jnp.int32), jnp.asarray(j_best[3]),
            jnp.asarray(j_passes, jnp.int32), n, eps)
        np_loads, np_best, np_passes = tcertify.refine_round_np(
            g.src, g.dst, deg, g.n_edges, j_loads, j_best, eps)
        j_loads = np.asarray(out[0])
        j_best = (np.asarray(out[1]), int(out[2]), int(out[3]), np.asarray(out[4]))
        np.testing.assert_array_equal(np_loads, j_loads)
        assert _bits(np_best[0]) == _bits(j_best[0]) and np_best[1:3] == j_best[1:3]
        assert np_passes == int(out[5]) - j_passes
        j_passes = int(out[5])
        for kernel in (False, True):
            src, dst = g.dst_sorted() if kernel else (g.src, g.dst)
            prev = t_state[kernel] or (
                torch.zeros(n, dtype=torch.int32), torch.tensor(0.0),
                torch.tensor(0, dtype=torch.int32), torch.tensor(0, dtype=torch.int32),
                torch.zeros(n, dtype=torch.bool), torch.tensor(0, dtype=torch.int32))
            res = _refine_round(torch.from_numpy(src), torch.from_numpy(dst),
                                torch.from_numpy(deg), torch.tensor(g.n_edges), *prev,
                                n, eps, kernel)
            t_state[kernel] = res
            assert res[0].dtype == torch.int32
            np.testing.assert_array_equal(res[0].numpy(), j_loads)
            assert _bits(res[1].item()) == _bits(j_best[0])
            assert (res[2].item(), res[3].item(), res[5].item()) == (
                j_best[1], j_best[2], j_passes)
            np.testing.assert_array_equal(res[4].numpy(), j_best[3])


@pytest.mark.parametrize("case", ["er", "planted120", "random0", "random1", "triangle",
                                  "empty", "edgeless"])
@pytest.mark.parametrize("mode", [{"target_gap": -1.0, "max_rounds": 5},
                                  {"target_gap": 0.02, "max_rounds": 60}])
def test_refine_matches_jax(case, mode, er_graph):
    g = {
        "er": er_graph,
        "planted120": planted_dense(120, 15, seed=3)[0],
        "random0": erdos_renyi(48, 0.15, seed=0),
        "random1": erdos_renyi(7, 0.5, seed=1),
        "triangle": JGraph.from_edges(np.array([[0, 1], [1, 2], [0, 2]])),
        "empty": JGraph.from_edges(np.zeros((0, 2)), n_nodes=0),
        "edgeless": JGraph.from_edges(np.zeros((0, 2)), n_nodes=5),
    }[case]
    want = jengine.refine(g, kernel=False, **mode)
    for kernel in (False, True):
        assert_same_result(tengine.refine(port(g), kernel=kernel, device="cpu", **mode), want)


def test_refine_seeds_match_jax():
    """A custom weak seed (eps 0.5) and the pruned seed path."""
    g = erdos_renyi(80, 0.12, seed=11)
    tg = port(g)
    seed = jcore.pbahmani(g, eps=0.5)
    want = jengine.refine(g, target_gap=0.05, max_rounds=50, eps=0.5, seed=seed)
    got = tengine.refine(tg, target_gap=0.05, max_rounds=50, eps=0.5, seed=seed,
                         kernel=True, device="cpu")
    assert_same_result(got, want)
    want = jengine.refine(g, target_gap=-1.0, max_rounds=3, eps=0.1, pruned=True)
    for kernel in (False, True):
        got = tengine.refine(tg, target_gap=-1.0, max_rounds=3, eps=0.1, pruned=True,
                             kernel=kernel, device="cpu")
        assert_same_result(got, want)
    tcertify.oracle_check(tg, got.certificate)


@pytest.mark.parametrize("pruned", [False, True])
def test_pbahmani_refine_rounds_matches_jax(planted, pruned):
    g = planted[0]
    for eps in (0.0, 0.1):
        want = jcore.pbahmani(g, eps=eps, pruned=pruned, refine_rounds=2)
        for kernel in (False, True):
            got = tcore.pbahmani(port(g), eps=eps, pruned=pruned, refine_rounds=2,
                                 kernel=kernel, device="cpu")
            assert _bits(got[0]) == _bits(want[0]) and got[2] == want[2]
            np.testing.assert_array_equal(got[1], want[1])


def test_certify_copy_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(20):
        loads = rng.integers(0, 50, int(rng.integers(1, 30)))
        t = int(rng.integers(1, 6))
        assert tcertify.dual_fraction(loads, t) == jcertify.dual_fraction(loads, t)
        args = [int(x) for x in rng.integers(0, 40, 4)]
        assert (dataclasses.asdict(tcertify.make_certificate(*args))
                == dataclasses.asdict(jcertify.make_certificate(*args)))
        a, b = tuple(rng.integers(0, 9, 2)), tuple(rng.integers(0, 9, 2))
        assert tcertify.max_fraction(a, b) == jcertify.max_fraction(a, b)
