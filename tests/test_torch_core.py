"""The port's P-Bahmani, k-core and CBDS-P against the JAX package, bit for
bit, on the CPU: kernel on (the plain version of K1 on dst-sorted lanes) and
kernel off (the scatter tier) both equal JAX with ``kernel=False`` and
``kernel=True`` (Pallas in interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.core import density as jdensity  # noqa: E402
from repro.core import dispatch as jdispatch  # noqa: E402
from repro.graphs.generators import rmat as jrmat  # noqa: E402
from repro.graphs.generators import small_named  # noqa: E402
from repro.graphs.graph import Graph as JGraph  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import density as tdensity  # noqa: E402
from repro_torch.core import dispatch as tdispatch  # noqa: E402
from repro_torch.graphs.convert import graph_from_arrays  # noqa: E402

NAMED = ["triangle_plus_path", "k4_plus_star", "two_cliques", "petersen"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These graphs are small: torch's intra-op threads cost more than they
    save on them, and oversubscribe the parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port(g):
    """The JAX package's graph as the port's (the tests build each graph once)."""
    return graph_from_arrays(g.n_nodes, g.n_edges, g.src, g.dst, g.n_directed)


def _bits(x):
    return np.float32(x).view(np.int32)


def assert_same_triple(got, want):
    assert _bits(got[0]) == _bits(want[0])
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture(params=["er", "planted"] + NAMED)
def any_graph(request, er_graph, planted):
    return {"er": er_graph, "planted": planted[0]}.get(request.param) \
        or small_named(request.param)


def test_peel_threshold_bits_match_jax():
    rng = np.random.default_rng(0)
    n_e = rng.integers(0, 1 << 24, 20_000).astype(np.int32)
    n_v = rng.integers(0, 1 << 22, 20_000).astype(np.int32)
    n_v[:50] = 0  # the max(n_v, 1) guard
    for eps in [0.0, 0.05, 0.1, 0.5, 1e-3, 1 / 3, 2.0]:
        want = np.asarray(jdensity.peel_threshold(jnp.asarray(n_e), jnp.asarray(n_v), eps))
        got = tdensity.peel_threshold(torch.from_numpy(n_e), torch.from_numpy(n_v), eps)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_density_helpers_match_jax(planted):
    g = planted[0]
    mask = np.random.default_rng(2).random(g.n_nodes) < 0.4
    j = (jnp.asarray(g.src), jnp.asarray(g.dst), jnp.asarray(mask))
    t = (torch.from_numpy(g.src), torch.from_numpy(g.dst), torch.from_numpy(mask))
    np.testing.assert_array_equal(tdensity.degrees_from_coo(t[0], g.n_nodes).numpy(),
                                  np.asarray(jdensity.degrees_from_coo(j[0], g.n_nodes)))
    for name in ("masked_degrees", "induced_edge_count", "subgraph_density"):
        got = getattr(tdensity, name)(*t, g.n_nodes).numpy()
        want = np.asarray(getattr(jdensity, name)(*j, g.n_nodes))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tdensity.density_np(10, 4) == jdensity.density_np(10, 4)
    assert tdensity.check_approx_bound(1.0, 2.0, 2.0) == jdensity.check_approx_bound(1.0, 2.0, 2.0)


@pytest.mark.parametrize("kernel", [False, True])
def test_peel_delta_matches_jax(er_graph, kernel):
    g = er_graph
    src, dst = g.dst_sorted() if kernel else (g.src, g.dst)
    fail = np.random.default_rng(3).random(src.shape[0]) < 0.4
    want = np.asarray(jdispatch.peel_delta(jnp.asarray(fail), jnp.asarray(dst),
                                           g.n_nodes, kernel))
    got = tdispatch.peel_delta(torch.from_numpy(fail), torch.from_numpy(dst),
                               g.n_nodes, kernel)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("eps", [0.0, 0.05, 0.5])
def test_pbahmani_matches_jax(any_graph, eps):
    g = any_graph
    want = jcore.pbahmani(g, eps=eps, kernel=False)
    assert_same_triple(jcore.pbahmani(g, eps=eps, kernel=True), want)
    tg = port(g)
    for kernel in (False, True):
        assert_same_triple(tcore.pbahmani(tg, eps=eps, kernel=kernel, device="cpu"), want)
    assert_same_triple(tcore.pbahmani_np(tg, eps=eps), jcore.pbahmani_np(g, eps=eps))


def test_kcore_matches_jax(any_graph):
    g = any_graph
    want = jcore.kcore_decompose(g, kernel=False)
    tg = port(g)
    for kernel in (False, True):
        got = tcore.kcore_decompose(tg, kernel=kernel, device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        assert _bits(got[1]) == _bits(want[1])
        assert got[2:] == want[2:]
    np_t, np_j = tcore.kcore_np(tg), jcore.kcore_np(g)
    np.testing.assert_array_equal(np_t[0], np_j[0])
    assert np_t[1:] == np_j[1:]


def test_kcore_kernel_matches_jax_kernel(er_graph):
    """JAX's own kernel path (Pallas interpret) agrees as well."""
    want = jcore.kcore_decompose(er_graph, kernel=True)
    got = tcore.kcore_decompose(port(er_graph), kernel=True, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert (_bits(got[1]), *got[2:]) == (_bits(want[1]), *want[2:])


def assert_same_cbds(got, want):
    assert set(got) == set(want)
    for key in ("density", "core_density"):
        assert _bits(got[key]) == _bits(want[key])
    assert (got["k_star"], got["n_legit"]) == (want["k_star"], want["n_legit"])
    np.testing.assert_array_equal(got["member_mask"], want["member_mask"])


@pytest.mark.parametrize("rounds", [1, 3])
def test_cbds_matches_jax(any_graph, rounds):
    g = any_graph
    want = jcore.cbds_p(g, rounds=rounds)
    tg = port(g)
    for kernel in (False, True):
        assert_same_cbds(tcore.cbds_p(tg, rounds=rounds, kernel=kernel, device="cpu"), want)
    np_t, np_j = tcore.cbds_np(tg, rounds=rounds), jcore.cbds_np(g, rounds=rounds)
    np.testing.assert_array_equal(np_t.pop("member_mask"), np_j.pop("member_mask"))
    assert np_t == np_j


def test_envelope_error_matches_jax():
    """The same ValueError at the same entry points, before any upload: a
    graph whose lane count reaches 2^24 (views of one int, no memory)."""
    lanes = np.broadcast_to(np.int32(4), (1 << 24,))
    jg = JGraph(n_nodes=4, n_edges=0, src=lanes, dst=lanes, n_directed=0)
    tg = graph_from_arrays(4, 0, lanes, lanes, 0)
    for jfn, tfn in [(jcore.pbahmani, tcore.pbahmani),
                     (jcore.kcore_decompose, tcore.kcore_decompose)]:
        with pytest.raises(ValueError) as jerr:
            jfn(jg, kernel=True)
        with pytest.raises(ValueError) as terr:
            tfn(tg, kernel=True, device="cpu")
        assert str(terr.value) == str(jerr.value)
    assert tdispatch.EXACT_ENVELOPE == jdispatch.EXACT_ENVELOPE


@pytest.mark.parametrize("kw", [{"pruned": True}, {"refine_rounds": 2}])
def test_unported_options_raise(er_graph, kw):
    """Both options run on one device (tests/test_torch_prune.py and
    tests/test_torch_refine.py hold them against JAX), and since the
    sharded tier was ported their sharded forms run too: over a mesh of one
    they equal the single-device call bit for bit (tests/test_torch_shard.py
    holds them against JAX's sharded forms). What still raises is a device
    that is not the mesh's."""
    from repro_torch.core import prune
    from repro_torch.core.distributed import make_mesh
    from repro_torch.graphs.convert import to_device
    from repro_torch.refine import engine

    tg = port(er_graph)
    assert tcore.pbahmani(tg, eps=0.1, device="cpu", **kw)[0] > 0
    mesh = make_mesh(device="cpu")
    if "pruned" in kw:
        u, v = prune.slot_arrays(tg)
        plan = prune.plan_for_graph(tg, device="cpu")

        def run(**m):
            return prune.pruned_peel_host(u, v, tg.degrees(), tg.n_edges, 0.1, plan, **m)
    else:
        src, dst = to_device(tg, "cpu")
        deg = torch.from_numpy(tg.degrees().astype(np.int32))

        def run(**m):
            mask = np.zeros(tg.n_nodes, bool)
            cert, mask, passes, rounds, _ = engine.refine_resident(
                src, dst, deg, tg.n_edges, tg.n_nodes, 0.1, 0, 0, mask, 0, -1.0, 2, **m)
            return cert.best_ne, cert.best_nv, cert.dual_num, cert.dual_den, mask, passes
    one, sharded = run(device="cpu") if "pruned" in kw else run(), run(mesh=mesh)
    assert _bits(one[0]) == _bits(sharded[0])
    for a, b in zip(one[1:], sharded[1:]):
        assert np.array_equal(a, b)
    if "pruned" in kw:
        with pytest.raises(ValueError, match="not the mesh's device"):
            run(mesh=mesh, device="meta")


def test_empty_graph():
    g = JGraph.from_edges(np.zeros((0, 2)), n_nodes=0)
    got = tcore.pbahmani(port(g), device="cpu")
    assert got[0] == 0.0 and got[2] == 0 and got[1].shape == (0,)


def test_whole_slice_rmat():
    """The slice end to end on a Graph500 RMAT graph: every entry point,
    kernel on and off, equal to the JAX package (scatter tier; its Pallas
    interpret mode is too slow at this size)."""
    g = jrmat(12, 16, seed=0)
    tg = port(g)
    for eps in (0.0, 0.1):
        want = jcore.pbahmani(g, eps=eps, kernel=False)
        for kernel in (False, True):
            assert_same_triple(tcore.pbahmani(tg, eps=eps, kernel=kernel, device="cpu"), want)
    want_core = jcore.kcore_decompose(g, kernel=False)
    want_cbds = jcore.cbds_p(g, rounds=1)
    for kernel in (False, True):
        got = tcore.kcore_decompose(tg, kernel=kernel, device="cpu")
        np.testing.assert_array_equal(got[0], want_core[0])
        assert (_bits(got[1]), *got[2:]) == (_bits(want_core[1]), *want_core[2:])
        assert_same_cbds(tcore.cbds_p(tg, rounds=1, kernel=kernel, device="cpu"), want_cbds)


# ---------------------------------------------------------------------------
# The fused edge stage (K2, core/dispatch.py:peel_edges) against one JAX
# pass from the same numpy-seeded state, kernel on (K2's plain version on
# dst-sorted lanes) and off (the scatter tier)
# ---------------------------------------------------------------------------
PEEL_CASES = ["sentinel", "src_past_n", "all_failed", "none_failed", "all_dead",
              "isolated", "hub"]


def peel_case(name, seed=0):
    """(n, src, dst, active, failed): dst-sorted symmetric COO lanes padded
    with sentinel lanes (src = dst = n), a live mask and a failed subset of
    it, each made from a numpy seed."""
    rng = np.random.default_rng(seed)
    n = {"isolated": 200, "hub": 1500}.get(name, 64)
    k = 40 if name == "isolated" else n  # vertices 40.. of "isolated" have no edges
    u = rng.integers(0, k, 4 * n)
    v = rng.integers(0, k, 4 * n)
    if name == "hub":  # vertex 3 joined to every other vertex
        u = np.r_[u, np.full(n, 3)]
        v = np.r_[v, np.arange(n)]
    keep = u != v
    src, dst = np.r_[u[keep], v[keep]], np.r_[v[keep], u[keep]]
    if name == "src_past_n":  # lanes whose src is past the sentinel
        src[:30] = n + rng.integers(0, 4, 30)
    order = np.argsort(dst, kind="stable")
    pad = 17
    src = np.r_[src[order], np.full(pad, n)].astype(np.int32)
    dst = np.r_[dst[order], np.full(pad, n)].astype(np.int32)
    active = rng.random(n) < (0.0 if name == "all_dead" else 0.85)
    failed = active & ({"all_failed": 1.0, "none_failed": 0.0}.get(name, 0.3)
                       > rng.random(n))
    return n, src, dst, active, failed


def peel_oracle(n, src, dst, active, failed):
    """numpy: (delta, removed, inc) of the edge stage."""
    s, d = src.astype(np.int64), dst.astype(np.int64)
    ok = (s < n) & (d < n)
    sc, dc = np.minimum(s, n - 1), np.minimum(d, n - 1)
    live = ok & active[sc] & active[dc]
    fs, fd = failed[sc] & live, failed[dc] & live
    assign = fd & (~fs | (dc < sc))
    return (np.bincount(dc[fs], minlength=n).astype(np.int32), int((fs | fd).sum()),
            np.bincount(dc[assign], minlength=n).astype(np.int32))


def _pass_state(n, src, dst, active, failed, rng):
    """deg 0 on the failed vertices and far above any threshold elsewhere, so
    a pass fails exactly ``failed``; counts as the live subgraph's."""
    deg = np.where(active, np.where(failed, 0, 1 << 20), 0).astype(np.int32)
    n_v = int(active.sum())
    ok = (src < n) & (dst < n)
    live = ok & active[np.minimum(src, n - 1)] & active[np.minimum(dst, n - 1)]
    n_e = int(live.sum()) // 2
    loads = np.where(active, rng.integers(0, 3, n), 0).astype(np.int32)
    return deg, n_v, n_e, loads


@pytest.mark.parametrize("case", PEEL_CASES)
@pytest.mark.parametrize("kernel", [False, True])
def test_peel_edges_matches_oracle(case, kernel):
    n, src, dst, active, failed = peel_case(case)
    want = peel_oracle(n, src, dst, active, failed)
    t = [torch.from_numpy(a) for a in (src, dst, active, failed)]
    delta, removed = tdispatch.peel_edges(*t, n, kernel)
    got = tdispatch.peel_edges(*t, n, kernel, charge=True)
    assert all(x.dtype == torch.int32 for x in got) and removed.dim() == 0
    np.testing.assert_array_equal(delta.numpy(), want[0])
    assert int(removed) == want[1]
    for x, w in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), w)


@pytest.mark.parametrize("case", PEEL_CASES)
def test_peel_edges_matches_jax_pbahmani_pass(case):
    """One pass from the same state: the port's whole new state equals
    JAX's, kernel on and off, and delta/removed read back from JAX's state
    (deg - deg_new on survivors, n_e - n_e_new) equal peel_edges'."""
    from repro.core.pbahmani import PeelState as JState, pbahmani_pass as jpass
    from repro_torch.core.pbahmani import PeelState as TState, pbahmani_pass as tpass

    n, src, dst, active, failed = peel_case(case)
    deg, n_v, n_e, _ = _pass_state(n, src, dst, active, failed, np.random.default_rng(1))
    mask = np.zeros(n, bool)
    jstate = JState(jnp.asarray(deg), jnp.asarray(active), jnp.int32(n_v),
                           jnp.int32(n_e), jnp.float32(0.0), jnp.asarray(mask), jnp.int32(0))
    want = jpass(jstate, jnp.asarray(src), jnp.asarray(dst), n, 0.1)
    surv = np.asarray(want.active)
    t = [torch.from_numpy(a) for a in (src, dst, active, failed)]
    for kernel in (False, True):
        tstate = TState(torch.from_numpy(deg), torch.from_numpy(active),
                               torch.tensor(n_v, dtype=torch.int32),
                               torch.tensor(n_e, dtype=torch.int32), torch.tensor(0.0),
                               torch.from_numpy(mask), torch.tensor(0, dtype=torch.int32))
        got = tpass(tstate, t[0], t[1], n, 0.1, kernel)
        for field, w in zip(got, want):
            np.testing.assert_array_equal(field.numpy(), np.asarray(w))
        delta, removed = tdispatch.peel_edges(*t, n, kernel)
        np.testing.assert_array_equal(np.asarray(want.deg)[surv], deg[surv] - delta.numpy()[surv])
        assert n_e - int(want.n_e) == int(removed) // 2
    np.testing.assert_array_equal(np.asarray(want.active), active & ~failed)


@pytest.mark.parametrize("case", PEEL_CASES)
def test_peel_edges_matches_jax_refine_pass(case):
    """One refinement pass from the same state: the port's new state equals
    JAX's, kernel on and off, and JAX's loads_new - loads equals inc (the
    edge charges) with the failed set the pass chose."""
    import repro.refine.loads as jl
    import repro_torch.refine.loads as tl

    n, src, dst, active, failed = peel_case(case)
    deg, n_v, n_e, loads = _pass_state(n, src, dst, active, failed, np.random.default_rng(2))
    load_sum = int(loads[active].sum())
    mask = np.zeros(n, bool)
    jstate = jl.RefinePeelState(
        jnp.asarray(deg), jnp.asarray(loads), jnp.asarray(active), jnp.int32(n_v),
        jnp.int32(n_e), jnp.int32(load_sum), jnp.float32(0.0), jnp.int32(0), jnp.int32(0),
        jnp.asarray(mask), jnp.int32(0))
    want = jl.refine_pass(jstate, jnp.asarray(src), jnp.asarray(dst), n, 0.1)
    chosen = active & ~np.asarray(want.active)   # the failed set of this pass
    t = [torch.from_numpy(a) for a in (src, dst, active, chosen)]
    for kernel in (False, True):
        tstate = tl.RefinePeelState(
            torch.from_numpy(deg), torch.from_numpy(loads), torch.from_numpy(active),
            *(torch.tensor(x, dtype=torch.int32) for x in (n_v, n_e, load_sum)),
            torch.tensor(0.0), torch.tensor(0, dtype=torch.int32),
            torch.tensor(0, dtype=torch.int32), torch.from_numpy(mask),
            torch.tensor(0, dtype=torch.int32))
        got = tl.refine_pass(tstate, t[0], t[1], n, 0.1, kernel)
        for field, w in zip(got, want):
            np.testing.assert_array_equal(field.numpy(), np.asarray(w))
        delta, removed, inc = tdispatch.peel_edges(*t, n, kernel, charge=True)
        np.testing.assert_array_equal(np.asarray(want.loads) - loads, inc.numpy())
        assert n_e - int(want.n_e) == int(removed) // 2
        oracle = peel_oracle(n, src, dst, active, chosen)
        np.testing.assert_array_equal(delta.numpy(), oracle[0])
