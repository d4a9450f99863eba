"""The port's sorted segment-sum (K1), fused peel edge stage (K2,
peel_update and peel_edges) and fused gather-and-segment-sum (K5,
segment_embed) against the JAX package's Pallas kernels (interpret mode on
the CPU, as tests/test_kernels.py runs them) and its ``impl="xla"`` path.

On the CPU the port's wrappers run their plain versions
(tests/test_torch_gpu.py holds the CUDA kernel against them on the card).
Tolerances: 1e-5 for random float32 and 2e-2 for
bfloat16 (the summation order differs, as in tests/test_kernels.py); exact
for 0/1 and integer lanes; rtol 1e-5, atol 1e-6 for K5's float32 sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import embed, ops, peel, ref, segsum  # noqa: E402


def _problem(rng, e, d, v, sorted_=True):
    seg = rng.integers(0, v, e).astype(np.int32)
    if sorted_:
        seg = np.sort(seg)
    vals = rng.normal(size=(e, d) if d else (e,)).astype(np.float32)
    return vals, seg


def _jax_segsum(vals, seg, v, presorted=True):
    return np.asarray(jops.segment_sum(jnp.asarray(vals), jnp.asarray(seg),
                                       num_segments=v, presorted=presorted))


def _port_segsum(vals, seg, v, **kw):
    return ops.segment_sum(torch.from_numpy(vals), torch.from_numpy(seg),
                           num_segments=v, **kw).numpy()


@pytest.mark.parametrize("e,d,v,ids_below", [
    pytest.param(64, 0, 16, None, id="64-0-16"),
    pytest.param(1000, 33, 300, None, id="1000-33-300"),
    pytest.param(512, 128, 256, None, id="512-128-256"),
    pytest.param(2048, 16, 1000, None, id="2048-16-1000"),
    pytest.param(513, 7, 100, None, id="513-7-100"),
    pytest.param(100, 200, 50, None, id="100-200-50"),
    # the GNNs' other widths: EGNN's coordinates, SchNet/EGNN, MACE's 9 x 128
    pytest.param(1500, 3, 400, None, id="1500-3-400"),
    pytest.param(1024, 64, 200, None, id="1024-64-200"),
    pytest.param(300, 1152, 40, None, id="300-1152-40"),
    # ids only in the first 400 of 5,000 rows: a sampled block's long empty tail
    pytest.param(3000, 16, 5000, 400, id="3000-16-5000-tail"),
])
def test_segment_sum_shapes_match_jax(e, d, v, ids_below):
    rng = np.random.default_rng(e * 7 + d)
    vals, seg = _problem(rng, e, d, ids_below or v)
    np.testing.assert_allclose(_port_segsum(vals, seg, v), _jax_segsum(vals, seg, v),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "bool"])
def test_segment_sum_dtypes_match_jax(dtype):
    rng = np.random.default_rng(5)
    seg = np.sort(rng.integers(0, 64, 500)).astype(np.int32)
    if dtype in ("int32", "bool"):
        vals = rng.integers(0, 3 if dtype == "int32" else 2, (500, 8)).astype(dtype)
        jv, tv = jnp.asarray(vals), torch.from_numpy(vals)
    else:
        vals = rng.normal(size=(500, 8)).astype(np.float32)
        jv = jnp.asarray(vals, getattr(jnp, dtype))
        tv = torch.from_numpy(vals).to(getattr(torch, dtype))
    exp = np.asarray(jops.segment_sum(jv, jnp.asarray(seg), num_segments=64), np.float32)
    out = ops.segment_sum(tv, torch.from_numpy(seg), num_segments=64)
    assert out.dtype == torch.float32
    tol = {"bfloat16": 2e-2, "float32": 1e-5}.get(dtype, 0)
    np.testing.assert_allclose(out.numpy(), exp, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ["sentinel", "all_sentinel", "straddle",
                                  "duplicates", "negative"])
def test_segment_sum_edge_cases_match_jax(case):
    """Exact 0/1 cases: sentinel padding (ids >= V drop), a fully padded
    input, one segment across many tiles, runs split at tile boundaries,
    and negative ids (dropped, as JAX drops them)."""
    seg, v = {
        "sentinel": (np.array([0, 1, 1, 7, 8, 100]), 7),
        "all_sentinel": (np.full(700, 1 << 20), 32),
        "straddle": (np.zeros(1537), 4),
        "duplicates": (np.sort(np.r_[np.full(510, 3), np.full(5, 4), np.full(509, 5)]), 8),
        "negative": (np.sort(np.r_[np.arange(-40, 0), np.arange(300) % 30]), 30),
    }[case]
    seg = seg.astype(np.int32)
    vals = np.ones(seg.size, np.float32)
    out = _port_segsum(vals, seg, v)
    np.testing.assert_array_equal(out, _jax_segsum(vals, seg, v))
    counts = ops.segment_sum(torch.from_numpy(vals).bool(), torch.from_numpy(seg),
                             num_segments=v, out_dtype=torch.int32)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), out.astype(np.int32))


def test_segment_sum_unsorted_matches_jax_and_counts():
    """presorted=False sorts inside every call; the counter rises per call
    and the sorted path leaves it alone."""
    rng = np.random.default_rng(9)
    vals, seg = _problem(rng, 777, 12, 99, sorted_=False)
    before = ops.unsorted_fallback_count
    out = _port_segsum(vals, seg, 99, presorted=False)
    _port_segsum(vals, seg, 99, presorted=False)
    assert ops.unsorted_fallback_count == before + 2
    np.testing.assert_allclose(out, _jax_segsum(vals, seg, 99, presorted=False),
                               rtol=1e-5, atol=1e-5)
    vals_s, seg_s = _problem(rng, 300, 4, 50)
    _port_segsum(vals_s, seg_s, 50)
    assert ops.unsorted_fallback_count == before + 2


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float64, torch.float32),
    (torch.int64, torch.float32),
    (torch.float32, torch.int32),
    (torch.float32, torch.float64),
])
def test_segment_sum_rejects_unsupported_dtypes(dtype, out_dtype):
    seg = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        segsum.segment_sum_sorted(torch.ones(8, dtype=dtype), seg, num_segments=2,
                                  out_dtype=out_dtype)


def test_segment_sum_rejects_bad_ids():
    with pytest.raises(ValueError, match="int32"):
        segsum.segment_sum_sorted(torch.ones(8), torch.zeros(8, dtype=torch.int64),
                                  num_segments=2)
    with pytest.raises(ValueError):
        segsum.segment_sum_sorted(torch.ones(7), torch.zeros(8, dtype=torch.int32),
                                  num_segments=2)


def test_segment_sum_sorted_rejects_unsorted_ids_on_cpu():
    """Sortedness is K1's precondition: on the card unsorted ids give wrong
    sums, so the CPU path raises on them instead of summing them right.
    peel_delta with the kernel on goes through the same check."""
    from repro_torch.core.dispatch import peel_delta

    seg = torch.tensor([0, 2, 1, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="ascending"):
        segsum.segment_sum_sorted(torch.ones(4), seg, num_segments=4)
    with pytest.raises(ValueError, match="ascending"):
        peel_delta(torch.ones(4, dtype=torch.bool), seg, 4, kernel=True)
    assert peel_delta(torch.ones(4, dtype=torch.bool), seg, 4, kernel=False).tolist() == [1] * 4
    assert ops.segment_sum(torch.ones(4), seg, num_segments=4,
                           presorted=False).tolist() == [1.0] * 4


@pytest.mark.parametrize("p_fail", [0.0, 0.3, 1.0])
def test_peel_update_matches_jax(er_graph, p_fail):
    g = er_graph
    src_s, dst_s = g.dst_sorted()
    failed = np.random.default_rng(1).random(g.n_nodes) < p_fail
    exp = np.asarray(jops.peel_update(jnp.asarray(src_s), jnp.asarray(dst_s),
                                      jnp.asarray(failed), n_nodes=g.n_nodes))
    out = ops.peel_update(torch.from_numpy(src_s), torch.from_numpy(dst_s),
                          torch.from_numpy(failed), n_nodes=g.n_nodes)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), exp)
    plain = ref.peel_update_ref(torch.from_numpy(g.src), torch.from_numpy(g.dst),
                                torch.from_numpy(failed), g.n_nodes)
    np.testing.assert_array_equal(plain.numpy(), exp)


def test_peel_update_unsorted_lanes(er_graph):
    g = er_graph
    failed = np.random.default_rng(4).random(g.n_nodes) < 0.5
    before = ops.unsorted_fallback_count
    out = ops.peel_update(torch.from_numpy(g.src), torch.from_numpy(g.dst),
                          torch.from_numpy(failed), n_nodes=g.n_nodes, presorted=False)
    assert ops.unsorted_fallback_count == before + 1
    s, d = g.src[:g.n_directed], g.dst[:g.n_directed]
    np.testing.assert_array_equal(out.numpy(),
                                  np.bincount(d[failed[s]], minlength=g.n_nodes))


# ---------------------------------------------------------------------------
# K5: the fused gather and segment-sum (segment_embed)
# ---------------------------------------------------------------------------
EMBED_TOL = dict(rtol=1e-5, atol=1e-6)  # float32 sums in another order


def _embed_problem(rng, n, d, e, v, weighted, invalid=False):
    table = rng.normal(size=(n, d)).astype(np.float32)
    lo, hi = (-n, 2 * n) if invalid else (0, n)
    gid = rng.integers(lo, hi, e).astype(np.int32)
    seg = np.sort(rng.integers(-3 if invalid else 0, v + 3 if invalid else v, e)).astype(np.int32)
    w = rng.random(e).astype(np.float32) if weighted else None
    return table, gid, seg, w


def _jax_embed(table, gid, seg, w, v, impl="pallas", presorted=True):
    return np.asarray(jops.segment_embed(
        jnp.asarray(table), jnp.asarray(gid), jnp.asarray(seg),
        None if w is None else jnp.asarray(w), num_segments=v, impl=impl,
        presorted=presorted))


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("n,d,e,v,weighted,invalid", [
    (50, 16, 1000, 300, True, False),    # the three cases of tests/test_kernels.py
    (20, 64, 200, 64, False, False),
    (100, 8, 64, 8, True, False),
    (50, 16, 1000, 300, True, True),     # ids < 0 and >= R, seg ids < 0 and >= V
    (30, 7, 500, 40, False, True),
])
def test_segment_embed_matches_jax(n, d, e, v, weighted, invalid):
    rng = np.random.default_rng(n + e)
    table, gid, seg, w = _embed_problem(rng, n, d, e, v, weighted, invalid)
    if invalid:
        assert (gid < 0).any() and (gid >= n).any() and (seg < 0).any() and (seg >= v).any()
    out = ops.segment_embed(_t(table), _t(gid), _t(seg), _t(w), num_segments=v)
    assert out.shape == (v, d) and out.dtype == torch.float32
    for impl in ("pallas", "xla"):
        np.testing.assert_allclose(out.numpy(), _jax_embed(table, gid, seg, w, v, impl),
                                   **EMBED_TOL)
    plain = ref.segment_embed_ref(_t(table), _t(gid), _t(seg), _t(w), v)
    np.testing.assert_allclose(plain.numpy(), out.numpy(), **EMBED_TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_segment_embed_batched_tables_match_jax(weighted):
    """T tables with one shared, unsorted seg in one call: [V, T, D], table
    t's sums at out[:, t], each equal to JAX's single-table call; one sort
    (one count) for all tables."""
    rng = np.random.default_rng(21 + weighted)
    t_, n, d, e, v = 5, 40, 8, 300, 37
    tables = rng.normal(size=(t_, n, d)).astype(np.float32)
    gid = rng.integers(-2, n + 2, (t_, e)).astype(np.int32)
    seg = rng.integers(0, v + 2, e).astype(np.int32)
    w = rng.random((t_, e)).astype(np.float32) if weighted else None
    before = ops.unsorted_fallback_count
    out = ops.segment_embed(_t(tables), _t(gid), _t(seg), _t(w), num_segments=v,
                            presorted=False)
    assert ops.unsorted_fallback_count == before + 1
    assert out.shape == (v, t_, d)
    for k in range(t_):
        exp = _jax_embed(tables[k], gid[k], seg, None if w is None else w[k], v,
                         presorted=False)
        np.testing.assert_allclose(out[:, k].numpy(), exp, **EMBED_TOL)
    plain = ref.segment_embed_ref(_t(tables), _t(gid), torch.sort(_t(seg)).values,
                                  None, v)
    assert plain.shape == (v, t_, d)


@pytest.mark.parametrize("b,t_,m,weighted", [(40, 5, 4, False), (33, 3, 3, True),
                                              (20, 4, 1, False), (7, 2, 9, True)])
def test_segment_embed_strided_ids_match_jax(b, t_, m, weighted):
    """Gather ids as the [T, B, M] view of [B, T, M] ids (what DCN-v2's
    embedding_bag hands K5, no copy): equal to JAX's segment_embed, Pallas
    interpret and xla, on the transposed copy, table by table; the plain
    version flattens the view itself. Bags of M lanes, plus one bag id past
    V and invalid row ids."""
    rng = np.random.default_rng(b * 10 + m)
    n, d = 30, 8
    tables = rng.normal(size=(t_, n, d)).astype(np.float32)
    ids = rng.integers(-2, n + 2, (b, t_, m)).astype(np.int32)
    seg = np.repeat(np.arange(b, dtype=np.int32), m)
    seg[-1] = b  # past V: dropped
    w = rng.random((b, t_, m)).astype(np.float32) if weighted else None
    view = torch.from_numpy(ids).permute(1, 0, 2)
    wview = None if w is None else torch.from_numpy(w).permute(1, 0, 2)
    assert not view.is_contiguous()
    out = ops.segment_embed(_t(tables), view, _t(seg), wview, num_segments=b)
    assert out.shape == (b, t_, d)
    flat = ids.transpose(1, 0, 2).reshape(t_, -1)
    wflat = None if w is None else w.transpose(1, 0, 2).reshape(t_, -1)
    for k in range(t_):
        for impl in ("pallas", "xla"):
            exp = _jax_embed(tables[k], flat[k], seg, None if w is None else wflat[k], b, impl)
            np.testing.assert_allclose(out[:, k].numpy(), exp, **EMBED_TOL)
    same = ref.segment_embed_ref(_t(tables), _t(np.ascontiguousarray(flat)), _t(seg),
                                 _t(None if w is None else np.ascontiguousarray(wflat)), b)
    assert torch.equal(out, same)
    # presorted=False flattens the view before it carries the ids through the sort
    resorted = ops.segment_embed(_t(tables), view, _t(seg), wview, num_segments=b,
                                 presorted=False)
    assert torch.equal(resorted, out)


def test_segment_embed_empty_bags_and_lanes():
    table = torch.ones(4, 8)
    seg = torch.tensor([1, 1, 3], dtype=torch.int32)
    out = ops.segment_embed(table, torch.tensor([0, 3, 2], dtype=torch.int32), seg,
                            num_segments=5)
    assert out.sum(1).tolist() == [0.0, 16.0, 0.0, 8.0, 0.0]
    none = ops.segment_embed(table, torch.zeros(0, dtype=torch.int32),
                             torch.zeros(0, dtype=torch.int32), num_segments=3)
    assert torch.equal(none, torch.zeros(3, 8))


def test_segment_embed_sorted_rejects_unsorted_ids_on_cpu():
    seg = torch.tensor([0, 2, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="ascending"):
        embed.segment_embed_sorted(torch.ones(3, 4), torch.zeros(3, dtype=torch.int32),
                                   seg, num_segments=3)


def test_segment_embed_refuses_autograd():
    """No backward yet: an input that requires a gradient raises while grad
    mode is on, so backward() cannot silently skip the tables; under
    no_grad the same call runs."""
    table = torch.ones(6, 4, requires_grad=True)
    gid, seg = torch.tensor([0, 5], dtype=torch.int32), torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.segment_embed(table, gid, seg, num_segments=2)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.segment_embed(torch.ones(6, 4), gid, seg,
                          torch.ones(2, requires_grad=True), num_segments=2)
    with torch.no_grad():
        assert ops.segment_embed(table, gid, seg, num_segments=2).sum() == 8


@pytest.mark.parametrize("case", ["table_dtype", "ids_dtype", "ids_shape", "weights_shape",
                                  "devices"])
def test_segment_embed_rejects_bad_inputs(case):
    table, gid = torch.ones(6, 4), torch.zeros(3, dtype=torch.int32)
    seg, w = torch.zeros(3, dtype=torch.int32), None
    if case == "table_dtype":
        table = table.double()
    elif case == "ids_dtype":
        gid = gid.long()
    elif case == "ids_shape":
        table = torch.ones(2, 6, 4)
    elif case == "weights_shape":
        w = torch.ones(4)
    else:
        table = table.to("meta")
    with pytest.raises((TypeError, ValueError)):
        embed.segment_embed_sorted(table, gid, seg, w, num_segments=2)


def _k2_lanes(g, variant, rng):
    """dst-sorted lanes of ``g`` (sentinel-padded), optionally with lanes
    whose src is past the sentinel or with a hub row of 3,000 lanes."""
    src, dst = (a.copy() for a in g.dst_sorted())
    n = g.n_nodes
    if variant == "src_past_n":
        src[rng.choice(g.n_directed, 50, replace=False)] = n + rng.integers(0, 3, 50)
    if variant == "hub":
        hub_src = rng.integers(0, n, 3000).astype(np.int32)
        src, dst = np.r_[hub_src, src], np.r_[np.zeros(3000, np.int32), dst]
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
    return src, dst


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("variant,p_fail", [("plain", 0.0), ("plain", 0.3), ("plain", 1.0),
                                            ("src_past_n", 0.5), ("hub", 0.4)])
def test_peel_edges_active_none_matches_jax_peel_update(er_graph, impl, variant, p_fail):
    """K2 with active=None keeps JAX's peel_update contract: every valid
    lane counts, no live mask; removed counts the lanes with a failed end."""
    rng = np.random.default_rng(11)
    g = er_graph
    src, dst = _k2_lanes(g, variant, rng)
    failed = rng.random(g.n_nodes) < p_fail
    exp = np.asarray(jops.peel_update(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(failed),
                                      n_nodes=g.n_nodes, impl=impl))
    t = [torch.from_numpy(a) for a in (src, dst, failed)]
    delta, removed, inc = peel.peel_edges_sorted(t[0], t[1], None, t[2], n_nodes=g.n_nodes,
                                         charge=True)
    np.testing.assert_array_equal(delta.numpy(), exp)
    np.testing.assert_array_equal(ops.peel_update(*t, n_nodes=g.n_nodes).numpy(), exp)
    n = g.n_nodes
    valid = (src < n) & (dst < n)
    fs = failed[np.minimum(src, n - 1)] & valid
    fd = failed[np.minimum(dst, n - 1)] & valid
    assert int(removed) == int((fs | fd).sum())
    charge = fd & (~fs | (dst < src))
    np.testing.assert_array_equal(inc.numpy(), np.bincount(dst[charge], minlength=n))


def test_peel_edges_plain_version_is_ref(er_graph):
    """On the CPU the wrapper returns exactly ref.peel_edges_ref."""
    rng = np.random.default_rng(12)
    g = er_graph
    t = [torch.from_numpy(a) for a in g.dst_sorted()]
    active = torch.from_numpy(rng.random(g.n_nodes) < 0.8)
    failed = active & torch.from_numpy(rng.random(g.n_nodes) < 0.4)
    for charge in (False, True):
        got = peel.peel_edges_sorted(*t, active, failed, n_nodes=g.n_nodes, charge=charge)
        want = ref.peel_edges_ref(*t, active, failed, g.n_nodes, charge)
        assert len(got) == len(want) == 2 + charge
        for x, w in zip(got, want):
            assert x.dtype == torch.int32 and torch.equal(x, w)


def test_peel_edges_sorted_rejects_bad_input():
    """dst must ascend (the kernel's precondition): unsorted lanes raise on
    the CPU too; wrong types and mask shapes raise."""
    src = torch.tensor([1, 0, 2, 1], dtype=torch.int32)
    dst = torch.tensor([0, 2, 1, 3], dtype=torch.int32)
    failed = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="ascending"):
        peel.peel_edges_sorted(src, dst, None, failed, n_nodes=4)
    with pytest.raises(ValueError, match="ascending"):
        ops.peel_update(src, dst, failed, n_nodes=4)
    ok = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        peel.peel_edges_sorted(src.long(), ok, None, failed, n_nodes=4)
    with pytest.raises(ValueError, match="bool"):
        peel.peel_edges_sorted(src, ok, None, failed.int(), n_nodes=4)
    with pytest.raises(ValueError, match="bool"):
        peel.peel_edges_sorted(src, ok, torch.ones(3, dtype=torch.bool), failed, n_nodes=4)
    delta, removed = peel.peel_edges_sorted(src, ok, None, failed, n_nodes=4)
    assert delta.tolist() == [1, 1, 1, 1] and int(removed) == 4


# ---------------------------------------------------------------------------
# row-batched K1 and K2 (the fused tenants' batched passes) against jax.vmap
# of the JAX package's kernels
# ---------------------------------------------------------------------------
def _rows(rng, g, L, v, sentinel_tail=True):
    """[g, L] lanes, each row dst-sorted with a sentinel tail; row 1 empty
    (all sentinel) when g > 1. From L = 1024 on, row 0 has no tail and three
    quarters of its lanes share one dst: a hub run across several of the
    kernels' 512-lane tiles."""
    src = rng.integers(0, v, (g, L)).astype(np.int32)
    dst = rng.integers(0, v, (g, L)).astype(np.int32)
    for r in range(g):
        k = int(rng.integers(0, L + 1)) if sentinel_tail else L
        if r == 1:
            k = 0
        if r == 0 and L >= 1024:
            k = L
            dst[r, :3 * L // 4] = v // 2
        src[r, k:], dst[r, k:] = v, v
        order = np.argsort(dst[r], kind="stable")
        src[r], dst[r] = src[r][order], dst[r][order]
    return src, dst


def _jax_rows_stage(src, dst, active, failed, n):
    """The JAX package's edge stage of one pass (refine_pass's), vmapped over
    rows, with both sums through its Pallas K1 (peel_delta, kernel=True)."""
    import jax

    from repro.core.dispatch import peel_delta as j_peel_delta

    def one(s, d, a, f):
        s_c, d_c = jnp.minimum(s, n - 1), jnp.minimum(d, n - 1)
        live = (s < n) & (d < n) & a[s_c] & a[d_c]
        fs, fd = f[s_c] & live, f[d_c] & live
        assign = fd & (~fs | (d_c < s_c))
        return (j_peel_delta(fs, d, n, True), jnp.sum((fs | fd).astype(jnp.int32)),
                j_peel_delta(assign, d, n, True))

    return [np.asarray(x) for x in jax.vmap(one)(*(jnp.asarray(x) for x in (
        src, dst, active, failed)))]


@pytest.mark.parametrize("g,L,v", [(3, 200, 40), (1, 64, 1), (4, 1, 5), (5, 513, 17),
                                   (2, 0, 8),
                                   # the row-local kernel's edges: a hub run over
                                   # several tiles, L not a multiple of 4 with a hub,
                                   # more rows than a row's spans, V = 1 over rows
                                   (2, 2600, 30), (4, 1030, 9), (40, 37, 5), (3, 90, 1)])
def test_peel_edges_rows_match_jax_vmap(g, L, v):
    """Random rows with sentinel tails, an empty row (every lane the
    sentinel), a row of one vertex, zero lanes, hub runs: delta, removed and
    inc per row equal the JAX package's vmapped edge stage over its Pallas
    K1 (interpret mode)."""
    rng = np.random.default_rng(g * 100 + L + v)
    src, dst = _rows(rng, g, L, v)
    active = rng.random((g, v)) < 0.85
    failed = rng.random((g, v)) < 0.4
    got = peel.peel_edges_rows(*(torch.from_numpy(x) for x in (src, dst, active, failed)),
                               n_nodes=v, charge=True)
    assert [tuple(x.shape) for x in got] == [(g, v), (g,), (g, v)]
    assert all(x.dtype == torch.int32 for x in got)
    if L:
        want = _jax_rows_stage(src, dst, active, failed, v)
        for x, w in zip(got, want):
            np.testing.assert_array_equal(x.numpy(), w)
    for r in range(g):  # and each row is the single-row plain version
        one = ref.peel_edges_ref(*(torch.from_numpy(x[r]) for x in (src, dst, active, failed)),
                                 v, True)
        for x, w in zip(got, one):
            assert torch.equal(x[r], w)
    two = peel.peel_edges_rows(*(torch.from_numpy(x) for x in (src, dst, active, failed)),
                               n_nodes=v)
    assert len(two) == 2 and torch.equal(two[0], got[0]) and torch.equal(two[1], got[1])


@pytest.mark.parametrize("g,L,v,kind", [(3, 300, 50, "bool"), (4, 37, 3, "int32"),
                                        (1, 1, 1, "bool"), (2, 0, 4, "int32"),
                                        # a hub run over several tiles, L not a
                                        # multiple of 4, many short rows, V = 1
                                        (2, 2600, 30, "bool"), (4, 1030, 9, "int32"),
                                        (3, 777, 40, "bool"), (40, 37, 5, "int32"),
                                        (3, 90, 1, "bool")])
def test_segment_sum_rows_match_jax_vmap(g, L, v, kind):
    """K1's rows entry against jax.vmap of the JAX package's K1 (Pallas,
    interpret mode): ids past V (the sentinel tail) drop; an empty row, hub
    runs."""
    import jax

    rng = np.random.default_rng(g + L + v)
    _, seg = _rows(rng, g, L, v)
    vals = (rng.random((g, L)) < 0.5 if kind == "bool"
            else rng.integers(-3, 4, (g, L)).astype(np.int32))
    got = segsum.segment_sum_rows_sorted(torch.from_numpy(vals), torch.from_numpy(seg),
                                         num_segments=v)
    assert got.shape == (g, v) and got.dtype == torch.int32
    if L:
        want = jax.vmap(lambda x, s: jops.segment_sum(x.astype(jnp.float32), s,
                                                      num_segments=v))(
            jnp.asarray(vals), jnp.asarray(seg))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    else:
        assert not got.any()


def test_rows_entries_reject_bad_input():
    """Every row's dst must ascend on its own (a row may restart below the
    last id of the row before); wrong shapes raise."""
    src = torch.tensor([[0, 1, 2], [2, 0, 1]], dtype=torch.int32)
    ok = torch.tensor([[0, 1, 3], [0, 2, 3]], dtype=torch.int32)
    bad = torch.tensor([[0, 1, 3], [2, 0, 3]], dtype=torch.int32)
    f = torch.zeros(2, 3, dtype=torch.bool)
    peel.peel_edges_rows(src, ok, None, f, n_nodes=3)
    with pytest.raises(ValueError, match="ascending"):
        peel.peel_edges_rows(src, bad, None, f, n_nodes=3)
    with pytest.raises(ValueError, match="ascending"):
        segsum.segment_sum_rows_sorted(f[:, :3], bad, num_segments=3)
    with pytest.raises(ValueError, match="bool"):
        peel.peel_edges_rows(src, ok, None, torch.zeros(2, 4, dtype=torch.bool), n_nodes=3)
    with pytest.raises(ValueError, match=r"\[G, L\]"):
        peel.peel_edges_rows(src[0], ok[0], None, f, n_nodes=3)
    with pytest.raises(TypeError):
        segsum.segment_sum_rows_sorted(ok.float(), ok, num_segments=3)
