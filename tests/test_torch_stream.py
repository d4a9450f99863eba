"""The port's streaming slice (``repro_torch.stream``) against the JAX
package's, step by step, on the CPU.

``EdgeBuffer`` must hold the JAX buffer's arrays after every batch. A port
``DeltaEngine`` (kernel off, and kernel on through the plain versions of
K1-K4) is fed the same insert/delete stream as a JAX ``DeltaEngine(kernel=
False)`` and must match it after every step: the query triple (the f32 bits
of the density, the mask, the passes), ``warm_density``/``warm_mask``, the
certificates' integers, ``UpdateStats`` (but ``latency_ms`` and
``compiled``), ``cbds``'s dict and the integer metrics. The streams cover
hole reuse inside a batch, regrow, the tombstone autocompact, the epoch
shrink, refreshes, a pruned fallback, refined queries with a certified skip
and with the insert slack, ``cbds``, an empty graph and deletion back to
empty. One small stream also runs against JAX with ``kernel=True`` (Pallas
in interpret mode). Every input comes from a numpy seed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graphs.io import load_edge_stream as j_load_stream  # noqa: E402
from repro.stream import DeltaEngine as JEngine  # noqa: E402
from repro.stream import EdgeBuffer as JBuffer  # noqa: E402
from repro_torch.core import prune as tprune  # noqa: E402
from repro_torch.graphs.io import load_edge_stream, save_edge_stream  # noqa: E402
from repro_torch.kernels import peel, ref  # noqa: E402
from repro_torch.stream import DeltaEngine, EdgeBuffer  # noqa: E402
from repro_torch.stream import delta as tdelta  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small graphs: torch's intra-op threads cost more than they save and
    oversubscribe the parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    return np.float32(x).view(np.int32)


def _pairs(rng, n, k):
    return rng.integers(0, n, (k, 2))


# ---------------------------------------------------------------------------
# the streams: lists of steps, each ("update", ins, dels), ("query",),
# ("refine", kwargs), ("refresh",) or ("cbds", rounds)
# ---------------------------------------------------------------------------
def _churn(rng):
    """Random inserts and deletes of present edges: refreshes every few
    batches, pruned queries with bucket regrows and shrinks, refined queries
    and cbds along the way. Deletes come first in a batch, so its inserts
    reuse the holes they leave."""
    n, steps, edges = 120, [], set()
    for i in range(12):
        ins = _pairs(rng, n, int(rng.integers(8, 60)))
        dels = None
        if edges and rng.random() < 0.7:
            pool = np.asarray(sorted(edges))
            dels = pool[rng.random(len(pool)) < 0.3]
            edges -= {(int(u), int(v)) for u, v in dels}
        edges |= {(min(int(u), int(v)), max(int(u), int(v))) for u, v in ins if u != v}
        steps.append(("update", ins, dels))
        steps.append(("query",))
        if i % 4 == 3:
            steps.append(("refine", {"target_gap": 0.05, "max_refine_rounds": 6}))
    steps.append(("cbds", 2))
    return dict(n_nodes=n, refresh_every=4, eps=0.1), steps


def _grow_shrink(rng):
    """Grow through two capacity doublings, delete until the tombstone
    fraction forces a mid-stream compaction, then let the epoch refresh
    shrink the buffer, and grow again. The warm path (``pruned=False``)."""
    n, steps = 256, []
    for _ in range(6):
        steps += [("update", _pairs(rng, n, 120), None), ("query",)]
    steps.append(("delete_most", 40, 0))   # chunks of 40, keep none extra
    steps += [("refresh",), ("query",)]
    for _ in range(3):
        steps += [("update", _pairs(rng, n, 90), None), ("query",)]
    steps.append(("cbds", 1))
    return dict(n_nodes=n, capacity=256, refresh_every=10**9, pruned=False), steps


def _fallback(rng):
    """A 20-clique in a matching: pass 0 strips the matching and leaves the
    clique's 190 edges, more than half the 256-slot lane width, so the pruned
    query falls back to the full-width peel (and the warm path serves until
    the refresh rebuilds the plan)."""
    clique = np.array([(i, j) for i in range(20) for j in range(i + 1, 20)])
    matching = np.array([(20 + 2 * i, 21 + 2 * i) for i in range(60)])
    steps = [("update", np.concatenate([clique, matching]), None), ("query",),
             ("update", np.array([[100, 101], [102, 103]]), matching[:3]), ("query",),
             ("refresh",), ("update", _pairs(rng, 160, 12), None), ("query",)]
    return dict(n_nodes=160, capacity=256, refresh_every=10**9), steps


def _refine_skip(rng):
    """A proved certificate answers a delete-only follow-up with no peel (the
    certified skip); an insert adds slack and forces real rounds. A later
    batch deletes an edge and inserts another into its freed slot."""
    tri = np.array([[0, 1], [1, 2], [0, 2]])
    tail = np.array([[3, 4], [4, 5], [5, 6]])
    exact = {"target_gap": 0.0, "max_refine_rounds": 200}
    steps = [("update", np.concatenate([tri, tail]), None), ("refine", exact),
             ("update", None, np.array([[4, 5]])), ("refine", exact),
             ("update", np.array([[2, 3]]), None), ("refine", exact),
             ("update", np.array([[6, 7]]), np.array([[3, 4]])), ("query",),
             ("cbds", 1)]
    return dict(n_nodes=8, refresh_every=10**9), steps


def _empty(rng):
    """Queries on an empty graph, a triangle, and deletion back to empty."""
    tri = np.array([[0, 1], [1, 2], [0, 2]])
    steps = [("query",), ("cbds", 1), ("update", tri, None), ("query",),
             ("refine", {}), ("update", None, tri), ("query",), ("cbds", 1),
             ("refresh",), ("update", np.array([[3, 3]]), np.array([[5, 6]])), ("query",)]
    return dict(n_nodes=20, refresh_every=3), steps


SCENARIOS = {"churn": _churn, "grow_shrink": _grow_shrink, "fallback": _fallback,
             "refine_skip": _refine_skip, "empty": _empty}


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------
def _same_query(got, want, where):
    assert _bits(got.density) == _bits(want.density), (where, got.density, want.density)
    assert got.passes == want.passes, where
    assert np.array_equal(got.mask, want.mask), where
    assert _bits(got.warm_density) == _bits(want.warm_density), where
    assert np.array_equal(got.warm_mask, want.warm_mask), where
    assert (got.refreshed, got.pruned, got.refine_rounds, got.certified_skip) == (
        want.refreshed, want.pruned, want.refine_rounds, want.certified_skip), where
    if want.certificate is None:
        assert got.certificate is None, where
    else:
        assert dataclasses.asdict(got.certificate) == dataclasses.asdict(
            want.certificate), where


def _same_cbds(got, want, where):
    assert set(got) == set(want), where
    for k in ("density", "core_density"):
        assert _bits(got[k]) == _bits(want[k]), (where, k)
    assert (got["k_star"], got["n_legit"]) == (want["k_star"], want["n_legit"]), where
    assert np.array_equal(got["member_mask"], want["member_mask"]), where


METRIC_FIELDS = [f.name for f in dataclasses.fields(tdelta.EngineMetrics)
                 if not f.name.endswith("_ms_total")]


def _same_state(t, j, where):
    """Metrics (but times and the first-call count), buffer, degrees and the
    engine's scalar state."""
    for name in METRIC_FIELDS:
        if name != "n_query_first_calls":
            assert getattr(t.metrics, name) == getattr(j.metrics, name), (where, name)
    assert t.n_edges == j.n_edges and t.buffer.capacity == j.buffer.capacity, where
    assert t.buffer.generation == j.buffer.generation, where
    assert t._staleness == j._staleness and t.stale == j.stale, where
    if j._deg is not None:
        assert np.array_equal(t._deg.numpy(), np.asarray(j._deg)), where
    assert np.array_equal(t._prev_mask.numpy(), np.asarray(j._prev_mask)), where


def _run(scenario, seed, port_kw, jax_kw):
    """Feed one stream to a port and a JAX engine, comparing after every
    step; returns the port engine."""
    cfg, steps = SCENARIOS[scenario](np.random.default_rng(seed))
    t = DeltaEngine(**cfg, device="cpu", **port_kw)
    j = JEngine(**cfg, **jax_kw)
    for i, step in enumerate(steps):
        where = f"{scenario} step {i} {step[0]}"
        if step[0] == "update":
            st_t = t.apply_updates(insert=step[1], delete=step[2])
            st_j = j.apply_updates(insert=step[1], delete=step[2])
            skip = {"latency_ms", "compiled"}
            assert ({k: v for k, v in dataclasses.asdict(st_t).items() if k not in skip}
                    == {k: v for k, v in dataclasses.asdict(st_j).items() if k not in skip}
                    ), where
        elif step[0] == "delete_most":
            pool = np.asarray(sorted(j.buffer._slot))
            for k in range(0, len(pool) - step[2], step[1]):
                chunk = pool[k:k + step[1]]
                assert t.apply_updates(delete=chunk).regrew == j.apply_updates(
                    delete=chunk).regrew, where
                _same_query(t.query(), j.query(), where)
        elif step[0] == "query":
            _same_query(t.query(), j.query(), where)
        elif step[0] == "refine":
            _same_query(t.query(refine=True, **step[1]), j.query(refine=True, **step[1]),
                        where)
        elif step[0] == "refresh":
            _same_query(t.refresh(), j.refresh(), where)
        elif step[0] == "cbds":
            _same_cbds(t.cbds(step[1]), j.cbds(step[1]), where)
        _same_state(t, j, where)
    return t, j


@pytest.mark.parametrize("kernel", [False, True], ids=["scatter", "kernel"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_matches_jax_every_step(scenario, kernel):
    t, j = _run(scenario, 7, {"kernel": kernel}, {"kernel": False})
    m = t.metrics
    # each stream reaches what it is there for
    if scenario == "churn":
        assert m.n_refreshes >= 2 and m.n_pruned_queries > 0 and m.n_refine_queries > 0
    elif scenario == "grow_shrink":
        assert m.n_buffer_shrinks == 1 and t.buffer.generation >= 4
    elif scenario == "fallback":
        assert m.n_prune_fallbacks == 2 and m.n_pruned_queries == 1  # after a regrow
    elif scenario == "refine_skip":
        assert m.n_certified_skips == 1 and m.n_refine_queries == 2
    elif scenario == "empty":
        assert t.n_edges == 0 and m.n_refreshes >= 1


def test_engine_matches_jax_with_pallas_kernel():
    """The port with its kernel on against JAX with its Pallas kernel on
    (interpret mode): a short churn stream, refined query and cbds."""
    cfg = dict(n_nodes=24, refresh_every=3)
    rng = np.random.default_rng(3)
    t = DeltaEngine(**cfg, device="cpu", kernel=True)
    j = JEngine(**cfg, kernel=True)
    for i in range(4):
        ins = _pairs(rng, 24, 20)
        dels = np.asarray(sorted(j.buffer._slot))[::3] if i else None
        t.apply_updates(insert=ins, delete=dels)
        j.apply_updates(insert=ins, delete=dels)
        _same_query(t.query(), j.query(), f"step {i}")
        _same_state(t, j, f"step {i}")
    _same_query(t.query(refine=True, max_refine_rounds=4),
                j.query(refine=True, max_refine_rounds=4), "refine")
    _same_cbds(t.cbds(), j.cbds(), "cbds")


# ---------------------------------------------------------------------------
# the sorted lanes: the trap of patching a sorted layout
# ---------------------------------------------------------------------------
def _engine_with_reused_slot():
    """A kernel-mode engine whose last batch reused a freed slot: the
    patched lanes hold a new dst at an old sorted position."""
    eng = DeltaEngine(16, refresh_every=10**9, pruned=False, kernel=True, device="cpu")
    eng.apply_updates(insert=np.array([[0, 1], [1, 2], [0, 2], [2, 3], [9, 10]]))
    eng.query()
    eng.apply_updates(delete=np.array([[0, 1]]), insert=np.array([[11, 14]]))
    return eng


def test_reused_slot_is_resorted_before_a_kernel_pass(monkeypatch):
    """Regression: an insert into a freed slot leaves dst unsorted. Without
    the re-sort, the kernel's plain version refuses the lanes (on the card
    the kernel would store a split row twice instead of summing it)."""
    eng = _engine_with_reused_slot()
    assert not eng._sorted and bool((eng._dst[1:] < eng._dst[:-1]).any())
    monkeypatch.setattr(DeltaEngine, "_resort", lambda self: None)
    with pytest.raises(ValueError, match="ascending"):
        eng.query()
    monkeypatch.undo()
    eng = _engine_with_reused_slot()
    q = eng.query()
    assert eng._sorted and bool((eng._dst[1:] >= eng._dst[:-1]).all())
    cold = DeltaEngine(16, pruned=False, kernel=False, device="cpu")
    cold.apply_updates(insert=np.array([[1, 2], [0, 2], [2, 3], [9, 10], [11, 14]]))
    want = cold.query()
    assert (_bits(q.density), q.passes) == (_bits(want.density), want.passes)
    assert np.array_equal(q.mask, want.mask)


def test_every_kernel_pass_sees_sorted_lanes(monkeypatch):
    """Every K2 hand-off of a churn stream with refreshes, pruned, refined
    queries and cbds ascends in dst (the plain version checks it too)."""
    seen = []

    def checked(src, dst, active, failed, **kw):
        seen.append(dst.numel())
        assert bool((dst[1:] >= dst[:-1]).all())
        return ref.peel_edges_ref(src, dst, active, failed, kw["n_nodes"],
                                  kw.get("charge", False))

    monkeypatch.setattr(peel, "peel_edges_sorted", checked)
    _run("churn", 11, {"kernel": True}, {"kernel": False})
    assert len(seen) > 50


def test_lane_perm_after_resort_matches_a_fresh_resync():
    """Patch, re-sort, patch again, re-sort: the lanes, degrees and
    ``lane_perm`` equal a resync from the host's sorted snapshot."""
    rng = np.random.default_rng(5)
    eng = DeltaEngine(64, capacity=512, refresh_every=10**9, pruned=False, kernel=True,
                      device="cpu")
    eng.apply_updates(insert=_pairs(rng, 64, 200))
    for _ in range(2):
        pool = np.asarray(sorted(eng.buffer._slot))
        eng.apply_updates(insert=_pairs(rng, 64, 30), delete=pool[rng.random(len(pool)) < 0.2])
        assert not eng._sorted
        eng._lanes()
    got = [x.clone() for x in (eng._src, eng._dst, eng._deg, eng._lane_perm)]
    eng._resync_device()
    src, dst, deg, perm = got
    # the same dst rows and degrees; within a row the order may differ, but
    # both lane_perms send every slot's two lanes to that slot's (u, v)
    assert torch.equal(dst, eng._dst) and torch.equal(deg, eng._deg)
    u, v = eng.buffer.host_view()
    cap = eng.buffer.capacity
    for lanes_src, lanes_dst, lp in ((src, dst, perm), (eng._src, eng._dst, eng._lane_perm)):
        s, d, p = lanes_src.numpy(), lanes_dst.numpy(), lp.numpy()
        assert np.array_equal(s[p[:cap]], u) and np.array_equal(d[p[:cap]], v)
        assert np.array_equal(s[p[cap:]], v) and np.array_equal(d[p[cap:]], u)
        assert np.array_equal(np.sort(p), np.arange(2 * cap))


def test_pruned_plans_carry_their_lane_width(monkeypatch):
    """The resident prep's fallback lane width (``2*(n_edges+1)``) differs
    from the host prep's (``2*capacity``), but it is read only for a plan
    with no sizing basis; every plan the engine hands the prep carries
    ``lane_width = 2*capacity``, so it is never read."""
    calls = []
    real = tprune._fit_plan

    def recorded(plan, n_v1, lanes1, node_width, lane_width):
        calls.append((plan.node_width, plan.lane_width))
        return real(plan, n_v1, lanes1, node_width, lane_width)

    monkeypatch.setattr(tprune, "_fit_plan", recorded)
    t, _ = _run("churn", 7, {"kernel": False}, {"kernel": False})
    assert calls and all(nw == t.node_capacity and lw > 0 for nw, lw in calls)
    assert {lw for _, lw in calls} <= {2 * c for c in (256, 512, 1024)}


# ---------------------------------------------------------------------------
# the buffer, the entry point's contract, the stream file format
# ---------------------------------------------------------------------------
def _same_buffer(t, j, node_capacity):
    for a, b in zip(t.host_view(), j.host_view()):
        assert np.array_equal(a, b)
    for a, b in zip(t.device_view(), j.device_view()):
        assert np.array_equal(a, b)
    for a, b in zip(t.resident_state(node_capacity), j.resident_state(node_capacity)):
        assert np.array_equal(a, b)
    for a, b in zip(t.dst_sorted_state(node_capacity), j.dst_sorted_state(node_capacity)):
        assert np.array_equal(a, b)
    assert (t.generation, t.capacity, t.n_edges, t.tombstone_fraction) == (
        j.generation, j.capacity, j.n_edges, j.tombstone_fraction)
    assert sorted(t._slot.items()) == sorted(j._slot.items())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_buffer_matches_jax_every_step(seed):
    """Inserts with duplicates and self-loops, deletes of present and absent
    edges, growth, the tombstone autocompact and the epoch shrink."""
    rng = np.random.default_rng(seed)
    n = 64
    t, j = EdgeBuffer(n, capacity=256), JBuffer(n, capacity=256)
    for i in range(14):
        ins = _pairs(rng, n, int(rng.integers(0, 200))) if i < 8 or i % 3 == 0 else None
        pool = np.asarray(sorted(j._slot)) if j._slot else np.zeros((0, 2), np.int64)
        dels = np.concatenate([pool[rng.random(len(pool)) < (0.1 if i < 8 else 0.6)],
                               _pairs(rng, n, 3)]) if i else None
        for a, b in zip(t.apply(ins, dels), j.apply(ins, dels)):
            assert np.array_equal(a, b) and a.dtype == b.dtype
        _same_buffer(t, j, 64)
        if i % 5 == 4:
            assert t.epoch_compact(shrink=True) == j.epoch_compact(shrink=True)
            _same_buffer(t, j, 64)
    assert t.to_graph().n_edges == j.to_graph().n_edges
    assert np.array_equal(t.to_graph().src, j.to_graph().src)


def test_engine_entry_contract(monkeypatch):
    """``device=None`` means CUDA and raises without it, sharded or not; a
    sharded engine (``sharded=True`` or ``mesh=``) takes its mesh's device,
    refuses another, and stays on the scatter tier as the JAX package's
    does."""
    from repro_torch.core.distributed import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"sharded": True}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeltaEngine(8, **kw)
    mesh = make_mesh(device="cpu")
    for kw in ({"sharded": True, "device": "cpu"}, {"mesh": mesh}):
        eng = DeltaEngine(8, kernel=True, **kw)
        assert (eng.sharded, eng.n_shards, eng.kind, eng.kernel) == (True, 1, "sharded", False)
        assert eng.device == torch.device("cpu")
    with pytest.raises(ValueError, match="not the mesh's device"):
        DeltaEngine(8, mesh=mesh, device="meta")
    assert DeltaEngine(8, device="cpu").kernel is False
    assert DeltaEngine(8, device="cpu", kernel=True).kernel is True


def test_edge_stream_io_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    events = [("+" if rng.random() < 0.7 else "-", int(u), int(v))
              for u, v in _pairs(rng, 30, 200)]
    path = str(tmp_path / "s" / "events.txt")
    save_edge_stream(events, path)
    with open(path, "a") as f:
        f.write("3 4\n# a comment\n")
    got, want = list(load_edge_stream(path, 16)), list(j_load_stream(path, 16))
    assert len(got) == len(want) > 10
    for (gi, gd), (wi, wd) in zip(got, want):
        assert np.array_equal(gi, wi) and np.array_equal(gd, wd)
    with pytest.raises(ValueError):
        save_edge_stream([("*", 1, 2)], path)
