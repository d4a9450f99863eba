"""The port's fused multi-tenant layer (``repro_torch.stream``: ``fused``,
``registry``, ``service``) against the JAX package's, on the CPU.

Every stream is fed to a port ``FusedEngine`` (kernel off, and kernel on
through the plain versions of K1-K4 and of K1's and K2's rows entries), to
a JAX ``FusedEngine`` (``kernel=False``) and to a solo port ``DeltaEngine``;
after every step the query triples must match bit for bit (the f32 bits of
the density, the mask, the passes), with ``warm_density``/``warm_mask``,
``refreshed``, ``pruned`` and, in fixed-round mode, the certificates'
integers, and the bucket rows' degrees and warm-seed masks must equal the
JAX stacks'. These are the JAX package's tests of ``tests/test_tenants.py``,
its registry and service tests of ``tests/test_stream.py`` and
``tests/test_refine.py:test_fused_refine_parity_dense_and_sparse``, each held
to the JAX package as well as to its own claim; the fused+sharded stacks are
held to it in tests/test_torch_shard.py and tests/test_torch_distributed.py.
Every input comes from a numpy seed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.stream import FusedEngine as JFused  # noqa: E402
from repro.stream import FusedPool as JPool  # noqa: E402
from repro.stream import StreamService as JService  # noqa: E402
from repro.stream import ingest_group as j_ingest_group  # noqa: E402
from repro.stream import query_group as j_query_group  # noqa: E402
from repro_torch.core import pbahmani_np  # noqa: E402
from repro_torch.core import prune as tprune  # noqa: E402
from repro_torch.stream import (  # noqa: E402
    DeltaEngine, FusedEngine, FusedPool, GraphRegistry, StreamService, ingest_group,
    query_group,
)
from repro_torch.stream import fused as tfused  # noqa: E402
from repro_torch.stream.fused import DENSE_NODE_CAP, MIN_LANES  # noqa: E402

KERNEL = pytest.mark.parametrize("kernel", [False, True], ids=["scatter", "kernel"])


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


def _same(got, want, where, warm=True):
    assert _bits(got.density) == _bits(want.density), (where, got.density, want.density)
    assert got.passes == want.passes, (where, got.passes, want.passes)
    assert np.array_equal(np.asarray(got.mask), np.asarray(want.mask)), where
    if warm:
        assert _bits(got.warm_density) == _bits(want.warm_density), where
        assert np.array_equal(np.asarray(got.warm_mask), np.asarray(want.warm_mask)), where
        assert (got.refreshed, got.pruned) == (want.refreshed, want.pruned), where
    if want.certificate is not None:
        assert dataclasses.asdict(got.certificate) == dataclasses.asdict(want.certificate)
        assert (got.refine_rounds, got.certified_skip) == (want.refine_rounds,
                                                           want.certified_skip)


def _same_rows(t: FusedEngine, j, where):
    """The port's bucket row equals the JAX stack's: degrees, warm seed."""
    jb = j.batch
    assert np.array_equal(t.batch._deg[t._lane].numpy(), np.asarray(jb._deg[j._lane])), where
    assert np.array_equal(t.batch._prev_mask[t._lane].numpy(),
                          np.asarray(jb._prev_mask[j._lane])), where


def _sorted_rows(batch):
    """Kernel mode: every row of the stack that holds a tenant ascends in dst."""
    if not batch.kernel:
        return True
    return all(bool((batch._dst[lane][1:] >= batch._dst[lane][:-1]).all())
               for lane in batch.lane_of.values() if not batch._unsorted[lane])


def _churn(rng, n, edges, max_ins=50):
    ins = rng.integers(0, n, (int(rng.integers(1, max_ins)), 2))
    dels = None
    if edges and rng.random() < 0.6:
        pool = np.asarray(sorted(edges))
        dels = pool[rng.random(len(pool)) < 0.3]
        for u, v in dels:
            edges.discard((int(u), int(v)))
    for u, v in ins:
        u, v = int(u), int(v)
        if u != v:
            edges.add((min(u, v), max(u, v)))
    return ins, dels


class Trio:
    """The same tenants three ways: port fused, JAX fused, port solo."""

    def __init__(self, names, n, kernel, **kw):
        self.pool, self.jpool = FusedPool(), JPool()
        self.t = {k: FusedEngine(k, self.pool, n, kernel=kernel, device="cpu", **kw)
                  for k in names}
        self.j = {k: JFused(k, self.jpool, n, kernel=False, **kw) for k in names}
        self.s = {k: DeltaEngine(n, kernel=kernel, device="cpu", **kw) for k in names}

    def ingest(self, updates, where):
        st_t = ingest_group(updates, self.t)
        st_j = j_ingest_group(updates, self.j)
        for k, (ins, dels) in updates.items():
            st_s = self.s[k].apply_updates(insert=ins, delete=dels)
            skip = {"latency_ms", "compiled"}
            for st in (st_t[k], st_j[k]):
                assert ({a: b for a, b in dataclasses.asdict(st).items() if a not in skip}
                        == {a: b for a, b in dataclasses.asdict(st_s).items()
                            if a not in skip}), where

    def query(self, where, **kw):
        got, want = query_group(self.t, **kw), j_query_group(self.j, **kw)
        for k in self.t:
            solo = self.s[k].query(**kw)
            _same(got[k], want[k], (where, k))
            _same(got[k], solo, (where, k, "solo"))
            _same_rows(self.t[k], self.j[k], (where, k))
        for b in self.pool.batches.values():
            assert _sorted_rows(b), where
        return got


# ---------------------------------------------------------------------------
# bit-identity: fused == JAX fused == solo
# ---------------------------------------------------------------------------
@KERNEL
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_matches_unbatched_stream(seed, kernel):
    """After any insert/delete sequence, epoch refreshes included, a fused
    tenant's single query equals the JAX fused tenant's and the solo
    engine's, pruned and unpruned."""
    rng = np.random.default_rng(seed)
    n = 150
    for pruned in (False, True):
        trio = Trio([f"t{pruned}"], n, kernel, refresh_every=4, pruned=pruned)
        (name,) = trio.t
        edges: set = set()
        for step in range(8):
            ins, dels = _churn(rng, n, edges)
            for eng in (trio.t[name], trio.j[name], trio.s[name]):
                eng.apply_updates(insert=ins, delete=dels)
            q, qj, qs = trio.t[name].query(), trio.j[name].query(), trio.s[name].query()
            _same(q, qj, (pruned, step))
            _same(q, qs, (pruned, step, "solo"))
            _same_rows(trio.t[name], trio.j[name], (pruned, step))


@KERNEL
def test_fused_group_query_parity_and_lane_growth(kernel):
    """A group flush answers every tenant bit-identically to its own solo
    twin and to JAX; growing past MIN_LANES keeps the resident rows."""
    rng = np.random.default_rng(1)
    n = 120
    names = [f"t{i}" for i in range(MIN_LANES + 2)]  # forces one stack growth
    trio = Trio(names, n, kernel, refresh_every=10**9)
    trio.ingest({k: (rng.integers(0, n, (60 + 10 * i, 2)), None)
                 for i, k in enumerate(names)}, "seed")
    assert trio.t["t0"].batch.lanes > MIN_LANES
    results = trio.query("group")
    again = query_group(trio.t)  # memoized: the same objects
    assert all(again[k] is results[k] for k in names)


@KERNEL
def test_fused_sparse_bucket_parity(kernel):
    """Vertex spaces above DENSE_NODE_CAP peel on the lanes (K2's rows
    entry with the kernel), not the dense products: same contract."""
    rng = np.random.default_rng(2)
    n = DENSE_NODE_CAP + 10  # node capacity 1024
    trio = Trio(["big", "big2"], n, kernel, refresh_every=10**9, pruned=False)
    trio.ingest({"big": (rng.integers(0, n, (800, 2)), None),
                 "big2": (rng.integers(0, n, (300, 2)), None)}, "seed")
    assert not trio.t["big"].batch.dense
    trio.query("sparse")
    _same(trio.t["big"].query(), trio.s["big"].query(), "single")


def test_fused_sharded_is_not_ported():
    """The name is kept from when the port refused fused+sharded stacks; it
    now checks the opposite. The JAX package's fused+sharded stacks build
    through every way in: a sharded bucket has no
    dense stack, holds its rank's block of the lanes (all of them on a mesh
    of one), and is a bucket of its own beside the unsharded one. Their
    results are held to JAX in tests/test_torch_shard.py and, over 2 and 4
    ranks, tests/test_torch_distributed.py."""
    from repro_torch.core.distributed import make_mesh

    mesh = make_mesh(device="cpu")
    eng = FusedEngine("a", FusedPool(), 50, sharded=True, device="cpu")
    assert (eng.kind, eng.sharded, eng.kernel, eng.n_shards) == ("fused+sharded", True, False, 1)
    reg = GraphRegistry(fused=True, sharded=True, device="cpu")
    assert reg.register("a", n_nodes=50).kind == "fused+sharded"
    batch = tfused.TenantBatch(64, 256, 0.0, device="cpu", mesh=mesh)
    assert batch.sharded and not batch.dense and tuple(batch._src.shape) == (MIN_LANES, 512)
    reg = GraphRegistry(fused=True, device="cpu")
    b, c = reg.register("b", n_nodes=50, sharded=True), reg.register("c", n_nodes=50)
    assert b.kind == "fused+sharded" and c.kind == "fused"
    for eng in (b, c):
        eng.apply_updates(insert=np.array([[0, 1], [1, 2], [0, 2]]))
    assert b.mesh == reg.mesh and b.batch.sharded and not c.batch.sharded
    assert b.query().density == c.query().density == 1.0


@KERNEL
def test_fused_capacity_migration_rebuckets(kernel):
    """A buffer regrow moves the tenant to the matching capacity bucket
    (evict + join) with exact results on the other side."""
    rng = np.random.default_rng(3)
    n = 100
    trio = Trio(["grow"], n, kernel, capacity=256, refresh_every=10**9)
    trio.ingest({"grow": (rng.integers(0, n, (60, 2)), None)}, "seed")
    trio.query("first")
    first = trio.t["grow"].batch
    trio.ingest({"grow": (rng.integers(0, n, (2000, 2)), None)}, "big")
    fe = trio.t["grow"]
    assert fe.buffer.capacity > 256 and fe.batch is not first
    assert "grow" not in first.lane_of
    rho, mask, passes = pbahmani_np(fe.buffer.to_graph())
    q = trio.query("migrated")["grow"]
    assert q.density == pytest.approx(rho, rel=1e-6, abs=1e-9)
    assert np.array_equal(q.mask, mask[:n]) and q.passes == passes


@KERNEL
def test_fused_join_evict_zero_recompiles(kernel):
    """Tenant churn in a warm bucket is a row write: evict one tenant, join
    another, ingest and query — nothing is built (no kernel library loaded,
    the auditor's count flat), the freed row is reused, and every answer
    still equals the solo engine's."""
    rng = np.random.default_rng(4)
    n = 100
    pool = FusedPool()
    fused, solo = {}, {}
    for i in range(4):
        f = FusedEngine(f"t{i}", pool, n, refresh_every=10**9, pruned=False, kernel=kernel,
                        device="cpu")
        s = DeltaEngine(n, refresh_every=10**9, pruned=False, kernel=kernel, device="cpu")
        e = rng.integers(0, n, (48, 2))
        f.apply_updates(insert=e)
        s.apply_updates(insert=e)
        fused[f"t{i}"], solo[f"t{i}"] = f, s
    query_group(fused)
    before = DeltaEngine.compile_count()
    lane = fused["t1"]._lane
    fused.pop("t1").release()
    solo.pop("t1")
    nf = FusedEngine("t9", pool, n, refresh_every=10**9, pruned=False, kernel=kernel,
                     device="cpu")
    assert nf.batch is None
    e = rng.integers(0, n, (48, 2))
    nf.apply_updates(insert=e)
    assert nf._lane == lane  # the freed row
    fused["t9"] = nf
    solo["t9"] = DeltaEngine(n, refresh_every=10**9, pruned=False, kernel=kernel,
                             device="cpu")
    solo["t9"].apply_updates(insert=e)
    upd = {k: (rng.integers(0, n, (20, 2)), None) for k in fused}
    ingest_group(upd, fused)
    for k, (ins, _) in upd.items():
        solo[k].apply_updates(insert=ins)
    res = query_group(fused)
    for k in fused:
        _same(res[k], solo[k].query(), k)
    assert DeltaEngine.compile_count() == before, "join/evict loaded a kernel library"


@KERNEL
def test_fused_ingest_group_parity(kernel):
    """One fused patch applies many tenants' batches with the same outcome
    as per-tenant dispatch (UpdateStats, rows, answers)."""
    rng = np.random.default_rng(5)
    n = 90
    names = ["t0", "t1", "t2"]
    trio = Trio(names, n, kernel, refresh_every=10**9)
    trio.ingest({k: (rng.integers(0, n, (40, 2)), None) for k in names}, "seed")
    upd = {k: (rng.integers(0, n, (25, 2)), np.asarray(sorted(trio.s[k].buffer._slot))[:5])
           for k in names}
    trio.ingest(upd, "churn")
    trio.query("after")


def test_dense_ingest_is_one_dispatch(monkeypatch):
    """The dense-bucket ingest patches the lanes, degrees and adjacency in
    one ``_batched_apply`` a batch, and the adjacency stays exact."""
    calls = []
    real = tfused._batched_apply
    monkeypatch.setattr(tfused, "_batched_apply",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    rng = np.random.default_rng(9)
    n = 80
    trio = Trio(["t0"], n, False, refresh_every=10**9)
    trio.ingest({"t0": (rng.integers(0, n, (60, 2)), None)}, "seed")
    eng = trio.t["t0"]
    assert eng.batch.dense
    d0, calls[:] = eng.batch.n_ingest_dispatches, []
    for i in range(3):
        pool = np.asarray(sorted(trio.s["t0"].buffer._slot))
        trio.ingest({"t0": (rng.integers(0, n, (16, 2)), pool[:3])}, f"b{i}")
    assert calls == [1] * 3 and eng.batch.n_ingest_dispatches == d0 + 3
    assert eng.batch.n_ingests == eng.batch.n_ingest_dispatches
    u, v = eng.buffer.host_view()
    adj = np.zeros((eng.node_capacity, eng.node_capacity), np.float32)
    live = u < eng.node_capacity
    np.add.at(adj, (u[live], v[live]), 1.0)
    np.add.at(adj, (v[live], u[live]), 1.0)
    assert np.array_equal(eng.batch._adj[eng._lane].numpy(), adj)
    trio.query("after")


def test_ingest_group_partial_failure_stays_consistent():
    """A failing tenant mid-ingest must not leave earlier tenants' rows
    stale: their host buffers committed, so their staged rows dispatch."""
    svc = StreamService(fused=True, device="cpu")
    svc.create_tenant("good", n_nodes=20)
    svc.create_tenant("bad", n_nodes=10)
    svc.apply_updates("good", insert=np.array([[0, 1], [1, 2], [0, 2]]))
    svc.density("good")
    r = svc.ingest_many({
        "good": (np.array([[2, 3], [3, 4]]), None),
        "bad": (np.array([[0, 99]]), None),   # endpoint out of range
    })
    assert not r.ok and "out of range" in r.error
    d = svc.density("good")
    rho, mask, passes = pbahmani_np(svc.registry.get("good").buffer.to_graph())
    assert d.ok and d.value["density"] == pytest.approx(rho)
    m = svc.membership("good")
    assert np.array_equal(m.value["mask"], mask[:20])


def test_flush_survives_engine_failure():
    """A tenant whose query raises at flush time must not orphan the other
    pending tickets: every ticket gets a response."""
    svc = StreamService(fused=True, coalesce_window_ms=1e9, device="cpu")
    svc.create_tenant("ok", n_nodes=20)
    svc.apply_updates("ok", insert=np.array([[0, 1], [1, 2], [0, 2]]))
    svc.create_tenant("boom", n_nodes=20)
    eng = svc.registry.get("boom")

    def explode():
        raise ValueError("engine exploded")

    eng._resync_device = explode
    t_ok = svc.submit_density("ok")
    t_boom = svc.submit_density("boom")
    assert svc.flush() == 2
    r_ok, r_boom = svc.poll(t_ok), svc.poll(t_boom)
    assert r_ok is not None and r_ok.ok
    assert r_ok.value["density"] == pytest.approx(1.0)
    assert r_boom is not None and not r_boom.ok
    assert "exploded" in r_boom.error


def test_group_helpers_accept_unbatched_engines():
    """query_group / ingest_group route plain DeltaEngines through their own
    paths, so mixed fused/unfused registries work."""
    plain = DeltaEngine(n_nodes=30, refresh_every=10**9, device="cpu")
    plain.apply_updates(insert=np.array([[0, 1], [1, 2], [0, 2]]))
    fe = FusedEngine("f", FusedPool(), 30, refresh_every=10**9, device="cpu")
    fe.apply_updates(insert=np.array([[4, 5]]))
    res = query_group({"plain": plain, "f": fe})
    assert res["plain"].density == pytest.approx(1.0)
    assert res["f"].density == pytest.approx(0.5)
    stats = ingest_group({"plain": (np.array([[2, 3]]), None),
                          "f": (np.array([[5, 6]]), None)},
                         {"plain": plain, "f": fe})
    assert stats["plain"].n_inserted == 1 and stats["f"].n_inserted == 1


# ---------------------------------------------------------------------------
# the stack: rows stay rows of it, sorted where the kernels read them
# ---------------------------------------------------------------------------
N_LANES = DENSE_NODE_CAP + 88  # a lane bucket: its passes reach K2


def _reused_slot_engine():
    """A kernel-mode fused tenant (beside another in its bucket) whose last
    batch reused a freed slot: its row holds a new dst at an old sorted
    position."""
    pool = FusedPool()
    eng = FusedEngine("a", pool, N_LANES, refresh_every=10**9, pruned=False, kernel=True,
                      device="cpu")
    other = FusedEngine("b", pool, N_LANES, refresh_every=10**9, pruned=False, kernel=True,
                        device="cpu")
    other.apply_updates(insert=np.array([[3, 4]]))
    eng.apply_updates(insert=np.array([[0, 1], [1, 2], [0, 2], [2, 3], [9, 10]]))
    eng.query()
    eng.apply_updates(delete=np.array([[0, 1]]), insert=np.array([[11, 14]]))
    return eng


def _in_stack(t: torch.Tensor, stack: torch.Tensor) -> bool:
    lo = stack.data_ptr()
    return lo <= t.data_ptr() < lo + stack.numel() * stack.element_size()


def test_fused_resort_writes_into_the_stack():
    """Regression guard for the views trap: a FusedEngine's lanes are its
    row of the bucket's stacks. A re-sort (the engine's own, and the
    inherited DeltaEngine one through the row properties) must leave the
    stack's row sorted, not a tensor outside it, or the next flush would peel
    the stale unsorted row (the plain K2 refuses it)."""
    for resort in (FusedEngine._resort, DeltaEngine._resort):
        eng = _reused_slot_engine()
        b, lane = eng.batch, eng._lane
        assert not eng._sorted and bool((b._dst[lane][1:] < b._dst[lane][:-1]).any())
        resort(eng)
        assert eng._sorted and not b._unsorted[lane]
        assert bool((b._dst[lane][1:] >= b._dst[lane][:-1]).all())
        for name in ("_src", "_dst", "_deg", "_prev_mask", "_lane_perm"):
            assert _in_stack(getattr(eng, name), getattr(b, name)), name
        cold = DeltaEngine(N_LANES, pruned=False, device="cpu")
        cold.apply_updates(insert=np.array([[1, 2], [0, 2], [2, 3], [9, 10], [11, 14]]))
        _same(eng.query(), cold.query(), "after the re-sort", warm=False)
    # a stack growth re-allocates the stacks: the rows follow
    eng = _reused_slot_engine()
    old = eng.batch._src
    for i in range(MIN_LANES):
        FusedEngine(f"x{i}", eng.pool, N_LANES, pruned=False, kernel=True,
                    device="cpu").apply_updates(insert=np.array([[1, 5]]))
    assert eng.batch._src is not old and _in_stack(eng._src, eng.batch._src)
    cold = DeltaEngine(N_LANES, pruned=False, device="cpu")
    cold.apply_updates(insert=np.array([[1, 2], [0, 2], [2, 3], [9, 10], [11, 14]]))
    _same(eng.query(), cold.query(), "after the growth", warm=False)


def test_fused_unsorted_row_is_refused_by_the_kernel(monkeypatch):
    """Without the re-sort the flush hands K2 an unsorted row, and its plain
    version refuses it: the precondition the batch's dirty flags protect."""
    eng = _reused_slot_engine()
    monkeypatch.setattr(tfused.TenantBatch, "resort", lambda self, lanes: None)
    with pytest.raises(ValueError, match="ascending"):
        eng.query()


def test_fused_rows_sorted_at_every_kernel_pass(monkeypatch):
    """Every rows hand-off to K2 in a churn stream with pruned and warm
    tenants and refreshes ascends in dst, and inside a flush every pass is a
    rows call for the group (no single-row pass, whatever the group size;
    the single-row edge stages left are the plan's k-core iterations)."""
    import importlib

    tpb = importlib.import_module("repro_torch.core.pbahmani")
    tloads = importlib.import_module("repro_torch.refine.loads")

    from repro_torch.core import batched as tbatched

    seen, single, in_flush = [], [], [False]

    real = tbatched.peel_edges_rows

    def rows(src, dst, *a, **k):
        assert bool((dst[:, 1:] >= dst[:, :-1]).all())
        seen.append(src.shape[0])
        return real(src, dst, *a, **k)

    def counted(real_fn):
        def fn(*a, **k):
            if in_flush[0]:
                single.append(1)
            return real_fn(*a, **k)
        return fn

    real_flush = tfused._flush

    def flush(*a, **k):
        in_flush[0] = True
        try:
            return real_flush(*a, **k)
        finally:
            in_flush[0] = False

    monkeypatch.setattr(tbatched, "peel_edges_rows", rows)
    monkeypatch.setattr(tpb, "peel_edges", counted(tpb.peel_edges))
    monkeypatch.setattr(tloads, "peel_edges", counted(tloads.peel_edges))
    monkeypatch.setattr(tfused, "_flush", flush)
    rng = np.random.default_rng(21)
    n = 700
    names = [f"t{i}" for i in range(5)]
    trio = Trio(names, n, True, refresh_every=3, pruned=True)
    trio.t["t3"].pruned = trio.j["t3"].pruned = trio.s["t3"].pruned = False
    edge_sets = {k: set() for k in names}
    for step in range(5):
        trio.ingest({k: _churn(rng, n, edge_sets[k], 200) for k in names}, step)
        trio.query(step)
    trio.query("refine", refine=True, target_gap=-1.0, max_refine_rounds=3)
    assert seen and max(seen) >= 2 and not single


# ---------------------------------------------------------------------------
# refinement
# ---------------------------------------------------------------------------
@KERNEL
def test_fused_refine_parity_dense_and_sparse(kernel):
    """Fixed-round group refinement == per-tenant solo refinement == JAX,
    bit for bit, on a dense (batched products) bucket and a sparse (K2 rows)
    one."""
    rng = np.random.default_rng(1)
    for n_nodes, capacity in ((96, 256), (1024, 4096)):
        names = ["t0", "t1", "t2"]
        trio = Trio(names, n_nodes, kernel, capacity=capacity, refresh_every=10**9)
        trio.ingest({k: (rng.integers(0, n_nodes, (4 * n_nodes, 2)), None) for k in names},
                    "seed")
        assert trio.t["t0"].batch.dense == (n_nodes == 96)
        trio.query("refine", refine=True, target_gap=-1.0, max_refine_rounds=7)


def test_dense_refuses_reduced_precision_products():
    """The dense passes count edges with float32 products: they refuse to
    run in TF32."""
    eng = FusedEngine("d", FusedPool(), 40, refresh_every=10**9, pruned=False, device="cpu")
    eng.apply_updates(insert=np.array([[0, 1], [1, 2], [0, 2]]))
    assert eng.batch.dense
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            eng.query()
    finally:
        torch.set_float32_matmul_precision(prev)
    assert eng.query().density == pytest.approx(1.0)


def test_dense_round_equals_lane_round():
    """One refinement round off a dense adjacency (``dense_refine_round_body``,
    the JAX package's, as a group of one) equals the lane round
    (``_refine_round``) on the same graph and seed state, output for output,
    over rounds."""
    from repro_torch.refine import loads

    rng = np.random.default_rng(6)
    v = 64
    eng = DeltaEngine(v, refresh_every=10**9, pruned=False, device="cpu")
    eng.apply_updates(insert=rng.integers(0, v, (300, 2)))
    src, dst = eng._lanes()
    adj = torch.zeros((v, v))
    live = src < v
    adj.index_put_((src[live].long(), dst[live].long()), torch.ones(int(live.sum())),
                   accumulate=True)
    i32 = torch.int32
    state = (torch.zeros(v, dtype=i32), torch.tensor(0.5), torch.tensor(1, dtype=i32),
             torch.tensor(2, dtype=i32), torch.zeros(v, dtype=torch.bool),
             torch.tensor(3, dtype=i32))
    dense, lane = state, state
    ne = torch.tensor(eng.n_edges, dtype=i32)
    for _ in range(3):
        dense = loads.dense_refine_round_body(adj, eng._deg, ne, *dense, 0.1)
        lane = loads._refine_round(src, dst, eng._deg, ne, *lane, v, 0.1)
        for a, b in zip(dense, lane):
            assert torch.equal(a, b)
    assert int(dense[5]) > 3 and bool(dense[0].any())


@KERNEL
def test_batched_bucket_peel_rows_equal_single(kernel):
    """The row-batched resident prep and bucket peel equal their single-row
    versions row for row, fitting, refused (no bucket) and empty rows."""
    from repro_torch.graphs.generators import planted_dense

    rng = np.random.default_rng(8)
    rows, plans, n_edges = [], [], []
    for i in range(4):
        g, _, _ = planted_dense(600, 40, 0.01, 0.9, seed=i)
        eng = DeltaEngine(g.n_nodes, capacity=4096, refresh_every=10**9, kernel=kernel,
                          device="cpu")
        if i < 3:
            eng.apply_updates(insert=np.stack([g.src[:g.n_edges], g.dst[:g.n_edges]], 1))
        else:
            eng.apply_updates(insert=rng.integers(0, 600, (5, 2)))
            eng.apply_updates(delete=np.asarray(sorted(eng.buffer._slot)))
        eng._rebuild_plan()
        plan = eng._plan if i != 1 else dataclasses.replace(
            eng._plan, bucket_v=64, bucket_e=256, node_width=64, lane_width=256)
        src, dst = eng._lanes() if kernel else (torch.from_numpy(
            eng.buffer.dst_sorted_state(eng.node_capacity)[0]), torch.from_numpy(
            eng.buffer.dst_sorted_state(eng.node_capacity)[1]))
        rows.append((src, dst))
        plans.append(plan)
        n_edges.append(eng.n_edges)
    v = 1024
    src = torch.stack([r[0] for r in rows])
    dst = torch.stack([r[1] for r in rows])
    got = tprune.prepare_pruned_peel_rows(src, dst, v, n_edges, 0.1, plans, kernel)
    want = [tprune.prepare_pruned_peel_resident(src[i], dst[i], v, n_edges[i], 0.1, plans[i],
                                                kernel) for i in range(4)]
    assert got[1] is None and want[1] is None
    assert isinstance(got[3], tuple) and got[3][2] == 0
    for a, b in zip(got, want):
        if isinstance(b, tprune.PrunedDispatch):
            for f in ("b_src", "b_dst", "perm", "a1", "active0"):
                assert torch.equal(getattr(a, f), getattr(b, f)), f
            assert (a.n_v1, a.n_e1, a.best_d1, a.better1, a.observed, a.plan) == (
                b.n_v1, b.n_e1, b.best_d1, b.better1, b.observed, b.plan)
    pds = [got[0], got[2]]
    assert all(isinstance(p, tprune.PrunedDispatch) for p in pds)
    plan = pds[0].plan
    pds[1] = tprune.prepare_pruned_peel_resident(src[2], dst[2], v, n_edges[2], 0.1, plan,
                                                 kernel)
    assert pds[1].plan.buckets == plan.buckets
    d, m, p = tprune._batched_bucket_peel(
        torch.stack([x.b_src for x in pds]), torch.stack([x.b_dst for x in pds]),
        torch.tensor([x.n_v1 for x in pds], dtype=torch.int32),
        torch.tensor([x.n_e1 for x in pds], dtype=torch.int32),
        torch.tensor([x.best_d1 for x in pds], dtype=torch.float32),
        torch.ones(2, dtype=torch.int32), 0.1, *plan.buckets, kernel)
    for i, x in enumerate(pds):
        d1, m1, p1 = tprune._bucket_peel(x.b_src, x.b_dst, x.n_v1, x.n_e1, float(x.best_d1),
                                         1, 0.1, *plan.buckets, kernel)
        assert _bits(d[i]) == _bits(d1) and int(p[i]) == int(p1) and torch.equal(m[i], m1)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def test_registry_fused_roster_and_conflicts():
    reg = GraphRegistry(fused=True, max_tenants=2, device="cpu")
    a = reg.register("a", n_nodes=100)
    assert isinstance(a, FusedEngine)
    a.apply_updates(insert=np.array([[0, 1], [1, 2]]))
    a.query()
    st_ = reg.stats("a")
    assert st_.fused and st_.lane >= 0 and st_.batch_lanes >= MIN_LANES
    assert st_.placement == "fused" and not st_.sharded
    with pytest.raises(ValueError, match="fused"):
        reg.register("a", n_nodes=100, fused=False)
    # LRU eviction releases the lane back to the bucket
    batch = a.batch
    reg.register("c", n_nodes=100)
    reg.get("c")
    reg.register("d", n_nodes=100)  # evicts "a" (LRU)
    assert "a" not in reg and "a" not in batch.lane_of
    d = reg.get("d")
    reg.remove("d")
    assert d.batch is None


def test_registry_register_get_lru_eviction():
    reg = GraphRegistry(max_tenants=2, device="cpu")
    reg.register("a", n_nodes=100)
    reg.register("b", n_nodes=200)
    reg.get("a")                      # touch: b becomes LRU
    reg.register("c", n_nodes=300)    # evicts b
    assert "a" in reg and "c" in reg and "b" not in reg
    assert reg.evictions == 1
    with pytest.raises(KeyError):
        reg.get("b")


def test_registry_reregister_conflict():
    reg = GraphRegistry(device="cpu")
    reg.register("t", n_nodes=100)
    assert reg.register("t", n_nodes=100) is reg.get("t")  # idempotent
    with pytest.raises(ValueError, match="already registered"):
        reg.register("t", n_nodes=5000)
    with pytest.raises(ValueError, match="already registered"):
        reg.register("t", n_nodes=100, kernel=True)
    svc = StreamService(device="cpu")
    svc.create_tenant("t", n_nodes=100)
    r = svc.create_tenant("t", n_nodes=5000)
    assert not r.ok and "already registered" in r.error


@KERNEL
def test_registry_bucketing_shares_buckets(kernel):
    """Tenants bucketed to the same capacities share one lane stack and
    load nothing new (the JAX package's shared-executables test: here, no
    kernel library load and one TenantBatch)."""
    rng = np.random.default_rng(13)
    reg = GraphRegistry(max_tenants=8, fused=True, kernel=kernel, device="cpu")
    a = reg.register("a", n_nodes=500, capacity=2048)
    a.apply_updates(insert=rng.integers(0, 500, (40, 2)))
    a.query()
    before = DeltaEngine.compile_count()
    for name, n in (("b", 400), ("c", 300), ("d", 257)):
        e = reg.register(name, n_nodes=n, capacity=2048)  # all bucket to 512
        assert e.node_capacity == 512
        e.apply_updates(insert=rng.integers(0, n, (40, 2)))
        e.query()
    assert DeltaEngine.compile_count() == before
    assert len(reg.fused_pool.batches) == 1


def test_registry_stats():
    reg = GraphRegistry(device="cpu")
    eng = reg.register("t", n_nodes=100)
    eng.apply_updates(insert=np.array([[0, 1], [1, 2]]))
    eng.query()
    st_ = reg.stats("t")
    assert st_.n_edges == 2 and st_.n_update_batches == 1
    assert st_.n_queries == 1 and st_.node_capacity == 128
    assert st_.placement == "solo" and st_.kernel is False


# ---------------------------------------------------------------------------
# service
# ---------------------------------------------------------------------------
def test_service_end_to_end():
    svc = StreamService(max_tenants=4, device="cpu")
    assert svc.create_tenant("us", n_nodes=100).ok
    assert svc.create_tenant("eu", n_nodes=100).ok
    assert svc.apply_updates("us", insert=np.array([[0, 1], [1, 2], [0, 2]])).ok
    assert svc.apply_updates("eu", insert=np.array([[5, 6]])).ok
    d = svc.density("us")
    assert d.ok and d.value["density"] == pytest.approx(1.0)
    m = svc.membership("us")
    assert m.ok and m.value["n_members"] == 3
    top = svc.top_k_densest(k=1)
    assert top.ok and top.value[0]["tenant"] == "us"
    s = svc.stats()
    assert s.ok and len(s.value) == 2
    assert svc.metrics.n_requests >= 7 and svc.metrics.n_errors == 0


def test_service_structured_errors():
    svc = StreamService(device="cpu")
    r = svc.density("nope")
    assert not r.ok and "nope" in r.error and r.latency_ms >= 0
    svc.create_tenant("t", n_nodes=10)
    r2 = svc.apply_updates("t", insert=np.array([[0, 99]]))
    assert not r2.ok and "out of range" in r2.error
    assert svc.metrics.n_errors == 2


def test_service_unknown_tenant_paths():
    svc = StreamService(fused=True, device="cpu")
    for op in (lambda: svc.density("ghost"),
               lambda: svc.membership("ghost"),
               lambda: svc.apply_updates("ghost", insert=np.array([[0, 1]])),
               lambda: svc.stats("ghost"),
               lambda: svc.ingest_many({"ghost": (np.array([[0, 1]]), None)})):
        r = op()
        assert not r.ok and "ghost" in r.error
    assert svc.metrics.n_errors == 5


def test_service_empty_graph_density():
    svc = StreamService(fused=True, device="cpu")
    assert svc.create_tenant("empty", n_nodes=32).ok
    d = svc.density("empty")
    assert d.ok and d.value["density"] == 0.0
    m = svc.membership("empty")
    assert m.ok and m.value["n_members"] == 0


def test_service_top_k_exceeding_tenant_count():
    svc = StreamService(fused=True, device="cpu")
    svc.create_tenant("x", n_nodes=50)
    svc.create_tenant("y", n_nodes=50)
    svc.apply_updates("x", insert=np.array([[0, 1], [1, 2], [0, 2]]))
    svc.apply_updates("y", insert=np.array([[3, 4]]))
    top = svc.top_k_densest(k=99)
    assert top.ok and len(top.value) == 2  # all tenants, densest first
    assert top.value[0]["tenant"] == "x"


def test_service_coalescing_window_and_flush():
    svc = StreamService(fused=True, coalesce_window_ms=1e9, device="cpu")
    svc.create_tenant("a", n_nodes=40)
    svc.create_tenant("b", n_nodes=40)
    svc.apply_updates("a", insert=np.array([[0, 1], [1, 2], [0, 2]]))
    svc.apply_updates("b", insert=np.array([[4, 5]]))
    ta = svc.submit_density("a")
    tb = svc.submit_density("b")
    tg = svc.submit_density("ghost")  # unknown tenant: error at flush
    assert svc.poll(ta) is None      # window still open: pending
    assert svc.flush() == 3
    ra, rb, rg = svc.poll(ta), svc.poll(tb), svc.poll(tg)
    assert ra.ok and ra.value["density"] == pytest.approx(1.0)
    assert rb.ok and rb.value["density"] == pytest.approx(0.5)
    assert not rg.ok and "ghost" in rg.error
    assert svc.poll(ta) is None      # results pop once
    svc0 = StreamService(fused=True, device="cpu")
    svc0.create_tenant("a", n_nodes=40)
    svc0.apply_updates("a", insert=np.array([[0, 1]]))
    t0 = svc0.submit_density("a")
    assert svc0.poll(t0).ok


def test_service_coalescing_flush_on_shutdown():
    svc = StreamService(fused=True, coalesce_window_ms=1e9, device="cpu")
    svc.create_tenant("a", n_nodes=40)
    svc.apply_updates("a", insert=np.array([[0, 1], [1, 2], [0, 2]]))
    t = svc.submit_density("a")
    assert svc.poll(t) is None
    assert svc.shutdown() == 1       # pending queries answered at shutdown
    r = svc.poll(t)
    assert r is not None and r.ok and r.value["density"] == pytest.approx(1.0)
    assert svc.shutdown() == 0       # idempotent
    with pytest.raises(RuntimeError):
        svc.submit_density("a")      # no new submissions after shutdown


@KERNEL
def test_service_matches_jax_service(kernel):
    """A multi-tenant deployment through both services, step by step:
    coalesced density answers, ingest_many, top_k, membership, refined
    densities in fixed-round mode, and the registry's stats, on a dense and
    a sparse bucket with pruned and unpruned tenants."""
    rng = np.random.default_rng(17)
    t = StreamService(fused=True, eps=0.1, refresh_every=4, coalesce_window_ms=1e9,
                      kernel=kernel, device="cpu")
    j = JService(fused=True, eps=0.1, refresh_every=4, coalesce_window_ms=1e9, kernel=False)
    tenants = {"d0": (300, True), "d1": (300, False), "s0": (900, True), "s1": (900, False),
               "s2": (900, True)}
    for svc in (t, j):
        for name, (n, pruned) in tenants.items():
            assert svc.create_tenant(name, n_nodes=n, capacity=2048, pruned=pruned).ok
    edges = {k: set() for k in tenants}
    for rnd in range(4):
        upd = {k: _churn(rng, n, edges[k], 300) for k, (n, _) in tenants.items()}
        rt, rj = t.ingest_many(upd), j.ingest_many(upd)
        assert rt.ok and rj.ok
        tickets = [(t.submit_density(k), j.submit_density(k)) for k in tenants]
        assert t.flush() == j.flush() == len(tenants)
        for a, b in tickets:
            ra, rb = t.poll(a), j.poll(b)
            assert ra.ok and rb.ok and ra.error is None
            va, vb = ra.value, rb.value
            assert _bits(va["density"]) == _bits(vb["density"]), (rnd, ra.tenant)
            assert _bits(va["warm_density"]) == _bits(vb["warm_density"]), (rnd, ra.tenant)
            assert (va["passes"], va["refreshed"], va["pruned"]) == (
                vb["passes"], vb["refreshed"], vb["pruned"]), (rnd, ra.tenant)
        ta, ja = t.top_k_densest(3), j.top_k_densest(3)
        assert [r["tenant"] for r in ta.value] == [r["tenant"] for r in ja.value]
        assert [_bits(r["density"]) for r in ta.value] == [_bits(r["density"])
                                                           for r in ja.value]
    for k in tenants:
        ma, mb = t.membership(k), j.membership(k)
        assert np.array_equal(ma.value["mask"], np.asarray(mb.value["mask"]))
        ra = t.density(k, refine=True, target_gap=-1.0, max_refine_rounds=5)
        rb = j.density(k, refine=True, target_gap=-1.0, max_refine_rounds=5)
        assert ra.ok and rb.ok
        for f in ("density", "dual_bound", "certified_gap"):
            assert _bits(ra.value[f]) == _bits(rb.value[f]), (k, f)
        assert ra.value["refine_rounds"] == rb.value["refine_rounds"] == 5
    skip = {"update_ms_total", "query_ms_total", "query_first_call_ms", "query_steady_ms",
            "worker", "kernel", "n_query_first_calls"}
    for sa, sb in zip(t.stats().value, j.stats().value):
        da, db = dataclasses.asdict(sa), dataclasses.asdict(sb)
        assert {k: v for k, v in da.items() if k not in skip} == {
            k: v for k, v in db.items() if k not in skip}, sa.name
    assert t.metrics.n_errors == j.metrics.n_errors == 0
