"""The spans inside the graph entry points (``obs.trace.capture``): off by
default and free of records there, the same answers with them on, one root
a call, one ``peel_pass`` a pass, one ``kcore_iter`` a fixpoint iteration,
one ``host_sync`` a sync at a known site, and ``obs:<name>`` ranges only
while a profiler records."""
import collections

import numpy as np
import pytest

from repro_torch.core import kcore, syncs
from repro_torch.core.cbds import cbds_p
from repro_torch.core.pbahmani import pbahmani
from repro_torch.graphs.generators import planted_dense, rmat
from repro_torch.obs import trace
from repro_torch.obs.metrics import MetricsRegistry


@pytest.fixture(scope="module")
def graphs():
    return {"rmat": rmat(9, 8, seed=3),
            "planted": planted_dense(300, 24, 0.03, 0.9, seed=1)[0]}


@pytest.fixture
def tracer():
    """A fresh default tracer for the test; the previous one put back."""
    tr = trace.Tracer(ring_size=1 << 16)
    prev = trace.set_tracer(tr)
    yield tr
    trace.set_tracer(prev)


def run(entry, g, kw):
    if entry == "pbahmani":
        return pbahmani(g, device="cpu", **kw)
    return cbds_p(g, device="cpu", **kw)


def same(a, b):
    """Equal field by field: numbers in type and value, arrays in dtype too."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


CALLS = [("pbahmani", {"eps": 0.1}), ("pbahmani", {"eps": 0.0}),
         ("pbahmani", {"eps": 0.1, "kernel": True}), ("cbds_p", {"rounds": 1}),
         ("cbds_p", {"rounds": 2, "kernel": True})]


@pytest.mark.parametrize("graph", ["rmat", "planted"])
@pytest.mark.parametrize("entry, kw", CALLS)
def test_capture_changes_no_answer(graphs, tracer, graph, entry, kw):
    off = run(entry, graphs[graph], kw)
    with trace.capture() as t:
        on = run(entry, graphs[graph], kw)
    assert same(off, on)
    assert t.ring()


@pytest.mark.parametrize("entry, kw", CALLS)
def test_capture_off_records_nothing(graphs, entry, kw):
    tr = trace.Tracer()
    prev = trace.set_tracer(tr)
    try:
        run(entry, graphs["rmat"], kw)
    finally:
        trace.set_tracer(prev)
    assert tr.ring() == [] and not tr.detail
    assert tr.registry.snapshot() == MetricsRegistry().snapshot()
    assert next(tr._ids) == 0   # no span was even built


def test_detail_is_the_noop_outside_capture(tracer):
    assert trace.detail("peel_pass") is trace.NOOP_SPAN
    assert syncs.host_sync("pass_test") is trace.NOOP_SPAN
    with trace.capture() as t:
        assert trace.get_tracer() is t and t.detail and not tracer.detail
        assert trace.detail("peel_pass") is not trace.NOOP_SPAN
    assert trace.get_tracer() is tracer and not t.detail
    assert trace.detail("peel_pass") is trace.NOOP_SPAN


def test_capture_leaves_the_default_tracer_alone(graphs, tracer):
    """Without a tracer of its own, capture records on a fresh one with a
    ring of ``CAPTURE_RING`` and no registry: the default tracer's ring (the
    service's request spans) and registry see nothing of the block."""
    with tracer.span("query"):
        pass
    before = (tracer.ring(), tracer.registry.snapshot())
    with trace.capture() as t:
        cbds_p(graphs["planted"], device="cpu")
        with trace.span("query"):
            pass
    assert (tracer.ring(), tracer.registry.snapshot()) == before
    assert t is not tracer and t.ring_size == trace.CAPTURE_RING
    assert not t.registry.enabled and t._jsonl_path is None
    names = collections.Counter(r.name for r in t.ring())
    assert names["cbds_p"] == 1 and names["query"] == 1 and names["host_sync"] > 0


def test_capture_on_a_given_tracer_restores_the_default(tracer):
    mine = trace.Tracer()
    with pytest.raises(RuntimeError):
        with trace.capture(mine) as t:
            assert t is mine and trace.get_tracer() is mine and mine.detail
            raise RuntimeError
    assert trace.get_tracer() is tracer and not mine.detail and not tracer.detail


def check_tree(records):
    """Parent links intact: every parent recorded, depths one apart."""
    by_id = {r.span_id: r for r in records}
    assert len(by_id) == len(records)
    for r in records:
        if r.parent_id is None:
            assert r.depth == 0
        else:
            assert r.depth == by_id[r.parent_id].depth + 1
    for r in records:
        if r.name == "host_sync":
            assert r.labels["at"] in syncs.SITES
    return by_id


def root_of(r, by_id):
    while r.parent_id is not None:
        r = by_id[r.parent_id]
    return r


@pytest.mark.parametrize("eps", [0.1, 0.0])
def test_pbahmani_span_tree(graphs, tracer, eps):
    with trace.capture() as t:
        _, _, passes = pbahmani(graphs["rmat"], eps=eps, device="cpu")
    recs = t.ring()
    by_id = check_tree(recs)
    roots = [r for r in recs if r.parent_id is None]
    assert [(r.name, r.labels) for r in roots] == [("pbahmani", {"eps": eps})]
    assert all(root_of(r, by_id) is roots[0] for r in recs)
    names = collections.Counter(r.name for r in recs)
    assert names["peel_setup"] == 1 and names["peel_pass"] == passes
    at = collections.Counter(r.labels["at"] for r in recs if r.name == "host_sync")
    # a test before each pass and one that ends the loop; three reads of the
    # answer; n_e and the pass counter uploaded
    assert at == {"pass_test": passes + 1, "result": 3, "upload": 2}
    for r in recs:
        if r.name in ("peel_setup", "peel_pass") or r.labels.get("at") in ("pass_test",
                                                                           "result"):
            assert by_id[r.parent_id].name == "pbahmani"
        if r.labels.get("at") == "upload":
            assert by_id[r.parent_id].name == "peel_setup"
    assert roots[0].duration_ms >= sum(r.duration_ms for r in recs if r.depth == 1)


@pytest.mark.parametrize("rounds", [1, 2])
def test_cbds_span_tree(graphs, tracer, monkeypatch, rounds):
    iters = []
    real = kcore.peel_edges

    def counted(*a, **kw):
        iters.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(kcore, "peel_edges", counted)
    g = graphs["planted"]
    with trace.capture() as t:
        cbds_p(g, rounds=rounds, device="cpu")
    recs = t.ring()
    by_id = check_tree(recs)
    roots = [r for r in recs if r.parent_id is None]
    assert [(r.name, r.labels) for r in roots] == [("cbds_p", {"rounds": rounds})]
    levels = [r for r in recs if r.name == "kcore_level"]
    coreness = kcore.kcore_np(g)[0]
    assert [r.attrs["k"] for r in levels] == list(range(int(coreness.max()) + 1))
    names = collections.Counter(r.name for r in recs)
    assert names["kcore_iter"] == len(iters) > 0 and names["cbds_augment"] == rounds
    assert all(by_id[r.parent_id].name == "kcore_level" for r in recs
               if r.name == "kcore_iter")
    at = collections.Counter(r.labels["at"] for r in recs if r.name == "host_sync")
    # each level's fixpoint ends on a test that finds nothing to peel
    assert at == {"level_test": len(levels) + 1, "fixpoint_test": len(iters) + len(levels),
                  "result": 5, "upload": 5}


def test_no_record_function_without_a_profiler(graphs, tracer, monkeypatch):
    entered = []

    class Fake:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trace, "_record_function", Fake)
    with trace.capture() as t:
        pbahmani(graphs["rmat"], eps=0.1, device="cpu")
        cbds_p(graphs["rmat"], device="cpu")
    with tracer.span("query"):
        pass
    assert t.ring() and tracer.ring() and entered == []


@pytest.mark.parametrize("entry, want", [
    ("pbahmani", {"obs:pbahmani", "obs:peel_setup", "obs:peel_pass", "obs:host_sync"}),
    ("cbds_p", {"obs:cbds_p", "obs:kcore_level", "obs:kcore_iter", "obs:cbds_augment",
                "obs:host_sync"}),
])
def test_profiler_sees_the_spans_as_obs_ranges(graphs, tracer, entry, want):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.capture() as t:
        run(entry, graphs["rmat"], {})
    ranges = collections.Counter(e.name for e in prof.events() if e.name.startswith("obs:"))
    assert set(ranges) == want
    spans = collections.Counter(f"obs:{r.name}" for r in t.ring())
    assert ranges == spans
    # without capture the profiler sees none of them
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(entry, graphs["rmat"], {})
    assert not any(e.name.startswith("obs:") for e in prof.events())
