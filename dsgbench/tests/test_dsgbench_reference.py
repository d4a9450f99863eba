"""The plain references against the port's CPU path, and the generators
against the program's own graph building, at sizes the CPU runs."""
import numpy as np
import pytest
import torch

from dsgbench.gen.graph500 import graph500
from dsgbench.gen.tenants import TenantStream, bucket_names
from dsgbench.reference.cbds import cbds_ref, coreness
from dsgbench.reference.peel import pbahmani_ref, to_bfloat16
from dsgbench.reference.stream import EdgeSet
from repro_torch.core.cbds import cbds_p
from repro_torch.core.kcore import kcore_np
from repro_torch.core.pbahmani import pbahmani
from repro_torch.graphs.graph import Graph
from repro_torch.stream.buffer import EdgeBuffer

from _dsgbench_small import SEED, SMALL_TENANTS, run_small

G500 = dict(scale=10, edgefactor=16, A=0.57, B=0.19, C=0.19, D=0.05, graph_seed=500)


def program_graph(lanes):
    return Graph(n_nodes=lanes.n_nodes, n_edges=lanes.n_edges, src=lanes.src, dst=lanes.dst,
                 n_directed=lanes.n_directed)


@pytest.fixture(scope="module", params=[1, SEED])
def lanes(request):
    return graph500(G500, request.param, "cpu")


def test_graph500_is_what_from_edges_builds(lanes):
    want = Graph.from_edges(np.stack([lanes.u, lanes.v], axis=1), n_nodes=lanes.n_nodes)
    assert want.n_edges == lanes.n_edges
    assert np.array_equal(want.src, lanes.src) and np.array_equal(want.dst, lanes.dst)


def test_graph500_seed_permutes_labels_of_one_graph():
    a, b = graph500(G500, 1, "cpu"), graph500(G500, 2, "cpu")
    assert a.n_edges == b.n_edges
    assert not np.array_equal(a.u, b.u)
    deg = lambda g: np.sort(np.bincount(g.src[:g.n_directed], minlength=g.n_nodes))  # noqa: E731
    assert np.array_equal(deg(a), deg(b))
    assert np.array_equal(graph500(G500, 1, "cpu").src, a.src)


@pytest.mark.parametrize("eps", [0.1, 0.0, 0.5])
def test_pbahmani_reference_equals_the_port(lanes, eps):
    d, m, p = pbahmani(program_graph(lanes), eps=eps, kernel=True, device="cpu")
    rd, rm, rp = pbahmani_ref(lanes.n_nodes, lanes.src[:lanes.n_directed],
                              lanes.dst[:lanes.n_directed], eps)
    assert np.float32(d).view(np.int32) == np.float32(rd).view(np.int32)
    assert p == rp and np.array_equal(m, rm)


@pytest.mark.parametrize("rounds", [1, 2])
def test_cbds_reference_equals_the_port(lanes, rounds):
    got = cbds_p(program_graph(lanes), rounds=rounds, kernel=True, device="cpu")
    want = cbds_ref(lanes.n_nodes, lanes.src[:lanes.n_directed], lanes.dst[:lanes.n_directed],
                    rounds)
    assert np.array_equal(got.pop("member_mask"), want.pop("member_mask"))
    assert got == want


def test_coreness_equals_the_level_fixpoint(lanes):
    want = kcore_np(program_graph(lanes))[0]
    got = coreness(lanes.n_nodes, lanes.src[:lanes.n_directed], lanes.dst[:lanes.n_directed])
    assert np.array_equal(got, want)


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, 307.7, 3.4e38, -2.5], dtype=np.float32)
    want = torch.tensor(x).to(torch.bfloat16).to(torch.float32).numpy()
    assert np.array_equal(to_bfloat16(x), want)


def test_edge_set_follows_the_service_buffer():
    rng = np.random.default_rng(5)
    n = 64
    buf, es = EdgeBuffer(n, capacity=4096), EdgeSet(n)
    present = []
    for _ in range(30):
        ins = rng.integers(0, n, (40, 2))
        dele = (np.array(present)[rng.choice(len(present), 15, replace=False)] if present
                else None)
        if dele is not None:   # absent edges and self-loops among the deletes too
            dele = np.concatenate([dele, rng.integers(0, n, (5, 2)), [[3, 3]]])
        buf.apply(insert=ins, delete=dele)
        es.apply(ins, dele)
        present = sorted(buf._slot)
        assert np.array_equal(es.keys, np.array([u * n + v for u, v in present]))


def test_tenant_stream_deletes_present_edges_and_matches_its_reference():
    cfg = SMALL_TENANTS["config"]
    stream = TenantStream({"buckets": cfg["buckets"]}, SEED, "cpu")
    seeds = stream.seeds()
    ins, dels = stream.rounds("lane", 6, 32, 32)
    assert ins.shape == (6, 4, 32, 2) and dels.shape == (6, 4, 32, 2)
    n = cfg["buckets"]["lane"]["n"]
    for t, name in enumerate(bucket_names({"buckets": cfg["buckets"]}, "lane")):
        es = EdgeSet(n, seeds[name])
        for r in range(6):
            keys = dels[r, t, :, 0] * n + dels[r, t, :, 1]
            assert np.isin(keys, es.keys).all() and np.unique(keys).size == keys.size
            es.apply(ins[r, t], dels[r, t])
    again = TenantStream({"buckets": cfg["buckets"]}, SEED, "cpu")
    assert all(np.array_equal(a, seeds[k]) for k, a in again.seeds().items())
    assert np.array_equal(again.rounds("lane", 6, 32, 32)[1], dels)


@pytest.mark.parametrize("cell", ["g500s19-peel", "g500s19-cbds", "tenants-lane"])
def test_a_small_run_of_each_cell_is_correct(cell):
    result, lines = run_small(cell)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks" and result["checks"]["wrong_answers"]["value"] == 0
    assert lines[-2].startswith("check wrong_answers")


def test_a_pruned_peel_is_held_to_the_same_reference(monkeypatch):
    import _dsgbench_small as small

    patch = {"config": {"scale": 12}, "traffic": {"calls": [{"eps": 0.1, "pruned": True}]}}
    monkeypatch.setitem(small.SMALL, "g500s19-peel", patch)
    result, lines = small.run_small("g500s19-peel")
    assert result["correct"], lines


def test_a_window_ends_early_when_the_drawn_rounds_run_out(monkeypatch):
    import _dsgbench_small as small

    patch = {"config": small.SMALL_TENANTS["config"],
             "traffic": dict(small.SMALL_TENANTS["traffic"], max_rounds=7)}
    monkeypatch.setitem(small.SMALL, "tenants-lane", patch)
    result, lines = small.run_small("tenants-lane", seconds=60)
    assert result["correct"], lines
    assert result["attempted"] == 2 * 4 * 2   # rounds 2..5 after the warm cycle: 2 cycles
    assert any("ran out" in line for line in lines)


@pytest.mark.parametrize("cell", ["g500s19-peel", "g500s19-cbds"])
def test_other_edge_draws_are_held_to_the_reference(cell):
    import _dsgbench_small as small
    from dsgbench.edge_seeds import check_edge_draw

    for graph_seed in (1, 2):
        out = check_edge_draw(cell, graph_seed, small.SEED, 1, "cpu", small.SMALL[cell])
        assert out["correct"], out
        assert out["checks"]["answers_checked"] == len(out["answers"])
