"""The readers of the program's spans inside its entry points, on hand-built
records and on a small run of each graph cell: host self time, sync wait and
syncs an answer, and nothing where the program records no span."""
import types

import pytest

from dsgbench import entry_spans, spans
from dsgbench.harness import load_reader

import _dsgbench_small as small


def rec(span_id, parent_id, name, ms, **labels):
    return types.SimpleNamespace(span_id=span_id, parent_id=parent_id, name=name,
                                 duration_ms=ms, labels=labels)


# two answers: a peel of two passes (10 ms, 1 + 2 + 1.5 ms of syncs, one of
# them below peel_setup) and a CBDS-P answer (20 ms, syncs 4 + 0.5 ms under
# a level and 3 ms at the root)
SPANS = [
    rec(0, None, "pbahmani", 10.0, eps=0.1),
    rec(1, 0, "peel_setup", 2.0), rec(2, 1, "host_sync", 1.0, at="upload"),
    rec(3, 0, "host_sync", 2.0, at="pass_test"), rec(4, 0, "peel_pass", 0.5),
    rec(5, 0, "host_sync", 1.5, at="result"),
    rec(6, None, "cbds_p", 20.0, rounds=1),
    rec(7, 6, "host_sync", 3.0, at="level_test"), rec(8, 6, "kcore_level", 9.0),
    rec(9, 8, "host_sync", 4.0, at="fixpoint_test"), rec(10, 8, "kcore_iter", 2.0),
    rec(11, 8, "host_sync", 0.5, at="fixpoint_test"),
]


@pytest.mark.parametrize("name, want", [
    ("host_self_ms_per_answer", ((10 - 4.5) + (20 - 7.5)) / 2),
    ("sync_wait_ms_per_answer", (4.5 + 7.5) / 2),
    ("program_syncs_per_answer", (3 + 3) / 2),
])
def test_span_readers(name, want):
    obs = types.SimpleNamespace(spans=SPANS)
    assert load_reader("metrics", name).read(obs) == pytest.approx(want)


@pytest.mark.parametrize("name", ["host_self_ms_per_answer", "sync_wait_ms_per_answer",
                                  "program_syncs_per_answer"])
@pytest.mark.parametrize("obs", [types.SimpleNamespace(), types.SimpleNamespace(spans=None),
                                 types.SimpleNamespace(spans=[]),
                                 types.SimpleNamespace(spans=SPANS[1:6])])
def test_span_readers_read_nothing_without_a_root(name, obs):
    assert load_reader("metrics", name).read(obs) is None


# one answer whose entry point falls back to another: pbahmani(pruned=True)
# calls pbahmani inside its own root span
NESTED = [
    rec(0, None, "pbahmani", 10.0, eps=0.1), rec(1, 0, "host_sync", 1.0, at="pass_test"),
    rec(2, 0, "pbahmani", 6.0, eps=0.1), rec(3, 2, "host_sync", 2.0, at="result"),
    rec(4, 2, "peel_pass", 1.0), rec(5, 4, "host_sync", 0.5, at="upload"),
]


@pytest.mark.parametrize("name, want", [
    ("host_self_ms_per_answer", 10 - 3.5),
    ("sync_wait_ms_per_answer", 3.5),
    ("program_syncs_per_answer", 3),
])
def test_a_nested_root_is_one_answer(name, want):
    assert spans.answers(NESTED) == [(10.0, 3.5, 3)]
    obs = types.SimpleNamespace(spans=NESTED)
    assert load_reader("metrics", name).read(obs) == pytest.approx(want)


def test_a_pruned_call_that_falls_back_is_one_answer():
    from repro_torch.core.pbahmani import pbahmani
    from repro_torch.core.prune import plan_for_graph
    from repro_torch.graphs.generators import small_named

    g = small_named("petersen")   # vertex-transitive: nothing to prune, the plan is off
    assert not plan_for_graph(g, device="cpu").enabled
    with entry_spans.captured() as held:
        pbahmani(g, eps=0.1, pruned=True, device="cpu")
    roots = [r for r in held.records if r.name == "pbahmani"]
    assert len(roots) == 2   # the call and its fallback
    syncs = [r for r in held.records if r.name == "host_sync"]
    outer = next(r for r in roots if r.parent_id is None)
    assert spans.answers(held.records) == [
        (outer.duration_ms, pytest.approx(sum(r.duration_ms for r in syncs)), len(syncs))]
    obs = types.SimpleNamespace(spans=held.records)
    assert load_reader("metrics", "program_syncs_per_answer").read(obs) == len(syncs)


def test_self_time_by_span_name():
    got = entry_spans.self_ms_by_name(SPANS)
    assert got == pytest.approx({"pbahmani": 10 - 2 - 2 - 0.5 - 1.5, "peel_setup": 1.0,
                                 "host_sync": 1 + 2 + 1.5 + 3 + 4 + 0.5, "peel_pass": 0.5,
                                 "cbds_p": 20 - 3 - 9, "kcore_level": 9 - 4 - 2 - 0.5,
                                 "kcore_iter": 2.0})
    assert sum(got.values()) == pytest.approx(30.0)   # the roots' time, each part once


def test_capture_gives_nothing_where_the_program_has_none(monkeypatch):
    from repro_torch.obs import trace

    monkeypatch.delattr(trace, "capture")
    with entry_spans.captured() as held:
        pass
    assert held.records is None


def test_a_filled_ring_gives_nothing():
    from repro_torch.core.pbahmani import pbahmani
    from repro_torch.graphs.generators import rmat
    from repro_torch.obs import trace

    g = rmat(8, 8, seed=0)
    with entry_spans.captured(trace.Tracer(ring_size=8)) as held:
        pbahmani(g, eps=0.1, device="cpu")
    assert held.records is None
    with entry_spans.captured() as held:
        pbahmani(g, eps=0.1, device="cpu")
    assert [r.name for r in held.records].count("pbahmani") == 1


def test_it_refuses_to_run_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert entry_spans.main(["--workload", "g500s19-peel", "--seed", "1"]) == 2
    assert "needs a CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("cell", ["g500s19-peel", "g500s19-cbds"])
def test_both_graph_cells_report_the_span_metrics(cell):
    result, notes = entry_spans.run(cell, small.SEED, "cpu", turns=2, cycles=1,
                                    bench=small.bench(), patch=small.SMALL[cell])
    assert result["correct"], notes
    m = result["metrics"]
    assert set(m) == {"host_self_ms_per_answer", "sync_wait_ms_per_answer",
                      "program_syncs_per_answer"}
    assert all(v is not None and v > 0 for v in m.values())
    # the root spans cover the call: self time and wait add up to it
    assert m["host_self_ms_per_answer"] + m["sync_wait_ms_per_answer"] == pytest.approx(
        result["root_ms_per_answer"])
    assert result["root_ms_per_answer"] <= result["latency_ms"]["captured_mean"]
    lat = result["latency_ms"]
    assert result["capture_ms_per_answer"] == pytest.approx(
        lat["captured_mean"] - lat["plain_mean"])
    assert result["host_self_ms_net_of_capture"] == pytest.approx(
        m["host_self_ms_per_answer"] - result["capture_ms_per_answer"])
    assert all(v >= 0 for v in result["gc_ms_per_answer"].values())
    assert set(result["gc_full_collections"]) == {"plain", "captured"}
    # the segment under sync debug mode makes the answers' syncs again
    assert result["syncs_per_answer"]["program"] == m["program_syncs_per_answer"]
    assert result["syncs_per_answer"]["torch"] is None   # no card: torch reports none
    assert sum(result["self_ms_per_answer_by_span"].values()) == pytest.approx(
        result["root_ms_per_answer"])
    # no card, no device event: the labelled window is one idle gap
    assert len(result["idle_gaps"]) == 1 and result["idle_gaps"][0][1] > 0
