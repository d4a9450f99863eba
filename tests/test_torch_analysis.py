"""Tests for the port's invariant linter (repro_torch.analysis), on the CPU.

One known-good + one known-bad torch fixture per rule ID, pragma
round-trips, reporter/exit-code contracts, the port's own tree linting
clean (the gate ``make lint-invariants-torch`` enforces), and the copy held
against the JAX package's linter: the pragma parser and the rules whose
meaning carried over unchanged (RPR301-303, RPR501) agree with
``repro.analysis`` on the reference's own fixtures.
"""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import run_analysis as ref_run_analysis  # noqa: E402
from repro.analysis.pragmas import parse_pragmas as ref_parse_pragmas  # noqa: E402
from repro.analysis.rules import RULE_CATALOG as REF_CATALOG  # noqa: E402
from repro.analysis.rules import rules_by_id as ref_rules_by_id  # noqa: E402
from repro_torch.analysis import run_analysis  # noqa: E402
from repro_torch.analysis.cli import main as cli_main  # noqa: E402
from repro_torch.analysis.framework import (  # noqa: E402
    LOAD_ENTRY, find_library_loads, find_pass_loops, load_module,
)
from repro_torch.analysis.pragmas import parse_pragmas  # noqa: E402
from repro_torch.analysis.report import to_json  # noqa: E402
from repro_torch.analysis.rules import ALL_RULES, RULE_CATALOG, rules_by_id  # noqa: E402
from repro_torch.analysis.rules.audit import AuditCoverageRule  # noqa: E402
from test_analysis import FIXTURES as REF_FIXTURES  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src" / "repro_torch"


def _static_rules(ids=None):
    """Rule set with RPR201 in pure-static mode (no runtime import) so
    fixture modules don't need the live providers snapshot."""
    rules = []
    for cls in ALL_RULES:
        if ids and cls.rule_id not in ids:
            continue
        rules.append(cls(dynamic=False) if cls is AuditCoverageRule
                     else cls())
    return rules


def lint_snippet(tmp_path, code: str, ids=None):
    path = tmp_path / "snippet.py"
    path.write_text(textwrap.dedent(code))
    return run_analysis([path], rules=_static_rules(ids))


def rule_ids(result):
    return sorted({f.rule for f in result.findings})


# ---------------------------------------------------------------------------
# fixtures per rule: (rule id, known-bad snippet, known-good snippet)
# ---------------------------------------------------------------------------
FIXTURES = [
    ("RPR101", """
        from repro_torch.core.pbahmani import pbahmani_pass

        def peel(state, src, dst, n, eps):
            while state.n_v.item() > 0:  # repro: allow RPR101 -- the one host sync of each pass
                state = pbahmani_pass(state, src, dst, n, eps, True)
                print(state.passes.item())
            return state
        """, """
        from repro_torch.core.pbahmani import pbahmani_pass

        def peel(state, src, dst, n, eps):
            while state.n_v.item() > 0:  # repro: allow RPR101 -- the one host sync of each pass
                state = pbahmani_pass(state, src, dst, n, float(eps), True)
            return state
        """),
    ("RPR102", """
        from repro_torch.core.pbahmani import pbahmani_pass

        def peel(state, src, dst, n, eps):
            while state.n_v.item() > 0:  # repro: allow RPR101 -- the one host sync of each pass
                state = pbahmani_pass(state, src, dst, n, eps, True)
                if state.best_density > 1:
                    eps = eps / 2
            return state
        """, """
        from repro_torch.core.pbahmani import pbahmani_pass

        def peel(state, src, dst, n, eps, mesh=None):
            while state.n_v.item() > 0:  # repro: allow RPR101 -- the one host sync of each pass
                if state.deg.shape[0] > 1 and mesh is None:  # metadata: no sync
                    state = pbahmani_pass(state, src, dst, n, eps, True)
            return state
        """),
    ("RPR103", """
        from repro_torch.core.pbahmani import pbahmani_pass

        def peel(state, src, dst, n, eps):
            seen = {}
            while state.n_v.item() > 0:  # repro: allow RPR101 -- the one host sync of each pass
                state = pbahmani_pass(state, src, dst, n, eps, True)
                seen[state.n_v] = {state.best_density: 1}
            return seen
        """, """
        from repro_torch.core.pbahmani import pbahmani_pass

        def peel(state, src, dst, n, eps):
            while state.n_v.item() > 0:  # repro: allow RPR101 -- the one host sync of each pass
                state = pbahmani_pass(state, src, dst, n, eps, True)
                tag = {state.deg.shape[0]: f"{n} vertices"}
            return state, tag
        """),
    ("RPR104", """
        import torch

        def step(fn, x):
            compiled = torch.compile(fn)
            return compiled(x)
        """, """
        import torch
        from functools import lru_cache

        @lru_cache(maxsize=None)
        def make_step(n):
            return torch.compile(lambda x: x * n)
        """),
    ("RPR201", """
        import torch

        def capture(fn):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn()
            return graph
        """, """
        import torch
        from repro_torch.kernels import build

        def capture(fn):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn()
            build.GRAPH_CAPTURES.append(graph)
            return graph
        """),
    ("RPR301", """
        import torch
        # repro: proof
        def certify(n_e: torch.Tensor, n_v: torch.Tensor):
            return n_e >= n_v * 2.0
        """, """
        import torch
        # repro: proof
        def certify(n_e: torch.Tensor, n_v: torch.Tensor):
            return n_e >= n_v * 2
        """),
    ("RPR302", """
        import torch
        # repro: proof
        def density(n_e: torch.Tensor, n_v: torch.Tensor):
            return n_e / n_v
        """, """
        import torch
        # repro: proof
        def denser(a_ne, a_nv, b_ne, b_nv):
            return torch.gt(a_ne * b_nv, b_ne * a_nv)
        """),
    ("RPR303", """
        import torch
        # repro: proof
        def acc(x):
            return x.to(torch.float32).sum()
        """, """
        import torch
        # repro: proof
        def acc(x):
            return x.to(torch.int64).sum()
        """),
    ("RPR304", """
        from repro_torch.core.dispatch import peel_edges

        def stage(src, dst, active, failed, n):
            return peel_edges(src, dst, active, failed, n, True)
        """, """
        from repro_torch.core.dispatch import assert_exact_envelope, peel_edges

        def stage(src, dst, active, failed, n):
            assert_exact_envelope(src.shape[0], n)
            return peel_edges(src, dst, active, failed, n, True)
        """),
    ("RPR401", """
        import torch.distributed as dist

        def total(t, mesh):
            dist.all_reduce(t, group=mesh.group)
            return t
        """, """
        from repro_torch.core import collective

        def total(t, mesh):
            return collective.all_reduce_sum(t, mesh)
        """),
    # the hang of the sharded tier's first card run: only rank 0 entered
    # the sharded peel, so its all-reduce waited for a rank that never came
    ("RPR402", """
        import torch.distributed as dist
        from repro_torch.core.distributed import make_mesh, pbahmani_distributed

        def main(graph):
            mesh = make_mesh()
            rank = dist.get_rank()
            if rank == 0:
                print(pbahmani_distributed(graph, mesh, eps=0.1))
        """, """
        import torch.distributed as dist
        from repro_torch.core.distributed import make_mesh, pbahmani_distributed

        def main(graph):
            mesh = make_mesh()
            rank = dist.get_rank()
            result = pbahmani_distributed(graph, mesh, eps=0.1)
            if rank == 0:
                print(result)
        """),
    ("RPR501", """
        import torch

        class Pool:
            def __init__(self):
                self.batches = {}

            def batch_for(self, node_capacity, edge_capacity, eps,
                          kernel=False, device=None, mesh=None):
                key = (int(node_capacity), int(edge_capacity), float(eps),
                       bool(kernel), str(torch.device(device)))  # mesh missing
                return self.batches.setdefault(key, object())
        """, """
        import torch

        class Pool:
            def __init__(self):
                self.batches = {}

            def batch_for(self, node_capacity, edge_capacity, eps,
                          kernel=False, device=None, mesh=None):
                key = (int(node_capacity), int(edge_capacity), float(eps),
                       bool(kernel), str(torch.device(device)), mesh)
                return self.batches.setdefault(key, object())
        """),
]

# further shapes each rule must catch: (rule id, label, snippet)
MORE_BAD = [
    ("RPR101", "int-of-tensor", """
        from repro_torch.core.dispatch import peel_edges

        def loop(src, dst, active, failed, n):
            while True:
                delta, removed = peel_edges(src, dst, active, failed, n, True)
                if int(removed) == 0:
                    return delta
        """),
    ("RPR101", "pass-body", """
        import torch
        from repro_torch.core.dispatch import peel_edges

        def pbahmani_pass(state, src, dst, n):
            delta, removed = peel_edges(src, dst, state.active, state.active, n, True)
            return state.n_v.item() - removed
        """),
    ("RPR101", "callable-handed-in", """
        from repro_torch.core.batched import pbahmani_pass_rows

        def run(state, step):
            while True:
                state = step(state)
                print(state.n_v.tolist())

        def peel(state, src, dst, n):
            return run(state, lambda s: pbahmani_pass_rows(s, src, dst, n, 0.1))
        """),
    ("RPR102", "implicit-loop-test", """
        from repro_torch.core.batched import pbahmani_pass_rows

        def peel(state, src, dst, n):
            while (state.n_v > 0).any():
                state = pbahmani_pass_rows(state, src, dst, n, 0.1)
            return state
        """),
    ("RPR103", "f-string", """
        from repro_torch.core.pbahmani import pbahmani_pass

        def peel(state, src, dst, n, log):
            while state.n_v.item() > 0:  # repro: allow RPR101 -- the one host sync of each pass
                state = pbahmani_pass(state, src, dst, n, 0.1, True)
                log(f"density {state.best_density}")
        """),
    ("RPR104", "bare-decorator", """
        import torch

        def serve(x):
            @torch.compile
            def f(y):
                return y + 1
            return f(x)
        """),
    ("RPR201", "ctypes-load", """
        import ctypes

        LIB = ctypes.CDLL("libpeel.so")
        """),
    ("RPR303", "float-method", """
        # repro: proof
        def acc(x):
            return x.double().sum()
        """),
    ("RPR401", "imported-name", """
        from torch.distributed import all_gather

        def gather(out, t):
            all_gather(out, t)
        """),
    ("RPR402", "early-return", """
        from repro_torch.core import collective

        def total(t, mesh):
            if mesh.rank != 0:
                return t
            return collective.all_reduce_sum(t, mesh)
        """),
    ("RPR402", "barrier-by-rank-param", """
        import torch.distributed as dist

        def worker(rank, world):
            if rank == 0:
                dist.barrier()
        """),
]


@pytest.mark.parametrize("rule_id,bad,good",
                         FIXTURES, ids=[f[0] for f in FIXTURES])
def test_rule_fires_on_bad_fixture(tmp_path, rule_id, bad, good):
    result = lint_snippet(tmp_path, bad)
    assert rule_id in rule_ids(result), (
        f"{rule_id} did not fire on its known-bad fixture; "
        f"got {rule_ids(result)}")


@pytest.mark.parametrize("rule_id,bad,good",
                         FIXTURES, ids=[f[0] for f in FIXTURES])
def test_rule_silent_on_good_fixture(tmp_path, rule_id, bad, good):
    result = lint_snippet(tmp_path, good)
    assert rule_id not in rule_ids(result), (
        f"{rule_id} fired on its known-good fixture: "
        f"{[f.message for f in result.findings if f.rule == rule_id]}")


@pytest.mark.parametrize("rule_id,label,bad", MORE_BAD,
                         ids=[f"{r}-{lbl}" for r, lbl, _ in MORE_BAD])
def test_rule_fires_on_more_shapes(tmp_path, rule_id, label, bad):
    assert rule_id in rule_ids(lint_snippet(tmp_path, bad, ids={rule_id}))


def test_rule_filter_restricts_findings(tmp_path):
    bad_everything = FIXTURES[0][1]  # RPR101 bad snippet
    result = lint_snippet(tmp_path, bad_everything, ids={"RPR302"})
    assert result.findings == []


def test_pass_loop_with_two_allowed_syncs_is_rpr001(tmp_path):
    """Allowing a second sync does not make a loop clean: a pass loop has
    one documented sync, and a second allow is itself a finding."""
    bad = FIXTURES[0][1].replace(
        "print(state.passes.item())",
        "print(state.passes.item())  # repro: allow RPR101 -- a second one")
    result = lint_snippet(tmp_path, bad)
    assert [(f.rule, f.line) for f in result.findings] == [("RPR001", 5)]
    assert len(result.suppressed) == 2


# ---------------------------------------------------------------------------
# pragmas / suppressions
# ---------------------------------------------------------------------------
def test_pragma_suppression_round_trip(tmp_path):
    bad = """
        # repro: proof
        def density(ne, nv):
            return ne / nv  # repro: allow RPR302 -- reporting convenience
        """
    result = lint_snippet(tmp_path, bad)
    assert "RPR302" not in rule_ids(result)
    assert len(result.suppressed) == 1
    finding, reason = result.suppressed[0]
    assert finding.rule == "RPR302"
    assert reason == "reporting convenience"


def test_standalone_suppression_covers_next_line(tmp_path):
    bad = """
        from repro_torch.core.dispatch import peel_edges

        def loop(src, dst, active, failed, n):
            while True:
                delta, removed = peel_edges(src, dst, active, failed, n, True)
                # repro: allow RPR101 -- the one host sync of each pass
                if removed.item() == 0:
                    return delta
        """
    result = lint_snippet(tmp_path, bad)
    assert "RPR101" not in rule_ids(result)
    assert len(result.suppressed) == 1


def test_suppression_does_not_leak_to_other_lines(tmp_path):
    bad = """
        # repro: proof
        def density(ne, nv):
            x = ne / nv  # repro: allow RPR302 -- here only
            return ne / nv
        """
    result = lint_snippet(tmp_path, bad)
    assert "RPR302" in rule_ids(result)          # second line still flagged
    assert len(result.suppressed) == 1


def test_malformed_pragmas_are_rpr001(tmp_path):
    bad = """
        # repro: allow -- no rule ids
        # repro: allow RPR101
        # repro: unaudited
        # repro: frobnicate
        x = 1
        """
    result = lint_snippet(tmp_path, bad)
    assert [f.rule for f in result.findings] == ["RPR001"] * 4


def test_rpr001_is_not_suppressible(tmp_path):
    bad = """
        # repro: frobnicate  # repro: allow RPR001 -- nice try
        x = 1
        """
    result = lint_snippet(tmp_path, bad)
    assert "RPR001" in rule_ids(result)


def test_pragma_text_inside_strings_is_ignored():
    idx = parse_pragmas(['DOC = "use # repro: allow RPR101 to suppress"',
                         "x = 1  # repro: proof"])
    assert idx.malformed == []
    assert idx.proof_lines == {2}


def test_unaudited_pragma_requires_reason():
    idx = parse_pragmas(["# repro: unaudited -- demo path, not audited"])
    assert idx.unaudited == {1: "demo path, not audited"}
    idx2 = parse_pragmas(["# repro: unaudited"])
    assert idx2.unaudited == {} and len(idx2.malformed) == 1


def test_unaudited_silences_rpr201(tmp_path):
    bad = """
        import ctypes

        # repro: unaudited -- fixture
        def load(path):
            return ctypes.CDLL(path)
        """
    result = lint_snippet(tmp_path, bad, ids={"RPR201"})
    assert result.findings == []


def _pragma_view(idx):
    return (idx.proof_lines, idx.unaudited,
            [(s.line, s.rules, s.reason, s.standalone) for s in idx.allows],
            [line for line, _msg in idx.malformed])


PRAGMA_TEXTS = (
    [(f"{rid}-{side}", src) for rid, bad, good in FIXTURES
     for side, src in (("bad", bad), ("good", good))]
    + [("malformed", "# repro: allow -- x\n# repro: allow RPR3\n# repro: allow RPR101\n"
        "# repro: unaudited\n# repro: proof now\n# repro: zap\nx = 1  # repro: proof\n"),
       ("certify", (SRC / "refine" / "certify.py").read_text())])


@pytest.mark.parametrize("label,text", PRAGMA_TEXTS, ids=[p[0] for p in PRAGMA_TEXTS])
def test_pragmas_agree_with_reference(label, text):
    """The copied parser reads every pragma as the JAX package's does:
    directives, suppressions and the malformed lines."""
    lines = textwrap.dedent(text).splitlines()
    assert _pragma_view(parse_pragmas(lines)) == _pragma_view(ref_parse_pragmas(lines))


SHARED = [(rid, side, src) for rid, bad, good in REF_FIXTURES
          if rid in ("RPR301", "RPR302", "RPR303", "RPR501")
          for side, src in (("bad", bad), ("good", good))]


@pytest.mark.parametrize("rule_id,side,src", SHARED,
                         ids=[f"{r}-{s}" for r, s, _ in SHARED])
def test_shared_rules_agree_with_reference(tmp_path, rule_id, side, src):
    """RPR301-303 and RPR501 keep their meaning: both linters find the same
    (rule, line) on the reference's own fixtures."""
    path = tmp_path / "snippet.py"
    path.write_text(textwrap.dedent(src))
    ours = run_analysis([path], rules=rules_by_id([rule_id]))
    theirs = ref_run_analysis([path], rules=ref_rules_by_id([rule_id]))
    assert sorted((f.rule, f.line) for f in ours.findings) \
        == sorted((f.rule, f.line) for f in theirs.findings)
    assert (side == "bad") == bool(ours.findings)


# ---------------------------------------------------------------------------
# CLI / reporters
# ---------------------------------------------------------------------------
def test_cli_exit_codes_and_json(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("# repro: proof\ndef f(a, b):\n    return a / b\n")
    good = tmp_path / "good.py"
    good.write_text("def f(a, b):\n    return a // b\n")

    assert cli_main(["--static", str(good)]) == 0
    capsys.readouterr()
    assert cli_main(["--static", "--json", str(bad)]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["counts"] == {"RPR302": 1}
    assert payload["findings"][0]["rule"] == "RPR302"
    assert payload["findings"][0]["line"] == 3

    assert cli_main(["--static", str(tmp_path / "missing.py")]) == 2
    capsys.readouterr()
    assert cli_main(["--static", "--rules", "RPR999", str(good)]) == 2
    capsys.readouterr()
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in RULE_CATALOG:
        assert rid in out


def test_json_report_includes_suppression_reasons(tmp_path):
    path = tmp_path / "s.py"
    path.write_text("# repro: proof\ndef f(a, b):\n"
                    "    return a / b  # repro: allow RPR302 -- why not\n")
    result = run_analysis([path], rules=_static_rules())
    payload = json.loads(to_json(result))
    assert payload["findings"] == []
    assert payload["suppressed"][0]["reason"] == "why not"


def test_catalog_is_consistent():
    """The reference's IDs, one torch rule each."""
    ids = [cls.rule_id for cls in ALL_RULES]
    assert len(ids) == len(set(ids))
    assert set(RULE_CATALOG) == set(ids) | {"RPR001"} == set(REF_CATALOG)
    assert all(r.rule_id in RULE_CATALOG for r in rules_by_id())
    assert [r.rule_id for r in rules_by_id(["RPR301"])] == ["RPR301"]


def test_syntax_error_reports_rpr001(tmp_path):
    path = tmp_path / "broken.py"
    path.write_text("def f(:\n")
    result = run_analysis([path], rules=_static_rules())
    assert [f.rule for f in result.findings] == ["RPR001"]


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dynamic", [True, False], ids=["dynamic", "static"])
def test_repo_tree_lints_clean(dynamic):
    """The gate: src/repro_torch has 0 findings under the full catalog
    (with and without the runtime providers snapshot), every suppression
    carries a reason, and every RPR101 pragma fires, so each pass loop's
    documented sync is one the discovery really finds."""
    rules = [cls(dynamic=dynamic) if cls is AuditCoverageRule else cls()
             for cls in ALL_RULES]
    result = run_analysis([SRC], rules=rules, root=REPO)
    assert result.findings == [], "\n".join(
        f"{f.path}:{f.line}: {f.rule} {f.message}" for f in result.findings)
    assert all(reason for _f, reason in result.suppressed)
    fired = {(f.path, f.line) for f, _ in result.suppressed if f.rule == "RPR101"}
    for path in sorted(SRC.rglob("*.py")):
        mod = load_module(path)
        for sup in mod.pragmas.allows:
            if "RPR101" in sup.rules:
                line = sup.line + 1 if sup.standalone else sup.line
                assert (str(path.relative_to(REPO)), line) in fired, (path, sup)


def test_documented_syncs_are_pass_loops():
    """Each loop the pass loops are known by holds its one documented sync."""
    sites = {"core/pbahmani.py": ["pbahmani"], "core/kcore.py": ["_level_fixpoint", "_kcore"],
             "refine/loads.py": ["refine_round_body"], "core/batched.py": ["run_rows"],
             "core/prune.py": ["_plan", "_peel_to_end", "_staged_peel"],
             "core/distributed.py": ["pbahmani_distributed"],
             "launch/train.py": ["peel_with_restarts", "run_training"]}
    for rel, names in sites.items():
        mod = load_module(SRC / rel)
        assert sorted(lp.name for lp in find_pass_loops(mod)) == sorted(names), rel


RPR401_MAX = ("""
    import torch.distributed as dist

    def shared_scale(t, mesh):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
        return t
    """, """
    from repro_torch.core import collective

    def shared_scale(t, mesh):
        return collective.all_reduce_max(t, mesh)
    """)


@pytest.mark.parametrize("side", ["bad", "good"])
def test_rpr401_admits_all_reduce_max(tmp_path, side):
    """The max of optim/compress.py goes through the second counted site:
    RPR401 fires on a raw MAX all-reduce and not on collective.all_reduce_max."""
    result = lint_snippet(tmp_path, RPR401_MAX[side == "good"], ids={"RPR401"})
    assert rule_ids(result) == (["RPR401"] if side == "bad" else [])


# RPR401 and RPR402 through the sub-axis collectives: a raw gather or
# all-to-all, and a rank-tested call of each new site or of a layer that
# reaches one (moe_ep's all-to-alls, vp_segment_sum's sum over sub-axes)
NEW_SITE_FIXTURES = {
    "all_gather": ("RPR401", """
        import torch
        import torch.distributed as dist

        def gather(t, mesh):
            out = t.new_empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]))
            dist.all_gather_into_tensor(out, t, group=mesh.group)
            return out
        """, """
        from repro_torch.core import collective

        def gather(t, mesh):
            return collective.all_gather(t, mesh, "model")
        """),
    "all_to_all": ("RPR401", """
        import torch
        import torch.distributed as dist

        def exchange(t, mesh):
            out = torch.empty_like(t)
            dist.all_to_all_single(out, t, group=mesh.group)
            return out
        """, """
        from repro_torch.core import collective

        def exchange(t, mesh):
            return collective.all_to_all(t, mesh, "model")
        """),
    "all_gather-by-rank": ("RPR402", """
        from repro_torch.core import collective

        def features(h, mesh):
            if mesh.rank == 0:
                h = collective.all_gather(h, mesh, "data")
            return h
        """, """
        from repro_torch.core import collective

        def features(h, mesh):
            full = collective.all_gather(h, mesh, "data")
            if mesh.rank == 0:
                print(full.shape)
            return full
        """),
    "moe_ep-by-rank": ("RPR402", """
        import torch.distributed as dist
        from repro_torch.models import moe_ep

        def layer(x, p, cfg, mesh):
            if dist.get_rank() == 0:
                return moe_ep(x, p, cfg, mesh=mesh)[0]
            return x
        """, """
        import torch.distributed as dist
        from repro_torch.models import moe_ep

        def layer(x, p, cfg, mesh):
            y, aux = moe_ep(x, p, cfg, mesh=mesh)
            if dist.get_rank() == 0:
                print(float(aux))
            return y
        """),
    "vp_segment_sum-by-rank": ("RPR402", """
        from repro_torch.kernels.ops import segment_output_sharding, vp_segment_sum

        def aggregate(vals, ids, n, mesh, rank):
            with segment_output_sharding(mesh, ("data",)):
                if rank == 0:
                    return vp_segment_sum(vals, ids, n)
            return None
        """, """
        from repro_torch.kernels.ops import segment_output_sharding, vp_segment_sum

        def aggregate(vals, ids, n, mesh, rank):
            with segment_output_sharding(mesh, ("data",)):
                out = vp_segment_sum(vals, ids, n)
            return out if rank == 0 else None
        """),
}


@pytest.mark.parametrize("side", ["bad", "good"])
@pytest.mark.parametrize("case", sorted(NEW_SITE_FIXTURES))
def test_sub_axis_collective_sites(tmp_path, case, side):
    """RPR401 fires on a raw all-gather or all-to-all and not on
    collective.all_gather/all_to_all; RPR402 fires on a rank-tested call of
    a new site or of a layer that reaches one, not on the call made by every
    rank."""
    rule, bad, good = NEW_SITE_FIXTURES[case]
    result = lint_snippet(tmp_path, good if side == "good" else bad, ids={rule})
    assert rule_ids(result) == ([rule] if side == "bad" else []), [
        f"{f.line}: {f.rule} {f.message}" for f in result.findings]


def test_collective_sites_are_the_two_reducers():
    """The port's only torch.distributed collective calls are the bodies of
    core/collective.py's four sites: all_reduce_sum, all_reduce_max,
    all_gather and all_to_all."""
    import ast

    from repro_torch.analysis.framework import (
        COLLECTIVE_SITES, dotted, is_dist_collective, module_imports, qualify,
    )

    found = set()
    for path in sorted(SRC.rglob("*.py")):
        mod = load_module(path)
        imports = module_imports(mod)
        for fn in ast.walk(mod.tree):
            if isinstance(fn, ast.FunctionDef) and any(
                    isinstance(n, ast.Call) and is_dist_collective(
                        qualify(dotted(n.func), imports)) for n in ast.walk(fn)):
                found.add(f"{mod.module}.{fn.name}")
    assert found == set(COLLECTIVE_SITES)


CHECKPOINT_FIXTURES = {
    # a loop that saves through a CheckpointManager is a train loop: each of
    # its syncs is documented (no cap of one), the save among them
    "train-loop": ("RPR101", """
        from repro_torch.checkpoint import CheckpointManager

        def train(step_fn, state, batches, ckpt: CheckpointManager):
            for i, batch in enumerate(batches):
                state, loss = step_fn(state, batch)
                print(float(loss))
                ckpt.save(i, state)
        """, """
        from repro_torch.checkpoint import CheckpointManager

        def train(step_fn, state, batches, ckpt: CheckpointManager, model):
            for i, batch in enumerate(batches):
                state, loss = step_fn(state, batch)
                print(float(loss))  # repro: allow RPR101 -- the loss, once a step
                ckpt.save(i, state)  # repro: allow RPR101 -- the checkpoint's host copy
                model.save(i)  # not a CheckpointManager: no sync
        """),
    # only a CheckpointManager's restore answers on the host; another
    # object's restore of a tensor is a tensor
    "restore": ("RPR102", """
        from repro_torch.core.pbahmani import pbahmani_pass

        def peel(state, src, dst, n, cache):
            while state.n_v.item() > 0:  # repro: allow RPR101 -- the one host sync of each pass
                state = pbahmani_pass(state, src, dst, n, 0.1, True)
                back = cache.restore(state)
                if back.n_v > 0:
                    state = back
        """, """
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.core.pbahmani import pbahmani_pass

        def peel(state, src, dst, n, ckpt: CheckpointManager):
            while state.n_v.item() > 0:  # repro: allow RPR101 -- the one host sync of each pass
                state = pbahmani_pass(state, src, dst, n, 0.1, True)
                _, back = ckpt.restore(state)
                if back.n_v > 0:
                    return back
        """),
}


@pytest.mark.parametrize("side", ["bad", "good"])
@pytest.mark.parametrize("case", sorted(CHECKPOINT_FIXTURES))
def test_checkpoint_calls_keyed_on_the_module(tmp_path, case, side):
    """A checkpoint's save and restore are known by the CheckpointManager
    imported from repro_torch.checkpoint, not by the method's name."""
    rule, bad, good = CHECKPOINT_FIXTURES[case]
    result = lint_snippet(tmp_path, good if side == "good" else bad)
    assert rule_ids(result) == ([rule] if side == "bad" else []), [
        f"{f.line}: {f.rule} {f.message}" for f in result.findings]


def test_chip_smoke_lints_clean_under_collective_rules():
    """The smoke's own rank-dependent code keeps every collective-reaching
    call on every rank (RPR402 against the port's functions)."""
    result = run_analysis([REPO / "chip_smoke.py"], rules=rules_by_id(["RPR401", "RPR402"]))
    assert result.findings == []


def test_providers_snapshot_matches_static_discovery():
    """providers_snapshot() (the runtime source of truth for RPR201) names
    the kernels provider, whose one entry is build.load, and the static
    walker finds every library the port loads going through it."""
    from repro_torch.kernels import build, compact, embed, peel, segsum
    from repro_torch.obs.audit import AUDITOR

    snap = AUDITOR.providers_snapshot()
    assert snap["kernels"] == [LOAD_ENTRY] and not build.GRAPH_CAPTURES
    sites = [s for p in sorted(SRC.rglob("*.py")) for s in find_library_loads(load_module(p))]
    assert {s.entry for s in sites if s.kind in ("load", "graph", "compile")} \
        == set(snap["kernels"])
    assert {s.source for s in sites if s.kind == "load"} \
        == {m.SOURCE.name for m in (segsum, peel, compact, embed)}
    assert [(s.kind, s.enclosing[-1].name) for s in sites if s.kind != "load"] \
        == [("library", "load")]  # build.load's own ctypes.CDLL


def test_repro_torch_lint_entry_point_runs():
    """`python -m repro_torch.analysis` (the repro-torch-lint console
    script target) exits 0 on a clean file and lists the reference's IDs."""
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin", "HOME": "/tmp"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--static", "--json",
         str(SRC / "analysis" / "pragmas.py")],
        capture_output=True, text=True, env=env)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["findings"] == []
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--list-rules"],
                          capture_output=True, text=True, env=env)
    assert proc.returncode == 0, proc.stderr
    assert [ln.split()[0] for ln in proc.stdout.splitlines()] == sorted(REF_CATALOG)
