"""repro_torch.analysis — the invariant linter for the PyTorch/CUDA port.

An AST-based static-analysis pass over ``src/repro_torch`` under the rule
IDs of the JAX package's linter, each rule the torch counterpart of the
JAX one: host syncs in the host-driven pass loops (RPR1xx), kernel-library
loads and graph captures the recompile auditor counts (RPR2xx), exact
int32/rational arithmetic for anything called a proof (RPR3xx), and the
sharded tier's collective discipline (RPR4xx), plus the fused bucket key
(RPR5xx). It imports neither JAX nor the JAX package: the analyzer, the
pragma grammar and the reporters are its own copies.

Entry points: the ``repro-torch-lint`` console script / ``python -m
repro_torch.analysis`` (cli.py), ``make lint-invariants-torch``, and the
:func:`run_analysis` API the tests drive directly.
"""
from repro_torch.analysis.framework import (
    Analyzer, Finding, ModuleInfo, Rule, load_module, run_analysis,
)
from repro_torch.analysis.pragmas import PragmaIndex, Suppression, parse_pragmas
from repro_torch.analysis.report import to_human, to_json
from repro_torch.analysis.rules import ALL_RULES, RULE_CATALOG, rules_by_id

__all__ = [
    "Analyzer", "Finding", "ModuleInfo", "Rule",
    "load_module", "run_analysis",
    "PragmaIndex", "Suppression", "parse_pragmas",
    "to_human", "to_json",
    "ALL_RULES", "RULE_CATALOG", "rules_by_id",
]
