"""``repro-torch-lint`` — the port's invariant linter's command line.

Exit codes: 0 clean, 1 findings, 2 bad usage / internal error.

Typical invocations::

    repro-torch-lint                          # lint src/repro_torch, full catalog
    repro-torch-lint --json src/repro_torch   # machine-readable report
    repro-torch-lint --rules RPR401,RPR402 chip_smoke.py
    repro-torch-lint --static                 # skip the runtime providers_snapshot()
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.framework import Analyzer
from repro_torch.analysis.report import to_human, to_json
from repro_torch.analysis.rules import ALL_RULES, RULE_CATALOG
from repro_torch.analysis.rules.audit import AuditCoverageRule

DEFAULT_PATHS = ["src/repro_torch"]


def build_rules(ids: set[str] | None, dynamic: bool):
    rules = []
    for cls in ALL_RULES:
        if ids and cls.rule_id not in ids:
            continue
        if cls is AuditCoverageRule:
            rules.append(cls(dynamic=dynamic))
        else:
            rules.append(cls())
    return rules


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="repro-torch-lint",
        description="Static invariant linter of the PyTorch/CUDA port: host "
                    "syncs in pass loops (RPR1xx), auditor coverage (RPR2xx), "
                    "exactness (RPR3xx), collectives (RPR4xx).")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files or directories (default: src/repro_torch)")
    parser.add_argument("--json", action="store_true",
                        help="emit the JSON report instead of human output")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule IDs to run (default: all)")
    parser.add_argument("--static", action="store_true",
                        help="pure-static mode: do not import the runtime "
                             "tree for the RPR201 providers snapshot")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="list fired suppressions with their reasons")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rid in sorted(RULE_CATALOG):
            print(f"{rid}  {RULE_CATALOG[rid]}")
        return 0

    ids: set[str] | None = None
    if args.rules:
        ids = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = ids - set(RULE_CATALOG)
        if unknown:
            print(f"repro-torch-lint: unknown rule id(s): {sorted(unknown)}",
                  file=sys.stderr)
            return 2

    paths = [Path(p) for p in (args.paths or DEFAULT_PATHS)]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"repro-torch-lint: no such path(s): "
              f"{[str(p) for p in missing]}", file=sys.stderr)
        return 2

    analyzer = Analyzer(build_rules(ids, dynamic=not args.static),
                        root=Path.cwd())
    result = analyzer.run(paths)
    if args.json:
        print(to_json(result))
    else:
        print(to_human(result, show_suppressed=args.show_suppressed))
    return 1 if result.findings else 0


if __name__ == "__main__":
    sys.exit(main())
