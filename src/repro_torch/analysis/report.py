"""Reporters: human (one finding per line, grep-able) and JSON (stable
schema for CI artifacts and the test suite)."""
from __future__ import annotations

import json

from repro_torch.analysis.framework import AnalysisResult

JSON_SCHEMA_VERSION = 1


def to_human(result: AnalysisResult, show_suppressed: bool = False) -> str:
    lines: list[str] = []
    for f in result.findings:
        ctx = f" [{f.context}]" if f.context else ""
        lines.append(f"{f.path}:{f.line}: {f.rule}{ctx} {f.message}")
    if show_suppressed and result.suppressed:
        lines.append("")
        lines.append(f"suppressed ({len(result.suppressed)}):")
        for f, reason in sorted(result.suppressed,
                                key=lambda pair: pair[0].sort_key()):
            lines.append(f"  {f.path}:{f.line}: {f.rule} "
                         f"allowed -- {reason}")
    counts = ", ".join(f"{rid}: {n}" for rid, n in result.counts.items())
    lines.append("")
    if result.findings:
        lines.append(f"{len(result.findings)} finding(s) across "
                     f"{result.files} file(s) ({counts}); "
                     f"{len(result.suppressed)} suppressed")
    else:
        lines.append(f"clean: 0 findings across {result.files} file(s); "
                     f"{len(result.suppressed)} suppressed")
    return "\n".join(lines)


def to_json(result: AnalysisResult) -> str:
    payload = {
        "schema_version": JSON_SCHEMA_VERSION,
        "files": result.files,
        "counts": result.counts,
        "findings": [f.to_json() for f in result.findings],
        "suppressed": [
            {**f.to_json(), "reason": reason}
            for f, reason in sorted(result.suppressed,
                                    key=lambda pair: pair[0].sort_key())],
    }
    return json.dumps(payload, indent=2, sort_keys=True)


__all__ = ["to_human", "to_json", "JSON_SCHEMA_VERSION"]
