"""Pragma and suppression syntax for the port's invariant linter.

Three directives, all spelled as ``# repro:`` comments so they survive
formatters and read as documentation at the site they govern (the grammar
of the JAX package's linter, so one pragma reads the same in both trees):

``# repro: proof``
    Marks the *next* (or same-line) ``def`` — or, before any top-level
    statement, the whole module — as a proof scope: the RPR3xx exactness
    rules apply inside it. Proof scopes may not use float literals, true
    division, or float dtypes unless each offending line carries an
    explicit ``allow``.

``# repro: unaudited -- <reason>``
    On (or immediately above) a kernel-library load, CUDA-graph capture or
    ``torch.compile``: the RPR2xx auditor-coverage rule accepts that this
    site is deliberately outside the recompile auditor's ``"kernels"``
    provider. The reason is mandatory — an unaudited site without a
    recorded why is itself a finding (RPR001).

``# repro: allow RPR101[,RPR102] -- <reason>``
    Suppresses the named rule(s) on this line (or, when the comment
    stands alone, on the next line). Rule IDs and a reason are both
    mandatory; a bare ``allow`` is a malformed-pragma finding (RPR001).
    Reasons are surfaced in the JSON report so suppressions stay
    reviewable. A pass loop's one host sync carries
    ``# repro: allow RPR101 -- the one host sync of each pass``.
"""
from __future__ import annotations

import io
import re
import tokenize
from dataclasses import dataclass, field

PRAGMA_RE = re.compile(r"#\s*repro:\s*(?P<body>.*)$")
RULE_ID_RE = re.compile(r"^RPR\d{3}$")


@dataclass(frozen=True)
class Suppression:
    """One ``allow`` pragma: which rules it silences, where, and why."""

    line: int                 # line the pragma sits on (1-based)
    rules: tuple[str, ...]    # rule IDs, e.g. ("RPR301", "RPR302")
    reason: str
    standalone: bool          # comment-only line: applies to the NEXT line

    def covers(self, rule_id: str, line: int) -> bool:
        if rule_id not in self.rules:
            return False
        return line == self.line or (self.standalone and line == self.line + 1)


@dataclass
class PragmaIndex:
    """All ``# repro:`` pragmas of one module, pre-parsed."""

    proof_lines: set[int] = field(default_factory=set)
    unaudited: dict[int, str] = field(default_factory=dict)  # line -> reason
    allows: list[Suppression] = field(default_factory=list)
    malformed: list[tuple[int, str]] = field(default_factory=list)

    def is_suppressed(self, rule_id: str, line: int) -> Suppression | None:
        for sup in self.allows:
            if sup.covers(rule_id, line):
                return sup
        return None

    def unaudited_reason(self, lines: set[int]) -> str | None:
        """Reason of an ``unaudited`` pragma on any of the given lines."""
        for ln in lines:
            if ln in self.unaudited:
                return self.unaudited[ln]
        return None


def _split_reason(body: str) -> tuple[str, str | None]:
    """Split ``<head> -- <reason>``; reason is None when absent/empty."""
    if "--" not in body:
        return body.strip(), None
    head, _, reason = body.partition("--")
    reason = reason.strip()
    return head.strip(), reason or None


def _comment_tokens(lines: list[str]) -> list[tuple[int, str, bool]]:
    """(line, comment_text, standalone) for every real COMMENT token —
    tokenizing (rather than regexing raw lines) keeps ``# repro:`` text
    inside strings and docstrings from parsing as a pragma. Falls back to
    a whole-line scan if the module does not tokenize (the analyzer
    reports the syntax error separately)."""
    source = "\n".join(lines) + "\n"
    out: list[tuple[int, str, bool]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                row = tok.start[0]
                standalone = lines[row - 1].strip().startswith("#")
                out.append((row, tok.string, standalone))
    except (tokenize.TokenizeError, IndentationError, SyntaxError):
        out = [(i, raw, raw.strip().startswith("#"))
               for i, raw in enumerate(lines, start=1) if "#" in raw]
    return out


def parse_pragmas(lines: list[str]) -> PragmaIndex:
    idx = PragmaIndex()
    for i, comment, standalone in _comment_tokens(lines):
        m = PRAGMA_RE.search(comment)
        if not m:
            continue
        head, reason = _split_reason(m.group("body"))
        parts = head.split()
        directive = parts[0] if parts else ""
        if directive == "proof":
            if len(parts) > 1:
                idx.malformed.append(
                    (i, f"'proof' takes no arguments, got {head!r}"))
            else:
                idx.proof_lines.add(i)
        elif directive == "unaudited":
            if reason is None:
                idx.malformed.append(
                    (i, "'unaudited' requires a reason: "
                        "# repro: unaudited -- <why this load is not audited>"))
            else:
                idx.unaudited[i] = reason
        elif directive == "allow":
            rule_ids = tuple(
                r for part in parts[1:] for r in part.split(",") if r)
            bad = [r for r in rule_ids if not RULE_ID_RE.match(r)]
            if not rule_ids:
                idx.malformed.append(
                    (i, "'allow' requires rule IDs: "
                        "# repro: allow RPR301 -- <reason>"))
            elif bad:
                idx.malformed.append(
                    (i, f"'allow' got invalid rule IDs {bad} "
                        "(expected RPRnnn)"))
            elif reason is None:
                idx.malformed.append(
                    (i, f"'allow {' '.join(rule_ids)}' requires a reason "
                        "after ' -- '"))
            else:
                idx.allows.append(Suppression(
                    line=i, rules=rule_ids, reason=reason,
                    standalone=standalone))
        else:
            idx.malformed.append(
                (i, f"unknown pragma directive {directive!r} "
                    "(expected proof | unaudited | allow)"))
    return idx


__all__ = ["PragmaIndex", "Suppression", "parse_pragmas",
           "PRAGMA_RE", "RULE_ID_RE"]
