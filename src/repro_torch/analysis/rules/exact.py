"""RPR3xx — exactness rules.

The port's optimality story rests on exact arithmetic, as the JAX
package's does: certificates are host-side Python rationals
(``refine/certify.py``), CBDS thresholds are integer comparisons
(``core/cbds.py``), and the kernel tier is held to the 2^24 envelope of the
JAX package's float32 sums (``core/dispatch.assert_exact_envelope``), so
that both packages accept and refuse the same graphs. These rules make
those promises checkable: ``# repro: proof`` scopes may not introduce
float literals, true division, or float dtypes and casts (each escape
hatch needs an ``allow`` with a reason), and any call into an edge stage
or degree sum that the JAX package accumulates in float32 must be
dominated by an envelope assertion in its module.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.framework import (
    Finding, ModuleInfo, Rule, dotted, iter_function_defs,
)

# dtypes whose appearance inside a proof scope breaks exactness
FLOAT_DTYPES = {
    "jnp.float16", "jnp.bfloat16", "jnp.float32", "jnp.float64",
    "np.float16", "np.float32", "np.float64",
    "jax.numpy.float32", "jax.numpy.float64",
    "numpy.float32", "numpy.float64",
    "torch.float16", "torch.bfloat16", "torch.float32", "torch.float64",
    "torch.half", "torch.float", "torch.double",
}
FLOAT_METHODS = {"float", "double", "half", "bfloat16"}  # x.float() casts
FLOAT_DTYPE_STRINGS = {"float16", "bfloat16", "float32", "float64"}

# the port's entries to what the JAX package accumulates in f32 on device
# (the edge stages and degree sums of core/dispatch.py, the refinement
# engine) — every call site's module must also call assert_exact_envelope
# (core/dispatch.py, 2^24)
ACCUMULATING_CALLS = {"peel_edges", "peel_edges_rows", "peel_delta",
                      "lane_degrees", "lane_degrees_rows", "refine_resident"}
ENVELOPE_ASSERT = "assert_exact_envelope"


def proof_scopes(mod: ModuleInfo) -> list[ast.AST]:
    """Scopes governed by a ``# repro: proof`` pragma: each function def
    whose def/decorator lines (or the line above) carry one, plus the
    whole module when a pragma precedes the first top-level statement."""
    scopes: list[ast.AST] = []
    claimed: set[int] = set()
    for fn, _enclosing in iter_function_defs(mod.tree):
        lines = {fn.lineno, fn.lineno - 1}
        for dec in fn.decorator_list:
            lines |= {dec.lineno, dec.lineno - 1}
        hit = lines & mod.pragmas.proof_lines
        if hit:
            scopes.append(fn)
            claimed |= hit
    first_stmt = mod.tree.body[0].lineno if mod.tree.body else 0
    if any(ln <= first_stmt for ln in mod.pragmas.proof_lines - claimed):
        scopes.append(mod.tree)
    return scopes


def _walk_scope(scope: ast.AST) -> Iterator[ast.AST]:
    """Every node in a proof scope. Module-level proof scopes do not
    descend into defs that are themselves proof-marked (they are their
    own scopes) — but plain nested helpers inherit the proof discipline."""
    yield from ast.walk(scope)


class _ProofRule(Rule):
    """Shared walk: visit every node of every proof scope."""

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        rel = mod.rel()
        for scope in proof_scopes(mod):
            name = getattr(scope, "name", "<module>")
            for node in _walk_scope(scope):
                yield from self.check_node(node, name, rel)

    def check_node(self, node: ast.AST, scope: str, rel: str
                   ) -> Iterator[Finding]:
        return iter(())


class FloatLiteralRule(_ProofRule):
    rule_id = "RPR301"
    title = "float literal inside a proof scope"

    def check_node(self, node, scope, rel):
        if isinstance(node, ast.Constant) and type(node.value) is float:
            yield Finding(
                rule=self.rule_id, path=rel, line=node.lineno, context=scope,
                message=f"float literal {node.value!r} inside proof scope "
                        f"'{scope}' — proofs must stay in exact ints / "
                        "Fractions; if this line is deliberately approximate "
                        "add '# repro: allow RPR301 -- <reason>'")


class TrueDivisionRule(_ProofRule):
    rule_id = "RPR302"
    title = "true division inside a proof scope"

    def check_node(self, node, scope, rel):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            yield Finding(
                rule=self.rule_id, path=rel, line=node.lineno, context=scope,
                message=f"true division `/` inside proof scope '{scope}' "
                        "rounds to float — compare cross-multiplied ints or "
                        "use Fraction / floor division `//`")


class FloatDtypeRule(_ProofRule):
    rule_id = "RPR303"
    title = "float dtype / float() cast inside a proof scope"

    def check_node(self, node, scope, rel):
        if isinstance(node, (ast.Attribute, ast.Name)) \
                and dotted(node) in FLOAT_DTYPES:
            yield Finding(
                rule=self.rule_id, path=rel, line=node.lineno, context=scope,
                message=f"float dtype {dotted(node)} inside proof scope "
                        f"'{scope}' — exact invariants require integer "
                        "dtypes (int32/int64) or host rationals")
        elif isinstance(node, ast.Call) and dotted(node.func) == "float":
            yield Finding(
                rule=self.rule_id, path=rel, line=node.lineno, context=scope,
                message=f"float() cast inside proof scope '{scope}' drops "
                        "to binary floating point — keep the proof in "
                        "ints/Fractions")
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in FLOAT_METHODS and not node.args:
            yield Finding(
                rule=self.rule_id, path=rel, line=node.lineno, context=scope,
                message=f".{node.func.attr}() cast inside proof scope "
                        f"'{scope}' drops to floating point — exact "
                        "invariants require integer dtypes")
        elif isinstance(node, ast.keyword) and node.arg == "dtype" \
                and isinstance(node.value, ast.Constant) \
                and node.value.value in FLOAT_DTYPE_STRINGS:
            yield Finding(
                rule=self.rule_id, path=rel, line=node.value.lineno,
                context=scope,
                message=f"dtype={node.value.value!r} inside proof scope "
                        f"'{scope}' — exact invariants require integer "
                        "dtypes")


class EnvelopeRule(Rule):
    rule_id = "RPR304"
    title = "f32-accumulating kernel call without assert_exact_envelope"

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        rel = mod.rel()
        has_assert = any(
            isinstance(n, ast.Call) and dotted(n.func).split(".")[-1]
            == ENVELOPE_ASSERT for n in ast.walk(mod.tree))
        if has_assert:
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted(node.func).split(".")[-1]
            if callee in ACCUMULATING_CALLS:
                yield Finding(
                    rule=self.rule_id, path=rel, line=node.lineno,
                    context=callee,
                    message=f"call to f32-accumulating kernel '{callee}' but "
                            "this module never calls assert_exact_envelope — "
                            "counts above 2^24 would silently lose exactness "
                            "(core/dispatch.py); assert the envelope on the "
                            "host path or '# repro: allow RPR304 -- <where "
                            "the caller asserts it>'")


__all__ = ["FloatLiteralRule", "TrueDivisionRule", "FloatDtypeRule",
           "EnvelopeRule", "proof_scopes", "FLOAT_DTYPES", "FLOAT_METHODS",
           "ACCUMULATING_CALLS"]
