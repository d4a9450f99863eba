"""RPR4xx — collective discipline for the sharded tier (SPMD rules).

The port's sharded paths run one process a rank, and every rank makes the
same calls on the same inputs: the JAX package's shard_map bodies become
ordinary host code around ``torch.distributed``. Two things keep that
sound. RPR401: every collective goes through one of the four sites,
``core/collective.py``'s ``all_reduce_sum``, ``all_reduce_max``,
``all_gather`` and ``all_to_all``, which count it in
``collective.collectives`` and ``collective.calls`` (the counters the card
checks hold at one a pass, three all-to-alls a MoE layer); a ``dist.*``
collective anywhere else is a finding. RPR402: a call
that reaches a collective must not sit under a branch that only some
ranks take (``if rank == 0:``, a test of ``mesh.rank`` or
``dist.get_rank()``, or a name derived from one, or after a rank-tested
early return): the other ranks never enter the collective and the group
hangs. It is project-level, so a script's ``if rank == 0:
pbahmani_distributed(...)`` is caught against the port's own functions.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.framework import (
    COLLECTIVE_SITES, Finding, ModuleInfo, Rule, collective_reachers, dotted,
    is_dist_collective, module_imports, names_in, param_names, qualify,
    reaches_collective,
)

RANK_PARAMS = {"rank", "local_rank"}
RANK_ENV = {"RANK", "LOCAL_RANK"}


def reads_rank(expr: ast.AST, rank_names: set[str]) -> bool:
    """Does ``expr`` read this process's rank: ``.rank``, ``get_rank()``,
    ``os.environ["RANK"]``, or a name derived from one?"""
    for n in ast.walk(expr):
        if isinstance(n, ast.Attribute) and n.attr == "rank":
            return True
        if isinstance(n, ast.Call) and dotted(n.func).rsplit(".", 1)[-1] == "get_rank":
            return True
        if isinstance(n, ast.Constant) and n.value in RANK_ENV:
            return True
        if isinstance(n, ast.Name) and n.id in rank_names:
            return True
    return False


def rank_names(scope: ast.AST) -> set[str]:
    """Local names of a def (or the module) derived from the rank, to a
    fixpoint; parameters named ``rank`` are ranks."""
    names: set[str] = set()
    if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
        names |= set(param_names(scope)) & RANK_PARAMS
    assigns: list[tuple[set[str], ast.AST]] = []
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign):
            assigns.append((set().union(*(names_in(t) for t in node.targets)), node.value))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and node.value is not None:
            assigns.append((names_in(node.target), node.value))
    changed = True
    while changed:
        changed = False
        for targets, value in assigns:
            if not targets <= names and reads_rank(value, names):
                names |= targets
                changed = True
    return names


def _exits(stmts: list[ast.stmt]) -> bool:
    return bool(stmts) and isinstance(stmts[-1], (ast.Return, ast.Raise,
                                                  ast.Continue, ast.Break))


def divergent_calls(scope: ast.AST, ranks: set[str]) -> Iterator[ast.Call]:
    """Calls in ``scope``'s own body (not in nested defs) that only some
    ranks make: under an ``if``/``while``/conditional expression whose
    test reads the rank, or after a rank-tested branch that leaves the
    block."""
    def expr_calls(node: ast.AST, divergent: bool) -> Iterator[ast.Call]:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                             ast.Lambda)):
            return
        if isinstance(node, ast.IfExp) and reads_rank(node.test, ranks):
            yield from expr_calls(node.test, divergent)
            yield from expr_calls(node.body, True)
            yield from expr_calls(node.orelse, True)
            return
        if isinstance(node, ast.Call) and divergent:
            yield node
        for child in ast.iter_child_nodes(node):
            yield from expr_calls(child, divergent)

    def block(stmts: list[ast.stmt], divergent: bool) -> Iterator[ast.Call]:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.If, ast.While)):
                split = reads_rank(stmt.test, ranks)
                yield from expr_calls(stmt.test, divergent)
                yield from block(stmt.body, divergent or split)
                yield from block(stmt.orelse, divergent or split)
                if split and isinstance(stmt, ast.If) and (
                        _exits(stmt.body) or _exits(stmt.orelse)):
                    divergent = True  # the ranks that stay run the rest alone
                continue
            for _field, value in ast.iter_fields(stmt):
                if isinstance(value, list) and value and isinstance(value[0], ast.stmt):
                    yield from block(value, divergent)
                elif isinstance(value, list):
                    for v in value:
                        if isinstance(v, ast.AST):
                            yield from expr_calls(v, divergent)
                elif isinstance(value, ast.AST):
                    yield from expr_calls(value, divergent)

    yield from block(getattr(scope, "body", []), False)


def _enclosing_defs(tree: ast.Module) -> dict[int, str]:
    """id(call) -> the name of the def whose own body holds it."""
    out: dict[int, str] = {}

    def visit(node: ast.AST, name: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Call):
                out[id(child)] = name
            visit(child, name)

    visit(tree, "<module>")
    return out


class CollectiveSiteRule(Rule):
    rule_id = "RPR401"
    title = ("torch.distributed collective outside core/collective.py's "
             "all_reduce_sum, all_reduce_max, all_gather and all_to_all")

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        rel = mod.rel()
        imports = module_imports(mod)
        owner = _enclosing_defs(mod.tree)
        sites = {tuple(site.rsplit(".", 1)) for site in COLLECTIVE_SITES}
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = qualify(dotted(node.func), imports)
            if not is_dist_collective(name):
                continue
            context = owner.get(id(node), "<module>")
            if (mod.module, context) in sites:
                continue  # a counted site
            yield Finding(
                rule=self.rule_id, path=rel, line=node.lineno, context=context,
                message=f"{name}(...) outside {', '.join(COLLECTIVE_SITES)} is a "
                        "collective that collective.collectives never counts; "
                        "go through collective.all_reduce_sum, all_reduce_max, "
                        "all_gather or all_to_all(t, mesh, axes)")


class RankDivergenceRule(Rule):
    rule_id = "RPR402"
    title = "collective-reaching call under a rank-dependent branch"
    project_level = True

    def check_project(self, mods: list[ModuleInfo]) -> Iterator[Finding]:
        reachers = collective_reachers(mods)
        for mod in mods:
            rel = mod.rel()
            imports = module_imports(mod)
            scopes = [mod.tree] + [n for n in ast.walk(mod.tree) if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef))]
            for scope in scopes:
                ranks = rank_names(scope)
                context = getattr(scope, "name", "<module>")
                for call in divergent_calls(scope, ranks):
                    if reaches_collective(call, imports, reachers):
                        yield Finding(
                            rule=self.rule_id, path=rel, line=call.lineno,
                            context=context,
                            message=f"{dotted(call.func)}(...) reaches a "
                                    "collective but only the ranks that take "
                                    "this rank-dependent branch call it: the "
                                    "others never join and the group hangs; "
                                    "call it on every rank and branch on the "
                                    "result")


__all__ = ["CollectiveSiteRule", "RankDivergenceRule", "divergent_calls",
           "rank_names", "reads_rank"]
