"""RPR1xx — host syncs in pass loops, and per-call builds.

The port's hot loops run on the host: each pass of a peel is a few kernel
launches, and the loop reads one count back to decide whether to go on.
That read is the one host sync a pass, and each loop documents it with
``# repro: allow RPR101 -- the one host sync of each pass``. Every other
device-to-host read in a pass loop stalls the launch queue once more a
pass, and the card sits idle while the host waits. These rules pin each
loop to its one documented sync (RPR101-103; a train loop, found by the
checkpoint it saves, documents each of its syncs) and reject a kernel library,
CUDA graph or ``torch.compile`` made anew on every call (RPR104), the
counterparts of the JAX package's tracer rules.
"""
from __future__ import annotations

import ast
import functools
from typing import Iterator

from repro_torch.analysis.framework import (
    BUILD_MODULE, FRAMEWORK_RULE, PASS_SEEDS, Finding, ModuleInfo, Rule,
    checkpoint_calls, dotted, find_library_loads, find_pass_loops,
    per_pass_functions, tensor_names, tensor_taint, walk_local,
)

# calls that read the device back on the host whatever they are given
# (and a checkpoint's save and snapshot: framework.checkpoint_calls)
HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "nonzero", "unique",
                     "masked_select"}
HOST_SYNC_FUNCS = {"torch.nonzero", "torch.unique", "torch.masked_select",
                   "torch.cuda.synchronize"}
# conversions that sync when given a tensor
HOST_SYNC_CALLS = {"float", "int", "bool", "complex"}

CACHING_DECORATORS = {
    "lru_cache", "functools.lru_cache", "cache", "functools.cache",
}


class _Scope:
    """What runs once a pass: a pass loop, or the body of a seed pass
    function outside its own pass loops. ``capped``: a loop of passes, held
    to one documented sync (a train loop's step, found by its checkpoint,
    documents each of its syncs instead)."""

    def __init__(self, name: str, lineno: int, nodes: list[ast.AST],
                 taint: set[str], ckpt, head: ast.AST | None = None,
                 capped: bool = True):
        self.name, self.lineno, self.nodes = name, lineno, nodes
        self.taint = taint
        self.syncs = ckpt.syncs  # a checkpoint's save and snapshot, by id
        self.names = functools.partial(tensor_names, host=ckpt.host)
        self.head = head  # the loop itself (None: a pass function's body)
        self.capped = capped


def pass_scopes(mod: ModuleInfo) -> list[_Scope]:
    """Every scope of the module that runs once a pass (computed once a
    module and shared by RPR101-103)."""
    if "pass_scopes" not in mod.memo:
        mod.memo["pass_scopes"] = _pass_scopes(mod)
    return mod.memo["pass_scopes"]


def _pass_scopes(mod: ModuleInfo) -> list[_Scope]:
    per_pass, pass_params = passes = per_pass_functions(mod)
    loops = find_pass_loops(mod, passes)
    ckpt = checkpoint_calls(mod)
    taints: dict[int, set[str]] = {}

    def taint_of(fn):
        key = id(fn)
        if key not in taints:
            params = pass_params.get(getattr(fn, "name", ""), set())
            taints[key] = tensor_taint(fn if fn is not None else mod.tree,
                                       per_pass, params, ckpt)
        return taints[key]

    scopes = [_Scope(f"pass loop in '{lp.name}'", lp.lineno, list(lp.nodes()),
                     taint_of(lp.function), ckpt, lp.node, lp.per_pass) for lp in loops]
    loop_ids = {id(lp.node) for lp in loops}
    for fn in ast.walk(mod.tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and fn.name in PASS_SEEDS:
            nodes = list(walk_local(fn.body, skip=lambda n: id(n) in loop_ids))
            scopes.append(_Scope(f"pass '{fn.name}'", fn.lineno, nodes,
                                 taint_of(fn), ckpt))
    return scopes


def sync_calls(scope: _Scope) -> Iterator[tuple[ast.Call, str]]:
    """(call, what) for every host sync in the scope: a sync method or
    function, a checkpoint's save or snapshot, or a conversion of a tensor.
    A chain such as ``x.cpu().numpy()`` is one sync, reported at its
    innermost call."""
    for node in scope.nodes:
        if not isinstance(node, ast.Call):
            continue
        fn = dotted(node.func)
        if id(node) in scope.syncs:
            yield node, f"{fn}() (a checkpoint's host copy)"
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in HOST_SYNC_METHODS:
            inner = any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                        and n.func.attr in HOST_SYNC_METHODS
                        for n in ast.walk(node.func.value))
            if not inner:
                yield node, f".{node.func.attr}()"
        elif fn in HOST_SYNC_FUNCS:
            yield node, f"{fn}()"
        elif fn in HOST_SYNC_CALLS and node.args \
                and scope.names(node.args[0]) & scope.taint:
            yield node, f"{fn}() of a tensor"


class HostSyncRule(Rule):
    rule_id = "RPR101"
    title = "host sync inside a pass loop"

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        rel = mod.rel()
        for scope in pass_scopes(mod):
            allowed: list[int] = []
            for node, what in sync_calls(scope):
                if mod.pragmas.is_suppressed(self.rule_id, node.lineno):
                    allowed.append(node.lineno)
                yield Finding(
                    rule=self.rule_id, path=rel, line=node.lineno,
                    context=scope.name,
                    message=f"{what} inside {scope.name} waits for the card "
                            "once a pass; keep the value on the device, or "
                            "make this the loop's one documented sync "
                            "('# repro: allow RPR101 -- the one host sync of "
                            "each pass')")
            if scope.head is not None and scope.capped and len(set(allowed)) > 1:
                yield Finding(
                    rule=FRAMEWORK_RULE, path=rel, line=scope.lineno,
                    context=scope.name,
                    message=f"{scope.name} allows {len(set(allowed))} host "
                            f"syncs (lines {sorted(set(allowed))}); a pass loop "
                            "has one documented sync")


class TensorControlFlowRule(Rule):
    rule_id = "RPR102"
    title = "Python if/while/assert on a tensor inside a pass loop"

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        rel = mod.rel()
        for scope in pass_scopes(mod):
            for node in [scope.head] + scope.nodes:  # a while loop's own test too
                if not isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
                    continue
                hot = scope.names(node.test) & scope.taint
                if not hot:
                    continue
                if isinstance(node.test, ast.Compare) and all(
                        isinstance(op, (ast.Is, ast.IsNot)) for op in node.test.ops):
                    continue  # `x is None` is identity, not a read of the values
                kw = {ast.If: "if", ast.While: "while", ast.Assert: "assert",
                      ast.IfExp: "if-expression"}[type(node)]
                yield Finding(
                    rule=self.rule_id, path=rel, line=node.lineno,
                    context=scope.name,
                    message=f"Python `{kw}` on tensor(s) {sorted(hot)} inside "
                            f"{scope.name} is an implicit host sync every pass; "
                            "use torch.where, or fold it into the loop's one "
                            "documented sync")


class TensorKeyRule(Rule):
    rule_id = "RPR103"
    title = "tensor used as a dict key / set element / in an f-string in a pass loop"

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        rel = mod.rel()
        for scope in pass_scopes(mod):
            for node in scope.nodes:
                if isinstance(node, ast.JoinedStr):
                    if any(isinstance(v, ast.FormattedValue)
                           and scope.names(v.value) & scope.taint
                           for v in node.values):
                        yield Finding(
                            rule=self.rule_id, path=rel, line=node.lineno,
                            context=scope.name,
                            message=f"tensor formatted into an f-string inside "
                                    f"{scope.name}: formatting reads the values "
                                    "back (a host sync every pass)")
                elif isinstance(node, (ast.Dict, ast.Set)):
                    keys = node.keys if isinstance(node, ast.Dict) else node.elts
                    for k in keys:
                        if k is not None and scope.names(k) & scope.taint:
                            yield Finding(
                                rule=self.rule_id, path=rel, line=k.lineno,
                                context=scope.name,
                                message=f"tensor used as a dict key or set element "
                                        f"inside {scope.name}: a tensor hashes by "
                                        "identity, so equal values never meet")
                elif isinstance(node, ast.Call) and dotted(node.func) in (
                        "str", "repr", "format") and node.args \
                        and scope.names(node.args[0]) & scope.taint:
                    yield Finding(
                        rule=self.rule_id, path=rel, line=node.lineno,
                        context=scope.name,
                        message=f"{dotted(node.func)}() of a tensor inside "
                                f"{scope.name} reads it back (a host sync every "
                                "pass)")


def cached(fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", []):
        name = dotted(dec) or (
            dotted(dec.func) if isinstance(dec, ast.Call) else "")
        if name in CACHING_DECORATORS:
            return True
    return False


class PerCallBuildRule(Rule):
    rule_id = "RPR104"
    title = "library load, CUDA graph or torch.compile made per call"

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        if mod.module == BUILD_MODULE:
            return  # the build cache itself: kernels/build.py:load
        rel = mod.rel()
        for site in find_library_loads(mod):
            if site.kind == "load" or not site.enclosing \
                    or any(cached(f) for f in site.enclosing):
                continue  # build.load caches by source; module level runs once
            parent = site.enclosing[-1].name
            yield Finding(
                rule=self.rule_id, path=rel, line=site.lineno, context=parent,
                message=f"{site.entry} inside uncached '{parent}' builds anew on "
                        "every call (a library load, graph capture or compile "
                        "each time); load through kernels/build.py:load, or "
                        "build once at module level or in an lru_cache'd factory")


__all__ = ["HostSyncRule", "TensorControlFlowRule", "TensorKeyRule",
           "PerCallBuildRule", "HOST_SYNC_CALLS", "HOST_SYNC_METHODS",
           "CACHING_DECORATORS", "pass_scopes", "sync_calls"]
