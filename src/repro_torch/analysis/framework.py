"""Checker framework: module loading, pass-loop discovery, rule runner.

The linter is a set of small :class:`Rule` subclasses over a shared
per-module view (:class:`ModuleInfo`: path, dotted name, AST, source
lines, parsed pragmas) plus shared discovery passes that the rule
families reuse. The analyzer, the pragmas and the AST helpers are those of
the JAX package's linter; the discovery passes are the port's own,
because its hot loops run on the host and launch kernels:

  * :func:`find_pass_loops` — every ``while``/``for`` loop whose test or
    body calls a per-pass function: the peel passes, the k-core level
    fixpoint, the refinement pass, the batched passes of
    ``core/batched.py`` and the edge stages of ``core/dispatch.py``,
    resolved to a fixpoint within the module (a function that calls one
    outside any loop of its own is one pass too, and so is a callable
    handed to a module function by a caller that passes one), and every
    loop that saves a checkpoint (a train loop's steps). Each loop runs
    once a pass, so what it syncs it syncs every pass.
  * :func:`tensor_taint` — a flow-insensitive closure of the local names
    that hold tensors (tensor-annotated parameters, results of ``torch.*``
    calls and of per-pass functions), minus whatever an explicit host
    conversion (``.item()``, ``int()``...) already made a Python value.
  * :func:`find_library_loads` — every kernel-library load
    (``build.load``, ``ctypes.CDLL``...), CUDA-graph capture and
    ``torch.compile``: what the port builds at run time, and so what the
    recompile auditor must count.
  * :func:`collective_reachers` — project-wide, to a fixpoint, the
    functions that reach one of ``core/collective.py``'s sites
    (``COLLECTIVE_SITES``), or a ``torch.distributed`` collective: every
    rank must call them alike.

Rules yield :class:`Finding`s; the :class:`Analyzer` filters them
through the pragma suppressions (recording which suppression fired, so
reports can show reviewed reasons) and turns malformed pragmas into
RPR001 findings of their own.
"""
from __future__ import annotations

import ast
import functools
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Iterable, Iterator

from repro_torch.analysis.pragmas import PragmaIndex, parse_pragmas

# rule family anchors (catalog lives in rules/__init__.py)
FRAMEWORK_RULE = "RPR001"
PORT_ROOT = Path(__file__).resolve().parents[1]  # src/repro_torch


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative where possible
    line: int
    message: str
    context: str = ""  # enclosing function / scope, for the human report

    def sort_key(self):
        return (self.path, self.line, self.rule)

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "context": self.context}


@dataclass
class ModuleInfo:
    path: Path
    module: str              # dotted module name, e.g. "repro_torch.stream.delta"
    source: str
    lines: list[str]
    tree: ast.Module
    pragmas: PragmaIndex
    # discovery results shared by the rules of one run (pass scopes, imports)
    memo: dict = field(default_factory=dict, repr=False, compare=False)

    def rel(self, root: Path | None = None) -> str:
        try:
            return str(self.path.relative_to(root)) if root else str(self.path)
        except ValueError:
            return str(self.path)


def dotted_module_name(path: Path) -> str:
    """Best-effort dotted name: everything under the nearest ``src`` or
    site-packages-style root; falls back to the stem."""
    parts = list(path.with_suffix("").parts)
    for anchor in ("src",):
        if anchor in parts:
            parts = parts[parts.index(anchor) + 1:]
            break
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) if parts else path.stem


def load_module(path: Path) -> ModuleInfo:
    source = Path(path).read_text()
    lines = source.splitlines()
    tree = ast.parse(source, filename=str(path))
    return ModuleInfo(path=Path(path), module=dotted_module_name(Path(path)),
                      source=source, lines=lines, tree=tree,
                      pragmas=parse_pragmas(lines))


# ---------------------------------------------------------------------------
# AST helpers shared by the rule families
# ---------------------------------------------------------------------------
def dotted(node: ast.AST) -> str:
    """'torch.cuda.graph' for Attribute/Name chains; '' for anything else."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


# attribute reads that never wait for the device: `x.ndim == 1` branches on
# the tensor's metadata, not its values (``numel``, ``dim``, ``stride``,
# ``is_contiguous`` and ``data_ptr`` are read as calls, ``x.numel()``)
STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "sharding", "aval",
                "device", "is_cuda", "numel", "dim", "stride", "is_contiguous",
                "data_ptr"}


def dynamic_names(node: ast.AST) -> set[str]:
    """Like :func:`names_in` but skips subtrees under a static attribute
    read (``x.shape``/``x.ndim``/``x.dtype``...): branching or hashing on
    those never syncs, so they must not propagate taint."""
    out: set[str] = set()

    def walk(n: ast.AST):
        if isinstance(n, ast.Attribute) and n.attr in STATIC_ATTRS:
            return
        if isinstance(n, ast.Name):
            out.add(n.id)
        for child in ast.iter_child_nodes(n):
            walk(child)

    walk(node)
    return out


def param_names(fn: ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda
                ) -> list[str]:
    a = fn.args
    return [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]


class _ScopeWalker(ast.NodeVisitor):
    """Collects (node, enclosing-def-name-chain) for every function def."""

    def __init__(self):
        self.stack: list[str] = []
        self.defs: list[tuple[ast.AST, tuple[str, ...]]] = []

    def visit_FunctionDef(self, node):
        self.defs.append((node, tuple(self.stack)))
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef


def iter_function_defs(tree: ast.Module
                       ) -> list[tuple[ast.FunctionDef, tuple[str, ...]]]:
    w = _ScopeWalker()
    w.visit(tree)
    return w.defs


def tainted_names(fn: ast.AST, seeds: set[str], names=None) -> set[str]:
    """Names (transitively) assigned from expressions referencing ``seeds``
    inside ``fn`` — flow-insensitive, iterated to a fixpoint so later
    passes catch assignments that textually precede their sources.
    ``names`` reads an expression's names (default :func:`dynamic_names`)."""
    names = names or dynamic_names
    tainted = set(seeds)
    if isinstance(fn, ast.Lambda):
        return tainted
    assigns: list[tuple[set[str], set[str]]] = []  # (targets, sources)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            targets = set()
            for t in node.targets:
                targets |= names_in(t)
            assigns.append((targets, names(node.value)))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                and node.value is not None:
            assigns.append((names_in(node.target), names(node.value)))
    changed = True
    while changed:
        changed = False
        for targets, sources in assigns:
            if sources & tainted and not targets <= tainted:
                tainted |= targets
                changed = True
    return tainted


def callee(call: ast.Call) -> str:
    """Last component of a call's dotted target: ``dispatch.peel_edges(...)``
    -> ``peel_edges``; '' for calls of computed callables."""
    return dotted(call.func).rsplit(".", 1)[-1]


_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
_LOOP_NODES = (ast.While, ast.For, ast.AsyncFor)


def walk_local(nodes: Iterable[ast.AST], skip=lambda node: False) -> Iterator[ast.AST]:
    """Every node under ``nodes`` in source order, without descending into
    nested defs, lambdas and classes (they run when called, not here), and
    without the nodes ``skip`` picks, nor anything under them."""
    for node in nodes:
        if skip(node):
            continue
        yield node
        if not isinstance(node, _SCOPE_NODES):
            yield from walk_local(ast.iter_child_nodes(node), skip)


def _is_loop(node: ast.AST) -> bool:
    return isinstance(node, _LOOP_NODES)


def module_imports(mod: ModuleInfo) -> dict[str, str]:
    """Local name -> the qualified name it is bound to by any import in the
    module (``import torch.distributed as dist`` -> ``dist``:
    ``torch.distributed``; ``from repro_torch.kernels import build`` ->
    ``build``: ``repro_torch.kernels.build``)."""
    if "imports" not in mod.memo:
        mod.memo["imports"] = _module_imports(mod)
    return mod.memo["imports"]


def _module_imports(mod: ModuleInfo) -> dict[str, str]:
    package = mod.module.split(".")
    if not mod.path.name == "__init__.py":
        package = package[:-1]
    out: dict[str, str] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    out[root] = root
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                anchor = package[:len(package) - node.level + 1]
                base = ".".join(anchor + ([base] if base else []))
            for a in node.names:
                out[a.asname or a.name] = f"{base}.{a.name}" if base else a.name
    return out


def qualify(name: str, imports: dict[str, str]) -> str:
    """A dotted call target with its first component resolved through the
    module's imports; unchanged when the root is not an imported name."""
    root, _, rest = name.partition(".")
    if root in imports:
        return f"{imports[root]}.{rest}" if rest else imports[root]
    return name


# ---------------------------------------------------------------------------
# pass loops (RPR1xx)
# ---------------------------------------------------------------------------
PASS_SEEDS = frozenset({
    # one pass of a single peel: P-Bahmani, one k-core level, refinement
    "pbahmani_pass", "_level_fixpoint", "refine_pass",
    # core/batched.py: one batched pass of G rows
    "pbahmani_pass_rows", "dense_pass_rows",
    # core/dispatch.py: the edge stages and degree sums each pass makes
    "peel_edges", "peel_edges_rows", "peel_delta", "lane_degrees",
    "lane_degrees_rows",
})


def _is_pass_callable(arg: ast.AST, per_pass: set[str]) -> bool:
    if isinstance(arg, ast.Name):
        return arg.id in per_pass
    if isinstance(arg, ast.Lambda):
        return any(isinstance(n, ast.Call) and callee(n) in per_pass
                   for n in ast.walk(arg.body))
    return False


def _calls_pass(nodes: Iterable[ast.AST], per_pass: set[str], params: set[str]) -> bool:
    return any(isinstance(n, ast.Call) and (
        callee(n) in per_pass
        or (isinstance(n.func, ast.Name) and n.func.id in params))
        for n in walk_local(nodes))


def per_pass_functions(mod: ModuleInfo
                       ) -> tuple[set[str], dict[str, set[str]]]:
    """(names of the module's per-pass functions, per function the names of
    its parameters that receive a pass): the seeds, every function that
    calls one outside any loop of its own, and every parameter to which a
    caller in the module hands a per-pass function or a lambda calling one
    (``run_rows(state, lambda s: pbahmani_pass_rows(...))``), to a fixpoint."""
    defs = iter_function_defs(mod.tree)
    params_of = {fn.name: param_names(fn) for fn, _ in defs}
    calls = [n for n in ast.walk(mod.tree) if isinstance(n, ast.Call)
             and callee(n) in params_of]
    # per def: the callees and the called bare names outside its own loops
    outside = []
    for fn, _ in defs:
        own = [n for n in walk_local(fn.body, skip=_is_loop) if isinstance(n, ast.Call)]
        outside.append((fn.name, {callee(c) for c in own},
                        {c.func.id for c in own if isinstance(c.func, ast.Name)}))
    per_pass = set(PASS_SEEDS)
    pass_params: dict[str, set[str]] = {}
    changed = True
    while changed:
        changed = False
        for call in calls:
            names = params_of[callee(call)]
            marked = pass_params.setdefault(callee(call), set())
            hits = {names[i] for i, a in enumerate(call.args)
                    if i < len(names) and _is_pass_callable(a, per_pass)}
            hits |= {kw.arg for kw in call.keywords
                     if kw.arg and _is_pass_callable(kw.value, per_pass)}
            if not hits <= marked:
                marked |= hits
                changed = True
        for name, callees, called in outside:
            if name not in per_pass and (
                    callees & per_pass or called & pass_params.get(name, set())):
                per_pass.add(name)
                changed = True
    return per_pass, {k: v for k, v in pass_params.items() if v}


# the checkpoint module: a ``CheckpointManager``'s ``save`` copies its state
# to the host (a sync) and answers with that copy, ``restore`` answers with
# host values read from disk, and ``snapshot`` is the host copy alone
CHECKPOINT_MODULES = ("repro_torch.checkpoint", "repro_torch.checkpoint.manager")


@dataclass
class CheckpointCalls:
    """The module's calls into the checkpoint module, by ``id`` of the call:
    ``save`` on a ``CheckpointManager`` (a parameter annotated as one, or a
    name bound to ``CheckpointManager(...)``), ``restore`` on one, and
    ``snapshot``. Keyed on the imports, not on method names: another
    object's ``save`` or ``restore`` is none of these."""

    saves: set[int] = field(default_factory=set)   # host syncs that answer on the host
    syncs: set[int] = field(default_factory=set)   # saves and snapshots
    host: frozenset[int] = frozenset()             # calls whose result is host values
    states: list[ast.AST] = field(default_factory=list)  # the trees the saves copy


def checkpoint_calls(mod: ModuleInfo) -> CheckpointCalls:
    if "checkpoint_calls" not in mod.memo:
        mod.memo["checkpoint_calls"] = _checkpoint_calls(mod)
    return mod.memo["checkpoint_calls"]


def _checkpoint_calls(mod: ModuleInfo) -> CheckpointCalls:
    imports = module_imports(mod)

    def names(name: str) -> set[str]:
        return {f"{m}.{name}" for m in CHECKPOINT_MODULES}

    def is_manager(node: ast.AST | None) -> bool:
        return node is not None and any(qualify(n, imports) in names("CheckpointManager")
                                        for n in names_in(node))

    out = CheckpointCalls()
    host: set[int] = set()
    for fn, _ in iter_function_defs(mod.tree):
        a = fn.args
        managers = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
                    if is_manager(p.annotation)}
        managers |= {t.id for n in ast.walk(fn) if isinstance(n, ast.Assign)
                     and isinstance(n.value, ast.Call) and is_manager(n.value.func)
                     for t in n.targets if isinstance(t, ast.Name)}
        for n in ast.walk(fn):
            if not isinstance(n, ast.Call):
                continue
            if qualify(dotted(n.func), imports) in names("snapshot"):
                out.syncs.add(id(n))
                host.add(id(n))
            elif isinstance(n.func, ast.Attribute) and dotted(n.func.value) in managers:
                if n.func.attr == "save":
                    out.saves.add(id(n))
                    out.syncs.add(id(n))
                    host.add(id(n))
                    out.states += n.args[1:2] + [k.value for k in n.keywords
                                                 if k.arg == "state"]
                elif n.func.attr == "restore":
                    host.add(id(n))
    out.host = frozenset(host)
    return out


@dataclass
class PassLoop:
    """One loop that runs once a pass: where, in which function, and which
    per-pass calls make it one."""

    node: ast.While | ast.For | ast.AsyncFor
    function: ast.AST | None            # enclosing def (None: module level)
    name: str                           # enclosing def's name, or <module>
    inner: list[ast.AST] = field(default_factory=list)  # nested pass loops
    per_pass: bool = True               # calls a per-pass function (else: saves a checkpoint)

    @property
    def lineno(self) -> int:
        return self.node.lineno

    def nodes(self) -> Iterator[ast.AST]:
        """What runs every pass: a while loop's test, the body and the else
        clause, without nested defs and without nested pass loops (each of
        those is a pass loop of its own)."""
        roots = ([self.node.test] if isinstance(self.node, ast.While) else [])
        roots += self.node.body + self.node.orelse
        inner = {id(n) for n in self.inner}
        yield from walk_local(roots, skip=lambda n: id(n) in inner)


def find_pass_loops(mod: ModuleInfo, passes: tuple | None = None) -> list[PassLoop]:
    """Every loop of the module that calls a per-pass function, or saves a
    checkpoint (a train loop's steps: each saves its state every so many
    steps); ``passes`` is :func:`per_pass_functions` of the module, when
    already at hand."""
    per_pass, pass_params = passes or per_pass_functions(mod)
    saves = checkpoint_calls(mod).saves
    loops: list[PassLoop] = []

    def visit(node: ast.AST, fn: ast.AST | None, outer: PassLoop | None):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child, None)
                continue
            here = outer
            if isinstance(child, _LOOP_NODES):
                roots = ([child.test] if isinstance(child, ast.While) else [])
                params = pass_params.get(getattr(fn, "name", ""), set())
                body = roots + child.body + child.orelse
                calls = _calls_pass(body, per_pass, params)
                if calls or any(id(n) in saves for n in walk_local(body)):
                    here = PassLoop(child, fn, getattr(fn, "name", "<module>"),
                                    per_pass=calls)
                    loops.append(here)
                    if outer is not None:
                        outer.inner.append(child)
            visit(child, fn, here)

    visit(mod.tree, None, None)
    return loops


# names a host conversion turns into Python values: no tensor flows past them
HOST_CONVERSIONS = {"int", "float", "bool", "complex", "len"}
HOST_METHODS = {"item", "tolist", "numpy"}
# torch.* calls that answer on the host, not with a tensor
TORCH_HOST_CALLS = ("torch.device", "torch.Size", "torch.cuda.", "torch.get_",
                    "torch.is_", "torch.finfo", "torch.iinfo", "torch.distributed.")


def tensor_names(node: ast.AST, host: frozenset[int] = frozenset()) -> set[str]:
    """:func:`dynamic_names` that also skips what an explicit host
    conversion (``int(x)``, ``x.item()``, ``x.tolist()``) returns: a Python
    value, whose use syncs nothing more. ``host`` holds the ``id`` of other
    calls that answer on the host (:func:`checkpoint_calls`)."""
    out: set[str] = set()

    def walk(n: ast.AST):
        if isinstance(n, ast.Attribute) and n.attr in STATIC_ATTRS:
            return
        if isinstance(n, ast.Call) and (
                id(n) in host or dotted(n.func) in HOST_CONVERSIONS
                or (isinstance(n.func, ast.Attribute)
                    and n.func.attr in HOST_METHODS)):
            return
        if isinstance(n, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
            return  # `x is None` compares identities, not values
        if isinstance(n, (ast.GeneratorExp, ast.ListComp, ast.SetComp, ast.DictComp)):
            # the iterable flows in only through what the element reads of
            # its targets: `any(t.device != d for t in ts)` reads no values
            targets = set().union(*(names_in(g.target) for g in n.generators))
            inner = set().union(*(tensor_names(part, host) for part in (
                [n.key, n.value] if isinstance(n, ast.DictComp) else [n.elt])
                + [c for g in n.generators for c in g.ifs]))
            out.update(inner - targets)
            if inner & targets:
                for g in n.generators:
                    walk(g.iter)
            return
        if isinstance(n, ast.Name):
            out.add(n.id)
        for child in ast.iter_child_nodes(n):
            walk(child)

    walk(node)
    return out


def _tensor_source(value: ast.AST, per_pass: set[str], params: set[str],
                   host: frozenset[int]) -> bool:
    """Does ``value`` make a tensor: a ``torch.*`` call or a pass's result,
    outside any explicit host conversion?"""
    def walk(n: ast.AST) -> bool:
        if isinstance(n, ast.Call):
            fn = dotted(n.func)
            if id(n) in host or fn in HOST_CONVERSIONS or (
                    isinstance(n.func, ast.Attribute) and n.func.attr in HOST_METHODS):
                return False
            if (fn.startswith("torch.") and not fn.startswith(TORCH_HOST_CALLS)) \
                    or callee(n) in per_pass \
                    or (isinstance(n.func, ast.Name) and n.func.id in params):
                return True
        return any(walk(c) for c in ast.iter_child_nodes(n))

    return walk(value)


def tensor_taint(fn: ast.AST, per_pass: set[str],
                 pass_params: set[str] = frozenset(),
                 ckpt: CheckpointCalls | None = None) -> set[str]:
    """Local names of ``fn`` (a def, or the module) that hold tensors:
    parameters annotated as a tensor or a ``*State`` of tensors, names
    assigned from a ``torch.*`` call or a pass, the state a checkpoint
    saves (``ckpt``: the module's :func:`checkpoint_calls`, whose host
    answers hold no tensor), and what flows from those, to a fixpoint.
    Flow-insensitive, like :func:`tainted_names`."""
    ckpt = ckpt or CheckpointCalls()
    fn_nodes = {id(n) for n in ast.walk(fn)}
    seeds: set[str] = set().union(*(tensor_names(s, ckpt.host) for s in ckpt.states
                                    if id(s) in fn_nodes))
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = fn.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            ann = ast.unparse(p.annotation) if p.annotation is not None else ""
            if "Tensor" in ann or ann.split("|")[0].strip().endswith("State"):
                seeds.add(p.arg)
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)) \
                and node.value is not None \
                and _tensor_source(node.value, per_pass, pass_params, ckpt.host):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            seeds |= set().union(*(names_in(t) for t in targets))
    return tainted_names(fn, seeds, names=functools.partial(tensor_names, host=ckpt.host))


# ---------------------------------------------------------------------------
# library loads, graph captures, torch.compile (RPR104, RPR201)
# ---------------------------------------------------------------------------
BUILD_MODULE = "repro_torch.kernels.build"
LOAD_ENTRY = f"{BUILD_MODULE}.load"  # the one audited way to load a library
LIBRARY_CALLS = {"ctypes.CDLL", "ctypes.PyDLL", "ctypes.cdll.LoadLibrary",
                 "torch.ops.load_library", "torch.utils.cpp_extension.load",
                 "torch.utils.cpp_extension.load_inline"}
GRAPH_CALLS = {"torch.cuda.CUDAGraph", "torch.cuda.graph",
               "torch.cuda.make_graphed_callables"}
COMPILE_CALLS = {"torch.compile"}


@dataclass
class LibraryLoad:
    """One site that builds or loads something at run time."""

    node: ast.AST                # the call, or a bare ``@torch.compile`` decorator
    kind: str                    # load | library | graph | compile
    entry: str                   # qualified call target (LOAD_ENTRY for build.load)
    source: str | None           # build.load: the csrc file name, when static
    enclosing: tuple[ast.AST, ...]  # enclosing defs, outermost first
    target: str | None = None    # the name the result is bound to, if any

    @property
    def lineno(self) -> int:
        return self.node.lineno


def _load_source(arg: ast.AST | None, mod: ModuleInfo) -> str | None:
    """The file name a ``build.load`` argument names: the last string
    constant in it, or in the module-level assignment of the name it is."""
    if arg is None:
        return None
    if isinstance(arg, ast.Name):
        name = arg.id
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == name for t in stmt.targets):
                arg = stmt.value
    consts = [n.value for n in ast.walk(arg)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    return Path(consts[-1]).name if consts else None


def find_library_loads(mod: ModuleInfo) -> list[LibraryLoad]:
    imports = module_imports(mod)
    out: list[LibraryLoad] = []

    def kind_of(func: ast.AST) -> tuple[str, str] | None:
        name = qualify(dotted(func), imports)
        if name == LOAD_ENTRY or (mod.module == BUILD_MODULE
                                  and dotted(func) == "load"):
            return "load", LOAD_ENTRY
        for kind, names in (("library", LIBRARY_CALLS), ("graph", GRAPH_CALLS),
                            ("compile", COMPILE_CALLS)):
            if name in names:
                return kind, name
        return None

    def visit(node: ast.AST, stack: tuple, target: str | None):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                hit = None if isinstance(dec, ast.Call) else kind_of(dec)
                if hit is not None:  # a bare `@torch.compile`
                    out.append(LibraryLoad(node=dec, kind=hit[0], entry=hit[1],
                                           source=None, enclosing=stack,
                                           target=node.name))
                visit(dec, stack, node.name)
            for stmt in node.body:
                visit(stmt, stack + (node,), None)
            return
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target = node.targets[0].id
        if isinstance(node, ast.Call):
            hit = kind_of(node.func)
            if hit is not None:
                arg = node.args[0] if node.args else None
                tgt = target
                if hit[0] == "graph" and isinstance(arg, ast.Name):
                    tgt = arg.id  # `with torch.cuda.graph(g):` captures g
                out.append(LibraryLoad(
                    node=node, kind=hit[0], entry=hit[1],
                    source=_load_source(arg, mod) if hit[0] == "load" else None,
                    enclosing=stack, target=tgt))
        for child in ast.iter_child_nodes(node):
            visit(child, stack, target if isinstance(node, (ast.Assign, ast.FunctionDef,
                                                            ast.AsyncFunctionDef)) else None)

    visit(mod.tree, (), None)
    return out


# ---------------------------------------------------------------------------
# collectives (RPR4xx)
# ---------------------------------------------------------------------------
COLLECTIVE_SITES = ("repro_torch.core.collective.all_reduce_sum",
                    "repro_torch.core.collective.all_reduce_max",
                    "repro_torch.core.collective.all_gather",
                    "repro_torch.core.collective.all_to_all")
DIST_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "all_gather_coalesced", "broadcast", "broadcast_object_list", "reduce",
    "reduce_scatter", "reduce_scatter_tensor", "gather", "gather_object",
    "scatter", "scatter_object_list", "all_to_all", "all_to_all_single",
    "barrier", "monitored_barrier", "send", "recv", "isend", "irecv",
    "send_object_list", "recv_object_list", "batch_isend_irecv",
}


def is_dist_collective(qualified: str) -> bool:
    """``torch.distributed.<collective>``, however it was imported."""
    base, _, name = qualified.rpartition(".")
    return base == "torch.distributed" and name in DIST_COLLECTIVES


def _resolves_outside(name: str, imports: dict[str, str]) -> bool:
    """The call target's root is a module imported from outside the port
    (``np.``, ``subprocess.``...): nothing there reaches our collective."""
    root = name.split(".")[0]
    return root in imports and not imports[root].startswith("repro_torch")


@functools.lru_cache(maxsize=1)
def _port_modules() -> tuple[ModuleInfo, ...]:
    """The port's own modules, parsed once: the project that a linted file
    calls into, whatever paths the run was given."""
    out = []
    for path in sorted(PORT_ROOT.rglob("*.py")):
        try:
            out.append(load_module(path))
        except SyntaxError:
            continue  # reported when the file itself is linted
    return tuple(out)


def reaches_collective(call: ast.Call, imports: dict[str, str],
                       reachers: set[str]) -> bool:
    name = dotted(call.func)
    if is_dist_collective(qualify(name, imports)):
        return True
    return bool(name) and callee(call) in reachers \
        and not _resolves_outside(name, imports)


def collective_reachers(mods: Iterable[ModuleInfo]) -> set[str]:
    """Bare names of the functions, methods and classes (by ``__init__``)
    that reach one of ``COLLECTIVE_SITES`` or a
    ``torch.distributed`` collective, over the given modules and the port's own, to a fixpoint.
    By name, not by object: a method of another class with a reacher's name
    counts as one (the rules keyed on this err towards a finding)."""
    seen: dict[Path, ModuleInfo] = {}
    for mod in list(mods) + list(_port_modules()):
        seen.setdefault(mod.path.resolve(), mod)
    bodies: list[tuple[str, list[ast.Call], dict[str, str]]] = []
    for mod in seen.values():
        imports = module_imports(mod)
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                calls = [n for n in ast.walk(node) if isinstance(n, ast.Call)]
                bodies.append((node.name, calls, imports))
            elif isinstance(node, ast.ClassDef):
                init = [n for stmt in node.body
                        if isinstance(stmt, ast.FunctionDef)
                        and stmt.name in ("__init__", "__post_init__")
                        for n in ast.walk(stmt) if isinstance(n, ast.Call)]
                bodies.append((node.name, init, imports))
    reachers = {site.rsplit(".", 1)[-1] for site in COLLECTIVE_SITES}
    changed = True
    while changed:
        changed = False
        for name, calls, imports in bodies:
            if name not in reachers and any(
                    reaches_collective(c, imports, reachers) for c in calls):
                reachers.add(name)
                changed = True
    return reachers


# ---------------------------------------------------------------------------
# rule base + analyzer
# ---------------------------------------------------------------------------
class Rule:
    """One checker. Subclasses set ``rule_id``/``title`` and implement
    ``check_module``; project-wide rules (RPR201, RPR402) implement
    ``check_project`` over every module at once and set
    ``project_level = True``."""

    rule_id: str = "RPR000"
    title: str = ""
    project_level: bool = False

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        return iter(())

    def check_project(self, mods: list[ModuleInfo]) -> Iterator[Finding]:
        return iter(())


@dataclass
class AnalysisResult:
    findings: list[Finding]
    suppressed: list[tuple[Finding, str]]   # (finding, reason)
    files: int

    @property
    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))


class Analyzer:
    def __init__(self, rules: Iterable[Rule], root: Path | None = None):
        self.rules = list(rules)
        self.root = root

    def _collect_paths(self, paths: Iterable[Path]) -> list[Path]:
        out: list[Path] = []
        for p in paths:
            p = Path(p)
            if p.is_dir():
                out.extend(sorted(p.rglob("*.py")))
            elif p.suffix == ".py":
                out.append(p)
        return out

    def run(self, paths: Iterable[Path]) -> AnalysisResult:
        files = self._collect_paths(paths)
        mods: list[ModuleInfo] = []
        raw: list[Finding] = []
        for path in files:
            try:
                mod = load_module(path)
            except SyntaxError as e:
                raw.append(Finding(
                    rule=FRAMEWORK_RULE, path=str(path),
                    line=e.lineno or 0, message=f"syntax error: {e.msg}"))
                continue
            mods.append(mod)
            for line, msg in mod.pragmas.malformed:
                raw.append(Finding(rule=FRAMEWORK_RULE, path=mod.rel(),
                                   line=line,
                                   message=f"malformed pragma: {msg}"))
            for rule in self.rules:
                if not rule.project_level:
                    raw.extend(rule.check_module(mod))
        for rule in self.rules:
            if rule.project_level:
                raw.extend(rule.check_project(mods))

        # rules key findings on mod.rel() (no root); match suppressions on
        # that same key, then relativize for display
        by_path = {mod.rel(): mod for mod in mods}
        rel_path = {mod.rel(): mod.rel(self.root) for mod in mods}
        findings: list[Finding] = []
        suppressed: list[tuple[Finding, str]] = []
        for f in raw:
            mod = by_path.get(f.path)
            sup = mod.pragmas.is_suppressed(f.rule, f.line) if mod else None
            if f.path in rel_path and rel_path[f.path] != f.path:
                f = replace(f, path=rel_path[f.path])
            if sup is not None and f.rule != FRAMEWORK_RULE:
                suppressed.append((f, sup.reason))
            else:
                findings.append(f)
        findings.sort(key=Finding.sort_key)
        return AnalysisResult(findings=findings, suppressed=suppressed,
                              files=len(files))


def run_analysis(paths: Iterable[Path], rules: Iterable[Rule] | None = None,
                 root: Path | None = None) -> AnalysisResult:
    """One-call API: lint ``paths`` with ``rules`` (default: the full
    catalog) and return the filtered result."""
    if rules is None:
        from repro_torch.analysis.rules import ALL_RULES
        rules = [cls() for cls in ALL_RULES]
    return Analyzer(rules, root=root).run(paths)


__all__ = [
    "Analyzer", "AnalysisResult", "Finding", "LibraryLoad", "ModuleInfo",
    "PassLoop", "Rule", "callee", "collective_reachers", "dotted",
    "dotted_module_name", "dynamic_names", "find_library_loads",
    "find_pass_loops", "is_dist_collective", "iter_function_defs",
    "load_module", "module_imports", "names_in", "param_names",
    "per_pass_functions", "qualify", "reaches_collective", "run_analysis",
    "tainted_names", "tensor_names", "tensor_taint", "walk_local",
    "CHECKPOINT_MODULES", "CheckpointCalls", "checkpoint_calls",
    "PASS_SEEDS", "STATIC_ATTRS", "LOAD_ENTRY",
]
