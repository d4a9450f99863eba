"""RPR2xx — auditor-coverage rules.

What the port builds at run time is a kernel library (a ``.so`` that
``nvcc`` made from ``csrc/``), and, once passes are captured, a CUDA
graph. ``DeltaEngine.compile_count()`` and the recompile auditor see only
what the ``"kernels"`` provider of ``kernels/build.py`` yields: the
libraries loaded through ``build.load`` and the captures registered in
``build.GRAPH_CAPTURES``. A load that bypasses ``build.load`` or a capture
that never registers silently under-counts. RPR201 closes that hole
statically: every ``ctypes.CDLL``-style load must be ``build.load``'s own,
every CUDA-graph capture or ``torch.compile`` must be appended to a
``GRAPH_CAPTURES`` list in its module, or the site is marked
``# repro: unaudited -- <reason>``. In dynamic mode the rule also reads
the runtime's own ``AUDITOR.providers_snapshot()``, so the checker and
the auditor can never drift: ``build.load`` must be an entry of it.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.framework import (
    BUILD_MODULE, LOAD_ENTRY, Finding, LibraryLoad, ModuleInfo, Rule, dotted,
    find_library_loads,
)

PROVIDER = "kernels"


def _registered(mod: ModuleInfo) -> set[str]:
    """Names appended to, or listed in, a ``GRAPH_CAPTURES`` list in this
    module (``build.GRAPH_CAPTURES.append(graph)`` and friends)."""
    out: set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("append", "extend") \
                and dotted(node.func.value).endswith("GRAPH_CAPTURES"):
            out |= {n.id for a in node.args for n in ast.walk(a)
                    if isinstance(n, ast.Name)}
        elif isinstance(node, ast.Assign) and any(
                dotted(t).endswith("GRAPH_CAPTURES") for t in node.targets):
            out |= {n.id for n in ast.walk(node.value) if isinstance(n, ast.Name)}
    return out


def load_provider_entry_points() -> set[str] | None:
    """Qualified ``module.name`` of every entry the runtime auditor's
    ``"kernels"`` provider yields. Returns None when the runtime tree
    cannot be imported (pure-static mode) — the provider check is then
    skipped rather than mis-reported."""
    try:
        import repro_torch.kernels.build  # noqa: F401  (registers the provider)
        from repro_torch.obs.audit import AUDITOR

        snapshot = AUDITOR.providers_snapshot()
    except Exception:
        return None
    return set(snapshot.get(PROVIDER, ()))


def _site_lines(site: LibraryLoad) -> set[int]:
    """Lines an ``unaudited`` pragma governing a site may sit on: the
    call's line and the one above, and the enclosing def's."""
    out = {site.lineno, site.lineno - 1}
    if site.enclosing:
        fn = site.enclosing[-1]
        out |= {fn.lineno, fn.lineno - 1}
        for dec in fn.decorator_list:
            out |= {dec.lineno, dec.lineno - 1}
    return out


class AuditCoverageRule(Rule):
    rule_id = "RPR201"
    title = "library load or graph capture not counted by the auditor's kernels provider"
    project_level = True

    def __init__(self, dynamic: bool = True):
        self._dynamic = dynamic
        self._provider_entries: set[str] | None = None
        self._loaded = False

    def _entries(self) -> set[str] | None:
        if not self._loaded:
            self._provider_entries = (
                load_provider_entry_points() if self._dynamic else None)
            self._loaded = True
        return self._provider_entries

    def check_project(self, mods: list[ModuleInfo]) -> Iterator[Finding]:
        entries = self._entries()
        for mod in mods:
            rel = mod.rel()
            registered = _registered(mod)
            for site in find_library_loads(mod):
                if mod.pragmas.unaudited_reason(_site_lines(site)) is not None:
                    continue
                context = site.enclosing[-1].name if site.enclosing else "<module>"
                if site.kind == "load":
                    if entries is None or LOAD_ENTRY in entries:
                        continue  # pure-static mode: cannot prove either way
                    yield Finding(
                        rule=self.rule_id, path=rel, line=site.lineno,
                        context=context,
                        message=f"{LOAD_ENTRY} is not yielded by the auditor's "
                                f"'{PROVIDER}' provider (obs.audit.AUDITOR."
                                "providers_snapshot()) — compile_count() "
                                "misses this load")
                elif site.kind == "library":
                    if mod.module == BUILD_MODULE and context == "load":
                        continue  # build.load's own load: what the provider counts
                    yield Finding(
                        rule=self.rule_id, path=rel, line=site.lineno,
                        context=context,
                        message=f"{site.entry}(...) loads a library around "
                                "kernels/build.py:load, so the auditor's "
                                f"'{PROVIDER}' provider never counts it; load "
                                "through build.load or mark it "
                                "'# repro: unaudited -- <reason>'")
                elif site.target not in registered:
                    yield Finding(
                        rule=self.rule_id, path=rel, line=site.lineno,
                        context=context,
                        message=f"{site.entry} result '{site.target}' is never "
                                "appended to build.GRAPH_CAPTURES, so the "
                                f"auditor's '{PROVIDER}' provider cannot count "
                                "its captures; register it or mark it "
                                "'# repro: unaudited -- <reason>'")


__all__ = ["AuditCoverageRule", "load_provider_entry_points", "PROVIDER"]
