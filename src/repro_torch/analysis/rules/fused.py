"""RPR5xx: fused-bucket-key completeness.

The fused multi-tenant layer (repro_torch.stream.fused) batches tenants
by routing every one through a bucket key computed in
``FusedPool.batch_for``: two tenants whose key tuples compare equal land
in the same ``TenantBatch`` stack and therefore run every batched pass
together. That is only sound if every argument that can change the
batched program — capacities, eps, the kernel tier, the device and the
mesh — feeds the key. An argument the factory accepts but never hashes
silently aliases two incompatible tenants onto one bucket: the bug class
this rule guards against is a replicated and a mesh-sharded tenant
sharing a lane stack.

RPR501 anchors on functions named ``batch_for`` (the bucket-factory
naming convention) and requires every non-``self`` parameter to appear
in a ``key = (...)`` assignment inside the function. Static by design:
the key must be derivable from the arguments alone — a key computed
through module state would not be checkable, and would also not be
cache-stable.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.framework import (
    Finding, ModuleInfo, Rule, iter_function_defs, names_in, param_names,
)

BUCKET_FACTORY_NAMES = ("batch_for",)


class BucketKeyRule(Rule):
    """RPR501: every bucket-factory parameter must feed the bucket key."""

    rule_id = "RPR501"
    title = "bucket-factory argument missing from the fused bucket key"

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        for fn, enclosing in iter_function_defs(mod.tree):
            if fn.name not in BUCKET_FACTORY_NAMES:
                continue
            context = ".".join(enclosing + (fn.name,))
            params = [p for p in param_names(fn) if p != "self"]
            key_exprs = [
                node.value for node in ast.walk(fn)
                if isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "key"
                        for t in node.targets)
            ]
            if not key_exprs:
                yield Finding(
                    rule=self.rule_id, path=mod.rel(), line=fn.lineno,
                    context=context,
                    message=(f"bucket factory '{fn.name}' has no "
                             f"`key = ...` assignment — bucket sharing "
                             f"cannot be keyed"))
                continue
            used: set[str] = set()
            for expr in key_exprs:
                used |= names_in(expr)
            missing = [p for p in params if p not in used]
            if missing:
                yield Finding(
                    rule=self.rule_id, path=mod.rel(), line=fn.lineno,
                    context=context,
                    message=(f"parameter(s) {', '.join(missing)} never feed "
                             f"the bucket key — tenants differing only in "
                             f"them would alias one bucket"))


__all__ = ["BucketKeyRule", "BUCKET_FACTORY_NAMES"]
