"""Rule catalog for the port's invariant linter.

Five families, one module each, under the rule IDs of the JAX package's
linter — each rule here is the torch counterpart of the JAX rule of the
same ID:

==========  ================================================================
RPR001      malformed ``# repro:`` pragma (framework-emitted)
RPR101      host sync in a pass loop (.item()/.tolist()/.cpu()/int(tensor))
RPR102      Python if/while/assert on a tensor in a pass loop
RPR103      tensor used as a dict key / set element / in an f-string there
RPR104      library load, CUDA graph or torch.compile made per call
RPR201      library load or graph capture the auditor's provider misses
RPR301      float literal inside a ``# repro: proof`` scope
RPR302      true division inside a proof scope
RPR303      float dtype / float cast inside a proof scope
RPR304      f32-envelope edge stage called without assert_exact_envelope
RPR401      torch.distributed collective outside core/collective.py's four sites
RPR402      collective-reaching call under a rank-dependent branch
RPR501      bucket-factory argument missing from the fused bucket key
==========  ================================================================
"""
from repro_torch.analysis.rules.audit import AuditCoverageRule
from repro_torch.analysis.rules.collective import (
    RankDivergenceRule, CollectiveSiteRule,
)
from repro_torch.analysis.rules.exact import (
    EnvelopeRule, FloatDtypeRule, FloatLiteralRule, TrueDivisionRule,
)
from repro_torch.analysis.rules.fused import BucketKeyRule
from repro_torch.analysis.rules.trace import (
    HostSyncRule, PerCallBuildRule, TensorControlFlowRule, TensorKeyRule,
)

ALL_RULES = [
    HostSyncRule, TensorControlFlowRule, TensorKeyRule, PerCallBuildRule,
    AuditCoverageRule,
    FloatLiteralRule, TrueDivisionRule, FloatDtypeRule, EnvelopeRule,
    CollectiveSiteRule, RankDivergenceRule,
    BucketKeyRule,
]

RULE_CATALOG = {cls.rule_id: cls.title for cls in ALL_RULES}
RULE_CATALOG["RPR001"] = "malformed # repro: pragma"


def rules_by_id(ids=None):
    """Instantiate the catalog, optionally filtered to the given rule IDs."""
    classes = ALL_RULES if not ids else [
        cls for cls in ALL_RULES if cls.rule_id in set(ids)]
    return [cls() for cls in classes]


__all__ = ["ALL_RULES", "RULE_CATALOG", "rules_by_id"]
