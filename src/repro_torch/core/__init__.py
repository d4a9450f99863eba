# The paper's primary contribution on the GPU: P-Bahmani (Alg. 1) and
# CBDS-P (Alg. 2) over the sorted segment-sum kernel, the candidate-pruned
# peel (prune.py, with the compaction kernels), and the exact (Goldberg
# flow) and serial greedy (Charikar) baselines the paper evaluates against,
# and the sharded tier over torch.distributed (distributed.py).
# Only what is ported is exported; ROADMAP.md lists what is still to come.
from repro_torch.core.cbds import cbds_np, cbds_p
from repro_torch.core.charikar import charikar, degeneracy_order
from repro_torch.core.density import check_approx_bound, subgraph_density
from repro_torch.core.distributed import (
    Mesh, cbds_distributed, make_mesh, pbahmani_distributed,
)
from repro_torch.core.exact import exact_densest
from repro_torch.core.kcore import kcore_decompose, kcore_np
from repro_torch.core.pbahmani import pbahmani, pbahmani_np, pbahmani_pass
from repro_torch.core.prune import (
    PrunePlan, build_plan, pbahmani_pruned, plan_for_graph,
)

__all__ = [
    "cbds_np",
    "cbds_p",
    "charikar",
    "degeneracy_order",
    "check_approx_bound",
    "subgraph_density",
    "Mesh",
    "cbds_distributed",
    "make_mesh",
    "pbahmani_distributed",
    "exact_densest",
    "kcore_decompose",
    "kcore_np",
    "pbahmani",
    "pbahmani_np",
    "pbahmani_pass",
    "PrunePlan",
    "build_plan",
    "pbahmani_pruned",
    "plan_for_graph",
]
