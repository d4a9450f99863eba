# The paper's primary contribution on the GPU: P-Bahmani (Alg. 1) and
# CBDS-P (Alg. 2) over the sorted segment-sum kernel. Only what is ported
# is exported; ROADMAP.md lists what is still to come.
from repro_torch.core.cbds import cbds_np, cbds_p
from repro_torch.core.density import check_approx_bound, subgraph_density
from repro_torch.core.kcore import kcore_decompose, kcore_np
from repro_torch.core.pbahmani import pbahmani, pbahmani_np, pbahmani_pass

__all__ = [
    "cbds_np",
    "cbds_p",
    "check_approx_bound",
    "subgraph_density",
    "kcore_decompose",
    "kcore_np",
    "pbahmani",
    "pbahmani_np",
    "pbahmani_pass",
]
