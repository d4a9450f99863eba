# Near-optimal refinement, one device: iterated weighted peeling (Greedy++ /
# Frank-Wolfe on the load-balancing LP) with exact-rational duality-gap
# certificates, between the (2+2eps)-approximate peels and the exact flow
# solver.
#
#   loads.py   — edge-load state + the weighted-peel pass and round (K2)
#   certify.py — LP-duality gap certificates (exact ints) + numpy bit-oracle
#   engine.py  — refine(graph, target_gap=...) anytime API with history
from repro_torch.refine.certify import (
    GapCertificate, make_certificate, oracle_check, refine_round_np,
)
from repro_torch.refine.engine import (
    DEFAULT_TARGET_GAP, RefineResult, RoundRecord, refine, refine_resident,
)

__all__ = [
    "GapCertificate",
    "make_certificate",
    "oracle_check",
    "refine_round_np",
    "DEFAULT_TARGET_GAP",
    "RefineResult",
    "RoundRecord",
    "refine",
    "refine_resident",
]
