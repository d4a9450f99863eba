# Hand-written CUDA kernels for the compute hot spots, each beside its plain
# PyTorch version:
#   segsum.py — sorted segment-sum (K1, csrc/segsum.cu): the paper's
#               part-2 atomicSub as a deterministic run reduction
#   ops.py    — the public ops over it; ref.py — the plain versions.
from repro_torch.kernels.ops import peel_update, segment_sum
from repro_torch.kernels.ref import peel_update_ref, segment_sum_ref
from repro_torch.kernels.segsum import segment_sum_sorted

__all__ = [
    "peel_update",
    "segment_sum",
    "segment_sum_sorted",
    "peel_update_ref",
    "segment_sum_ref",
]
