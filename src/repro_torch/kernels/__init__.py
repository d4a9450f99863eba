# Hand-written CUDA kernels for the compute hot spots, each beside its plain
# PyTorch version:
#   segsum.py  — sorted segment-sum (K1, csrc/segsum.cu): the paper's
#                part-2 atomicSub as a deterministic run reduction
#   peel.py    — the peel pass's fused edge stage (K2, csrc/peel.cu): live
#                mask, failed gathers, degree decrements, removed count and
#                refinement's charges in one pass; K1 and K2 share the
#                segmented-reduction core csrc/seg_reduce.cuh
#   compact.py — int32 prefix sum (K3) and stream compaction (K4,
#                csrc/compact.cu): the pruned peel's in-bucket ladder
#   embed.py   — fused gather and segment-sum (K5, csrc/embed.cu): the
#                DCN-v2 EmbeddingBag, all tables in one launch
#   ops.py     — the public ops over K1, K2 and K5; ref.py — the plain versions;
#   build.py   — nvcc at first use, one hash-keyed library per source.
from repro_torch.kernels.compact import prefix_sum, stream_compact
from repro_torch.kernels.embed import segment_embed_sorted
from repro_torch.kernels.ops import peel_update, segment_embed, segment_sum
from repro_torch.kernels.peel import peel_edges_sorted
from repro_torch.kernels.ref import (
    peel_edges_ref, peel_update_ref, prefix_sum_ref, segment_embed_ref, segment_sum_ref,
    stream_compact_ref,
)
from repro_torch.kernels.segsum import segment_sum_sorted

__all__ = [
    "peel_edges_sorted",
    "peel_update",
    "prefix_sum",
    "segment_embed",
    "segment_embed_sorted",
    "segment_sum",
    "segment_sum_sorted",
    "stream_compact",
    "peel_edges_ref",
    "peel_update_ref",
    "prefix_sum_ref",
    "segment_embed_ref",
    "segment_sum_ref",
    "stream_compact_ref",
]
