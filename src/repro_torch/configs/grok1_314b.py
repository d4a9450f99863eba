"""Grok-1 (314B MoE) [hf:xai-org/grok-1]. 64L, d_model 6144, 48 heads
(GQA kv=8), d_ff 32768 per expert, vocab 131072, MoE 8 experts top-2.

8 experts < |model|=16 -> TP-within-expert MoE over a mesh
(models/moe_tp.py); on one device the MoE is ``moe_ep``'s body. The same
configs as the JAX package's ``configs/grok1_314b.py``, with torch dtypes.
"""
import torch

from repro_torch.configs.common import Arch, lm_shapes
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="grok-1-314b",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072, rope_theta=1e4,
    moe=MoEConfig(n_experts=8, top_k=2, d_model=6144, d_ff=32768,
                  capacity_factor=1.25, compute_dtype=torch.bfloat16),
    n_dense_layers=0,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat=True, fsdp=True,
)

SMOKE = TransformerConfig(
    name="grok1-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    moe=MoEConfig(n_experts=4, top_k=2, d_model=64, d_ff=128,
                  capacity_factor=4.0),
    n_dense_layers=0,
)

ARCH = Arch(
    name="grok-1-314b", family="lm", full=FULL, smoke=SMOKE,
    shapes=lm_shapes(long_adapted=True), optimizer="adafactor", microbatches=8,
    grad_accum_dtype="bfloat16",
    source="hf:xai-org/grok-1",
    note="8 experts % 16 != 0 -> TP-within-expert MoE; Adafactor for opt-state",
)
