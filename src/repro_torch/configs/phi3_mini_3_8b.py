"""Phi-3-mini (3.8B) [arXiv:2404.14219]. 32L, d_model 3072, 32 heads
(kv=32, i.e. MHA), head_dim 96, d_ff 8192, vocab 32064, RoPE + SwiGLU. The
same configs as the JAX package's ``configs/phi3_mini_3_8b.py``, with torch
dtypes."""
import torch

from repro_torch.configs.common import Arch, lm_shapes
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="phi3-mini-3.8b",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064, rope_theta=1e4,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat=True,
    kv_cache_dtype="int8",   # MHA (kv=32) 32k cache: 1.6 TB bf16 -> 0.8 TB
)

SMOKE = TransformerConfig(
    name="phi3-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, rope_theta=1e4,
)

ARCH = Arch(
    name="phi3-mini-3.8b", family="lm", full=FULL, smoke=SMOKE,
    shapes=lm_shapes(long_adapted=True), optimizer="adamw", microbatches=1,
    train_layout="zero3",
    source="arXiv:2404.14219",
    note="pure full attention -> long_500k served via sliding-window cache",
)
