"""Mistral-Nemo-Base-2407 (12B dense) [hf:mistralai/Mistral-Nemo-Base-2407].

40L, d_model 5120, 32 heads (GQA kv=8), head_dim 128 (decoupled from
d_model/n_heads), d_ff 14336, vocab 131072, 128k-context RoPE (theta 1e6).
The same configs as the JAX package's ``configs/mistral_nemo_12b.py``, with
torch dtypes.
"""
import torch

from repro_torch.configs.common import Arch, lm_shapes
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="mistral-nemo-12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, rope_theta=1e6,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat=True, fsdp=True,
)

SMOKE = TransformerConfig(
    name="mistral-nemo-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, rope_theta=1e6,
)

ARCH = Arch(
    name="mistral-nemo-12b", family="lm", full=FULL, smoke=SMOKE,
    shapes=lm_shapes(long_adapted=True), optimizer="adamw", microbatches=4,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
    note="pure full attention -> long_500k served via sliding-window cache",
)
