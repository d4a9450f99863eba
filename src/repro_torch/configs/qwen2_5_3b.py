"""Qwen2.5-3B [hf:Qwen/Qwen2.5-3B family]. 36L, d_model 2048, 16 heads
(GQA kv=2), d_ff 11008, vocab 151936, QKV bias. The same configs as the JAX
package's ``configs/qwen2_5_3b.py``, with torch dtypes."""
import torch

from repro_torch.configs.common import Arch, lm_shapes
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen2.5-3b",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, vocab=151936, qkv_bias=True, rope_theta=1e6,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat=True,
)

SMOKE = TransformerConfig(
    name="qwen2.5-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=256, qkv_bias=True,
)

ARCH = Arch(
    name="qwen2.5-3b", family="lm", full=FULL, smoke=SMOKE,
    shapes=lm_shapes(long_adapted=True), optimizer="adamw", microbatches=1,
    train_layout="zero3",
    source="hf:Qwen/Qwen2.5-3B",
    note="pure full attention -> long_500k served via sliding-window cache",
)
