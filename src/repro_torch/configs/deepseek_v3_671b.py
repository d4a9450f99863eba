"""DeepSeek-V3 (671B MoE) [arXiv:2412.19437]. 61L (3 dense + 58 MoE),
d_model 7168, 128 heads MLA (q_lora 1536, kv_lora 512, nope 128, rope 64,
v 128), 256 routed experts top-8 + 1 shared (d_ff 2048), dense d_ff 18432,
vocab 129280, MTP depth 1.

MLA's latent KV cache ([B, S, 512+64]) is what makes decode_32k and even
long_500k fit without windowing. The same configs as the JAX package's
``configs/deepseek_v3_671b.py``, with torch dtypes.
"""
import torch

from repro_torch.configs.common import Arch, lm_shapes
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="deepseek-v3-671b",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,                       # the 3 dense layers
    vocab=129280, rope_theta=1e4,
    attn="mla",
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    moe=MoEConfig(n_experts=256, top_k=8, d_model=7168, d_ff=2048,
                  n_shared=1, capacity_factor=1.25,
                  compute_dtype=torch.bfloat16),
    n_dense_layers=3,
    mtp=True,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat=True, fsdp=True,
)

SMOKE = TransformerConfig(
    name="deepseek-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    attn="mla", q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8,
    qk_rope_dim=4, v_head_dim=8,
    moe=MoEConfig(n_experts=4, top_k=2, d_model=64, d_ff=48, n_shared=1,
                  capacity_factor=4.0),
    n_dense_layers=1, mtp=True,
)

ARCH = Arch(
    name="deepseek-v3-671b", family="lm", full=FULL, smoke=SMOKE,
    shapes=lm_shapes(long_adapted=False), optimizer="adafactor",
    microbatches=8, grad_accum_dtype="bfloat16", source="arXiv:2412.19437",
    note="MLA latent cache serves long_500k without windowing; EP all-to-all "
         "MoE (256 % 16 == 0); MTP head in train loss",
)
