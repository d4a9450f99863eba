"""DCN-v2 [arXiv:2008.13535]: 13 dense + 26 sparse features, embed_dim 16,
3 cross layers, MLP 1024-1024-512. The same configs as the JAX package's
``configs/dcn_v2.py``; on one card the tables are not sharded."""
from repro_torch.configs.common import Arch, RECSYS_SHAPES
from repro_torch.models.recsys import DCNConfig

FULL = DCNConfig(name="dcn-v2", n_dense=13, n_sparse=26, embed_dim=16,
                 table_rows=1_000_000, n_cross_layers=3,
                 mlp=(1024, 1024, 512))
SMOKE = DCNConfig(name="dcn-smoke", n_dense=13, n_sparse=26, embed_dim=8,
                  table_rows=1000, n_cross_layers=2, mlp=(64, 32))

ARCH = Arch(
    name="dcn-v2", family="recsys", full=FULL, smoke=SMOKE,
    shapes=RECSYS_SHAPES, optimizer="adamw", source="arXiv:2008.13535",
    note="EmbeddingBag = the fused gather and segment-sum K5 (kernels/embed.py)",
)
