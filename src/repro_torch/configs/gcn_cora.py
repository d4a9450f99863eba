"""GCN (Kipf & Welling) on Cora [arXiv:1609.02907]: 2 layers, d_hidden 16,
mean/symmetric normalization. The same configs as the JAX package's
``configs/gcn_cora.py``."""
from repro_torch.configs.common import Arch, GNN_SHAPES
from repro_torch.models.gnn import GCNConfig

FULL = GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16, d_feat=1433,
                 n_classes=7)
SMOKE = GCNConfig(name="gcn-smoke", n_layers=2, d_hidden=8, d_feat=32,
                  n_classes=4)

ARCH = Arch(
    name="gcn-cora", family="gnn", full=FULL, smoke=SMOKE, shapes=GNN_SHAPES,
    optimizer="adamw", source="arXiv:1609.02907",
    note="d_feat follows the shape (1433 Cora / 100 ogbn-products)",
)
