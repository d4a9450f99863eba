"""EGNN [arXiv:2102.09844]: 4 layers, d_hidden 64, E(n)-equivariant. The
same configs as the JAX package's ``configs/egnn.py``."""
from repro_torch.configs.common import Arch, GNN_SHAPES
from repro_torch.models.gnn import EGNNConfig

FULL = EGNNConfig(name="egnn", n_layers=4, d_hidden=64)
SMOKE = EGNNConfig(name="egnn-smoke", n_layers=2, d_hidden=16)

ARCH = Arch(
    name="egnn", family="gnn", full=FULL, smoke=SMOKE, shapes=GNN_SHAPES,
    optimizer="adamw", source="arXiv:2102.09844",
    note="irrep-free equivariance (l=1 via coordinate updates)",
)
