"""MACE [arXiv:2206.07697]: 2 layers, d_hidden 128, l_max 2, correlation 3,
8 radial basis functions, E(3)-ACE higher-order message passing. The same
configs as the JAX package's ``configs/mace.py``.

The JAX package's hardware adaptation, kept (``models/gnn.py``): the
Clebsch-Gordan B-basis is simplified to channel-wise invariant contractions
(per-l A-norms and powers up to nu=3) — O(3)-invariant outputs, same
radial × Y_lm edge-embedding compute shape, no irrep-algebra library.
"""
from repro_torch.configs.common import Arch, GNN_SHAPES
from repro_torch.models.gnn import MACEConfig

FULL = MACEConfig(name="mace", n_layers=2, d_hidden=128, l_max=2,
                  correlation=3, n_rbf=8)
SMOKE = MACEConfig(name="mace-smoke", n_layers=1, d_hidden=16, l_max=2,
                   correlation=2, n_rbf=4)

ARCH = Arch(
    name="mace", family="gnn", full=FULL, smoke=SMOKE, shapes=GNN_SHAPES,
    optimizer="adamw", source="arXiv:2206.07697",
    note="simplified invariant B-basis (documented adaptation)",
)
