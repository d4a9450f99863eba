"""SchNet [arXiv:1706.08566]: 3 interactions, d_hidden 64, 300 RBF,
cutoff 10 Å — continuous-filter convolutions. The same configs as the JAX
package's ``configs/schnet.py``."""
from repro_torch.configs.common import Arch, GNN_SHAPES
from repro_torch.models.gnn import SchNetConfig

FULL = SchNetConfig(name="schnet", n_interactions=3, d_hidden=64,
                    n_rbf=300, cutoff=10.0)
SMOKE = SchNetConfig(name="schnet-smoke", n_interactions=1, d_hidden=16,
                     n_rbf=16, cutoff=5.0)

ARCH = Arch(
    name="schnet", family="gnn", full=FULL, smoke=SMOKE, shapes=GNN_SHAPES,
    optimizer="adamw", source="arXiv:1706.08566",
)
