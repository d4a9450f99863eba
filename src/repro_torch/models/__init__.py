# Model zoo, as far as it is ported: DCN-v2 with its EmbeddingBag over K5
# (recsys.py), the GNNs with their message passing over K1 (gnn.py), and the
# carrying-across of the JAX package's parameters (convert.py). The
# transformer family comes with ROADMAP.md section 1, item 13b (6d).
from repro_torch.models.convert import dcn_params_from_jax, gnn_params_from_jax
from repro_torch.models.gnn import (
    EGNN, GCN, MACE, EGNNConfig, GCNConfig, MACEConfig, SchNet, SchNetConfig,
    egnn_forward, egnn_init, egnn_loss, gcn_forward, gcn_init, gcn_loss,
    mace_forward, mace_init, mace_loss, schnet_forward, schnet_init, schnet_loss,
)
from repro_torch.models.recsys import (
    DCNConfig, DCNv2, dcn_forward, dcn_init, dcn_loss, embedding_bag, retrieval_score,
)

__all__ = ["DCNConfig", "DCNv2", "dcn_forward", "dcn_init", "dcn_loss",
           "dcn_params_from_jax", "embedding_bag", "retrieval_score",
           "GCNConfig", "GCN", "gcn_init", "gcn_forward", "gcn_loss",
           "SchNetConfig", "SchNet", "schnet_init", "schnet_forward", "schnet_loss",
           "EGNNConfig", "EGNN", "egnn_init", "egnn_forward", "egnn_loss",
           "MACEConfig", "MACE", "mace_init", "mace_forward", "mace_loss",
           "gnn_params_from_jax"]
