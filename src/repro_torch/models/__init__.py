# Model zoo: DCN-v2 with its EmbeddingBag over K5 (recsys.py), the GNNs with
# their message passing over K1 (gnn.py), the transformer family's serving
# path and training loss (layers.py, moe.py, moe_tp.py, transformer.py), and
# the carrying-across of the JAX package's parameters and LM train state
# (convert.py).
from repro_torch.models.convert import (
    LM_STATE_LAYOUT, dcn_params_from_jax, gnn_params_from_jax, lm_params_from_jax,
    lm_state_from_jax, lm_state_to_jax, moe_params_from_jax,
)
from repro_torch.models.gnn import (
    EGNN, GCN, MACE, EGNNConfig, GCNConfig, MACEConfig, SchNet, SchNetConfig,
    egnn_forward, egnn_init, egnn_loss, gcn_forward, gcn_init, gcn_loss,
    mace_forward, mace_init, mace_loss, schnet_forward, schnet_init, schnet_loss,
)
from repro_torch.models.moe import MoEConfig, init_moe_params, moe_dense, moe_ep
from repro_torch.models.moe_tp import moe_tp
from repro_torch.models.recsys import (
    DCNConfig, DCNv2, dcn_forward, dcn_init, dcn_loss, embedding_bag, retrieval_score,
)
from repro_torch.models.transformer import (
    Transformer, TransformerConfig, decode_step, forward, init_cache, init_params, loss_fn,
    prefill,
)

__all__ = ["DCNConfig", "DCNv2", "dcn_forward", "dcn_init", "dcn_loss",
           "dcn_params_from_jax", "embedding_bag", "retrieval_score",
           "GCNConfig", "GCN", "gcn_init", "gcn_forward", "gcn_loss",
           "SchNetConfig", "SchNet", "schnet_init", "schnet_forward", "schnet_loss",
           "EGNNConfig", "EGNN", "egnn_init", "egnn_forward", "egnn_loss",
           "MACEConfig", "MACE", "mace_init", "mace_forward", "mace_loss",
           "gnn_params_from_jax",
           "MoEConfig", "init_moe_params", "moe_dense", "moe_ep", "moe_tp", "moe_params_from_jax",
           "TransformerConfig", "Transformer", "init_params", "forward", "prefill",
           "loss_fn", "init_cache", "decode_step", "lm_params_from_jax",
           "lm_state_to_jax", "lm_state_from_jax", "LM_STATE_LAYOUT"]
