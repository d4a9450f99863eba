# Model zoo, as far as it is ported: DCN-v2 with its EmbeddingBag over K5
# (recsys.py) and the carrying-across of the JAX package's parameters
# (convert.py). The GNNs and the transformer family come with ROADMAP.md
# section 1, item 13.
from repro_torch.models.convert import dcn_params_from_jax
from repro_torch.models.recsys import (
    DCNConfig, DCNv2, dcn_forward, dcn_init, dcn_loss, embedding_bag, retrieval_score,
)

__all__ = ["DCNConfig", "DCNv2", "dcn_forward", "dcn_init", "dcn_loss",
           "dcn_params_from_jax", "embedding_bag", "retrieval_score"]
