from repro_torch.data.pipeline import (
    GraphBatcher, gnn_batch, lm_token_batches, recsys_batches,
)

__all__ = ["lm_token_batches", "recsys_batches", "gnn_batch", "GraphBatcher"]
