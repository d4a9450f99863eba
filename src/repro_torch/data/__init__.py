from repro_torch.data.pipeline import lm_token_batches, recsys_batches

__all__ = ["lm_token_batches", "recsys_batches"]
