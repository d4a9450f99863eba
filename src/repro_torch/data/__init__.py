from repro_torch.data.pipeline import recsys_batches

__all__ = ["recsys_batches"]
