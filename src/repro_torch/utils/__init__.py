from repro_torch.utils.num import next_pow2

__all__ = ["next_pow2"]
