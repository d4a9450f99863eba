from repro_torch.utils.num import next_pow2
from repro_torch.utils.timing import Timer, time_fn

__all__ = ["Timer", "time_fn", "next_pow2"]
