# Optimizers, schedules and gradient compression: the JAX package's optim/
# over trees of tensors (utils/tree.py).
from repro_torch.optim.compress import compressed_psum, dequantize_int8, quantize_int8
from repro_torch.optim.optimizers import Optimizer, adafactor, adamw, sgdm
from repro_torch.optim.schedule import constant, linear_warmup_cosine
from repro_torch.optim.util import clip_by_global_norm, global_norm

__all__ = [
    "Optimizer", "adamw", "adafactor", "sgdm",
    "constant", "linear_warmup_cosine",
    "quantize_int8", "dequantize_int8", "compressed_psum",
    "clip_by_global_norm", "global_norm",
]
