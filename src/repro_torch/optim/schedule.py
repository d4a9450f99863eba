"""LR schedules: pure functions of an int32 step tensor (or a Python int)
that return a float32 0-d tensor on the step's device.

Every quotient has a tensor divisor: CUDA divides by a Python scalar
through its reciprocal, whose product can differ from the true quotient
(the JAX package's) in the last bit; a tensor divisor keeps the card's
value equal to the CPU's."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step)


def _div(a: torch.Tensor, b) -> torch.Tensor:
    return a / torch.full_like(a, b)


def constant(lr: float):
    def f(step):
        # a fill on the step's device: torch.tensor would copy from the host,
        # a sync on the card each update
        return torch.full((), lr, dtype=torch.float32, device=_step(step).device)
    return f


def linear_warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` then cosine decay to ``final_frac``·peak."""
    def f(step):
        step = _step(step).to(torch.float32)
        warm = _div(peak_lr * step, max(warmup_steps, 1))
        prog = torch.clamp(_div(step - warmup_steps, max(total_steps - warmup_steps, 1)),
                           0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return f


__all__ = ["constant", "linear_warmup_cosine"]
