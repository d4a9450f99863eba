"""Wall-clock timing helpers for benches (synchronising on CUDA outputs)."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch


@dataclass
class Timer:
    """Accumulating wall-clock timer."""

    elapsed: float = 0.0
    _start: float = field(default=0.0, repr=False)

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.elapsed += time.perf_counter() - self._start


def _leaves(x: Any):
    if isinstance(x, (list, tuple)):
        for item in x:
            yield from _leaves(item)
    elif isinstance(x, dict):
        for item in x.values():
            yield from _leaves(item)
    else:
        yield x


def _block(x: Any) -> None:
    """Wait for the card on every CUDA device among the tensors in ``x``
    (nested lists, tuples, named tuples and dicts), once per device."""
    devices = {leaf.device for leaf in _leaves(x)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


def time_fn(
    fn: Callable[..., Any],
    *args: Any,
    iters: int = 5,
    warmup: int = 1,
    **kwargs: Any,
) -> tuple[float, Any]:
    """Time ``fn(*args, **kwargs)``; returns (seconds_per_call, last_result).

    Synchronises on every CUDA tensor among the outputs, so the card's
    asynchronous launches don't hide work.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        _block(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
        _block(out)
    return (time.perf_counter() - t0) / iters, out
