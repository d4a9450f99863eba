"""Device and kernel-tier dispatch for the peel hot loop.

Every peel-family recurrence reduces a per-edge boolean onto its
destination vertex — the paper's part-2 atomicSub. Two implementations:

  * **scatter** — an int32 ``index_add_`` over ``n_nodes + 1`` segments with
    the sentinel row dropped, on any device;
  * **kernel** — the sorted segment-sum K1 (``kernels.ops.segment_sum``):
    the CUDA kernel on a CUDA tensor, its plain version on a CPU tensor.
    It needs dst-sorted lanes, which ``graphs.convert.to_device`` supplies.

:func:`peel_delta` is the single switch point ``pbahmani_pass`` and
``kcore._level_fixpoint`` route through. Both paths sum the same 0/1 lanes
in int32, so (density, mask, passes) triples match bit for bit with the
knob on or off. The kernel's int32 sums are exact at any size; the 2^24
envelope of the JAX kernel's float32 sums is still asserted at the same API
points, so both packages accept and refuse the same graphs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import segment_sum

# float32 integer-exactness envelope of the JAX package's kernel tier
EXACT_ENVELOPE = 1 << 24


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` means the GPU. Without CUDA that is an error that names the
    way out; an entry point never carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU by default; "
                "pass device='cpu' to run the plain PyTorch path")
        device = "cuda"
    return torch.device(device)


def resolve_kernel(kernel: bool | None, device: torch.device) -> bool:
    """``None`` -> on for a CUDA device, off elsewhere; else bool(kernel)."""
    return device.type == "cuda" if kernel is None else bool(kernel)


def assert_exact_envelope(*counts: int) -> None:
    """Fail fast (host-side, at the entry point) if any capacity could push
    the JAX kernel tier's float32 sums past exact-integer range."""
    for c in counts:
        if int(c) >= EXACT_ENVELOPE:
            raise ValueError(
                f"capacity {int(c)} >= 2^24 breaks the kernel tier's "
                f"float32 exactness envelope; shard the tenant or force "
                f"kernel=False")


def peel_delta(
    fail: torch.Tensor, dst: torch.Tensor, n_nodes: int, kernel: bool
) -> torch.Tensor:
    """Sum a per-edge-lane boolean onto its dst vertex: int32 ``[n_nodes]``.

    ``fail`` is any per-lane bool (failed-src edges for the degree
    decrement); sentinel lanes (dst >= n_nodes) drop on both paths. With
    ``kernel`` the lanes must be dst-sorted.
    """
    if kernel:
        return segment_sum(fail, dst, num_segments=n_nodes,
                           out_dtype=torch.int32)
    out = torch.zeros(n_nodes + 1, dtype=torch.int32, device=dst.device)
    out.index_add_(0, dst.clamp(max=n_nodes), fail.to(torch.int32))
    return out[:n_nodes]


__all__ = ["EXACT_ENVELOPE", "resolve_device", "resolve_kernel",
           "assert_exact_envelope", "peel_delta"]
