"""Small numeric helpers shared across subsystems."""
from __future__ import annotations


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (1 for x <= 1)."""
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


__all__ = ["next_pow2"]
