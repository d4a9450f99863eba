"""P-Bahmani (Bahmani, Kumar, Vassilvitskii 2012; the paper's Algorithm 1) in
plain NumPy: the yardstick the port's answers are held to, bit for bit.

Every vertex whose degree is at most ``2 (1 + eps) rho`` fails in a pass;
``rho = |E| / |V|`` of the live subgraph. The density, the threshold and the
degree test are float32 as the system states them: ``rho`` one float32
division of the counts, the constant ``2 (1 + eps)`` rounded to float32 and
multiplied in float32. Counts are exact integers. The best density is
updated on a strict increase only, so the first subgraph at the maximum is
the one reported.

``precision="bfloat16"`` computes the threshold and the degree test in
bfloat16 instead: the control, which a correct check must tell apart.
"""
from __future__ import annotations

import numpy as np

PRECISIONS = ("float32", "bfloat16")


def to_bfloat16(x) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), held
    as float32."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def rounder(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
    return np.float32 if precision == "float32" else to_bfloat16


def pbahmani_ref(n_nodes: int, src: np.ndarray, dst: np.ndarray, eps: float,
                 precision: str = "float32") -> tuple[np.float32, np.ndarray, int]:
    """``(best_density, best_mask, passes)`` over the symmetric directed lanes
    ``src -> dst`` (each undirected edge twice, no padding, no self-loop)."""
    rnd = rounder(precision)
    s = np.asarray(src, dtype=np.int64)
    d = np.asarray(dst, dtype=np.int64)
    deg = np.bincount(s, minlength=n_nodes).astype(np.int64)
    active = deg > 0
    n_v = int(active.sum())
    n_e = s.size // 2
    best = np.float32(np.float32(n_e) / np.float32(max(n_v, 1)))
    best_mask = active.copy()
    factor = rnd(np.float32(2.0 * (1.0 + eps)))
    passes = 0
    while n_v > 0:
        rho = rnd(np.float32(n_e) / np.float32(n_v))
        thr = rnd(np.float32(rho * factor))
        failed = active & (rnd(deg.astype(np.float32)) <= thr)
        live = active[s] & active[d]
        fs = failed[s] & live
        fd = failed[d] & live
        n_e -= int(np.count_nonzero(fs | fd)) // 2
        delta = np.bincount(d[fs], minlength=n_nodes)
        active &= ~failed
        deg = np.where(active, deg - delta, 0)
        n_v -= int(np.count_nonzero(failed))
        passes += 1
        if n_v > 0:
            rho_new = np.float32(np.float32(n_e) / np.float32(n_v))
            if rho_new > best:
                best, best_mask = rho_new, active.copy()
    return best, best_mask, passes


__all__ = ["PRECISIONS", "to_bfloat16", "rounder", "pbahmani_ref"]
