"""Peaks of the card and the bytes each kernel of the port must move.

A kernel's roofline share is the least time the card could take for the
bytes its inputs need (each input byte read once, each output byte written
once) at the published bandwidth, over the kernel's measured device time.
The peel kernels do a few integer operations a lane, far under the card's
operation rate, so bandwidth bounds them.
"""
from __future__ import annotations

import subprocess

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 bandwidth, at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12


def k2_bytes(n_lanes: int, n_nodes: int) -> int:
    """Bytes of one call of the fused peel edge stage K2
    (``repro_torch.kernels.peel.peel_edges_sorted``) without charges:
    int32 src and dst read once (8 a lane), the bool active and failed
    masks read once (2 a vertex), int32 delta written once (4 a vertex) and
    the int32 removed count (4)."""
    return n_lanes * 8 + n_nodes * 2 + n_nodes * 4 + 4


def share_pct(n_bytes: float, device_s: float) -> float:
    """Percent of the bandwidth bound that ``n_bytes`` moved in ``device_s``
    of device time reach."""
    if device_s <= 0:
        raise ValueError("no device time")
    return 100.0 * n_bytes / HBM_BYTES_PER_S / device_s


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    "not read" where it cannot run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not read"
    lines = out.strip().splitlines()
    return lines[0] if lines else "not read"


__all__ = ["HBM_BYTES_PER_S", "k2_bytes", "share_pct", "card_line"]
