"""k2_roofline_pct: the fused peel edge stage K2 (``csrc/peel.cu``: its
``pack_kernel`` and ``peel_kernel`` launches) against its bandwidth bound.
The launches are the port's counter ``repro_torch.kernels.peel.launches``
over the traced window, each moving ``roofline.k2_bytes`` at the run's
lanes and vertices; the time is the two kernels' device time in the trace."""
import re

from dsgbench.roofline import share_pct

K2_KERNELS = re.compile(r"\b(pack_kernel|peel_kernel)\b")


def read(obs):
    r, launches = obs.reading, obs.counters_profiled.get("k2_launches", 0)
    if r is None or not launches or obs.k2_bytes is None:
        return None
    device_s = sum(e.end_us - e.start_us for e in r.events if K2_KERNELS.search(e.name)) / 1e6
    if device_s <= 0:
        return None
    return share_pct(launches * obs.k2_bytes, device_s)
