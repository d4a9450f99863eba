"""The host syncs of the graph entry points, each inside a ``host_sync`` span.

``pbahmani``, ``kcore``'s level loop and fixpoint, and ``cbds_resident``
wait for the card at a handful of sites: a loop's test of a count on the
device, the final reads of the answer, and the upload of a 0-d tensor from
pageable host memory (the copy waits for the device's queue). Each such
wait runs inside ``host_sync(at)``: under ``obs.trace.capture()`` a span
named ``host_sync`` labelled with its site, so the spans count the syncs
and time the host's wait; otherwise the shared no-op span. A loop keeps its
one read in its own body, where the linter sees it (RPR101).
"""
from __future__ import annotations

import torch

from repro_torch.obs.trace import detail

# ``at`` of a host_sync span: a pass loop's test, a k-core level's test, a
# fixpoint iteration's test, a read of the answer, a 0-d upload
SITES = ("pass_test", "level_test", "fixpoint_test", "result", "upload")


def host_sync(at: str):
    """The span around one host sync at site ``at`` (one of ``SITES``)."""
    return detail("host_sync", at=at)


def host_read(t: torch.Tensor):
    """A read of the answer: ``t`` on the host, inside its ``host_sync``
    span (``at="result"``): a Python number for a 0-d tensor (as
    ``float(t)`` or ``int(t)`` gives it), else a numpy array."""
    with host_sync("result"):
        return t.item() if t.dim() == 0 else t.cpu().numpy()


def scalar(value, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-d tensor of ``value`` on ``device``, inside its ``host_sync``
    span: on a card the copy from pageable host memory waits for the
    device's queue."""
    with host_sync("upload"):
        return torch.tensor(value, dtype=dtype, device=device)


__all__ = ["SITES", "host_sync", "host_read", "scalar"]
