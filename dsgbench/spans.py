"""The program's spans inside its graph entry points, as the readers of
``metrics/`` take them: one answer a root span (``pbahmani``, ``cbds_p``,
recorded under ``repro_torch.obs.trace.capture()``), and the ``host_sync``
spans below it."""
from __future__ import annotations

ROOTS = ("pbahmani", "cbds_p")   # the entry points' root spans
SYNC = "host_sync"


def answers(records) -> list[tuple[float, float, int]]:
    """For each answer in ``records``: the duration of its root span, the
    summed duration of the ``host_sync`` spans below it (ms), and their
    count. An answer's root is the outermost root span: a call that falls
    back to another entry point (``pbahmani(pruned=True)`` calls
    ``pbahmani``) is one answer."""
    by_id = {r.span_id: r for r in records}

    def outermost(r):
        top = None
        while r is not None:
            if r.name in ROOTS:
                top = r
            r = by_id.get(r.parent_id)
        return top

    per_root = {r.span_id: [r.duration_ms, 0.0, 0] for r in records
                if r.name in ROOTS and outermost(r) is r}
    for r in records:
        if r.name == SYNC and (top := outermost(r)) is not None:
            per_root[top.span_id][1] += r.duration_ms
            per_root[top.span_id][2] += 1
    return [tuple(v) for v in per_root.values()]


def mean_of(obs, value) -> float | None:
    """The mean over the answers of ``obs.spans`` of ``value(total_ms,
    sync_ms, syncs)``; None where there are no spans (a program without
    capture) or no root among them."""
    per = answers(getattr(obs, "spans", None) or [])
    if not per:
        return None
    return sum(value(*a) for a in per) / len(per)
