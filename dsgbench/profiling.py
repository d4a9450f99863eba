"""Reading a traced segment: the device's activity from ``torch.profiler``,
the host ranges that label it, and the host syncs torch reports.

A device event is a kernel, a copy or a memset on the card's timeline; the
profiler's copies of host ranges there (``obs:``, ``dsgbench:``) are labels,
not activity. A segment is profiled one of two ways:
  * the card's activity alone (``labels=False``), which costs the host the
    least (each launch is still recorded): the busy share, the launches and
    the kernels' device time are read from it. Its window is the host
    clock's between a device synchronisation at each end, so every device
    event it queued lies inside;
  * with the host's ops and ranges too (``labels=True``), which costs the
    host more again: only the breakdown's labels are read from it. Its
    window is the ``dsgbench:window`` host range, which ends after a device
    synchronisation.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from dataclasses import dataclass, field

from dsgbench import stats

WINDOW = "dsgbench:window"
LABELS = ("dsgbench:", "obs:")
SYNC_WARNING = "synchronizing CUDA operation"   # torch's sync-debug warning text


@dataclass
class DeviceEvent:
    name: str          # a kernel's, or "Memcpy ..." / "Memset ..."
    start_us: float
    end_us: float


@dataclass
class TraceReading:
    # microseconds on the trace's clock, where a host range marks the window
    window: tuple[float, float] | None = None
    events: list[DeviceEvent] = field(default_factory=list)
    ranges: list[tuple[str, float, float]] = field(default_factory=list)   # host labels
    host_window_s: float = 0.0   # the window's length where no host range marks it

    @property
    def window_s(self) -> float:
        if self.window is None:
            return self.host_window_s
        return (self.window[1] - self.window[0]) / 1e6

    def inside(self) -> list[DeviceEvent]:
        """The device events wholly inside the window (all of them where the
        host clock bounds it)."""
        if self.window is None:
            return list(self.events)
        lo, hi = self.window
        return [e for e in self.events if e.start_us >= lo and e.end_us <= hi]

    def busy_s(self) -> float:
        spans = [(e.start_us, e.end_us) for e in self.events]
        if self.window is not None:
            spans = stats.clip(spans, *self.window)
        return stats.union_length(spans) / 1e6


def reading_from_events(events, host_window_s: float = 0.0) -> TraceReading:
    """A ``TraceReading`` from ``prof.events()``-like objects: ``name``,
    ``device_type`` and ``time_range`` (``start`` and ``end`` in
    microseconds). Without a ``dsgbench:window`` range among them the
    window is ``host_window_s`` long."""
    from torch.autograd import DeviceType

    out = TraceReading(host_window_s=host_window_s)
    for ev in events:
        name, tr = ev.name, ev.time_range
        if ev.device_type == DeviceType.CUDA:
            if not name.startswith(LABELS):
                out.events.append(DeviceEvent(name, tr.start, tr.end))
        elif name == WINDOW:
            out.window = (tr.start, tr.end)
        elif name.startswith(LABELS):
            out.ranges.append((name, tr.start, tr.end))
    return out


@contextlib.contextmanager
def profiled(device, labels: bool):
    """Profile the block on ``device``: the card's activity, and with
    ``labels`` the host's ops and ranges too, under one ``dsgbench:window``
    range. The reading is set on the yielded holder's ``reading`` once the
    block ends. Off the card only the host is profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Holder", (), {"reading": None})()
    on_card = device.type == "cuda"
    activities = [ProfilerActivity.CUDA] if on_card else []
    if labels or not on_card:
        activities.append(ProfilerActivity.CPU)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW) if labels else contextlib.nullcontext():
            yield holder
            sync()
        t1 = time.perf_counter()
    holder.reading = reading_from_events(prof.events(), t1 - t0)


@contextlib.contextmanager
def counted_syncs(device):
    """Count the host syncs torch reports in the block, under
    ``torch.cuda.set_sync_debug_mode("warn")`` with every warning recorded;
    the count is set on the yielded holder's ``syncs`` (None off the card)."""
    import torch

    holder = type("Holder", (), {"syncs": None})()
    if device.type != "cuda":
        yield holder
        return
    torch.cuda.synchronize(device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield holder
        finally:
            torch.cuda.set_sync_debug_mode("default")
    holder.syncs = sum(SYNC_WARNING in str(w.message) for w in caught)


def label_at(ranges, t: float) -> str:
    """The innermost host range (the latest to start) open at ``t``."""
    best = None
    for name, a, b in ranges:
        if a <= t <= b and (best is None or a > best[1]):
            best = (name, a)
    return best[0] if best else "host:unlabelled"


def breakdown(reading: TraceReading, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by the
    host range open at each gap's middle, each ``[name, seconds]``, at most
    ``top`` of each, largest first."""
    by_op: dict[str, float] = {}
    for e in reading.events:
        lo, hi = max(e.start_us, reading.window[0]), min(e.end_us, reading.window[1])
        if hi > lo:
            by_op[e.name[:96]] = by_op.get(e.name[:96], 0.0) + (hi - lo) / 1e6
    by_label: dict[str, float] = {}
    idle = stats.gaps([(e.start_us, e.end_us) for e in reading.events], *reading.window)
    for a, b in idle:
        name = label_at(reading.ranges, (a + b) / 2)
        by_label[name] = by_label.get(name, 0.0) + (b - a) / 1e6

    def largest(d: dict) -> list:
        return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]

    return {"device_ops": largest(by_op), "idle_gaps": largest(by_label)}


__all__ = ["DeviceEvent", "TraceReading", "WINDOW", "reading_from_events", "profiled",
           "counted_syncs", "label_at", "breakdown"]
