"""Nested span API: wall time + engine attributes into a bounded ring.

``with span("query", tenant="eu", engine="delta") as sp`` times a host-side
operation and, on exit, records one :class:`SpanRecord` into the tracer's
bounded in-memory ring (a ``deque(maxlen=...)`` — O(1), never grows) plus an
optional JSONL event log. Spans nest: the tracer keeps a stack, so a refined
query shows up as ``refine`` wrapping the seed ``query`` with parent/depth
links intact.

Engine attributes (``sp.set("passes", 7)``) ride on the record, and a small
attribute->metric mapping feeds the metrics registry on exit: peel passes
and refine rounds become per-tenant counters, the certified gap and
candidate fraction become gauges, and the span duration lands in a
per-tenant latency histogram — split into ``<name>_ms`` (steady) versus
``<name>_first_call_ms`` when the audit layer tagged the span
``compiled=True`` (in this package: the op loaded a kernel library, see
audit.py), which keeps first-call cost out of steady-state latency.

Two hard properties:

  * **host-side only** — a span never synchronises with the card or
    launches on it. The one call into torch is the optional
    ``torch.profiler.record_function`` bridge, entered only when the tracer
    is enabled, ``profiler_bridge`` is set and a profiler is recording on
    this thread: it names the host range ``obs:<name>`` in a
    ``torch.profiler`` trace, next to the kernels the span launched;
  * **one branch when disabled** — ``span()`` on a disabled tracer returns
    a shared no-op singleton; no clock read, no allocation, no ring write.
    Durations then read 0.0, which is what the engines' ``latency_ms``
    fields report with observability off.

The spans inside the graph entry points (each peel pass, k-core level and
fixpoint iteration, each host sync: ``detail()``) are off unless a block
asks for them with ``capture()``: a CBDS-P answer opens thousands, too many
to record on every call. Off, a ``detail()`` site reads one attribute and
returns the no-op span.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import time
from collections import deque
from dataclasses import dataclass, field

from repro_torch.obs.metrics import MetricsRegistry

try:  # the profiler bridge is optional: the metrics and export need no torch
    from torch._C._autograd import _profiler_enabled
    from torch.profiler import record_function as _record_function
except ImportError:  # pragma: no cover
    _record_function = None

# span attribute -> metrics-registry series fed on exit (labeled like the
# span). Counters accumulate ints; gauges keep the last value.
ATTR_COUNTERS = {
    "passes": "peel_passes_total",
    "refine_rounds": "refine_rounds_total",
    "n_inserted": "edges_inserted_total",
    "n_deleted": "edges_deleted_total",
}
ATTR_GAUGES = {
    "certified_gap": "certified_gap",
    "candidate_fraction": "candidate_fraction",
    "density": "last_density",
}
ATTR_FLAG_COUNTERS = {  # truthy attr -> counter += 1
    "certified_skip": "certified_skips_total",
    "compiled": "first_calls_total",
}


@dataclass
class SpanRecord:
    """One finished span, as stored in the ring / JSONL log."""

    span_id: int
    parent_id: int | None
    depth: int
    name: str
    labels: dict
    t_start: float          # time.time() epoch seconds (JSONL-friendly)
    duration_ms: float
    attrs: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"span_id": self.span_id, "parent_id": self.parent_id,
                "depth": self.depth, "name": self.name, "labels": self.labels,
                "t_start": self.t_start, "duration_ms": self.duration_ms,
                "attrs": self.attrs}

    @classmethod
    def from_json(cls, d: dict) -> "SpanRecord":
        return cls(span_id=d["span_id"], parent_id=d["parent_id"],
                   depth=d["depth"], name=d["name"], labels=d["labels"],
                   t_start=d["t_start"], duration_ms=d["duration_ms"],
                   attrs=d.get("attrs", {}))


class _NoopSpan:
    """Shared do-nothing span: the disabled-tracer fast path."""

    duration_ms = 0.0
    elapsed_ms = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value):
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    """Live span; use via ``with tracer.span(...) as sp``."""

    __slots__ = ("tracer", "name", "labels", "attrs", "span_id", "parent_id",
                 "depth", "_t0", "_wall", "duration_ms", "_ann")

    def __init__(self, tracer: "Tracer", name: str, labels: dict):
        self.tracer = tracer
        self.name = name
        self.labels = labels
        self.attrs: dict = {}
        self.span_id = next(tracer._ids)
        self.parent_id = None
        self.depth = 0
        self.duration_ms = 0.0
        self._ann = None

    def set(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    @property
    def elapsed_ms(self) -> float:
        """Wall time so far (span still open) — what the service uses for
        per-request latency without a second clock source."""
        return (time.perf_counter() - self._t0) * 1e3

    def __enter__(self) -> "Span":
        # record_function costs more than the rest of the span: enter it
        # only while a profiler records this thread. Its range holds the
        # span's own bookkeeping, so a profile puts that under this span and
        # not under its parent
        if (self.tracer.profiler_bridge and _record_function is not None
                and _profiler_enabled()):
            self._ann = _record_function(f"obs:{self.name}")
            self._ann.__enter__()
        stack = self.tracer._stack
        if stack:
            self.parent_id = stack[-1].span_id
            self.depth = len(stack)
        stack.append(self)
        self._wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.duration_ms = (time.perf_counter() - self._t0) * 1e3
        stack = self.tracer._stack
        if stack and stack[-1] is self:
            stack.pop()
        try:
            self.tracer._record(self)
        finally:
            if self._ann is not None:
                self._ann.__exit__(*exc)
        return False


class Tracer:
    """Span recorder: bounded ring + optional JSONL + metrics feed."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 ring_size: int = 2048, jsonl_path: str | None = None,
                 profiler_bridge: bool = True, enabled: bool = True,
                 jsonl_max_bytes: int | None = None,
                 jsonl_backups: int = 1):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.enabled = bool(enabled)
        self.detail = False  # the entry points' spans: on only inside capture()
        self.profiler_bridge = bool(profiler_bridge)
        self._ring: deque = deque(maxlen=int(ring_size))
        self._stack: list[Span] = []
        self._ids = itertools.count()
        self._jsonl_path = jsonl_path
        self._jsonl_file = None
        # size-capped rotation: without it a long-running serve_metrics
        # deployment appends spans forever and fills the disk. When the
        # active file passes ``jsonl_max_bytes`` it rotates to
        # ``<path>.1`` .. ``<path>.N`` (oldest dropped), so the sink holds
        # at most ~(backups + 1) * max_bytes on disk.
        self._jsonl_max_bytes = (None if jsonl_max_bytes is None
                                 else int(jsonl_max_bytes))
        self._jsonl_backups = max(0, int(jsonl_backups))

    # -- the API -------------------------------------------------------------
    def span(self, name: str, **labels):
        if not self.enabled:         # the one-branch disabled fast path
            return NOOP_SPAN
        return Span(self, name, labels)

    def ring(self) -> list[SpanRecord]:
        return list(self._ring)

    @property
    def ring_size(self) -> int:
        return self._ring.maxlen

    def clear(self) -> None:
        self._ring.clear()
        self._stack.clear()

    def close(self) -> None:
        if self._jsonl_file is not None:
            self._jsonl_file.close()
            self._jsonl_file = None

    def _rotate_jsonl(self) -> None:
        """Shift ``path -> path.1 -> ... -> path.N`` (drop past N) and
        reopen a fresh active file. With ``jsonl_backups=0`` the full file
        is simply truncated — the ring still holds the recent spans."""
        import os

        self.close()
        path = self._jsonl_path
        last = f"{path}.{self._jsonl_backups}"
        if os.path.exists(last):
            os.remove(last)
        for i in range(self._jsonl_backups - 1, 0, -1):
            src = f"{path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{path}.{i + 1}")
        if self._jsonl_backups > 0:
            os.replace(path, f"{path}.1")
        else:
            os.remove(path)
        self._jsonl_file = open(path, "a")

    # -- recording -----------------------------------------------------------
    def _record(self, sp: Span) -> None:
        rec = SpanRecord(span_id=sp.span_id, parent_id=sp.parent_id,
                         depth=sp.depth, name=sp.name, labels=sp.labels,
                         t_start=sp._wall, duration_ms=sp.duration_ms,
                         attrs=dict(sp.attrs))
        self._ring.append(rec)
        if self._jsonl_path is not None:
            if self._jsonl_file is None:
                self._jsonl_file = open(self._jsonl_path, "a")
            self._jsonl_file.write(json.dumps(rec.to_json()) + "\n")
            self._jsonl_file.flush()
            if (self._jsonl_max_bytes is not None
                    and self._jsonl_file.tell() >= self._jsonl_max_bytes):
                self._rotate_jsonl()
        reg = self.registry
        if not reg.enabled:
            return
        hist = (f"{sp.name}_first_call_ms" if sp.attrs.get("compiled")
                else f"{sp.name}_ms")
        reg.histogram(hist, **sp.labels).observe(sp.duration_ms)
        for attr, metric in ATTR_COUNTERS.items():
            v = sp.attrs.get(attr)
            if v:
                reg.counter(metric, **sp.labels).inc(int(v))
        for attr, metric in ATTR_GAUGES.items():
            v = sp.attrs.get(attr)
            if v is not None:
                reg.gauge(metric, **sp.labels).set(float(v))
        for attr, metric in ATTR_FLAG_COUNTERS.items():
            if sp.attrs.get(attr):
                reg.counter(metric, **sp.labels).inc(1)


def read_jsonl(path: str) -> list[SpanRecord]:
    """Parse a JSONL event log back into records (round-trip oracle)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(SpanRecord.from_json(json.loads(line)))
    return out


# ---------------------------------------------------------------------------
# the process-default tracer (what the engines instrument against)
# ---------------------------------------------------------------------------
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-default tracer (tests install fresh ones to
    isolate rings/registries); returns the previous tracer."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def configure(**kwargs) -> Tracer:
    """Replace the default tracer with a freshly-configured one (same
    kwargs as :class:`Tracer`); returns it."""
    set_tracer(Tracer(**kwargs))
    return _TRACER


def span(name: str, **labels):
    """Convenience: a span on the process-default tracer."""
    return _TRACER.span(name, **labels)


def detail(name: str, **labels):
    """A span inside a graph entry point, on the process-default tracer:
    recorded only inside ``capture()``; otherwise the shared no-op span,
    after one attribute read."""
    tracer = _TRACER
    if not tracer.detail:
        return NOOP_SPAN
    return tracer.span(name, **labels)


CAPTURE_RING = 1 << 17   # records a capture tracer holds: 50 CBDS-P answers


def capture_tracer() -> Tracer:
    """A tracer for ``capture()``: ``CAPTURE_RING`` records, no metrics
    registry (no ``host_sync_ms{at=...}`` series), no JSONL sink."""
    return Tracer(ring_size=CAPTURE_RING, registry=MetricsRegistry(enabled=False))


@contextlib.contextmanager
def capture(tracer: Tracer | None = None):
    """Record the ``detail()`` spans of the block on ``tracer``, or else on a
    fresh ``capture_tracer()``, made the process default for the block (so
    the block's other spans, a service's request spans say, go there too and
    leave the default tracer's ring and registry alone). Yields the tracer;
    on exit its ``detail`` state and the default tracer are what they
    were."""
    t = tracer if tracer is not None else capture_tracer()
    prev, was = set_tracer(t), t.detail
    t.detail = True
    try:
        yield t
    finally:
        t.detail = was
        set_tracer(prev)


__all__ = ["Span", "SpanRecord", "Tracer", "NOOP_SPAN", "span", "detail", "capture",
           "capture_tracer", "CAPTURE_RING", "get_tracer", "set_tracer", "configure",
           "read_jsonl", "ATTR_COUNTERS", "ATTR_GAUGES", "ATTR_FLAG_COUNTERS"]
