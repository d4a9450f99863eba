"""Process-local metrics registry: counters, gauges, exact-rank histograms.

The engines' performance story rests on *exact* invariants (bit-identical
peels, integer certificates), so the observability layer follows the same
discipline: histograms are fixed-bucket integer count arrays — no sampling,
no decaying reservoirs — and a quantile is an exact rank selection over
those counts. ``Histogram.quantile(p)`` returns the upper edge of the
bucket containing the rank-``ceil(p*n)`` observation, i.e. the smallest
bucket boundary that is >= the true order statistic (asserted against a
sorted-list oracle in tests/test_torch_obs.py). Bucket edges are geometric, so
the p50/p95/p99 the service exports are accurate to one bucket ratio
(2x by default) at every latency scale, from microsecond ingests to
second-long cold compiles.

Metrics are keyed by (name, labels): ``registry.counter("peel_passes_total",
tenant="eu", engine="delta")`` returns a distinct series per label set, the
Prometheus data model. Everything is plain host Python — creating or
updating a metric never touches torch, so instrumentation cannot perturb
kernel caches or device state (the hard invariant of repro_torch.obs).

A disabled registry short-circuits: ``enabled=False`` makes the span layer
(trace.py) skip recording entirely, and direct metric updates become no-ops
guarded by one branch.
"""
from __future__ import annotations

import math
import threading
import time
from bisect import bisect_left
from dataclasses import dataclass, field

# geometric latency edges: 0.001 ms .. ~8.6 s doubling per bucket, plus the
# overflow bucket. 24 int counters per series — small enough to label per
# tenant, wide enough to separate a 10us ingest from a 2s cold compile.
DEFAULT_LATENCY_BOUNDS_MS = tuple(0.001 * 2.0 ** k for k in range(24))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


@dataclass
class Counter:
    """Monotonic integer counter."""

    name: str
    labels: dict
    value: int = 0

    def inc(self, n: int = 1) -> None:
        self.value += int(n)


@dataclass
class Gauge:
    """Last-value gauge (float). ``updated_at`` (epoch seconds of the last
    ``set``) is the freshness signal the SLO layer alarms on: a
    certified-gap gauge that stops moving means certificates stopped being
    produced, which is an outage even when the last value looks healthy."""

    name: str
    labels: dict
    value: float = 0.0
    updated_at: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)
        self.updated_at = time.time()


@dataclass
class Histogram:
    """Fixed-bucket histogram with exact integer counts.

    ``bounds`` are ascending bucket *upper* edges; an observation lands in
    the first bucket whose edge is >= the value (the Prometheus ``le``
    convention), or in the overflow bucket past the last edge. Quantiles
    are exact rank selections over the counts — see module docstring.
    """

    name: str
    labels: dict
    bounds: tuple = DEFAULT_LATENCY_BOUNDS_MS
    counts: list = field(default_factory=list)
    total: int = 0
    sum: float = 0.0
    max_value: float = 0.0

    def __post_init__(self):
        if not self.counts:
            self.counts = [0] * (len(self.bounds) + 1)

    def observe(self, x: float) -> None:
        x = float(x)
        self.counts[bisect_left(self.bounds, x)] += 1
        self.total += 1
        self.sum += x
        if x > self.max_value:
            self.max_value = x

    def quantile(self, p: float) -> float | None:
        """Upper edge of the bucket holding the rank-``ceil(p*n)``
        observation (exact rank, no interpolation); the overflow bucket
        reports the max observed value. None when empty."""
        if self.total == 0:
            return None
        rank = max(1, math.ceil(float(p) * self.total))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                return self.bounds[i] if i < len(self.bounds) else self.max_value
        return self.max_value  # pragma: no cover (acc always reaches total)

    def quantiles(self, ps=(0.5, 0.95, 0.99)) -> dict:
        return {f"p{int(p * 100)}": self.quantile(p) for p in ps}

    def merged(self, other: "Histogram") -> "Histogram":
        """Sum of two same-bound histograms (exact: integer bucket adds) —
        used to aggregate one tenant's series across engine paths, and by
        the cross-process collector to pool worker histograms into exact
        fleet-level quantiles. Commutative and associative by construction
        (integer adds), so merge order across workers cannot change a
        reported quantile (property-tested in tests/test_torch_obs.py)."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different bounds")
        out = Histogram(self.name, dict(self.labels), self.bounds,
                        [a + b for a, b in zip(self.counts, other.counts)],
                        self.total + other.total, self.sum + other.sum,
                        max(self.max_value, other.max_value))
        return out

    def to_dict(self) -> dict:
        """JSON-ready dump carrying the full integer bucket state — the
        wire format the cross-process collector merges (obs/collector.py).
        Round-trips through :meth:`from_dict` without loss."""
        return {"name": self.name, "labels": dict(self.labels),
                "count": self.total, "sum": self.sum, "max": self.max_value,
                "bounds": list(self.bounds),
                "bucket_counts": list(self.counts),
                "quantiles": self.quantiles()}

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        """Rebuild a histogram from a :meth:`to_dict` / ``snapshot()``
        entry (exact: the bucket counts are the state)."""
        return cls(d["name"], dict(d.get("labels", {})),
                   tuple(d["bounds"]), [int(c) for c in d["bucket_counts"]],
                   int(d["count"]), float(d["sum"]), float(d["max"]))


class MetricsRegistry:
    """Name+labels -> metric map. Process-local, thread-safe creation."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._metrics: dict[tuple, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: dict, **kwargs):
        key = (cls.__name__, name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(key, cls(name, dict(labels),
                                                      **kwargs))
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, bounds: tuple | None = None,
                  **labels) -> Histogram:
        kwargs = {"bounds": tuple(bounds)} if bounds is not None else {}
        return self._get(Histogram, name, labels, **kwargs)

    def install(self, metric: "Counter | Gauge | Histogram") -> None:
        """Adopt an already-built metric (the collector's reconstruction
        path); replaces any series with the same (kind, name, labels)."""
        key = (type(metric).__name__, metric.name, _label_key(metric.labels))
        with self._lock:
            self._metrics[key] = metric

    # -- bulk access ---------------------------------------------------------
    def metrics(self) -> list:
        return list(self._metrics.values())

    def find(self, name: str, **labels) -> list:
        """All series for ``name`` whose labels include ``labels``."""
        want = labels.items()
        return [m for m in self._metrics.values()
                if m.name == name and all(m.labels.get(k) == v
                                          for k, v in want)]

    def merged_histogram(self, name: str, **labels) -> Histogram | None:
        """One histogram summing every series of ``name`` matching
        ``labels`` (exact integer bucket adds) — e.g. a tenant's query
        latency across engine paths."""
        series = [m for m in self.find(name, **labels)
                  if isinstance(m, Histogram)]
        if not series:
            return None
        out = series[0]
        for h in series[1:]:
            out = out.merged(h)
        return out

    def snapshot(self) -> dict:
        """JSON-ready dump of every series (full bucket counts included)."""
        counters, gauges, hists = [], [], []
        for m in self._metrics.values():
            if isinstance(m, Counter):
                counters.append({"name": m.name, "labels": m.labels,
                                 "value": m.value})
            elif isinstance(m, Gauge):
                gauges.append({"name": m.name, "labels": m.labels,
                               "value": m.value,
                               "updated_at": m.updated_at})
            else:
                hists.append(m.to_dict())
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    def reset(self) -> None:
        self._metrics.clear()


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_LATENCY_BOUNDS_MS"]
