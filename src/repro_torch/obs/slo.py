"""Multi-window burn-rate SLO evaluation over the exact histograms.

Turns the passive metric registry into actionable serving signals — the
``/slo`` endpoint's payload and the alert loop examples/streaming_fraud.py
consumes. The method is the standard SRE multi-window multi-burn-rate
alert: an SLO like "99% of steady queries under 8ms" defines an error
budget (1% of requests); the *burn rate* of a window is the fraction of
budget consumed per unit budget — ``(bad/total) / (1 - slo)``. A page
fires only when BOTH a fast-short (5m) and fast-long (1h) window burn
faster than 14.4x budget (sustained, not a blip); a ticket fires when
both slow windows (30m / 6h) burn faster than 6x.

All threshold comparisons are **pure host-side integer arithmetic over
bucket counts**: the registry histograms carry exact integer counts, a
window's (bad, total) pair is a difference of two cumulative integer
samples, the SLO objective is a rational ``slo_num/slo_den``, and the
burn factor is a rational ``(f_num, f_den)`` — so "is the burn above
14.4x" is the integer predicate

    bad * slo_den * f_den  >  (slo_den - slo_num) * total * f_num

with no float round-trip deciding an alert. (The float ``burn`` field in
the report is display-only.) The latency threshold snaps DOWN to the
histogram's bucket grid: with pow-2 edges, ``threshold_ms=10`` gates on
the 8.192ms edge — the conservative direction for an SLO.

Windowing over cumulative histograms needs history: ``sample()`` appends
one ``(t, good, total)`` integer pair per (policy, tenant) to a bounded
deque; ``evaluate()`` subtracts the sample at each window's start from
the newest one. A window older than the recorded history degrades to
"since first sample" (reported via ``window_complete``), so a freshly
started service alerts on real data instead of none.

Gauge freshness rides along: a ``certified_gap`` gauge that has not been
``set()`` within ``gap_freshness_s`` means certificates stopped being
produced — stale optimality proofs are an outage even when the last value
looks healthy.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.obs.trace import get_tracer

# default windows (seconds) and burn-rate factors: Google SRE workbook
# chapter 5's recommended multiwindow pairs
FAST_WINDOWS_S = (300.0, 3600.0)      # 5m / 1h  -> page at 14.4x
SLOW_WINDOWS_S = (1800.0, 21600.0)    # 30m / 6h -> ticket at 6x
FAST_BURN = (144, 10)                 # 14.4 as an exact rational
SLOW_BURN = (6, 1)


@dataclass(frozen=True)
class BurnRatePolicy:
    """One latency SLO: ``slo_num/slo_den`` of ``metric`` observations at
    or under ``threshold_ms``. Histogram series are grouped by their
    ``tenant`` label and merged (exact bucket adds) across the other
    labels, so one policy yields one burn rate per tenant."""

    name: str = "query_latency"
    metric: str = "query_ms"
    threshold_ms: float = 8.192
    slo_num: int = 99
    slo_den: int = 100
    fast_windows_s: tuple = FAST_WINDOWS_S
    slow_windows_s: tuple = SLOW_WINDOWS_S
    fast_burn: tuple = FAST_BURN
    slow_burn: tuple = SLOW_BURN

    def __post_init__(self):
        if not (0 < self.slo_num < self.slo_den):
            raise ValueError("need 0 < slo_num < slo_den (a real objective "
                             "with a nonzero error budget)")

    @property
    def objective(self) -> str:
        return f"{self.slo_num}/{self.slo_den}"

    def good_count(self, hist: Histogram) -> int:
        """Observations at or under the threshold — an exact integer sum
        of the bucket counts whose upper edge is <= threshold (snap-down:
        a threshold between edges gates on the tighter bucket)."""
        return sum(c for edge, c in zip(hist.bounds, hist.counts)
                   if edge <= self.threshold_ms)


def burn_exceeds(bad: int, total: int, slo_num: int, slo_den: int,
                 f_num: int, f_den: int) -> bool:
    """Integer predicate: does ``bad/total`` burn the ``1 - num/den``
    budget faster than ``f_num/f_den`` times? (False on an empty window —
    no data is not an alert.)"""
    if total <= 0:
        return False
    return bad * slo_den * f_den > (slo_den - slo_num) * total * f_num


@dataclass
class _Series:
    """Bounded (t, good, total) history for one (policy, tenant)."""

    samples: deque = field(default_factory=lambda: deque(maxlen=4096))

    def append(self, t: float, good: int, total: int) -> None:
        last = self.samples[-1] if self.samples else None
        if last is not None and last[1] == good and last[2] == total \
                and t - last[0] < 1e-9:
            return
        self.samples.append((t, good, total))

    def window(self, now: float, window_s: float) -> tuple:
        """(bad, total, complete) over [now - window_s, newest sample]:
        cumulative integer subtraction against the latest sample at or
        before the window start (or the oldest sample when history is
        shorter than the window — ``complete`` is False then)."""
        if not self.samples:
            return 0, 0, False
        newest = self.samples[-1]
        start = now - window_s
        base, complete = self.samples[0], False
        for s in self.samples:
            if s[0] <= start:
                base, complete = s, True
            else:
                break
        total = newest[2] - base[2]
        good = newest[1] - base[1]
        return total - good, total, complete


class SloMonitor:
    """Samples a registry's latency histograms and evaluates burn-rate
    alerts per tenant. ``registry_fn`` supplies the registry to read on
    each sample — the process-default one for a single worker, or a
    :class:`~repro_torch.obs.collector.Collector`'s ``as_registry`` for the
    fleet-level view (cross-worker merges stay exact, so fleet burn rates
    are computed over exact pooled counts). ``clock`` is injectable so
    tests drive windows deterministically."""

    def __init__(self, registry_fn=None, policies=(BurnRatePolicy(),),
                 gap_freshness_s: float = 600.0, clock=time.time):
        self.registry_fn = (registry_fn if registry_fn is not None
                            else (lambda: get_tracer().registry))
        self.policies = tuple(policies)
        names = [p.name for p in self.policies]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate policy names: {names}")
        self.gap_freshness_s = float(gap_freshness_s)
        self.clock = clock
        self._series: dict[tuple, _Series] = {}

    # -- sampling -------------------------------------------------------------
    def _tenant_histograms(self, reg: MetricsRegistry,
                           metric: str) -> dict[str, Histogram]:
        """Histogram series of ``metric`` grouped by tenant label and
        merged across every other label (worker, engine, path...) — exact
        integer bucket adds."""
        out: dict[str, Histogram] = {}
        for m in reg.find(metric):
            if not isinstance(m, Histogram):
                continue
            tenant = str(m.labels.get("tenant", "-"))
            prev = out.get(tenant)
            out[tenant] = m if prev is None else prev.merged(m)
        return out

    def sample(self, now: float | None = None) -> float:
        """Record one cumulative (good, total) integer pair per (policy,
        tenant); returns the sample time. Call on a cadence (the scrape
        endpoint samples on every ``/slo`` GET)."""
        now = self.clock() if now is None else float(now)
        reg = self.registry_fn()
        for pol in self.policies:
            for tenant, hist in self._tenant_histograms(reg,
                                                        pol.metric).items():
                series = self._series.setdefault((pol.name, tenant),
                                                 _Series())
                series.append(now, pol.good_count(hist), hist.total)
        return now

    # -- evaluation -----------------------------------------------------------
    def _eval_windows(self, pol: BurnRatePolicy, series: _Series,
                      now: float) -> dict:
        def one(window_s: float, f_num: int, f_den: int) -> dict:
            bad, total, complete = series.window(now, window_s)
            burn = (None if total <= 0 else
                    bad * pol.slo_den
                    / (total * (pol.slo_den - pol.slo_num)))
            return {"window_s": window_s, "bad": bad, "total": total,
                    "window_complete": complete,
                    "burn": burn,
                    "burn_threshold": f_num / f_den,
                    "alerting": burn_exceeds(bad, total, pol.slo_num,
                                             pol.slo_den, f_num, f_den)}

        fast = [one(w, *pol.fast_burn) for w in pol.fast_windows_s]
        slow = [one(w, *pol.slow_burn) for w in pol.slow_windows_s]
        return {
            "fast": fast, "slow": slow,
            # multi-window rule: every window of the pair must burn — a
            # short spike (fast-short only) or old smoke (fast-long only)
            # does not page
            "page": all(w["alerting"] for w in fast),
            "ticket": all(w["alerting"] for w in slow),
        }

    def evaluate(self, now: float | None = None) -> dict:
        """The ``/slo`` payload: per policy per tenant, the four window
        burn rates and the page/ticket verdicts; plus certified-gap
        freshness per tenant."""
        now = self.clock() if now is None else float(now)
        policies = {}
        for pol in self.policies:
            tenants = {}
            for (pname, tenant), series in sorted(self._series.items()):
                if pname != pol.name:
                    continue
                tenants[tenant] = self._eval_windows(pol, series, now)
            policies[pol.name] = {
                "metric": pol.metric,
                "threshold_ms": pol.threshold_ms,
                "objective": pol.objective,
                "tenants": tenants,
            }
        return {"generated_at": now, "policies": policies,
                "freshness": self._gap_freshness(now),
                "paging": sorted(
                    {f"{p}/{t}" for p, view in policies.items()
                     for t, v in view["tenants"].items() if v["page"]})}

    def _gap_freshness(self, now: float) -> dict:
        """certified_gap gauge staleness per tenant: ``stale`` when the
        last ``set()`` is older than ``gap_freshness_s`` — certificates
        stopped flowing. Tenants that never certified are reported with
        ``age_s=None`` (missing is not stale)."""
        out = {}
        reg = self.registry_fn()
        for g in reg.find("certified_gap"):
            if isinstance(g, Histogram):
                continue
            tenant = str(g.labels.get("tenant", "-"))
            at = float(getattr(g, "updated_at", 0.0))
            age = None if at <= 0 else max(0.0, now - at)
            ent = out.get(tenant)
            if ent is None or (age is not None
                               and (ent["age_s"] is None
                                    or age < ent["age_s"])):
                out[tenant] = {"value": g.value, "age_s": age,
                               "stale": (age is not None
                                         and age > self.gap_freshness_s)}
        return out

    def report(self, now: float | None = None) -> dict:
        """sample + evaluate in one call (the scrape handler's path)."""
        now = self.sample(now)
        return self.evaluate(now)


__all__ = ["BurnRatePolicy", "SloMonitor", "burn_exceeds",
           "FAST_WINDOWS_S", "SLOW_WINDOWS_S", "FAST_BURN", "SLOW_BURN"]
