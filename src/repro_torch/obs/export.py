"""Exporters: Prometheus exposition text and JSON snapshots.

Two consumers, one schema. ``snapshot()`` bundles the metrics registry
dump with the recompile-audit summary into a JSON-ready dict — what a
serving tier's ``metrics_snapshot()`` returns and what a run's gate reads
(``audited_steady_recompiles`` must be 0). ``prometheus_text()`` renders
the same registry in the Prometheus exposition format — histograms emit
cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``, so a
scraper recovers the exact integer bucket counts the quantiles were
computed from.

``service_snapshot(service)`` adds the serving-tier view on top: per
tenant, the p50/p95/p99 query latency split into first-call vs steady
series, peel-pass / refine-round counters, and the latest certified-gap
gauge — the SLO surface of a serving tier.
"""
from __future__ import annotations

from repro_torch.obs.audit import AUDITOR
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import get_tracer


def escape_label_value(v) -> str:
    """Escape a label value per the Prometheus exposition format: backslash
    first (so escapes don't double-escape), then double-quote and newline.
    Tenant names are caller-controlled strings, so an unescaped ``"`` or
    ``\\n`` would emit malformed exposition text a scraper rejects."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def unescape_label_value(v: str) -> str:
    """Inverse of :func:`escape_label_value` (the round-trip oracle)."""
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, c + nxt))
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _labels_text(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt(x: float) -> str:
    # Prometheus wants plain decimals; ints stay ints for exactness.
    if float(x) == int(x):
        return str(int(x))
    return repr(float(x))


def prometheus_text(registry: MetricsRegistry | None = None) -> str:
    """Render a registry in Prometheus exposition format."""
    reg = registry if registry is not None else get_tracer().registry
    by_name: dict[str, list] = {}
    for m in reg.metrics():
        by_name.setdefault(m.name, []).append(m)
    lines: list[str] = []
    for name in sorted(by_name):
        series = by_name[name]
        kind = ("counter" if isinstance(series[0], Counter) else
                "gauge" if isinstance(series[0], Gauge) else "histogram")
        lines.append(f"# TYPE {name} {kind}")
        for m in series:
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{name}{_labels_text(m.labels)} {_fmt(m.value)}")
                continue
            acc = 0
            for edge, c in zip(m.bounds, m.counts):
                acc += c
                lab = dict(m.labels, le=_fmt(edge))
                lines.append(f"{name}_bucket{_labels_text(lab)} {acc}")
            lab = dict(m.labels, le="+Inf")
            lines.append(f"{name}_bucket{_labels_text(lab)} {m.total}")
            lines.append(f"{name}_sum{_labels_text(m.labels)} {_fmt(m.sum)}")
            lines.append(f"{name}_count{_labels_text(m.labels)} {m.total}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> list:
    """Strict exposition-format parse: the lint the scrape smoke and tests
    run over ``/metrics`` output. Returns ``[(name, labels, value)]``
    samples with label values *unescaped*; raises ``ValueError`` on any
    malformed line (bad metric name, unterminated label quote, unknown
    TYPE, non-numeric sample value). A successful parse of
    ``prometheus_text()`` therefore proves the escaping round-trips."""
    import re

    name_re = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
    samples = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 2 and parts[1] == "TYPE":
                if len(parts) != 4 or not name_re.match(parts[2]) or \
                        parts[3] not in ("counter", "gauge", "histogram",
                                         "summary", "untyped"):
                    raise ValueError(f"line {lineno}: malformed TYPE: {line!r}")
            continue
        # sample line: name[{labels}] value
        brace = line.find("{")
        if brace == -1:
            try:
                name, value = line.rsplit(" ", 1)
            except ValueError:
                raise ValueError(f"line {lineno}: malformed sample: {line!r}")
            labels = {}
        else:
            name = line[:brace]
            # scan the label block honoring \" escapes inside values
            i, labels, end = brace + 1, {}, None
            while i < len(line):
                if line[i] == "}":
                    end = i
                    break
                eq = line.find("=", i)
                if eq == -1 or line[eq + 1] != '"':
                    raise ValueError(
                        f"line {lineno}: malformed label pair: {line!r}")
                key = line[i:eq].lstrip(",")
                if not name_re.match(key):
                    raise ValueError(
                        f"line {lineno}: bad label name {key!r}")
                j = eq + 2
                raw = []
                while j < len(line):
                    c = line[j]
                    if c == "\\":
                        raw.append(line[j:j + 2])
                        j += 2
                        continue
                    if c == '"':
                        break
                    if c == "\n":  # cannot happen post-splitlines; guard
                        raise ValueError(
                            f"line {lineno}: newline inside label value")
                    raw.append(c)
                    j += 1
                else:
                    raise ValueError(
                        f"line {lineno}: unterminated label value: {line!r}")
                labels[key] = unescape_label_value("".join(raw))
                i = j + 1
            if end is None:
                raise ValueError(
                    f"line {lineno}: unterminated label block: {line!r}")
            value = line[end + 1:].strip()
        if not name_re.match(name):
            raise ValueError(f"line {lineno}: bad metric name {name!r}")
        try:
            val = float(value)
        except ValueError:
            raise ValueError(f"line {lineno}: non-numeric value {value!r}")
        samples.append((name, labels, val))
    return samples


def snapshot(registry: MetricsRegistry | None = None) -> dict:
    """Registry dump + audit summary, JSON-ready."""
    reg = registry if registry is not None else get_tracer().registry
    return {"metrics": reg.snapshot(), "audit": AUDITOR.snapshot()}


def _hist_quantiles(h: Histogram | None) -> dict:
    if h is None or h.total == 0:
        return {"p50": None, "p95": None, "p99": None, "count": 0}
    q = h.quantiles()
    q["count"] = h.total
    return q


def service_snapshot(service) -> dict:
    """Per-tenant SLO view for a service's ``metrics_snapshot()``: any object
    with ``registry.names()``, ``registry.stats(name)`` and ``worker``.

    Query latency quantiles come from the span-fed ``query_ms`` /
    ``query_first_call_ms`` histograms (merged across engine labels per
    tenant — exact integer bucket adds); counters and gauges are the
    span-attribute feeds from trace.py.
    """
    from dataclasses import asdict

    reg = get_tracer().registry
    tenants = {}
    for name in service.registry.names():
        stats = service.registry.stats(name)
        steady = reg.merged_histogram("query_ms", tenant=name)
        first = reg.merged_histogram("query_first_call_ms", tenant=name)

        def _counter_total(metric: str) -> int:
            return sum(c.value for c in reg.find(metric, tenant=name)
                       if isinstance(c, Counter))

        gaps = [g.value for g in reg.find("certified_gap", tenant=name)
                if isinstance(g, Gauge)]
        tenants[name] = {
            "query_steady_ms": _hist_quantiles(steady),
            "query_first_call_ms": _hist_quantiles(first),
            "peel_passes_total": _counter_total("peel_passes_total"),
            "refine_rounds_total": _counter_total("refine_rounds_total"),
            "certified_skips_total": _counter_total("certified_skips_total"),
            "certified_gap": gaps[-1] if gaps else None,
            "stats": asdict(stats),
        }
    out = snapshot(reg)
    out["tenants"] = tenants
    # worker identity: the collector re-keys tenants by (worker, tenant)
    # when aggregating snapshots pushed from many processes
    out["worker"] = getattr(service, "worker", None)
    return out


def write_json(path: str, data: dict | None = None) -> dict:
    """Write a snapshot (default: the process-default one) to ``path``."""
    import json

    data = snapshot() if data is None else data
    with open(path, "w") as f:
        json.dump(data, f, indent=2, default=str)
        f.write("\n")
    return data


__all__ = ["prometheus_text", "snapshot", "service_snapshot", "write_json",
           "escape_label_value", "unescape_label_value",
           "parse_prometheus_text"]
