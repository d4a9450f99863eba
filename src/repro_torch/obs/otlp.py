"""OTLP export: spans and metrics into OpenTelemetry backends — gated.

The span ring and the metrics registry are OTel-shaped by construction
(name/parent/depth/attrs spans; monotonic counters, last-value gauges,
fixed-bucket histograms), but until now only JSONL and Prometheus text
left the process. This module maps both onto the OpenTelemetry SDK's
export types and ships them OTLP/HTTP:

  * a :class:`SpanRecord` becomes a ``ReadableSpan`` — ``parent_id``
    links survive (one trace per export batch, span ids offset into the
    64-bit space), ``t_start``/``duration_ms`` become start/end
    nanoseconds, labels + attrs ride as attributes (``compiled`` marks
    first-call spans for backend filtering);
  * a registry ``Counter`` becomes a cumulative monotonic ``Sum``, a
    ``Gauge`` a gauge point, and a ``Histogram`` an explicit-bounds
    histogram point whose ``bucket_counts`` are the registry's exact
    integer counts — the OTLP histogram wire type carries explicit bounds
    + integer bucket counts natively, so the export is lossless.

**No new hard dependencies**: everything OTel is imported lazily inside
``try``. When ``opentelemetry-sdk`` (or the OTLP/HTTP exporter package)
is not importable, the exporter degrades to a counted no-op — every
skipped batch increments ``otlp_export_noop_total`` in the registry, so a
deployment that *thinks* it is exporting can see that it is not. Export
failures (collector down, serialization surprise) are likewise counted
(``otlp_export_errors_total``) and never raise into the serving path.
"""
from __future__ import annotations

import os
import time

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import SpanRecord, get_tracer

_NS = 1_000_000_000


def otel_available() -> bool:
    """True when the OpenTelemetry SDK is importable (the gate)."""
    try:
        import opentelemetry.sdk.trace  # noqa: F401
        return True
    except Exception:
        return False


def _attr_value(v):
    """OTel attribute values must be str/bool/int/float (or lists of)."""
    if isinstance(v, (str, bool, int, float)):
        return v
    return str(v)


class OtlpExporter:
    """Best-effort OTLP/HTTP exporter over the span ring + registry.

    ``span_exporter`` / ``metric_exporter`` are injectable (tests use the
    SDK's in-memory exporters); by default the OTLP/HTTP exporters are
    constructed against ``endpoint`` (an OTel collector's
    ``/v1/traces`` + ``/v1/metrics``). ``available`` is False when the
    SDK cannot be imported — exports then no-op and count."""

    def __init__(self, endpoint: str | None = None,
                 registry: MetricsRegistry | None = None,
                 span_exporter=None, metric_exporter=None,
                 service_name: str = "repro-densest-subgraph"):
        self.endpoint = endpoint or os.environ.get(
            "OTEL_EXPORTER_OTLP_ENDPOINT", "http://127.0.0.1:4318")
        self._registry = registry
        self.service_name = service_name
        self._span_exporter = span_exporter
        self._metric_exporter = metric_exporter
        self.available = otel_available()
        self.n_spans_exported = 0
        self.n_metrics_exported = 0
        # one 128-bit trace id per exporter instance: a batch's spans land
        # in one trace so parent links resolve in the backend
        self._trace_id = int.from_bytes(os.urandom(16), "big") or 1

    @property
    def registry(self) -> MetricsRegistry:
        return (self._registry if self._registry is not None
                else get_tracer().registry)

    def _count(self, name: str) -> None:
        self.registry.counter(name, exporter="otlp").inc(1)

    # -- spans ----------------------------------------------------------------
    def _readable_spans(self, records: list):
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import ReadableSpan
        from opentelemetry.trace import SpanContext, TraceFlags

        resource = Resource.create({"service.name": self.service_name})
        flags = TraceFlags(TraceFlags.SAMPLED)

        def ctx(span_id: int) -> SpanContext:
            # ring span ids count from 0; OTel span ids must be nonzero
            return SpanContext(trace_id=self._trace_id,
                               span_id=(int(span_id) + 1) & (2**64 - 1) or 1,
                               is_remote=False, trace_flags=flags)

        out = []
        for r in records:
            start_ns = int(r.t_start * _NS)
            end_ns = start_ns + int(r.duration_ms * 1e6)
            attrs = {k: _attr_value(v) for k, v in r.labels.items()}
            attrs.update({k: _attr_value(v) for k, v in r.attrs.items()})
            attrs["obs.depth"] = int(r.depth)
            out.append(ReadableSpan(
                name=r.name, context=ctx(r.span_id),
                parent=(None if r.parent_id is None else ctx(r.parent_id)),
                resource=resource, attributes=attrs,
                start_time=start_ns, end_time=max(end_ns, start_ns)))
        return out

    def export_spans(self, records: list | None = None) -> int:
        """Export span records (default: the process tracer's ring);
        returns how many were exported (0 on no-op or failure)."""
        if records is None:
            records = get_tracer().ring()
        records = [r for r in records if isinstance(r, SpanRecord)]
        if not self.available:
            self._count("otlp_export_noop_total")
            return 0
        try:
            exporter = self._span_exporter
            if exporter is None:
                from opentelemetry.exporter.otlp.proto.http.trace_exporter \
                    import OTLPSpanExporter

                exporter = self._span_exporter = OTLPSpanExporter(
                    endpoint=f"{self.endpoint}/v1/traces")
            exporter.export(self._readable_spans(records))
        except Exception:
            self._count("otlp_export_errors_total")
            return 0
        self.n_spans_exported += len(records)
        self._count("otlp_span_batches_total")
        return len(records)

    # -- metrics --------------------------------------------------------------
    def _metrics_data(self, reg: MetricsRegistry):
        from opentelemetry.sdk.metrics.export import (
            AggregationTemporality,
            Gauge as OtGauge,
            Histogram as OtHistogram,
            HistogramDataPoint,
            Metric,
            MetricsData,
            NumberDataPoint,
            ResourceMetrics,
            ScopeMetrics,
            Sum,
        )
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.util.instrumentation import (
            InstrumentationScope,
        )

        now_ns = int(time.time() * _NS)
        cumulative = AggregationTemporality.CUMULATIVE
        metrics = []
        for m in reg.metrics():
            attrs = {k: _attr_value(v) for k, v in m.labels.items()}
            if isinstance(m, Counter):
                data = Sum(data_points=[NumberDataPoint(
                    attributes=attrs, start_time_unix_nano=0,
                    time_unix_nano=now_ns, value=int(m.value))],
                    aggregation_temporality=cumulative, is_monotonic=True)
                unit = "1"
            elif isinstance(m, Gauge):
                data = OtGauge(data_points=[NumberDataPoint(
                    attributes=attrs, start_time_unix_nano=0,
                    time_unix_nano=now_ns, value=float(m.value))])
                unit = "1"
            elif isinstance(m, Histogram):
                # lossless: OTLP histogram points carry explicit bounds +
                # integer bucket counts — the registry's exact state
                data = OtHistogram(data_points=[HistogramDataPoint(
                    attributes=attrs, start_time_unix_nano=0,
                    time_unix_nano=now_ns, count=int(m.total),
                    sum=float(m.sum), bucket_counts=tuple(m.counts),
                    explicit_bounds=tuple(m.bounds),
                    min=0.0, max=float(m.max_value))],
                    aggregation_temporality=cumulative)
                unit = "ms"
            else:  # pragma: no cover - no other metric kinds exist
                continue
            metrics.append(Metric(name=m.name, description="", unit=unit,
                                  data=data))
        scope = ScopeMetrics(
            scope=InstrumentationScope(name="repro_torch.obs"),
            metrics=metrics, schema_url="")
        return MetricsData(resource_metrics=[ResourceMetrics(
            resource=Resource.create({"service.name": self.service_name}),
            scope_metrics=[scope], schema_url="")])

    def export_metrics(self, registry: MetricsRegistry | None = None) -> int:
        """Export every registry series as OTLP metrics; returns the
        series count exported (0 on no-op or failure)."""
        reg = registry if registry is not None else self.registry
        n_series = len(reg.metrics())
        if not self.available:
            self._count("otlp_export_noop_total")
            return 0
        try:
            exporter = self._metric_exporter
            if exporter is None:
                from opentelemetry.exporter.otlp.proto.http.metric_exporter \
                    import OTLPMetricExporter

                exporter = self._metric_exporter = OTLPMetricExporter(
                    endpoint=f"{self.endpoint}/v1/metrics")
            exporter.export(self._metrics_data(reg))
        except Exception:
            self._count("otlp_export_errors_total")
            return 0
        self.n_metrics_exported += n_series
        self._count("otlp_metric_batches_total")
        return n_series


__all__ = ["OtlpExporter", "otel_available"]
