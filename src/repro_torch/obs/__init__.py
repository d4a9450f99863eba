"""repro_torch.obs — unified observability: spans, exact-rank metrics, recompile
audit, Prometheus/JSON export, and the mesh-wide telemetry plane
(cross-process collector, scrape endpoint, OTLP export, SLO burn-rate
alerts). Host-side only by construction: nothing here dispatches to the card,
so enabling tracing — or running a live scrape server and collector push —
cannot change results or add steady-state recompiles (asserted in
tests/test_torch_obs.py)."""
from repro_torch.obs.audit import AUDITOR, AuditRecord, RecompileAuditor
from repro_torch.obs.collector import Collector, CollectorServer, push_snapshot, write_spool
from repro_torch.obs.export import (
    escape_label_value,
    parse_prometheus_text,
    prometheus_text,
    service_snapshot,
    snapshot,
    unescape_label_value,
    write_json,
)
from repro_torch.obs.otlp import OtlpExporter, otel_available
from repro_torch.obs.scrape import MetricsServer, serve_metrics
from repro_torch.obs.slo import BurnRatePolicy, SloMonitor, burn_exceeds
from repro_torch.obs.metrics import (
    DEFAULT_LATENCY_BOUNDS_MS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import (
    NOOP_SPAN,
    Span,
    SpanRecord,
    Tracer,
    configure,
    get_tracer,
    read_jsonl,
    set_tracer,
    span,
)

__all__ = [
    "AUDITOR", "AuditRecord", "RecompileAuditor",
    "prometheus_text", "service_snapshot", "snapshot", "write_json",
    "escape_label_value", "unescape_label_value", "parse_prometheus_text",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_BOUNDS_MS",
    "NOOP_SPAN", "Span", "SpanRecord", "Tracer",
    "configure", "get_tracer", "set_tracer", "span", "read_jsonl",
    "Collector", "CollectorServer", "push_snapshot", "write_spool",
    "MetricsServer", "serve_metrics",
    "BurnRatePolicy", "SloMonitor", "burn_exceeds",
    "OtlpExporter", "otel_available",
]
