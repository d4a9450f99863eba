"""Scrape endpoint: /metrics, /snapshot, /slo over stdlib http.server.

Replaces the "pull a dict from Python" story: a worker (or a collector
aggregating many workers) binds a real HTTP port and any Prometheus
scraper, curl, or the examples' alert loop reads

  ``/metrics``   Prometheus exposition text (lintable: label values are
                 escaped per spec — obs/export.py);
  ``/snapshot``  the full JSON snapshot (per-tenant SLO views + registry
                 dump + recompile audit for a service; the merged fleet
                 snapshot for a collector);
  ``/slo``       the multi-window burn-rate evaluation (obs/slo.py) —
                 sampled on every GET, so scraping IS the cadence;
  ``/healthz``   liveness.

The server is a daemon ``ThreadingHTTPServer`` on its own thread:
handling a scrape renders host-side text from host-side integers and
never calls into torch, so a live scrape endpoint cannot perturb engine
results or kernel caches (asserted with the oracle-parity tests running
against a live server in tests/test_torch_obs.py). ``port=0`` binds an
ephemeral port (tests, CI smokes); ``close()`` shuts down cleanly.

Construction picks the source: ``serve_metrics(service=...)`` exposes one
worker's registry + per-tenant SLO view; ``serve_metrics(collector=...)``
exposes the fleet (worker-labeled series, exact cross-worker merges).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs.slo import SloMonitor
from repro_torch.obs.trace import get_tracer


def _json_default(o):
    return str(o)


class MetricsServer:
    """One scrape endpoint over a service, a collector, or a registry."""

    def __init__(self, service=None, collector=None, registry=None,
                 slo: SloMonitor | None = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self.collector = collector
        self._registry = registry
        if slo is None:
            slo = SloMonitor(registry_fn=self._registry_now)
        self.slo = slo
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet: no stderr spam
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        body = outer.render_metrics().encode()
                        self._send(200, body,
                                   "text/plain; version=0.0.4; "
                                   "charset=utf-8")
                    elif path == "/snapshot":
                        body = json.dumps(outer.render_snapshot(),
                                          default=_json_default).encode()
                        self._send(200, body, "application/json")
                    elif path == "/slo":
                        body = json.dumps(outer.slo.report(),
                                          default=_json_default).encode()
                        self._send(200, body, "application/json")
                    elif path in ("/", "/healthz"):
                        self._send(200, b"ok\n", "text/plain")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:  # a broken render must not wedge
                    outer.n_errors += 1   # the listener thread
                    self._send(500, f"error: {e}\n".encode(), "text/plain")

        self.n_errors = 0
        self._server = ThreadingHTTPServer((host, int(port)), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="obs-scrape", daemon=True)
        self._thread.start()

    # -- sources --------------------------------------------------------------
    def _registry_now(self):
        if self.collector is not None:
            return self.collector.as_registry()
        if self._registry is not None:
            return self._registry
        return get_tracer().registry

    def render_metrics(self) -> str:
        from repro_torch.obs.export import prometheus_text

        if self.collector is not None:
            return self.collector.prometheus_text()
        return prometheus_text(self._registry)

    def render_snapshot(self) -> dict:
        from repro_torch.obs.export import snapshot

        if self.collector is not None:
            return self.collector.fleet_snapshot()
        if self.service is not None:
            return self.service.metrics_snapshot()
        return snapshot(self._registry)

    # -- lifecycle ------------------------------------------------------------
    @property
    def address(self) -> tuple:
        return self._server.server_address[:2]

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


def serve_metrics(service=None, collector=None, registry=None,
                  slo: SloMonitor | None = None,
                  host: str = "127.0.0.1", port: int = 0) -> MetricsServer:
    """Start a scrape endpoint; returns the live :class:`MetricsServer`
    (``.url``, ``.port``, ``.close()``). With no source the process-default
    registry is served — the one-liner for any worker process."""
    return MetricsServer(service=service, collector=collector,
                         registry=registry, slo=slo, host=host, port=port)


__all__ = ["MetricsServer", "serve_metrics"]
