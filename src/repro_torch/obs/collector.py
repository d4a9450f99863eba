"""Cross-process telemetry collector: exact fleet-level aggregation.

The metrics registry is process-local. A sharded or multi-worker deployment
runs N interpreters, each with its own ``MetricsRegistry`` — and an SLO
over the *fleet* needs p50/p95/p99 computed over every worker's
observations, not an average of per-worker quantiles (averaging quantiles
is wrong in general). Because the histograms carry exact integer bucket
counts, the fix is exact too: the collector ingests ``snapshot()`` dicts
from each worker, rebuilds the histograms (``Histogram.from_dict``), and
pools same-series histograms with ``Histogram.merged()`` — integer bucket
adds, so the fleet quantile is *bit-identical* to what one pooled registry
observing every event would report (oracle-tested in
tests/test_torch_obs.py). Merging is commutative and associative, so
ingest order across workers cannot change a reported number.

Tenants are re-keyed by ``(worker, tenant)``: two workers each serving a
tenant named ``"eu"`` stay distinct series (``worker`` label), while the
fleet view merges them per tenant name for the cross-worker SLO.

Two stdlib-only transports feed a collector:

  * **file spool** — each worker atomically writes
    ``<spool>/<worker>.json`` (tmp + rename, so the collector never reads
    a torn file); ``Collector.scan_spool(dir)`` ingests every spooled
    snapshot. Survives worker crashes, needs only a shared directory.
  * **socket push** — ``CollectorServer`` listens on a TCP port; workers
    ``push_snapshot(addr, worker, snap)`` one length-delimited JSON
    message per connection. No shared filesystem needed.

Everything here is host-side JSON + integer arithmetic: ingesting a
snapshot never touches torch, so running a collector (or pushing to one)
cannot perturb kernel caches or results — the repro_torch.obs invariant.
"""
from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry


def _strip(labels: dict, *drop: str) -> tuple:
    return tuple(sorted((k, v) for k, v in labels.items() if k not in drop))


class Collector:
    """Aggregates worker ``snapshot()`` dicts into one fleet view."""

    def __init__(self):
        self._lock = threading.Lock()
        # worker id -> {"snapshot": dict, "ingested_at": epoch seconds}
        self._workers: dict[str, dict] = {}
        self.n_ingests = 0

    # -- ingest ---------------------------------------------------------------
    def ingest(self, worker: str, snap: dict) -> None:
        """Adopt one worker's snapshot (the dict ``repro_torch.obs.snapshot()``
        or a service's ``metrics_snapshot()`` returns). Re-ingesting the
        same worker replaces its previous snapshot — snapshots are
        cumulative-from-process-start, so the latest one supersedes."""
        if not isinstance(snap, dict) or "metrics" not in snap:
            raise ValueError("snapshot must be a dict with a 'metrics' key")
        with self._lock:
            self._workers[str(worker)] = {
                "snapshot": snap, "ingested_at": time.time()}
            self.n_ingests += 1

    def workers(self) -> list[str]:
        with self._lock:
            return sorted(self._workers)

    # -- views ----------------------------------------------------------------
    def as_registry(self) -> MetricsRegistry:
        """One registry holding every worker's series, each re-labeled
        with ``worker=<id>`` — what ``/metrics`` exposes (per-worker
        series, the Prometheus data model; cross-worker aggregation is
        exact because the bucket counts ride along)."""
        reg = MetricsRegistry()
        with self._lock:
            items = [(w, e["snapshot"]) for w, e in self._workers.items()]
        for worker, snap in items:
            m = snap.get("metrics", {})
            for c in m.get("counters", []):
                reg.install(Counter(c["name"],
                                    dict(c.get("labels", {}), worker=worker),
                                    int(c["value"])))
            for g in m.get("gauges", []):
                reg.install(Gauge(g["name"],
                                  dict(g.get("labels", {}), worker=worker),
                                  float(g["value"]),
                                  float(g.get("updated_at", 0.0))))
            for h in m.get("histograms", []):
                hist = Histogram.from_dict(h)
                hist.labels = dict(hist.labels, worker=worker)
                reg.install(hist)
        return reg

    def fleet_histogram(self, name: str, **labels) -> Histogram | None:
        """Exact cross-worker pool of every ``name`` series matching
        ``labels`` (ignoring the worker label): integer bucket adds via
        ``Histogram.merged()``."""
        return self.as_registry().merged_histogram(name, **labels)

    def fleet_snapshot(self) -> dict:
        """The merged fleet view, JSON-ready:

        * ``tenants`` — per ``(worker, tenant)`` SLO views, re-keyed as
          ``"<worker>/<tenant>"`` (from each worker's ``service_snapshot``
          ``tenants`` section when present);
        * ``fleet`` — cross-worker aggregates per series with the worker
          label stripped: histograms pooled with exact bucket adds (the
          quantiles here are fleet-exact), counters summed, gauges
          last-writer-wins by ``updated_at``;
        * ``audit`` — summed compile counts and steady recompiles (the
          fleet alarm stays "this must be 0").
        """
        with self._lock:
            items = sorted((w, e["snapshot"], e["ingested_at"])
                           for w, e in self._workers.items())
        tenants: dict[str, dict] = {}
        hists: dict[tuple, Histogram] = {}
        counters: dict[tuple, dict] = {}
        gauges: dict[tuple, dict] = {}
        audit = {"compile_count_total": 0, "attributed_compiles": 0,
                 "audited_steady_recompiles": 0}
        for worker, snap, ingested_at in items:
            for tname, view in (snap.get("tenants") or {}).items():
                tenants[f"{worker}/{tname}"] = dict(view, worker=worker)
            m = snap.get("metrics", {})
            for h in m.get("histograms", []):
                key = (h["name"], _strip(h.get("labels", {}), "worker"))
                hist = Histogram.from_dict(h)
                prev = hists.get(key)
                hists[key] = hist if prev is None else prev.merged(hist)
            for c in m.get("counters", []):
                key = (c["name"], _strip(c.get("labels", {}), "worker"))
                ent = counters.setdefault(
                    key, {"name": c["name"],
                          "labels": dict(_strip(c.get("labels", {}),
                                                "worker")),
                          "value": 0})
                ent["value"] += int(c["value"])
            for g in m.get("gauges", []):
                key = (g["name"], _strip(g.get("labels", {}), "worker"))
                ent = gauges.get(key)
                at = float(g.get("updated_at", 0.0))
                if ent is None or at >= ent["updated_at"]:
                    gauges[key] = {"name": g["name"],
                                   "labels": dict(_strip(g.get("labels", {}),
                                                         "worker")),
                                   "value": float(g["value"]),
                                   "updated_at": at}
            a = snap.get("audit") or {}
            for k in audit:
                audit[k] += int(a.get(k, 0))
        return {
            "n_workers": len(items),
            "workers": [w for w, _, _ in items],
            "ingested_at": {w: at for w, _, at in items},
            "tenants": tenants,
            "fleet": {
                "counters": sorted(counters.values(),
                                   key=lambda c: (c["name"],
                                                  sorted(c["labels"].items()))),
                "gauges": sorted(gauges.values(),
                                 key=lambda g: (g["name"],
                                                sorted(g["labels"].items()))),
                "histograms": [hists[k].to_dict()
                               for k in sorted(hists, key=str)],
            },
            "audit": audit,
        }

    def prometheus_text(self) -> str:
        """Exposition text over every worker's series (worker-labeled)."""
        from repro_torch.obs.export import prometheus_text

        return prometheus_text(self.as_registry())

    # -- file-spool transport -------------------------------------------------
    def scan_spool(self, spool_dir: str) -> int:
        """Ingest every ``*.json`` snapshot in ``spool_dir``; returns how
        many were ingested. Files are whole-file JSON written atomically
        by :func:`write_spool`, keyed by the embedded worker id (falling
        back to the filename stem)."""
        n = 0
        for fname in sorted(os.listdir(spool_dir)):
            if not fname.endswith(".json"):
                continue
            path = os.path.join(spool_dir, fname)
            try:
                with open(path) as f:
                    payload = json.load(f)
            except (json.JSONDecodeError, OSError):
                continue  # torn/foreign file: skip, a rescan will catch up
            worker = payload.get("worker") or fname[:-len(".json")]
            snap = payload.get("snapshot", payload)
            if isinstance(snap, dict) and "metrics" in snap:
                self.ingest(worker, snap)
                n += 1
        return n


def write_spool(spool_dir: str, worker: str, snap: dict) -> str:
    """Atomically spool one worker snapshot: write ``<worker>.json.tmp``
    then rename over ``<worker>.json``, so a concurrently scanning
    collector never sees a torn file. Returns the final path."""
    os.makedirs(spool_dir, exist_ok=True)
    final = os.path.join(spool_dir, f"{worker}.json")
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"worker": worker, "ts": time.time(), "snapshot": snap},
                  f, default=str)
    os.replace(tmp, final)
    return final


# ---------------------------------------------------------------------------
# socket-push transport
# ---------------------------------------------------------------------------
class _PushHandler(socketserver.StreamRequestHandler):
    def handle(self):
        data = self.rfile.read()  # one message per connection, EOF-delimited
        try:
            payload = json.loads(data.decode("utf-8"))
            worker = str(payload["worker"])
            snap = payload["snapshot"]
            self.server.collector.ingest(worker, snap)
            self.wfile.write(b"ok\n")
        except Exception as e:  # malformed push must not kill the listener
            self.server.n_rejected += 1
            try:
                self.wfile.write(f"error: {e}\n".encode())
            except OSError:
                pass


class CollectorServer:
    """TCP listener feeding a :class:`Collector` (one JSON message per
    connection — see :func:`push_snapshot`). Binds ``port=0`` to an
    ephemeral port; ``close()`` shuts the listener down cleanly."""

    def __init__(self, collector: Collector | None = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.collector = collector if collector is not None else Collector()

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, int(port)), _PushHandler)
        self._server.collector = self.collector
        self._server.n_rejected = 0
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="obs-collector", daemon=True)
        self._thread.start()

    @property
    def address(self) -> tuple:
        return self._server.server_address[:2]

    @property
    def n_rejected(self) -> int:
        return self._server.n_rejected

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


def push_snapshot(address: tuple, worker: str, snap: dict,
                  timeout: float = 5.0) -> bool:
    """Push one snapshot to a :class:`CollectorServer` at ``address``
    ``(host, port)``; returns True when the collector acknowledged.
    Failures return False instead of raising — telemetry push must never
    take the serving path down with it."""
    msg = json.dumps({"worker": worker, "snapshot": snap},
                     default=str).encode("utf-8")
    try:
        with socket.create_connection(address, timeout=timeout) as sock:
            sock.sendall(msg)
            sock.shutdown(socket.SHUT_WR)  # EOF marks end-of-message
            resp = sock.recv(64)
        return resp.startswith(b"ok")
    except OSError:
        return False


__all__ = ["Collector", "CollectorServer", "write_spool", "push_snapshot"]
