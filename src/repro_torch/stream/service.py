"""Batch query front-end over the tenant registry.

The serving surface: callers speak in named tenants and structured
requests; the service routes to the right ``DeltaEngine``, measures
latency, and exposes the build counter so an operator can alarm on rebuild
storms (the steady state loads no kernel library per request).

Operations
  ``apply_updates``  ingest one insert/delete batch for a tenant
  ``ingest_many``    ingest many tenants' batches (one fused patch per
                     capacity bucket for fused tenants)
  ``density``        oracle-exact densest-subgraph density (warm peel)
  ``membership``     boolean vertex mask of the best subgraph
  ``top_k_densest``  cross-tenant leaderboard (fraud triage: which graph
                     grew the hottest ring since the last sweep) — served
                     from one batched peel per bucket for fused tenants
  ``stats``          per-tenant counters for dashboards

Query coalescing: with ``coalesce_window_ms > 0`` callers can
``submit_density`` instead of ``density`` — requests queue until the window
expires (checked on the next submit), an explicit ``flush()``, or
``shutdown()``; same-bucket requests in one flush answer through one
batched peel (stream/fused.py). ``poll(ticket)`` retrieves a finished
response. The synchronous ``density`` API is unchanged.

This is the JAX package's ``stream/service.py``; the service takes
``device=`` for its registry (None means the GPU and raises where there is
none). Like the JAX package's, ``flush`` turns a failure inside the fused
flush into per-tenant queries and per-tenant error responses.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.obs.trace import span
from repro_torch.stream.buffer import MIN_CAPACITY
from repro_torch.stream.delta import DeltaEngine
from repro_torch.stream.fused import ingest_group, query_group
from repro_torch.stream.registry import GraphRegistry, placement_of


@dataclass
class ServiceResponse:
    ok: bool
    op: str
    tenant: str | None
    value: Any
    latency_ms: float
    compiles: int          # kernel libraries loaded so far (flat = healthy)
    error: str | None = None
    compiled: bool = False  # this request loaded a kernel library, so
                            # latency_ms is a first-call number (obs audit)


@dataclass
class ServiceMetrics:
    n_requests: int = 0
    n_errors: int = 0
    latency_ms_total: float = 0.0
    by_op: dict = field(default_factory=dict)


class StreamService:
    """Single-process front-end; one registry, many tenants."""

    def __init__(self, max_tenants: int = 64, eps: float = 0.0,
                 refresh_every: int = 32, pruned: bool = True,
                 sharded: bool = False, mesh=None, fused: bool = False,
                 kernel: bool | None = None,
                 coalesce_window_ms: float = 0.0,
                 worker: str | None = None,
                 device=None):
        # worker identity: labels this process's snapshots when they are
        # pushed/spooled to a cross-process collector (obs.collector
        # re-keys tenants by (worker, tenant)); defaults to the pid so two
        # unconfigured workers never alias
        import os

        self.worker = worker if worker else f"w{os.getpid()}"
        self.registry = GraphRegistry(
            max_tenants=max_tenants, eps=eps, refresh_every=refresh_every,
            pruned=pruned, sharded=sharded, mesh=mesh, fused=fused,
            kernel=kernel, worker=self.worker, device=device,
        )
        self.metrics = ServiceMetrics()
        self._metrics_server = None
        # query coalescing: pending (ticket, tenant, t_submit) triples are
        # flushed together so same-bucket fused tenants share one batched
        # peel; window <= 0 degenerates to flush-per-submit
        self.coalesce_window_ms = float(coalesce_window_ms)
        self._pending: list[tuple[int, str, float]] = []
        self._results: dict[int, ServiceResponse] = {}
        self._next_ticket = 0
        self._closed = False

    # -- plumbing -----------------------------------------------------------
    def _respond(self, op: str, tenant: str | None, sp,
                 value: Any = None, error: str | None = None,
                 compiled: bool = False) -> ServiceResponse:
        """Build the response from the op's *open* span (``sp.elapsed_ms``
        is the request latency so far — one clock source for the response,
        the span record, and the metrics registry)."""
        ms = sp.elapsed_ms
        self.metrics.n_requests += 1
        self.metrics.latency_ms_total += ms
        per_op = self.metrics.by_op.setdefault(op, {"n": 0, "ms": 0.0})
        per_op["n"] += 1
        per_op["ms"] += ms
        if error is not None:
            self.metrics.n_errors += 1
            sp.set("error", error)
        sp.set("compiled", compiled)
        return ServiceResponse(
            ok=error is None, op=op, tenant=tenant, value=value,
            latency_ms=ms, compiles=DeltaEngine.compile_count(), error=error,
            compiled=compiled,
        )

    def _engine(self, tenant: str) -> DeltaEngine:
        return self.registry.get(tenant)

    # -- tenant lifecycle ---------------------------------------------------
    def create_tenant(self, tenant: str, n_nodes: int, eps: float | None = None,
                      capacity: int = MIN_CAPACITY,
                      pruned: bool | None = None,
                      sharded: bool | None = None,
                      fused: bool | None = None,
                      kernel: bool | None = None) -> ServiceResponse:
        """``pruned=False`` opts a tenant back into the warm-mask path,
        whose warm_density is an anytime lower bound that can exceed the
        exact density right after deletions (pruned tenants mirror the
        exact result instead). ``fused=True`` places the tenant in its
        capacity bucket's lane stack so grouped queries/ingests batch into
        one program (the response's ``placement`` names the cell).
        ``kernel`` routes the tenant's passes through the CUDA kernels
        (bit-identical results; None defers to the service default, itself
        on for a CUDA device). ``sharded=True`` spans the tenant's graph over
        the service's mesh at identical results (``n_shards`` in the
        response); with ``fused`` too, its bucket's batched programs make one
        collective a pass for the whole bucket."""
        with span("service", op="create_tenant", tenant=tenant) as sp:
            try:
                eng = self.registry.register(tenant, n_nodes, eps=eps,
                                             capacity=capacity, pruned=pruned,
                                             sharded=sharded, fused=fused,
                                             kernel=kernel)
            except (ValueError, KeyError) as e:
                return self._respond("create_tenant", tenant, sp,
                                     error=str(e))
            return self._respond(
                "create_tenant", tenant, sp,
                value={"node_capacity": eng.node_capacity,
                       "edge_capacity": eng.buffer.capacity,
                       "n_shards": eng.n_shards,
                       "placement": placement_of(eng)},
            )

    # -- ingest -------------------------------------------------------------
    def apply_updates(self, tenant: str, insert=None,
                      delete=None) -> ServiceResponse:
        with span("service", op="apply_updates", tenant=tenant) as sp:
            try:
                stats = self._engine(tenant).apply_updates(insert=insert,
                                                           delete=delete)
            except (ValueError, KeyError) as e:
                return self._respond("apply_updates", tenant, sp,
                                     error=str(e))
            return self._respond("apply_updates", tenant, sp, value=stats,
                                 compiled=stats.compiled)

    def ingest_many(self, updates: dict) -> ServiceResponse:
        """Apply many tenants' batches; fused tenants in the same capacity
        bucket share one ``[T, B]`` scatter program per flush.
        ``updates`` maps tenant -> (insert, delete)."""
        with span("service", op="ingest_many", tenant="-") as sp:
            try:
                engines = {t: self._engine(t) for t in updates}
                stats = ingest_group(updates, engines)
            except (ValueError, KeyError) as e:
                return self._respond("ingest_many", None, sp, error=str(e))
            return self._respond(
                "ingest_many", None, sp, value=stats,
                compiled=any(s.compiled for s in stats.values()))

    # -- queries ------------------------------------------------------------
    @staticmethod
    def _density_value(q) -> dict:
        value = {"density": q.density, "warm_density": q.warm_density,
                 "passes": q.passes, "refreshed": q.refreshed,
                 "pruned": q.pruned}
        if q.certificate is not None:
            c = q.certificate
            value.update({
                "certified_gap": c.rel_gap,     # (dual - density) / dual
                "dual_bound": c.dual_bound,     # LP bound: >= rho*(G)
                "proved_optimal": c.proves_optimal,
                "refine_rounds": q.refine_rounds,
                "certified_skip": q.certified_skip,
            })
        return value

    def density(self, tenant: str, refine: bool = False,
                target_gap: float | None = None,
                max_refine_rounds: int = 64) -> ServiceResponse:
        """Densest-subgraph density for one tenant. ``refine=True`` serves
        the certified near-optimal density instead (repro_torch.refine): the
        response gains ``certified_gap`` / ``dual_bound`` /
        ``proved_optimal`` — an operator alarms on the gap exactly like on
        the build counter."""
        with span("service", op="density", tenant=tenant) as sp:
            try:
                q = self._engine(tenant).query(
                    refine=refine, target_gap=target_gap,
                    max_refine_rounds=max_refine_rounds)
            except (ValueError, KeyError) as e:
                return self._respond("density", tenant, sp, error=str(e))
            return self._respond("density", tenant, sp,
                                 value=self._density_value(q),
                                 compiled=q.compiled)

    def membership(self, tenant: str, warm: bool = False) -> ServiceResponse:
        with span("service", op="membership", tenant=tenant) as sp:
            try:
                q = self._engine(tenant).query()
            except (ValueError, KeyError) as e:
                return self._respond("membership", tenant, sp, error=str(e))
            mask = q.warm_mask if warm else q.mask
            return self._respond(
                "membership", tenant, sp,
                value={"mask": np.asarray(mask),
                       "density": q.warm_density if warm else q.density,
                       "n_members": int(np.asarray(mask).sum())},
                compiled=q.compiled,
            )

    def top_k_densest(self, k: int = 5) -> ServiceResponse:
        """Cross-tenant sweep, densest first. Fused tenants in the same
        capacity bucket answer through one batched peel per flush
        (query_group); unfused tenants peel individually — either way the
        steady state loads no kernel library. ``k`` larger than the tenant count
        returns the whole leaderboard."""
        with span("service", op="top_k_densest", tenant="-") as sp:
            board = []
            try:
                engines = {name: self.registry.get(name)
                           for name in list(self.registry.names())}
                results = query_group(engines)
                for name, q in results.items():
                    board.append({"tenant": name, "density": q.density,
                                  "warm_density": q.warm_density,
                                  "n_edges": engines[name].n_edges})
            except (ValueError, KeyError) as e:
                return self._respond("top_k_densest", None, sp, error=str(e))
            board.sort(key=lambda r: -r["density"])
            return self._respond(
                "top_k_densest", None, sp, value=board[: int(k)],
                compiled=any(q.compiled for q in results.values()))

    # -- query coalescing ---------------------------------------------------
    def submit_density(self, tenant: str) -> int:
        """Enqueue a density query; returns a ticket for ``poll``. The
        pending set flushes when the coalescing window has expired (checked
        here), on ``flush()``, or at ``shutdown()`` — so a burst of
        same-bucket submissions becomes one fused peel."""
        if self._closed:
            raise RuntimeError("service is shut down")
        ticket = self._next_ticket
        self._next_ticket += 1
        now = time.perf_counter()
        self._pending.append((ticket, tenant, now))
        window_s = self.coalesce_window_ms * 1e-3
        if window_s <= 0 or now - self._pending[0][2] >= window_s:
            self.flush()
        return ticket

    def poll(self, ticket: int) -> ServiceResponse | None:
        """Retrieve (and clear) a finished coalesced response, or None if
        the ticket is still pending."""
        return self._results.pop(ticket, None)

    def flush(self) -> int:
        """Answer every pending coalesced query now; returns how many were
        flushed. Same-bucket fused tenants share one batched peel."""
        pending, self._pending = self._pending, []
        if not pending:
            return 0
        with span("service", op="flush", tenant="-") as sp:
            engines, errors = {}, {}
            for _, tenant, _ in pending:
                if tenant in engines or tenant in errors:
                    continue
                try:
                    engines[tenant] = self.registry.get(tenant)
                except KeyError as e:
                    errors[tenant] = str(e)
            try:
                results = query_group(engines)
            except Exception:
                # one tenant's failure must not orphan the whole flush's
                # tickets: fall back to per-tenant queries so every ticket
                # gets a response (the failing tenant gets its own error)
                results = {}
                for tenant, eng in engines.items():
                    try:
                        results[tenant] = eng.query()
                    except Exception as e:
                        errors[tenant] = str(e)
            sp.set("n_flushed", len(pending))
            for ticket, tenant, _ in pending:
                if tenant in errors:
                    self._results[ticket] = self._respond(
                        "density", tenant, sp, error=errors[tenant])
                    continue
                q = results[tenant]
                self._results[ticket] = self._respond(
                    "density", tenant, sp, value=self._density_value(q),
                    compiled=q.compiled)
        return len(pending)

    def shutdown(self) -> int:
        """Flush any pending coalesced queries and refuse new submissions.
        Idempotent; returns how many pending queries the final flush
        answered (their results stay pollable). Also closes the scrape
        endpoint if ``serve_metrics`` started one."""
        if self._closed:
            return 0
        flushed = self.flush()
        self._closed = True
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        return flushed

    # -- observability ------------------------------------------------------
    def stats(self, tenant: str | None = None) -> ServiceResponse:
        with span("service", op="stats", tenant=tenant or "-") as sp:
            try:
                value = (self.registry.all_stats() if tenant is None
                         else self.registry.stats(tenant))
            except KeyError as e:
                return self._respond("stats", tenant, sp, error=str(e))
            return self._respond("stats", tenant, sp, value=value)

    def metrics_snapshot(self) -> dict:
        """Per-tenant SLO snapshot (obs.export): p50/p95/p99 query
        latency split into first-call vs steady series, peel-pass and
        refine-round counters, the latest certified-gap gauge, plus the full
        metrics-registry dump and the recompile audit
        (``audited_steady_recompiles`` is the alarm — the steady state is
        zero). JSON-ready; ``obs.prometheus_text()`` renders the same
        registry for a scraper."""
        from repro_torch.obs.export import service_snapshot

        return service_snapshot(self)

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1",
                      slo=None):
        """Start (or return) the HTTP scrape endpoint for this worker:
        ``/metrics`` (Prometheus text), ``/snapshot`` (the
        ``metrics_snapshot()`` JSON), ``/slo`` (multi-window burn-rate
        view — obs.slo), ``/healthz``. ``port=0`` binds an
        ephemeral port; the returned server exposes ``.url`` / ``.port``
        / ``.close()`` and is closed automatically by ``shutdown()``.
        Handling a scrape is host-side only — a live endpoint cannot
        change engine results or kernel caches."""
        if self._metrics_server is None:
            from repro_torch.obs.scrape import serve_metrics as _serve

            self._metrics_server = _serve(service=self, slo=slo,
                                          host=host, port=port)
        return self._metrics_server

    def push_snapshot(self, address: tuple) -> bool:
        """Push this worker's snapshot to a ``CollectorServer`` at
        ``(host, port)`` — labeled with ``self.worker``. Returns False
        (never raises) when the collector is unreachable: telemetry push
        must not take serving down."""
        from repro_torch.obs.collector import push_snapshot as _push

        return _push(address, self.worker, self.metrics_snapshot())

    def spool_snapshot(self, spool_dir: str) -> str:
        """Atomically write this worker's snapshot into a collector spool
        directory (``<dir>/<worker>.json``); returns the path. The
        file-transport counterpart of :meth:`push_snapshot`."""
        from repro_torch.obs.collector import write_spool

        return write_spool(spool_dir, self.worker, self.metrics_snapshot())


__all__ = ["StreamService", "ServiceResponse", "ServiceMetrics"]
