"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``) on the same inputs: metrics and exact-rank
quantiles, Prometheus text, the collector's fleet merge, SLO burn-rate
evaluation, the scrape server, JSONL rotation (on a fake clock, byte for
byte), the recompile auditor, and the spans of a traced stream (same names,
nesting and attributes but ``compiled``). Also the port's own contract: a
span is host-only (a disabled tracer returns the shared no-op, the profiler
bridge names the range and nothing else), and the auditor's ``"kernels"``
provider counts kernel library loads. Inputs come from numpy seeds.
"""
import dataclasses
import json
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
import repro.obs.trace as jtrace  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.obs.trace as ttrace  # noqa: E402
from repro.stream import DeltaEngine as JEngine  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.stream import DeltaEngine  # noqa: E402
from repro_torch.utils import time_fn  # noqa: E402

PACKAGES = {"port": tobs, "jax": jobs}
NAMES = ('acme "eu"', "bank\\prod", "multi\nline", "plain")


def _strip_times(x):
    """A snapshot with the wall-clock fields removed."""
    if isinstance(x, dict):
        return {k: _strip_times(v) for k, v in x.items()
                if k not in ("updated_at", "ingested_at")}
    if isinstance(x, list):
        return [_strip_times(v) for v in x]
    return x


def _registry(obs, seed):
    """The same metric operations, from one numpy seed, on ``obs``'s types."""
    rng = np.random.default_rng(seed)
    reg = obs.MetricsRegistry()
    for name in NAMES:
        reg.counter("peel_passes_total", tenant=name).inc(int(rng.integers(1, 9)))
        g = reg.gauge("certified_gap", tenant=name)
        g.set(float(rng.random()))
        g.updated_at = 100.0 + seed  # the fleet view keeps the last writer
        h = reg.histogram("query_ms", tenant=name, engine="delta")
        for v in rng.lognormal(0.0, 2.0, 60):
            h.observe(float(v))
    return reg


def test_metrics_and_prometheus_text_match_jax():
    port, ref = _registry(tobs, 1), _registry(jobs, 1)
    assert _strip_times(port.snapshot()) == _strip_times(ref.snapshot())
    for name in NAMES:
        a = port.merged_histogram("query_ms", tenant=name)
        b = ref.merged_histogram("query_ms", tenant=name)
        assert a.counts == b.counts and a.quantiles() == b.quantiles()
    text = tobs.prometheus_text(port)
    assert text == jobs.prometheus_text(ref)
    assert tobs.parse_prometheus_text(text) == jobs.parse_prometheus_text(text)
    for name in NAMES:
        assert tobs.unescape_label_value(tobs.escape_label_value(name)) == name
        assert tobs.escape_label_value(name) == jobs.escape_label_value(name)


def test_collector_merge_matches_jax(tmp_path):
    out = {}
    for key, obs in PACKAGES.items():
        col = obs.Collector()
        for seed in (1, 2, 3):
            col.ingest(f"w{seed}", {"metrics": _registry(obs, seed).snapshot(),
                                    "audit": {"compile_count_total": seed}})
        spool = tmp_path / key
        obs.write_spool(str(spool), "w9", {"metrics": _registry(obs, 9).snapshot()})
        assert col.scan_spool(str(spool)) == 1
        fleet = col.fleet_histogram("query_ms", tenant="plain")
        out[key] = (fleet.counts, fleet.quantiles(),
                    _strip_times(col.fleet_snapshot()),
                    obs.prometheus_text(col.as_registry()))
    assert out["port"] == out["jax"]


def test_collector_push_transport():
    server = tobs.CollectorServer()
    try:
        snap = {"metrics": _registry(tobs, 5).snapshot()}
        assert tobs.push_snapshot(server.address, "w5", snap)
        assert server.collector.workers() == ["w5"]
        assert server.collector.fleet_histogram("query_ms", tenant="plain").total == 60
    finally:
        server.close()
    assert tobs.push_snapshot(server.address, "w6", snap) is False


def test_slo_evaluation_matches_jax():
    """The same fake-clock sequence of observations and samples gives the
    same burn-rate evaluation, and the same integer predicate."""
    out = {}
    for key, obs in PACKAGES.items():
        rng = np.random.default_rng(2)
        reg, now = obs.MetricsRegistry(), [0.0]
        pol = obs.BurnRatePolicy(name="lat", threshold_ms=1.0, fast_windows_s=(5.0, 60.0),
                                 slow_windows_s=(30.0, 120.0))
        mon = obs.SloMonitor(registry_fn=lambda reg=reg: reg, policies=(pol,),
                             clock=lambda now=now: now[0])
        g = reg.gauge("certified_gap", tenant="eu")
        g.set(0.01)
        g.updated_at = 5.0
        evals = []
        for t in range(0, 90, 3):
            now[0] = float(t)
            for v in rng.lognormal(-1.0, 1.5, 8):
                reg.histogram("query_ms", tenant="eu").observe(float(v))
            mon.sample()
            evals.append(mon.evaluate())
        out[key] = evals
    assert out["port"] == out["jax"]
    for args in ((15, 100, 99, 100, 144, 10), (144, 1000, 99, 100, 144, 10)):
        assert tobs.burn_exceeds(*args) == jobs.burn_exceeds(*args)


def test_scrape_server_serves_what_jax_renders():
    reg = _registry(tobs, 3)
    server = tobs.serve_metrics(registry=reg)
    try:
        with urllib.request.urlopen(f"{server.url}/metrics", timeout=5) as resp:
            body = resp.read().decode()
        with urllib.request.urlopen(f"{server.url}/healthz", timeout=5) as resp:
            assert resp.read() == b"ok\n"
    finally:
        server.close()
    assert body == jobs.prometheus_text(_registry(jobs, 3))


class _FakeClock:
    """Deterministic stand-in for the ``time`` module inside trace.py."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.000731
        return self.t

    def time(self):
        return 1.7e9 + self.t


@pytest.mark.parametrize("max_bytes,backups", [(2048, 2), (1024, 0), (None, 1)])
def test_jsonl_rotation_matches_jax_byte_for_byte(tmp_path, monkeypatch, max_bytes, backups):
    files = {}
    for key, (obs, mod) in {"port": (tobs, ttrace), "jax": (jobs, jtrace)}.items():
        monkeypatch.setattr(mod, "time", _FakeClock())
        path = tmp_path / key / "t.jsonl"
        path.parent.mkdir()
        tr = obs.Tracer(jsonl_path=str(path), profiler_bridge=False,
                        jsonl_max_bytes=max_bytes, jsonl_backups=backups)
        for i in range(300):
            with tr.span("query", tenant="rot") as sp:
                sp.set("passes", i % 7)
        tr.close()
        files[key] = {p.name: p.read_bytes() for p in sorted(path.parent.iterdir())}
        assert len(tr.ring()) == 300
    assert files["port"] == files["jax"]
    assert len(files["port"]) == (1 if max_bytes is None else backups + 1)


class _FakeJit:
    def __init__(self):
        self.n = 0
        self.__name__ = "fake_jit"

    def _cache_size(self):
        return self.n


def test_auditor_matches_jax():
    out = {}
    for key, obs in PACKAGES.items():
        fj, aud = _FakeJit(), obs.RecompileAuditor()
        aud.register_provider(lambda fj=fj: [fj], name="fake")
        aud.sync()
        seen = []
        for growth, key_ in ((1, (64, 128)), (0, (64, 128)), (2, (64, 128)),
                             (1, (64, 256)), (5, None), (0, (8,))):
            fj.n += growth
            if key_ is None:
                aud.sync()
            else:
                seen.append(aud.record("t1", "query", key_))
        out[key] = (seen, aud.snapshot(), aud.providers_snapshot(),
                    aud.audited_steady_recompiles, aud.total_compile_count())
    assert out["port"] == out["jax"]
    assert out["port"][3] == 2


def test_kernels_provider_counts_library_loads(monkeypatch):
    """A library load under a fresh key is warm-up; one under a key seen
    before is a steady-state recompile, attributed to ``load``."""
    aud = tobs.RecompileAuditor()
    aud.register_provider(build._audited, name="kernels")
    aud.sync()
    base = aud.total_compile_count()
    monkeypatch.setitem(build._libs, Path("a.cu"), None)
    assert aud.record("t", "query", (1,)) is True and aud.audited_steady_recompiles == 0
    assert aud.record("t", "query", (1,)) is False
    monkeypatch.setitem(build._libs, Path("b.cu"), None)
    assert aud.record("t", "query", (1,)) is True and aud.audited_steady_recompiles == 1
    assert aud.steady_records()[-1].fn == "load"
    assert aud.total_compile_count() == base + 2
    assert aud.providers_snapshot() == {"kernels": ["repro_torch.kernels.build.load"]}
    snap = tobs.AUDITOR.providers_snapshot()
    assert snap["kernels"] == ["repro_torch.kernels.build.load"] and snap["stream"] == []
    assert DeltaEngine.compile_count() == tobs.AUDITOR.total_compile_count()


def _traced_stream(obs, engine_cls, tr, **kw):
    prev = obs.set_tracer(tr)
    try:
        rng = np.random.default_rng(8)
        eng = engine_cls(40, refresh_every=3, **kw)
        eng.tenant = "traced"
        results = []
        for i in range(7):
            eng.apply_updates(insert=rng.integers(0, 40, (14, 2)),
                              delete=np.asarray(sorted(eng.buffer._slot))[::5] if i else None)
            results.append(eng.query(refine=(i % 3 == 2), max_refine_rounds=3))
        return tr, results
    finally:
        obs.set_tracer(prev)


def test_traced_stream_spans_match_jax(tmp_path):
    """Same span names, nesting, labels and attributes as JAX's (but
    ``compiled``, which counts XLA compiles there and library loads here),
    the same metric feeds, and the same answers as an untraced run."""
    jsonl = tmp_path / "trace.jsonl"
    tr_t, res_t = _traced_stream(tobs, DeltaEngine, tobs.Tracer(
        jsonl_path=str(jsonl), profiler_bridge=False), device="cpu")
    tr_j, res_j = _traced_stream(jobs, JEngine, jobs.Tracer(profiler_bridge=False))

    def spans(tr):
        return [(r.span_id, r.parent_id, r.depth, r.name, r.labels,
                 {k: v for k, v in r.attrs.items() if k != "compiled"}) for r in tr.ring()]

    assert spans(tr_t) == spans(tr_j)
    assert {r.name for r in tr_t.ring()} >= {"ingest", "query", "refresh", "refine"}

    def counters(tr):
        return sorted((c["name"], sorted(c["labels"].items()), c["value"])
                      for c in tr.registry.snapshot()["counters"]
                      if c["name"] != "first_calls_total")

    assert counters(tr_t) == counters(tr_j)
    tr_t.close()
    assert [json.loads(x)["name"] for x in jsonl.read_text().splitlines()] == [
        r.name for r in tr_t.ring()]
    # tracing changes no answer
    _, res_q = _traced_stream(tobs, DeltaEngine, tobs.Tracer(enabled=False), device="cpu")
    for a, b, c in zip(res_t, res_j, res_q):
        assert a.density == b.density == c.density and a.passes == b.passes == c.passes
        assert np.array_equal(a.mask, c.mask) and c.latency_ms == 0.0


def test_disabled_tracer_is_the_shared_noop():
    tr = tobs.Tracer(enabled=False)
    sp = tr.span("query", tenant="x")
    assert sp is tobs.NOOP_SPAN
    with sp as s:
        assert s.set("passes", 3) is s and s.elapsed_ms == 0.0
    assert tr.ring() == [] and tr.registry.snapshot() == tobs.MetricsRegistry().snapshot()


@pytest.mark.parametrize("bridge", [True, False])
def test_profiler_bridge_names_the_host_range(bridge):
    """With the bridge on, a span appears in a torch.profiler trace as
    ``obs:<name>``; with it off, or the tracer disabled, nothing does."""
    from torch.profiler import ProfilerActivity, profile

    tr = tobs.Tracer(profiler_bridge=bridge)
    off = tobs.Tracer(profiler_bridge=True, enabled=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("query", tenant="p"):
            torch.ones(4).sum()
        with off.span("refine", tenant="p"):
            pass
    names = {e.name for e in prof.events()}
    assert ("obs:query" in names) == bridge and "obs:refine" not in names
    assert [r.name for r in tr.ring()] == ["query"]


def test_otlp_noop_and_failures_are_counted():
    for obs in PACKAGES.values():
        reg = obs.MetricsRegistry()
        reg.histogram("query_ms", tenant="eu").observe(1.0)
        exp = obs.OtlpExporter(registry=reg)
        exp.available = False
        assert exp.export_spans([]) == 0 and exp.export_metrics() == 0
        assert reg.counter("otlp_export_noop_total", exporter="otlp").value == 2
    assert tobs.otel_available() == jobs.otel_available()


def test_obs_exports_the_reference_names():
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    assert [f.name for f in dataclasses.fields(tobs.SpanRecord)] == [
        f.name for f in dataclasses.fields(jobs.SpanRecord)]


def test_time_fn_returns_the_result_and_a_time():
    calls = []

    def fn(x):
        calls.append(x)
        return {"a": (torch.ones(2), [torch.zeros(1)]), "b": 3}

    secs, out = time_fn(fn, 5, iters=3, warmup=2)
    assert secs >= 0.0 and out["b"] == 3 and calls == [5] * 5
