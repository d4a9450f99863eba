"""Recompile auditor: attribute every new executable to what triggered it.

A process-global count of "things built" (``DeltaEngine.compile_count()``)
can say that the hot path built something, but not *which* tenant, op or
shape paid for it. The auditor turns the count into an attribution log:

  * caches register through *providers*: callables yielding live objects
    with ``_cache_size()`` and ``__name__``. This package has no jit
    caches; what it builds at run time is a kernel library, loaded once a
    process by ``kernels/build.py:load`` (its ``"kernels"`` provider counts
    them, and is where CUDA-graph captures will be counted too), so a
    "compile" here is a library load;
  * around each engine op the instrumentation calls ``sync()`` (absorb any
    foreign growth, e.g. a benchmark's cold baseline peel, without
    attributing it) then ``record(tenant, op, shape)`` after dispatch: any
    cache growth in between becomes :class:`AuditRecord` entries tagged
    with the (tenant, op, shape) that triggered them.

Steady-state classification: the first growth under a given
``(tenant, op, shape)`` key is warmup (``steady=False`` — a cold first
call, a buffer regrow, a new prune-bucket shape may all build once). Growth
under a key that has already been observed is a **steady-state
recompile** — the zero-recompile contract is broken, and the record says
exactly where. ``audited_steady_recompiles`` is the count a run's gate
holds at 0. The shape component must therefore carry every legitimate
shape determinant (capacities, eps, prune buckets); the engines build it
via ``DeltaEngine._audit_shape()``.

Everything here is host arithmetic over ``_cache_size()`` calls; the
auditor never dispatches and cannot itself perturb the caches it watches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable

MAX_RECORDS = 4096  # attribution log bound (drops oldest past this)


@dataclass
class AuditRecord:
    """One compile event: which executable appeared, and who triggered it."""

    seq: int                 # monotone event number
    tenant: str
    op: str                  # engine operation ("ingest", "query", ...)
    shape: tuple             # the op's shape signature (capacities, eps, ...)
    fn: str                  # provider entry whose cache grew
    growth: int              # executables added
    steady: bool             # key seen before => steady-state recompile

    def to_json(self) -> dict:
        return {"seq": self.seq, "tenant": self.tenant, "op": self.op,
                "shape": list(map(str, self.shape)), "fn": self.fn,
                "growth": self.growth, "steady": self.steady}


@dataclass
class RecompileAuditor:
    """Cache-growth watcher over registered providers."""

    _providers: list = field(default_factory=list)
    _sizes: dict = field(default_factory=dict)       # id(fn) -> last size
    _keys_seen: set = field(default_factory=set)     # (tenant, op, shape)
    records: list = field(default_factory=list)
    n_compiles: int = 0                # attributed executables, total
    n_steady_recompiles: int = 0       # compiles under an already-seen key
    _seq: int = 0

    # -- providers -----------------------------------------------------------
    def register_provider(self, provider: Callable[[], Iterable],
                          name: str | None = None) -> None:
        """``provider()`` yields the currently-live cache holders (lists
        may grow as new ones are made). ``name`` labels
        the provider in :meth:`providers_snapshot`; defaults to the
        provider's ``__name__``."""
        self._providers.append(
            (name or getattr(provider, "__name__", "provider"), provider))

    def _iter_fns(self):
        for _name, provider in self._providers:
            yield from provider()

    def providers_snapshot(self) -> dict[str, list[str]]:
        """Provider name -> sorted qualified (``module.name``) entry points
        it currently yields: an entry point absent from every list here is
        invisible to ``total_compile_count()``."""
        out: dict[str, list[str]] = {}
        for name, provider in self._providers:
            entries = set()
            for fn in provider():
                mod = getattr(fn, "__module__", "") or ""
                fn_name = getattr(fn, "__name__", "jit")
                entries.add(f"{mod}.{fn_name}" if mod else fn_name)
            out[name] = sorted(entries)
        return out

    # -- counting ------------------------------------------------------------
    def total_compile_count(self) -> int:
        """Sum of all registered caches: the process-global backstop that
        zero-recompile tests assert on. New code should prefer the
        attribution log."""
        return sum(fn._cache_size() for fn in self._iter_fns())

    def _scan(self) -> list[tuple[str, int]]:
        """Diff every cache against its last-seen size; returns the
        [(fn_name, growth)] list and absorbs the new sizes."""
        grown = []
        for fn in self._iter_fns():
            sz = fn._cache_size()
            prev = self._sizes.get(id(fn), 0)
            if sz > prev:
                grown.append((getattr(fn, "__name__", "jit"), sz - prev))
            self._sizes[id(fn)] = sz
        return grown

    def sync(self) -> None:
        """Absorb cache growth caused outside audited ops (benchmark
        baselines, test scaffolding) so it is not misattributed to the
        next ``record``. Call at the start of every audited op."""
        self._scan()

    def record(self, tenant: str, op: str, shape: tuple) -> bool:
        """Attribute growth since the last sync/record to (tenant, op,
        shape); returns True when anything compiled (the span layer's
        ``compiled`` tag, and the cold/warm latency split)."""
        grown = self._scan()
        key = (tenant, op, tuple(shape))
        steady = bool(grown) and key in self._keys_seen
        self._keys_seen.add(key)
        for fn_name, growth in grown:
            self._seq += 1
            self.records.append(AuditRecord(
                seq=self._seq, tenant=tenant, op=op, shape=tuple(shape),
                fn=fn_name, growth=growth, steady=steady))
            self.n_compiles += growth
            if steady:
                self.n_steady_recompiles += growth
        if len(self.records) > MAX_RECORDS:
            del self.records[: len(self.records) - MAX_RECORDS]
        return bool(grown)

    # -- reporting -----------------------------------------------------------
    @property
    def audited_steady_recompiles(self) -> int:
        return self.n_steady_recompiles

    def steady_records(self) -> list[AuditRecord]:
        return [r for r in self.records if r.steady]

    def snapshot(self, last: int = 64) -> dict:
        """JSON-ready audit summary: totals plus the most recent records
        (all steady records are always included — they are the alarms)."""
        recent = self.records[-int(last):]
        steady = [r for r in self.records if r.steady and r not in recent]
        return {
            "compile_count_total": self.total_compile_count(),
            "attributed_compiles": self.n_compiles,
            "audited_steady_recompiles": self.n_steady_recompiles,
            "records": [r.to_json() for r in steady + recent],
        }

    def reset(self) -> None:
        """Forget attribution state (keys, records, counters) but keep the
        providers and absorb current cache sizes as the new baseline."""
        self._keys_seen.clear()
        self.records.clear()
        self.n_compiles = 0
        self.n_steady_recompiles = 0
        self._scan()


# the process-default auditor the engines record into
AUDITOR = RecompileAuditor()


__all__ = ["AuditRecord", "RecompileAuditor", "AUDITOR", "MAX_RECORDS"]
