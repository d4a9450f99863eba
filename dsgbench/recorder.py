"""What a segment of a run records: each answer's latency, the benchmark's
own spans around the program's calls, and the host ranges that label a
profiler trace."""
from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import record_function


class Recorder:
    """One segment's record. ``sync_spans`` ends each span with a device
    synchronisation, so the span covers the device work the call queued;
    ``annotate`` names each call as a ``dsgbench:<name>`` host range for the
    profiler. Neither is on in a measured window."""

    def __init__(self, device, sync_spans: bool = False, annotate: bool = False):
        self.device = device
        self.sync_spans = sync_spans
        self.annotate = annotate
        self.latencies_s: list[float] = []
        self.spans_s: dict[str, list[float]] = {}
        self.failed = 0

    @property
    def answers(self) -> int:
        return len(self.latencies_s)

    def answer(self, latency_s: float, ok: bool = True) -> None:
        self.latencies_s.append(latency_s)
        self.failed += not ok

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def call(self, name: str):
        """A span around one call into the program."""
        ctx = record_function(f"dsgbench:{name}") if self.annotate else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
            if self.sync_spans:
                self._sync()
        if self.sync_spans:
            self.spans_s.setdefault(name, []).append(time.perf_counter() - t0)


__all__ = ["Recorder"]
