"""The program's own spans inside its graph entry points, read for a cell:

    python3 dsgbench/entry_spans.py --workload <cell> --seed <n> [--turns 3] [--cycles k]

on a CUDA device (it refuses to run without one, as ``run.py`` does).

The port records, under ``repro_torch.obs.trace.capture()``, a root span a
call (``pbahmani``, ``cbds_p``), its passes, k-core levels and fixpoint
iterations, and a ``host_sync`` span at each wait for the card. This reads
them for a cell of ``BENCHMARK.json``, with the cell's traffic and set-up,
in segments of the traffic's ``trace_cycles`` cycles (or ``--cycles``):
  * ``--turns`` pairs of a plain and a captured segment: each answer's
    latency without and with the spans (what capture costs, and the
    garbage collector's time in each), and from the captured segments'
    records the three per-answer metrics whose readers
    are ``metrics/host_self_ms_per_answer.py``,
    ``metrics/sync_wait_ms_per_answer.py`` and
    ``metrics/program_syncs_per_answer.py`` (none is an entry of
    ``BENCHMARK.json``: its harness does not capture yet), with the host's
    self time also net of what capture costs;
  * one captured segment under torch's sync debug mode (on a card): the
    syncs torch reports, by source line, against the ``host_sync`` spans;
  * one captured segment profiled with the host's ranges: the idle time by
    the innermost span open at each gap, and the share of the idle time
    inside the call that falls under a span below the root.
Then every answer is checked against the plain reference. Prints
notes on standard error and one JSON object as the last line of standard
output. Where the program has no ``capture`` the span readings are null.
"""
from __future__ import annotations

import contextlib
import gc
import json
import statistics
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":   # as a script: the root and the program on the path
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from dsgbench.spans import ROOTS, answers, mean_of  # noqa: E402


def self_ms_by_name(records) -> dict[str, float]:
    """Each span name's self time (its duration less its children's), summed
    over ``records``, in milliseconds: where the host's time goes."""
    children: dict[int, float] = {}
    for r in records:
        if r.parent_id is not None:
            children[r.parent_id] = children.get(r.parent_id, 0.0) + r.duration_ms
    out: dict[str, float] = {}
    for r in records:
        out[r.name] = out.get(r.name, 0.0) + r.duration_ms - children.get(r.span_id, 0.0)
    return out


@contextlib.contextmanager
def captured(tracer=None):
    """``obs.trace.capture(tracer)`` for the block. Every record the tracer
    holds is set on the yielded holder's ``records`` once the block ends:
    None where the program has no ``capture``, or where the ring filled (its
    oldest records gone)."""
    from repro_torch.obs import trace

    holder = type("Holder", (), {"records": None})()
    capture = getattr(trace, "capture", None)
    if capture is None:
        yield holder
        return
    with capture(tracer) as t:
        yield holder
    records = t.ring()
    holder.records = records if len(records) < t.ring_size else None


@contextlib.contextmanager
def gc_seconds():
    """The garbage collector's time in the block, on the host's clock, and
    its full collections (of the oldest generation), set on the yielded
    holder's ``s`` and ``full``."""
    holder = type("Holder", (), {"s": 0.0, "full": 0, "t0": 0.0})()

    def timed(phase, info):
        if phase == "start":
            holder.t0 = time.perf_counter()
        else:
            holder.s += time.perf_counter() - holder.t0
            holder.full += info["generation"] == 2

    gc.callbacks.append(timed)
    try:
        yield holder
    finally:
        gc.callbacks.remove(timed)


@contextlib.contextmanager
def sync_sites(device):
    """The syncs torch reports in the block (``set_sync_debug_mode("warn")``),
    counted by the source line that made each; set on the yielded holder's
    ``sites`` (None off the card)."""
    import torch

    from dsgbench.profiling import SYNC_WARNING

    holder = type("Holder", (), {"sites": None})()
    if device.type != "cuda":
        yield holder
        return
    torch.cuda.synchronize(device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield holder
        finally:
            torch.cuda.set_sync_debug_mode("default")
    holder.sites = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                           if SYNC_WARNING in str(w.message))


def idle_inside_call(gaps: list, entry: str) -> dict:
    """The idle seconds inside the program's call, split into those under a
    span below the root and those under the root or the benchmark's own
    ``dsgbench:<entry>`` range (gaps outside the call are left out)."""
    own = {f"obs:{name}" for name in ROOTS} | {f"dsgbench:{entry}"}
    below = sum(s for name, s in gaps if name.startswith("obs:") and name not in own)
    at_call = sum(s for name, s in gaps if name in own)
    inside = below + at_call
    return {"below_root_s": below, "root_or_call_s": at_call,
            "below_root_pct": 100.0 * below / inside if inside else None}


def run(cell: str, seed: int, device, turns: int = 3, cycles: int | None = None,
        bench: dict | None = None, patch: dict | None = None) -> tuple[dict, list[str]]:
    """The readings of ``cell`` (see the module's docstring): ``(result,
    notes)``."""
    import torch

    from dsgbench import harness, profiling
    from dsgbench.drivers import DRIVERS
    from dsgbench.recorder import Recorder
    from dsgbench.roofline import card_line

    device = torch.device(device)
    bench = bench or harness.load_benchmark()
    entry, cfg, traffic = harness.load_inputs(bench, cell, patch)
    if traffic["kind"] != "closed_loop":
        raise ValueError(f"{cell} runs no graph entry point (traffic kind {traffic['kind']!r})")
    cycles = int(cycles or traffic["trace_cycles"])
    driver = DRIVERS[traffic["kind"]](cfg, traffic, seed, device)
    driver.setup()
    notes = [f"cell {cell}: {driver.describe()}; seed {seed}; {turns} turns of "
             f"{cycles} cycles"]

    def segment(rec):
        for _ in range(cycles):
            driver.cycle(rec)
        return rec

    from repro_torch.obs.trace import capture_tracer

    plain, timed = [], []
    gc_s, gc_full = {"plain": 0.0, "captured": 0.0}, {"plain": 0, "captured": 0}
    tracer = capture_tracer()   # one tracer: span ids unique over the turns
    for _ in range(turns):
        with gc_seconds() as gc_plain:
            plain.append(segment(Recorder(device)).latencies_s)
        with gc_seconds() as gc_captured, captured(tracer) as held:
            timed.append(segment(Recorder(device)).latencies_s)
        gc_s["plain"] += gc_plain.s
        gc_s["captured"] += gc_captured.s
        gc_full["plain"] += gc_plain.full
        gc_full["captured"] += gc_captured.full
    records = held.records
    with sync_sites(device) as synced, captured() as sync_spans:
        n_synced = segment(Recorder(device)).answers
    with captured(), profiling.profiled(device, labels=True) as prof:
        segment(Recorder(device, annotate=True))
    driver.free()
    checked, check_notes = driver.checks()
    notes += check_notes

    obs = type("Spans", (), {"spans": records})()
    metrics = {name: harness.load_reader("metrics", name).read(obs)
               for name in ("host_self_ms_per_answer", "sync_wait_ms_per_answer",
                            "program_syncs_per_answer")}
    program_syncs = (sum(n for _, _, n in answers(sync_spans.records)) / n_synced
                     if sync_spans.records is not None and n_synced else None)
    torch_syncs = (sum(synced.sites.values()) / n_synced
                   if synced.sites is not None and n_synced else None)
    gaps = profiling.breakdown(prof.reading, top=1000)["idle_gaps"] \
        if prof.reading is not None and prof.reading.window is not None else []

    def ms(xs):
        return 1e3 * statistics.median(xs) if xs else None

    flat_plain = [x for seg in plain for x in seg]
    flat_timed = [x for seg in timed for x in seg]
    # what capture adds to an answer: the captured turns' mean latency less
    # the plain turns'; the spans' own host time lands in the host's self time
    capture_ms = 1e3 * (statistics.fmean(flat_timed) - statistics.fmean(flat_plain))
    ratios = [statistics.fmean(c) / statistics.fmean(p) for p, c in zip(plain, timed)]
    host_self = metrics["host_self_ms_per_answer"]
    result = {
        "cell": cell, "seed": seed,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": card_line() if device.type == "cuda" else "not read",
        "answers_per_segment": len(timed[0]) if timed else 0,
        "latency_ms": {"plain_median": ms(flat_plain), "captured_median": ms(flat_timed),
                       "plain_mean": 1e3 * statistics.fmean(flat_plain),
                       "captured_mean": 1e3 * statistics.fmean(flat_timed),
                       "plain_turns": [ms(s) for s in plain],
                       "captured_turns": [ms(s) for s in timed]},
        "capture_ms_per_answer": capture_ms,
        "captured_over_plain_turns": (statistics.quantiles(ratios, n=4)
                                      if len(ratios) > 1 else ratios),
        "gc_ms_per_answer": {"plain": 1e3 * gc_s["plain"] / len(flat_plain),
                             "captured": 1e3 * gc_s["captured"] / len(flat_timed)},
        "gc_full_collections": gc_full,
        "metrics": metrics,
        "host_self_ms_net_of_capture": (None if host_self is None
                                        else host_self - capture_ms),
        "root_ms_per_answer": mean_of(obs, lambda total, sync, n: total),
        "self_ms_per_answer_by_span": (
            None if not records or not flat_timed else
            {k: v / len(flat_timed) for k, v in sorted(self_ms_by_name(records).items(),
                                                       key=lambda kv: -kv[1])}),
        "syncs_per_answer": {"torch": torch_syncs, "program": program_syncs},
        "torch_sync_sites": (None if synced.sites is None else
                             {k: v / n_synced for k, v in synced.sites.most_common(12)}),
        "idle_gaps": [[name, s] for name, s in gaps],
        "idle_inside_call": idle_inside_call(gaps, traffic["entry"]),
        "spans_per_answer": (len(records) / len(flat_timed)
                             if records is not None and flat_timed else None),
        "correct": checked["wrong_answers"] == 0 and checked["answers_checked"] >= 1,
        "checks": checked,
    }
    return result, notes


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--turns", type=int, default=3)
    p.add_argument("--cycles", type=int, default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device; this machine has none", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    result, notes = run(args.workload, args.seed, "cuda", args.turns, args.cycles)
    for line in notes + [f"took {time.perf_counter() - t0} s"]:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
