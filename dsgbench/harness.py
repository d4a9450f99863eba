"""The benchmark's run: a cell of ``BENCHMARK.json`` found by name, its
configuration, traffic mix and metric readers found as files by name, one
measured window (``trace=0``: the cell's end-to-end metrics) or four traced
segments (``trace=1``: its per-layer metrics), and the check of every kept
answer against the plain reference once the program's state is gone.

Files found by name, under this directory:
  * ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives), its
    ``kind`` naming the generator under ``gen/``;
  * ``traffic/<traffic>.json``, its ``kind`` naming the driver
    (``drivers.DRIVERS``);
  * ``e2e/<metric>.py`` and ``metrics/<metric>.py``: each ``read(x)``
    returns the metric's value or None where it finds nothing to read.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from dsgbench import profiling
from dsgbench.drivers import DRIVERS
from dsgbench.recorder import Recorder
from dsgbench.roofline import card_line

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names, whole


@dataclass
class Window:
    answers: int
    seconds: float
    latencies_s: list
    setup_s: float
    marks: list = field(default_factory=list)
    cpu_s: float | None = None   # the process's CPU seconds in the window


@dataclass
class Observation:
    reading: profiling.TraceReading | None = None      # the card's activity alone
    labelled: profiling.TraceReading | None = None     # with the host's ops and ranges
    answers_profiled: int = 0       # in ``reading``'s segment
    answers_labelled: int = 0
    answers_synced: int = 0
    syncs: int | None = None
    spans_s: dict = field(default_factory=dict)
    counters_profiled: dict = field(default_factory=dict)
    k2_bytes: int | None = None


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> tuple[dict, dict]:
    """The workload entry named ``name`` and its configuration entry."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (there are {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if cell["config"] not in configs:
        raise KeyError(f"workload {name!r} names no configuration of BENCHMARK.json")
    return cell, configs[cell["config"]]


def metrics_of(entries: list, cell: str) -> list[dict]:
    """The metric entries a cell reports: those whose ``workloads`` list it,
    and those with no such list."""
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_reader(kind: str, name: str):
    """``<kind>/<name>.py`` under this directory, as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"dsgbench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_inputs(bench: dict, cell: str, patch: dict | None = None):
    """(workload entry, configuration, traffic) of ``cell``; ``patch`` may
    override keys of the configuration and the traffic (tests shrink them)."""
    patch = patch or {}
    entry, config = find_cell(bench, cell)
    cfg = json.loads((ROOT / config["file"]).read_text())
    traffic_path = HERE / "traffic" / f"{entry['traffic']}.json"
    if not traffic_path.is_file():
        raise FileNotFoundError(f"traffic {entry['traffic']!r} has no file "
                                f"{traffic_path.relative_to(ROOT)}")
    traffic = json.loads(traffic_path.read_text())
    cfg.update(patch.get("config", {}))
    traffic.update(patch.get("traffic", {}))
    if traffic["kind"] not in DRIVERS:
        raise KeyError(f"traffic kind {traffic['kind']!r} has no driver")
    return entry, cfg, traffic


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(driver, seconds: float, device, t_process: float) -> tuple[Window, Recorder]:
    """Whole cycles until ``seconds`` have passed; nothing else in the loop."""
    rec = Recorder(device)
    _sync(device)
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    marks = []   # (seconds into the window, answers) at each cycle's end
    while True:
        driver.cycle(rec)
        marks.append((time.perf_counter() - t0, rec.answers))
        if marks[-1][0] >= seconds or driver.exhausted():
            break
    t1 = time.perf_counter()
    return Window(rec.answers, t1 - t0, rec.latencies_s, setup_s, marks,
                  time.process_time() - cpu0), rec


def slice_rates(marks, width: float) -> list[float]:
    """Answers a second in consecutive slices of about ``width`` seconds,
    each ending at a cycle's end: how the rate moved within the window."""
    out, t_prev, n_prev = [], 0.0, 0
    for t, n in marks:
        if t - t_prev >= width:
            out.append((n - n_prev) / (t - t_prev))
            t_prev, n_prev = t, n
    return out


def observe(driver, cycles: int, device) -> tuple[Observation, list[Recorder]]:
    """Four traced segments of ``cycles`` cycles each: the benchmark's spans
    (each ended by a sync), the host syncs torch reports, the card's
    activity alone, and the card's activity with the host's ranges that
    label it (read for the breakdown only: recording the host's ops slows
    the host)."""
    obs = Observation(k2_bytes=driver.k2_bytes())
    spans = Recorder(device, sync_spans=True)
    for _ in range(cycles):
        driver.cycle(spans)
    obs.spans_s = spans.spans_s

    synced = Recorder(device)
    with profiling.counted_syncs(device) as held:
        for _ in range(cycles):
            driver.cycle(synced)
    obs.syncs, obs.answers_synced = held.syncs, synced.answers

    traced = Recorder(device)
    before = driver.counters()
    with profiling.profiled(device, labels=False) as held:
        for _ in range(cycles):
            driver.cycle(traced)
    after = driver.counters()
    obs.reading, obs.answers_profiled = held.reading, traced.answers
    obs.counters_profiled = {k: after[k] - before[k] for k in after}

    labelled = Recorder(device, annotate=True)
    with profiling.profiled(device, labels=True) as held:
        for _ in range(cycles):
            driver.cycle(labelled)
    obs.labelled, obs.answers_labelled = held.reading, labelled.answers
    return obs, [spans, synced, traced, labelled]


def idle_line(obs: Observation) -> str:
    """The idle share and host time an answer of both profiled segments:
    what recording the host's ops costs the reading."""
    out = []
    for what, r, n in (("the card alone", obs.reading, obs.answers_profiled),
                       ("with host ops", obs.labelled, obs.answers_labelled)):
        if r is not None and r.window_s > 0 and n:
            out.append(f"{what}: idle {100.0 * (1.0 - r.busy_s() / r.window_s)} %, "
                       f"{1e3 * r.window_s / n} ms an answer, "
                       f"{len(r.inside()) / n} launches an answer")
    return "profiled segments: " + ("; ".join(out) if out else "no device activity recorded")


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_process: float, bench: dict | None = None, patch: dict | None = None):
    """One run of ``cell``: ``(result, lines)``, the result line's object
    and the lines for standard error, the checks last."""
    bench = bench or load_benchmark()
    device = torch.device(device)
    entry, cfg, traffic = load_inputs(bench, cell, patch)
    kind = "metrics" if trace else "e2e"
    wanted = metrics_of(bench["per_layer"] if trace else bench["end_to_end"], cell)
    readers = {m["name"]: (load_reader(kind, m["name"]), m["unit"]) for m in wanted}

    driver = DRIVERS[traffic["kind"]](cfg, traffic, seed, device)
    t_setup = time.perf_counter()
    driver.setup()
    lines = [f"cell {cell}: {driver.describe()}; seed {seed}",
             f"set-up: process start to the driver {t_setup - t_process} s; "
             + "; ".join(f"{what} {s} s" for what, s in driver.setup_laps)]
    if trace:
        obs, recs = observe(driver, int(traffic["trace_cycles"]), device)
        values = {name: r.read(obs) for name, (r, _) in readers.items()}
        lines.append(idle_line(obs))
    else:
        window, rec = measure(driver, seconds, device, t_process)
        recs = [rec]
        values = {name: r.read(window) for name, (r, _) in readers.items()}
        if window.seconds < seconds:
            lines.append(f"the traffic's inputs ran out: the window ended at {window.seconds} s")
        lines.append(f"window {window.seconds} s, {window.answers} answers, "
                     f"set-up {window.setup_s} s; answers/s by 2 s slices "
                     f"{[round(r, 3) for r in slice_rates(window.marks, 2.0)]}")
        lines.append(f"the process's CPU time in the window {window.cpu_s} s")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    driver.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checked, notes = driver.checks()
    lines += notes
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules the benchmark must not load are loaded: {bad}")
    lines.append(f"reference check {time.perf_counter() - t_check} s: "
                 f"{ {k: v for k, v in checked.items() if k != 'wrong_answers'} }")
    card = card_line() if device.type == "cuda" else "not read"   # after the window
    lines.append(f"card {card}")

    attempted = sum(r.answers for r in recs)
    failed = sum(r.failed for r in recs)
    checks = {"wrong_answers": {"value": checked["wrong_answers"], "limit": 0},
              "answers_checked": {"value": checked["answers_checked"], "min": 1}}
    correct = (checked["wrong_answers"] <= 0 and checked["answers_checked"] >= 1
               and attempted > 0)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": {name: {"value": v, "unit": readers[name][1]}
                          for name, v in values.items() if v is not None},
              "device": dev}
    if trace and obs.reading is not None and obs.reading.window_s > 0:
        dev["busy_s"] = obs.reading.busy_s()
        dev["window_s"] = obs.reading.window_s
    if trace and obs.labelled is not None and obs.labelled.window is not None:
        result["breakdown"] = profiling.breakdown(obs.labelled)
    result["card"] = card
    result["checks"] = checks
    lines += [f"check {k}: {v['value']} (limit {v['limit']})" if "limit" in v
              else f"check {k}: {v['value']} (at least {v['min']})" for k, v in checks.items()]
    return result, lines


def emit(result: dict, lines: list[str]) -> None:
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


__all__ = ["run_cell", "emit", "load_benchmark", "find_cell", "metrics_of", "load_reader",
           "load_inputs", "measure", "observe", "forbidden_modules", "Window", "Observation"]
