"""The control: the plain reference put in the program's place and computed
in bfloat16, the precision below the configuration's float32, which a
sound check must refuse. Not part of the benchmark's own runs.

    python3 dsgbench/control.py --workload <cell> --seeds <n> [<n> ...] --seconds <s>

runs each seed as ``run.py`` would, at the cell's own size, with the
control answering in place of the program, and prints each run's compared
numbers (and ``correct``, which must come out false) as one JSON line.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

PRECISION = "bfloat16"


def _lanes(graph):
    return graph.src[:graph.n_directed], graph.dst[:graph.n_directed]


def control_pbahmani(graph, eps=0.0, kernel=None, device=None, **_):
    from dsgbench.reference.peel import pbahmani_ref

    density, mask, passes = pbahmani_ref(graph.n_nodes, *_lanes(graph), eps, PRECISION)
    return float(density), mask, passes


def control_cbds(graph, rounds=1, kernel=None, device=None, **_):
    from dsgbench.reference.cbds import cbds_ref

    return cbds_ref(graph.n_nodes, *_lanes(graph), rounds, PRECISION)


class ControlService:
    """``StreamService``'s surface that the tenant driver uses, answering
    every density query by a cold bfloat16 peel of the tenant's edge set."""

    def __init__(self, eps=0.0, **_):
        self.eps = float(eps)
        self.sets, self.pending, self.results, self.next_ticket = {}, [], {}, 0

    def create_tenant(self, name, n_nodes, **_):
        from dsgbench.reference.stream import EdgeSet

        self.sets[name] = EdgeSet(n_nodes)
        return _Response(True, None)

    def ingest_many(self, updates):
        for name, (insert, delete) in updates.items():
            self.sets[name].apply(insert, delete)
        return _Response(True, None)

    def submit_density(self, name):
        ticket, self.next_ticket = self.next_ticket, self.next_ticket + 1
        self.pending.append((ticket, name))
        return ticket

    def flush(self):
        for ticket, name in self.pending:
            density, _, passes = self.sets[name].cold_peel(self.eps, PRECISION)
            self.results[ticket] = _Response(True, {"density": float(density),
                                                    "passes": passes})
        n, self.pending = len(self.pending), []
        return n

    def poll(self, ticket):
        return self.results.pop(ticket, None)

    def shutdown(self):
        return self.flush()


class _Response:
    def __init__(self, ok, value):
        self.ok, self.value, self.error = ok, value, None


@contextlib.contextmanager
def installed():
    """The control in the program's place for the block: the entry points
    the drivers call (``pbahmani``, ``cbds_p``) and the tenant service."""
    import importlib

    targets = [(importlib.import_module("repro_torch.core.pbahmani"), "pbahmani",
                control_pbahmani),
               (importlib.import_module("repro_torch.core.cbds"), "cbds_p", control_cbds),
               (importlib.import_module("repro_torch.stream"), "StreamService", ControlService)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
    try:
        for mod, name, fn in targets:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from dsgbench.harness import run_cell

    for seed in args.seeds:
        with installed():
            result, lines = run_cell(args.workload, seed, args.seconds, False, args.device,
                                     time.perf_counter())
        for line in lines[1:]:
            print(line, file=sys.stderr)
        print(json.dumps({"workload": args.workload, "seed": seed, "precision": PRECISION,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
