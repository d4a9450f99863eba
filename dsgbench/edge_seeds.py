"""The timed path held to the reference on other Graph500 edge draws.

The graph cells pin the edge draw (the configuration's ``graph_seed``), so
that every run peels one graph and does the same work, and the run's seed
only relabels the vertices. This runs a graph cell's own driver (the
window's calls, at the configuration's scale) on each of several edge
draws and prints for each one JSON line: the answers' fields and the
reference check. Not part of the benchmark's own runs.

    python3 dsgbench/edge_seeds.py --workload g500s19-peel --graph-seeds 1 2 3
"""
import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))


def check_edge_draw(cell: str, graph_seed: int, seed: int, cycles: int, device,
                    patch: dict | None = None) -> dict:
    """``cycles`` cycles of ``cell``'s driver on the edge draw ``graph_seed``,
    then the driver's own check: the distinct answers and the check's
    numbers, with ``correct`` as a run decides it."""
    import torch

    from dsgbench.drivers import DRIVERS, FIELD_NAMES
    from dsgbench.harness import load_benchmark, load_inputs
    from dsgbench.recorder import Recorder

    patch = dict(patch or {})
    patch["config"] = dict(patch.get("config", {}), graph_seed=graph_seed)
    device = torch.device(device)
    _, cfg, traffic = load_inputs(load_benchmark(), cell, patch)
    if traffic["kind"] != "closed_loop":
        raise ValueError(f"{cell} is not a graph cell")
    driver = DRIVERS[traffic["kind"]](cfg, traffic, seed, device)
    driver.setup()
    rec = Recorder(device)
    for _ in range(cycles):
        driver.cycle(rec)
    answers = {json.dumps(driver.calls[i]): dict(zip(FIELD_NAMES[traffic["entry"]], fields))
               for i, fields in driver.kept}
    graph = driver.describe()
    driver.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checked, notes = driver.checks()
    return {"workload": cell, "graph_seed": graph_seed, "seed": seed, "graph": graph,
            "answers": answers, "checks": checked, "notes": notes,
            "correct": checked["wrong_answers"] == 0 and checked["answers_checked"] >= 1}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--graph-seeds", type=int, nargs="+", required=True)
    p.add_argument("--seed", type=int, default=2**31 + 11)
    p.add_argument("--cycles", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for g in args.graph_seeds:
        print(json.dumps(check_edge_draw(args.workload, g, args.seed, args.cycles,
                                         args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
