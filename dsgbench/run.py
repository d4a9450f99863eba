"""The benchmark's entry point:

    python3 dsgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Prints the run's checks as the last lines of standard error and one
JSON object as the last line of standard output. Exits non-zero, printing
no result, without enough CUDA devices, without the program (``src/``)
beside it, or when a module of JAX or of the JAX package is loaded.
"""
import time

T_PROCESS = time.perf_counter()  # noqa: E402 -- set-up is counted from here

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the root, not this directory, on the path: the harness is the package
# ``dsgbench``, and its modules must not shadow others by their bare names
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from dsgbench.harness import emit, find_cell, load_benchmark, run_cell

    bench = load_benchmark()
    entry, _ = find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"the program under test (src/repro_torch) is not importable: {exc}",
              file=sys.stderr)
        return 3
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             "cuda", T_PROCESS, bench)
    emit(result, lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
