"""What the benchmark loads and where it runs: no module of JAX or of the
JAX package (top-level names compared whole: ``repro_torch`` is the program,
``repro`` is not), no file outside its own directory but the program, and
no result without a card or without the program."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "dsgbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PROBE = """
import json, sys, time
sys.path[0:0] = [{root!r}, {src!r}, {tests!r}]
from dsgbench import control, harness
from _dsgbench_small import run_small
for kind in ("e2e", "metrics"):
    for p in sorted((harness.HERE / kind).glob("*.py")):
        harness.load_reader(kind, p.stem)
for cell in ("g500s19-peel", "g500s19-cbds", "tenants-lane"):
    assert run_small(cell, seconds=0.1)[0]["correct"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_module_a_run_loads_is_jax_or_the_jax_package():
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), tests=str(HERE / "tests"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "dsgbench" in loaded
    assert not loaded & FORBIDDEN


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_source_of_the_benchmark_names_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, path
        if "tests" not in path.parts:   # the harness reads nothing of the JAX benchmarks
            assert '"benchmarks' not in path.read_text(), path


def test_the_reference_and_the_generators_import_nothing_of_the_program():
    for sub in ("reference", "gen"):
        for path in (HERE / sub).glob("*.py"):
            tops = {name.split(".")[0] for name in _imports(path)}
            assert "repro_torch" not in tops, path


def _run(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "dsgbench/run.py", "--workload", "g500s19-peel",
                           "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, env=env, cwd=cwd)


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_without_the_program_exits_non_zero_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "dsgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
def test_a_small_run_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import time

    from dsgbench.harness import run_cell

    result, lines = run_cell("g500s19-peel", 2**31 + 9, 1.0, False, "cuda", time.perf_counter(),
                             patch={"config": {"scale": 14}})
    assert result["correct"], lines
    assert result["device"]["platform"] == "gpu"
