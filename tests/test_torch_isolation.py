"""The port stands alone: nothing under src/repro_torch/ nor chip_smoke.py
imports JAX or the JAX package, and its entry points never fall back to the
CPU on their own."""
import ast
import functools
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
                and node.args and isinstance(node.args[0], ast.Constant)):
            mods.append(str(node.args[0].value))
    return mods


def test_port_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"chip_smoke.py", "src/repro_torch/core/pbahmani.py",
            "src/repro_torch/kernels/segsum.py", "src/repro_torch/kernels/compact.py",
            "src/repro_torch/kernels/build.py", "src/repro_torch/core/prune.py",
            "src/repro_torch/core/charikar.py", "src/repro_torch/core/exact.py",
            "src/repro_torch/refine/loads.py", "src/repro_torch/refine/engine.py",
            "src/repro_torch/refine/certify.py", "src/repro_torch/kernels/embed.py",
            "src/repro_torch/models/recsys.py", "src/repro_torch/models/convert.py",
            "src/repro_torch/configs/common.py", "src/repro_torch/configs/dcn_v2.py",
            "src/repro_torch/data/pipeline.py", "src/repro_torch/launch/steps.py",
            "src/repro_torch/utils/timing.py", "src/repro_torch/obs/__init__.py",
            "src/repro_torch/obs/metrics.py", "src/repro_torch/obs/trace.py",
            "src/repro_torch/obs/audit.py", "src/repro_torch/obs/export.py",
            "src/repro_torch/obs/slo.py", "src/repro_torch/obs/scrape.py",
            "src/repro_torch/obs/collector.py", "src/repro_torch/obs/otlp.py",
            "src/repro_torch/graphs/io.py", "src/repro_torch/stream/__init__.py",
            "src/repro_torch/stream/buffer.py", "src/repro_torch/stream/delta.py",
            "src/repro_torch/stream/fused.py", "src/repro_torch/stream/registry.py",
            "src/repro_torch/stream/service.py", "src/repro_torch/core/batched.py",
            "src/repro_torch/core/distributed.py", "src/repro_torch/graphs/partition.py",
            "src/repro_torch/core/collective.py", "src/repro_torch/analysis/framework.py",
            "src/repro_torch/analysis/cli.py", "src/repro_torch/models/layers.py",
            "src/repro_torch/models/moe.py", "src/repro_torch/models/moe_tp.py",
            "src/repro_torch/models/transformer.py", "src/repro_torch/launch/serve.py",
            "src/repro_torch/configs/qwen2_5_3b.py", "src/repro_torch/configs/mistral_nemo_12b.py",
            "src/repro_torch/configs/phi3_mini_3_8b.py", "src/repro_torch/configs/grok1_314b.py",
            "src/repro_torch/configs/deepseek_v3_671b.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nfrom repro.core import pbahmani\n"
                   "def f():\n    import jax.numpy as jnp\n"
                   "importlib.import_module('repro.graphs')\n")
    assert [m for m in _imported_modules(src) if m.split(".")[0] in FORBIDDEN] == [
        "repro.core", "jax.numpy", "repro.graphs"]


@pytest.mark.parametrize("entry", ["pbahmani", "kcore_decompose", "cbds_p",
                                   "pbahmani_pruned", "plan_for_graph", "refine",
                                   "dcn_init", "build_step", "DCNv2", "DeltaEngine",
                                   "FusedEngine", "GraphRegistry", "StreamService",
                                   "make_mesh", "pbahmani_distributed", "cbds_distributed",
                                   "gcn_init", "schnet_init", "egnn_init", "mace_init",
                                   "gnn_params_from_jax", "build_step_gnn",
                                   "init_params", "Transformer", "init_cache",
                                   "init_moe_params", "lm_params_from_jax", "build_step_lm",
                                   "serve_batch"])
def test_default_device_needs_cuda(monkeypatch, entry):
    """device=None means the GPU: with no CUDA it raises and names the way
    out, instead of running on the CPU."""
    import repro_torch.core as tcore
    import repro_torch.refine as trefine
    from repro_torch.configs import get_arch
    from repro_torch.graphs.generators import small_named
    from repro_torch.launch import build_step
    from repro_torch.launch import serve_batch
    from repro_torch.models import DCNv2, dcn_init, gnn_params_from_jax, lm_params_from_jax
    from repro_torch.models import gnn as tgnn
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer as tlm
    from repro_torch.stream import (
        DeltaEngine, FusedEngine, FusedPool, GraphRegistry, StreamService,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    qwen = get_arch("qwen2.5-3b").smoke
    calls = {"dcn_init": lambda: dcn_init(get_arch("dcn-v2").smoke),
             "build_step": lambda: build_step("dcn-v2", "serve_p99"),
             "DCNv2": lambda: DCNv2(get_arch("dcn-v2").smoke),
             "DeltaEngine": lambda: DeltaEngine(8),
             "FusedEngine": lambda: FusedEngine("t", FusedPool(), 8),
             "GraphRegistry": lambda: GraphRegistry(fused=True),
             "StreamService": lambda: StreamService(fused=True),
             "make_mesh": lambda: tcore.make_mesh(),
             "gnn_params_from_jax": lambda: gnn_params_from_jax({}, get_arch("gcn-cora").smoke),
             "build_step_gnn": lambda: build_step("gcn-cora", "full_graph_sm"),
             "init_params": lambda: tlm.init_params(qwen),
             "Transformer": lambda: tlm.Transformer(qwen),
             "init_cache": lambda: tlm.init_cache(qwen, 1, 4),
             "init_moe_params": lambda: tmoe.init_moe_params(get_arch("grok-1-314b").smoke.moe, 1),
             "lm_params_from_jax": lambda: lm_params_from_jax({}, qwen),
             "build_step_lm": lambda: build_step("qwen2.5-3b", "decode_32k"),
             "serve_batch": lambda: serve_batch(
                 tlm.Transformer(qwen, device="cpu"), qwen, [[1, 2]], 2),
             **{f"{name}_init": functools.partial(getattr(tgnn, f"{name}_init"),
                                                  get_arch(arch).smoke)
                for name, arch in (("gcn", "gcn-cora"), ("schnet", "schnet"),
                                   ("egnn", "egnn"), ("mace", "mace"))}}
    fn = calls.get(entry) or (lambda: (getattr(tcore, entry, None)
                                       or getattr(trefine, entry))(small_named("petersen")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn()
