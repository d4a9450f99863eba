"""The port's dry run against the JAX package's: ``launch/hlo_analysis.py``
(a copy) on HLO text that JAX compiles and on a hand-written text,
``make_production_mesh``'s layouts, ``dryrun.run_cell`` at 16 x 16 on the
meta device, and the dry mesh's collective traffic against a real gloo
world's.

The HLO comes from the JAX side of tests/test_torch_recsys_mesh.py (its
"hlo" part, a subprocess with 8 fabricated CPU devices): the reference's
DCN-v2 serve, retrieval and train programs jitted with its shardings at
(2, 2), ``jax.value_and_grad`` of its loss, and a ``lax.scan`` whose body
makes an all-reduce. The gloo world is two processes of
tests/_torch_recsys_mesh_ranks.py (``traffic`` mode), each killed past
``SPAWN_TIMEOUT_S``.
"""
import json
import math
import time
from dataclasses import replace
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import _torch_recsys_mesh_ranks as ranks  # noqa: E402
import test_torch_recsys_mesh as recsys_mesh  # noqa: E402

SPAWN_TIMEOUT_S = recsys_mesh.SPAWN_TIMEOUT_S

HAND_HLO = """HloModule hand, entry_computation_layout={(f32[8,4]{1,0})->f32[32,4]{1,0}}

%body (p: (s32[], f32[32,4])) -> (s32[], f32[32,4]) {
  %p = (s32[], f32[32,4]{1,0}) parameter(0)
  %x = f32[8,4]{1,0} constant({...})
  %ag-start = (f32[8,4]{1,0}, f32[32,4]{1,0}) all-gather-start(f32[8,4]{1,0} %x), replica_groups={{0,1,2,3}}, dimensions={0}
  %ag-done = f32[32,4]{1,0} all-gather-done((f32[8,4]{1,0}, f32[32,4]{1,0}) %ag-start)
  %ar-start = f32[32,4]{1,0} all-reduce-start(f32[32,4]{1,0} %ag-done), replica_groups={{0,1}}, to_apply=%add
  %ar-done = f32[32,4]{1,0} all-reduce-done(f32[32,4]{1,0} %ar-start)
  ROOT %t = (s32[], f32[32,4]{1,0}) tuple(s32[] %i, f32[32,4]{1,0} %ar-done)
}

%cond (p: (s32[], f32[32,4])) -> pred[] {
  %p = (s32[], f32[32,4]{1,0}) parameter(0)
  %n = s32[] constant(6)
  ROOT %lt = pred[] compare(s32[] %i, s32[] %n), direction=LT
}

ENTRY %main (a: f32[8,4]) -> f32[32,4] {
  %a = f32[8,4]{1,0} parameter(0)
  %cp = bf16[16,2]{1,0} collective-permute(bf16[16,2]{1,0} %b), source_target_pairs={{0,1}}
  %rs = s32[2]{0} reduce-scatter(s32[8]{0} %c), replica_groups={{0,1,2,3}}, dimensions={0}
  %a2a = (f32[4,4]{1,0}, f32[4,4]{1,0}) all-to-all(f32[4,4]{1,0} %d, f32[4,4]{1,0} %e), replica_groups={{0,1}}
  %w = (s32[], f32[32,4]{1,0}) while(%init), condition=%cond, body=%body
  ROOT %out = f32[32,4]{1,0} get-tuple-element((s32[], f32[32,4]{1,0}) %w), index=1
}
"""


@pytest.fixture(scope="module")
def hlo_texts(tmp_path_factory) -> dict:
    path = tmp_path_factory.mktemp("jax_hlo") / "hlo.npz"
    recsys_mesh.run_jax(path, "hlo")
    texts = json.loads(Path(str(path) + ".json").read_text())
    texts["hand"] = HAND_HLO
    return texts


def test_hlo_analysis_matches_the_reference(hlo_texts):
    """``collective_stats``, ``collective_stats_looped`` and ``count_op`` of
    the port's copy equal the reference's on every text; the scan's
    all-reduce counts once a trip when looped, and a -start/-done pair
    counts once."""
    from repro.launch import hlo_analysis as ref

    from repro_torch.launch import hlo_analysis as port

    assert len(hlo_texts) == 7
    for name, text in hlo_texts.items():
        assert port.collective_stats(text) == ref.collective_stats(text), name
        assert port.collective_stats_looped(text) == ref.collective_stats_looped(text), name
        for op in ("all-reduce", "all-gather-start", "fusion", "while", "dot"):
            assert port.count_op(text, op) == ref.count_op(text, op), (name, op)
    scan = port.collective_stats_looped(hlo_texts["2x2/scan"])
    assert scan["all-reduce"]["count"] == 5 * port.collective_stats(
        hlo_texts["2x2/scan"])["all-reduce"]["count"]
    hand = port.collective_stats_looped(HAND_HLO)
    assert hand["all-gather"] == {"count": 6, "bytes": 6 * (8 * 4 + 32 * 4) * 4}
    assert hand["all-reduce"] == {"count": 6, "bytes": 6 * 32 * 4 * 4}
    assert port.collective_stats(HAND_HLO)["all-to-all"] == {"count": 1, "bytes": 2 * 64}


def test_production_meshes_match_the_reference(monkeypatch):
    """``make_production_mesh`` gives the reference's shapes and axes (its
    code run with the mesh factory recording what it is asked for), and
    ``dp_axes`` / ``n_devices`` read them as the reference does."""
    from repro.launch import mesh as jmesh

    from repro_torch.launch import dp_axes, make_production_mesh, n_devices

    monkeypatch.setattr(jmesh, "make_mesh_auto", lambda shape, axes: (tuple(shape), tuple(axes)))
    for multi_pod in (False, True):
        layout = make_production_mesh(multi_pod=multi_pod)
        shape, axes = jmesh.make_production_mesh(multi_pod=multi_pod)
        assert (layout.sizes, layout.axis_names) == (shape, axes)
        fake = type("M", (), {"axis_names": axes, "shape": dict(zip(axes, shape))})()
        assert dp_axes(layout) == jmesh.dp_axes(fake)
        assert n_devices(layout) == jmesh.n_devices(fake) == (512 if multi_pod else 256)


def _local_bytes(shape, dtype, spec, layout) -> int:
    from repro_torch.models.shard import local_shape

    return math.prod(local_shape(shape, spec, layout)) * torch.empty((), dtype=dtype).element_size()


def _want_arg_bytes(arch: str, shape_name: str, step, layout) -> int:
    """The bytes of rank 0's inputs from the specs' local shapes: its
    parameter slices (twice more for AdamW's moments, and the step count,
    in a train step) and its block of the batch."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import _gnn_dims
    from repro_torch.models import DCNv2, GCN

    a = get_arch(arch)
    shape = a.shape(shape_name)
    every = tuple(layout.axis_names)
    f32, i32 = torch.float32, torch.int32
    if a.family == "recsys":
        cfg = a.full
        model = DCNv2(cfg, device="meta")
        specs = step.specs
        b = shape.dims["batch"]
        batch = [((b, cfg.n_dense), f32, ("data", None)),
                 ((b, cfg.n_sparse, cfg.multi_hot), i32, ("data", None, None))]
        if shape.kind == "train":
            batch.append(((b,), i32, ("data",)))
        if shape.kind == "retrieval":
            batch = [((b, cfg.n_dense), f32, ()), ((b, cfg.n_sparse, cfg.multi_hot), i32, ()),
                     ((step.meta["rows"], cfg.embed_dim), f32, (every, None))]
    else:
        n, e, _, feat = _gnn_dims(shape, 256)
        model = GCN(replace(a.full, d_feat=feat), device="meta")
        specs = {k: () for k, _ in model.named_parameters()}
        batch = [((e,), i32, (every,)), ((e,), i32, (every,)), ((n,), i32, (every,)),
                 ((n,), torch.bool, (every,)), ((n, feat), f32, (every, None)),
                 ((n,), i32, (every,)), ((n,), torch.bool, (every,))]
    params = sum(_local_bytes(p.shape, p.dtype, specs[k], layout)
                 for k, p in model.named_parameters())
    moments = 2 * params + 4 if shape.kind == "train" else 0
    return params + moments + sum(_local_bytes(s, d, sp, layout) for s, d, sp in batch)


@pytest.mark.parametrize("cell", ["dcn-v2:train_batch", "dcn-v2:serve_p99", "dcn-v2:serve_bulk",
                                  "dcn-v2:retrieval_cand", "gcn-cora:full_graph_sm"])
def test_run_cell_at_16x16(cell):
    """``run_cell`` at 16 x 16 on the meta device: ok, with the plain path,
    ``arg_bytes`` equal to the bytes of the specs' local shapes, the
    reference's meta, and the collectives counted."""
    from repro_torch.launch import build_step, make_production_mesh
    from repro_torch.launch.dryrun import run_cell

    arch, shape = cell.split(":")
    rec = run_cell(arch, shape, multi_pod=False, verbose=False)
    assert rec["ok"], rec.get("trace")
    layout = make_production_mesh()
    step = build_step(arch, shape, mesh=layout)
    assert rec["mesh"] == "16x16" and rec["devices"] == 256 and rec["kernel"] is False
    assert rec["arg_bytes"] == _want_arg_bytes(arch, shape, step, layout)
    assert rec["peak_bytes"] >= rec["arg_bytes"] and rec["out_bytes"] > 0
    assert rec["model_flops"] == step.meta["model_flops"]
    assert rec["meta"] == {k: v for k, v in step.meta.items() if k != "model_flops"}
    assert rec["collectives_looped"] == rec["collectives"]
    assert rec["collectives"]["all-reduce"]["count"] >= 1
    assert rec["flops"] > 0


def test_refused_cell_is_recorded():
    """A cell whose step raises is recorded as ``ok: false`` with its error,
    as the reference records a failure."""
    from repro_torch.launch.dryrun import run_cell

    rec = run_cell("dcn-v2", "no_such_shape", multi_pod=True, verbose=False)
    assert rec["ok"] is False and rec["mesh"] == "2x16x16" and "no_such_shape" in rec["error"]


def test_dry_traffic_equals_a_gloo_world(tmp_path):
    """The small DCN-v2 train step's gradient at (2, 1): the dry mesh's
    traffic on the meta device equals what each of two gloo ranks counted,
    kind by kind."""
    from repro_torch.launch import MeshLayout, dry_mesh

    procs = recsys_mesh.start_ranks(2, tmp_path, tmp_path / "unused.npz", "traffic")
    dry = ranks.train_traffic(dry_mesh(MeshLayout((2, 1), ranks.AXES)))
    answers = recsys_mesh.finish_ranks(2, procs, tmp_path, time.monotonic() + SPAWN_TIMEOUT_S)
    assert dry and set(dry) == {"all-reduce"}
    for r, ans in enumerate(answers):
        assert json.loads(str(ans["traffic"])) == dry, r
