"""The port's DCN-v2 over a mesh against the JAX package on the CPU: the
serve kind at ``multi_hot`` 1 and 4, the retrieval kind and a train step
over (1, 1), (1, 2), (2, 1) and (2, 2) meshes, the tables' rows over
``"model"``, and ``build_step(mesh=)``'s meta.

The JAX side runs once, in one subprocess with 8 fabricated CPU devices
(``_torch_recsys_mesh_ranks.JAX_SCRIPT``): ``dcn_init``'s parameters at
``configs/dcn_v2.py:SMOKE``'s widths (1,000 table rows, 500 a rank over 2,
250 over 4), the reference's serve, retrieval and train programs of
``build_step`` jitted with its shardings on one device and at (2, 2)
(``impl="xla"``), ``jax.value_and_grad(dcn_loss)``, and the meta of the four
cells at 2 x 4 and 16 x 16. The port runs tests/_torch_recsys_mesh_ranks.py
over a mesh of one in this process and in 2 and 4 processes over a gloo
group, each spawn killed past ``SPAWN_TIMEOUT_S``. Tolerances are
tests/test_torch_recsys.py's (bags rtol 1e-5, atol 1e-6; logits and scores
rtol 1e-4, atol 1e-5) and tests/test_torch_train.py's (the loss rtol 1e-5;
the step's parameters and moments rtol 1e-5, atol 1e-6), gradients at the
step's tolerance; one-hot bags bitwise against one device's.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_recsys_mesh_ranks as ranks  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT_S = 120
JAX_TIMEOUT_S = 300
BAG_TOL = dict(rtol=1e-5, atol=1e-6)
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
SERVE_CASES = ("serve1/k0", "serve4/k0", "serve4/k1")


def run_jax(path: Path, part: str, timeout: float = JAX_TIMEOUT_S) -> None:
    """The JAX side's PART into ``path`` (tests/test_torch_dryrun.py runs
    its "hlo" part)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", ranks.JAX_SCRIPT, str(path), str(ROOT / "tests"),
                          part], env=env, capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}"


def start_ranks(world: int, tmp: Path, ref_path: Path, *mode: str) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    init = f"file://{tmp / 'rendezvous'}"
    procs = []
    for r in range(world):
        with open(tmp / f"rank{r}.log", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "_torch_recsys_mesh_ranks.py"), str(r),
                 str(world), init, str(ref_path), str(tmp / f"rank{r}.npz"), *mode], env=env,
                stdout=out, stderr=subprocess.STDOUT))
    return procs


def finish_ranks(world: int, procs: list, tmp: Path, deadline: float) -> list[dict]:
    """Each rank's answers; every rank killed once ``deadline`` has passed."""
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"{world} ranks did not finish in {SPAWN_TIMEOUT_S} s (a deadlocked "
                    "collective?)")
    for r, p in enumerate(procs):
        log = (tmp / f"rank{r}.log").read_text()
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{log}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory) -> dict:
    path = tmp_path_factory.mktemp("jax_recsys_mesh") / "ref.npz"
    run_jax(path, "ref")
    out = dict(np.load(path))
    out["meta"] = json.loads(Path(str(path) + ".json").read_text())
    return out


@pytest.fixture(scope="module")
def spawned(jax_ref, tmp_path_factory):
    """Worlds 2 and 4 started at once: ``{world: (procs, directory,
    deadline)}``; every rank killed at the module's end if it still runs."""
    arrays = {k: v for k, v in jax_ref.items() if isinstance(v, np.ndarray)}
    base = tmp_path_factory.mktemp("recsys_mesh_worlds")
    ref_path = base / "ref.npz"
    np.savez(ref_path, **arrays)
    out = {}
    for w in (2, 4):
        tmp = base / f"world{w}"
        tmp.mkdir()
        out[w] = (start_ranks(w, tmp, ref_path), tmp, time.monotonic() + SPAWN_TIMEOUT_S)
    yield out
    for procs, _, _ in out.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda w: f"world{w}")
def world(request, jax_ref, spawned) -> tuple[int, list[dict]]:
    if request.param == 1:
        from repro_torch.core.distributed import make_mesh

        arrays = {k: v for k, v in jax_ref.items() if isinstance(v, np.ndarray)}
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return 1, [ranks.scripted(make_mesh((1, 1), ranks.AXES, device="cpu"), arrays)]
        finally:
            torch.set_num_threads(n)
    procs, tmp, deadline = spawned[request.param]
    return request.param, finish_ranks(request.param, procs, tmp, deadline)


def port_names(flat: dict) -> dict:
    """JAX's leaves (``cross_w/0``, ``mlp/1/0``, ...) by the port's
    parameter names, each ``[in, out]`` matrix transposed."""
    out = {}
    for k, v in flat.items():
        parts = k.split("/")
        if parts[0] == "tables":
            out["tables"] = v
        elif parts[0] in ("cross_w", "cross_b"):
            out[f"cross.{parts[1]}.{'weight' if parts[0] == 'cross_w' else 'bias'}"] = \
                v.T if parts[0] == "cross_w" else v
        else:
            out[f"mlp.{parts[1]}.{'weight' if parts[2] == '0' else 'bias'}"] = \
                v.T if parts[2] == "0" else v
    return out


def _one_device_bags(jax_ref, hot: int) -> np.ndarray:
    from repro_torch.models import DCNConfig, dcn_params_from_jax, embedding_bag

    cfg = ranks.dcn_config(DCNConfig, multi_hot=hot, kernel=False)
    model = dcn_params_from_jax(ranks.unflatten(ranks.part(jax_ref, "p/")), cfg, "cpu")
    ids = torch.as_tensor(jax_ref[f"b/serve{hot}/sparse_ids"])
    with torch.no_grad():
        return embedding_bag(model.tables, ids, cfg).numpy()


@pytest.mark.parametrize("case", SERVE_CASES)
def test_serve_matches_jax(world, jax_ref, case):
    """Every rank's logits, its batch block gathered, equal the reference's
    on one device and at (2, 2) (NaN where a one-hot id is out of range);
    the kernel-on multi-hot case makes one K5 call a serve call on each rank,
    the others none."""
    w, answers = world
    hot = case.split("/")[0]
    for shape in ranks.MESHES[w]:
        base = f"{ranks.tag(shape)}/{case}"
        for r, ans in enumerate(answers):
            for ref in ("1x1", "2x2"):
                np.testing.assert_allclose(ans[f"{base}/logits"],
                                           jax_ref[f"j/{ref}/{hot}/logits"], **OUT_TOL,
                                           err_msg=f"{base} rank {r} vs JAX {ref}")
            assert int(ans[f"{base}/k5_calls"]) == int(case.endswith("k1")), (base, r)
    if case == "serve1/k0":
        assert np.isnan(jax_ref["j/1x1/serve1/logits"]).any()


@pytest.mark.parametrize("case", SERVE_CASES)
def test_bags_match_one_device(world, jax_ref, case):
    """The bags summed over "model" equal one device's: one-hot bitwise
    (wrapped ids, NaN for ids out of range, every boundary row), multi-hot
    within the bags' tolerance (ids on other ranks and invalid ids add
    nothing)."""
    w, answers = world
    hot = int(case[5])
    want = _one_device_bags(jax_ref, hot)
    for shape in ranks.MESHES[w]:
        base = f"{ranks.tag(shape)}/{case}"
        for r, ans in enumerate(answers):
            np.testing.assert_allclose(ans[f"{base}/bags"], want, **BAG_TOL,
                                       err_msg=f"{base} rank {r}")
            if hot == 1:
                assert bool(ans[f"{base}/bags_bitwise"]), (base, r)


def test_retrieval_matches_jax(world, jax_ref):
    """Every rank's [Q, C / n_dev] columns, gathered in rank order, equal
    the reference's scores; ``meta["rows"]`` rounds the candidates by
    ``max(512, n_dev)``."""
    w, answers = world
    for shape in ranks.MESHES[w]:
        base = f"{ranks.tag(shape)}/retr"
        for r, ans in enumerate(answers):
            for ref in ("1x1", "2x2"):
                np.testing.assert_allclose(ans[f"{base}/scores"], jax_ref[f"j/{ref}/retr/scores"],
                                           **OUT_TOL, err_msg=f"{base} rank {r} vs {ref}")
            assert int(ans[f"{base}/meta_rows"]) == 1_000_448


def test_train_step_matches_jax(world, jax_ref):
    """The train kind's loss (the global mean) equals jax.value_and_grad's
    on one device and the reference's sharded step's at (2, 2); its
    gradients, put back whole, equal JAX's (the tables' rows summed over the
    batch axes); one AdamW step's parameters and first moments equal the
    reference's sharded step's."""
    w, answers = world
    want_g = port_names(ranks.part(jax_ref, "j/1x1/train/g/"))
    for shape in ranks.MESHES[w]:
        base = f"{ranks.tag(shape)}/train"
        for r, ans in enumerate(answers):
            for key in ("loss", "loss2"):
                np.testing.assert_allclose(float(ans[f"{base}/{key}"]),
                                           float(jax_ref["j/1x1/train/loss"]), **LOSS_TOL)
                np.testing.assert_allclose(float(ans[f"{base}/{key}"]),
                                           float(jax_ref["j/2x2/train/loss2"]), **LOSS_TOL)
            assert set(want_g) == {k[len(f"{base}/g/"):] for k in ans if
                                   k.startswith(f"{base}/g/")}
            for k, v in want_g.items():
                np.testing.assert_allclose(ans[f"{base}/g/{k}"], v, **STEP_TOL,
                                           err_msg=f"{base} rank {r} gradient {k}")
            for what in ("new", "mu"):
                for ref in ("1x1", "2x2"):
                    want = port_names(ranks.part(jax_ref, f"j/{ref}/train/{what}/"))
                    for k, v in want.items():
                        np.testing.assert_allclose(ans[f"{base}/{what}/{k}"], v, **STEP_TOL,
                                                   err_msg=f"{base} rank {r} {what} {k} vs {ref}")


def test_train_traffic_by_kind(world, jax_ref):
    """The train kind's gradient makes one all-reduce of the bags over
    "model" (where it holds more than one rank) and one of the loss and
    every gradient over "data" (the same): their output bytes on each rank
    are counted by kind in ``collective.traffic``."""
    from repro_torch.models import DCNConfig, DCNv2

    cfg = ranks.dcn_config(DCNConfig)
    w, answers = world
    n_params = sum(p.numel() for p in DCNv2(cfg, device="meta").parameters())
    for shape in ranks.MESHES[w]:
        data, model = shape
        rows = ranks.TRAIN_B // data
        want = {"count": 0, "bytes": 0}
        if model > 1:
            want = {"count": 1, "bytes": 4 * rows * cfg.n_sparse * cfg.embed_dim}
        if data > 1:
            local = n_params - cfg.n_sparse * cfg.table_rows * cfg.embed_dim * (1 - 1 / model)
            want = {"count": want["count"] + 1, "bytes": want["bytes"] + 4 * int(1 + local)}
        for r, ans in enumerate(answers):
            got = json.loads(str(ans[f"{ranks.tag(shape)}/train/traffic"]))
            assert got == ({"all-reduce": want} if want["count"] else {}), (shape, r, got)


def test_build_step_meta_matches_the_reference(jax_ref):
    """``build_step(mesh=MeshLayout)``'s meta of the four cells at 2 x 4 and
    16 x 16 equals the reference's; ``mesh=None`` keeps one device's."""
    from repro_torch.launch import MeshLayout, build_step

    meta = jax_ref["meta"]
    assert "16x16/error" not in meta, meta.get("16x16/error")
    for layout in ((2, 4), (16, 16)):
        mesh = MeshLayout(layout, ranks.AXES)
        for shape in ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand"):
            want = meta[f"{ranks.tag(layout)}/{shape}"]
            step = build_step("dcn-v2", shape, mesh=mesh)
            assert set(step.meta) == set(want), shape
            for k, v in want.items():
                np.testing.assert_allclose(step.meta[k], v, rtol=1e-12, err_msg=f"{shape} {k}")
            assert step.specs["tables"] == (None, "model", None)
            assert all(s == () for k, s in step.specs.items() if k != "tables")
    one = build_step("dcn-v2", "retrieval_cand", device="cpu")
    assert one.meta["rows"] == 1_000_448 and one.mesh is None and one.specs is None


def test_mesh_steps_refuse():
    """A multi-hot train step with the kernel on still raises over a mesh
    (K5 has no backward); a serve step refuses a model built for another
    mesh, and a layout's step refuses to run."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.launch import MeshLayout
    from repro_torch.models import DCNConfig, DCNv2

    mesh = make_mesh((1, 1), ranks.AXES, device="cpu")
    with pytest.raises(NotImplementedError, match="no backward"):
        ranks.build(ranks.dcn_config(DCNConfig, multi_hot=4, kernel=True), "train_batch", mesh)
    cfg = ranks.dcn_config(DCNConfig, kernel=False)
    step = ranks.build(cfg, "serve_p99", mesh)
    batch = ranks.part(ranks.batches(), "serve1/")
    with pytest.raises(ValueError, match="holds its tables"):
        step.fn(DCNv2(cfg, device="cpu"), batch)
    layout = ranks.build(cfg, "serve_p99", MeshLayout((2, 4), ranks.AXES))
    with pytest.raises(ValueError, match="layout"):
        layout.fn(DCNv2(cfg, mesh=mesh), batch)
