"""The port's sub-axis meshes against the JAX package on the CPU: the four
collectives, ``moe_ep`` and ``moe_tp`` over a mesh, and ``vp_segment_sum``.

The JAX side runs once, in one subprocess with 4 fabricated CPU devices
(the main process keeps its one device), and writes its inputs and its
sharded outputs and gradients to a file. The port runs tests/_torch_mesh_ranks.py
over a mesh of one in this process, and in 2 and 4 processes, one a rank,
over a gloo group, each spawn killed past ``SPAWN_TIMEOUT_S``. The ranks'
blocks are put together here and held against JAX's sharded outputs
(rtol = atol = 3e-4 for the MoE layers, 1e-5 for ``vp_segment_sum``), the
dense oracle, and the port's own unsharded gradients: a weight held alike by
the ranks that split the tokens has its gradient summed over them, as the
train step's data-parallel sum does (``core/collective.py``'s rule).
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as ranks  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT_S = 120  # a whole world's spawn; killed past it
JAX_TIMEOUT_S = 300
MOE_TOL = dict(rtol=3e-4, atol=3e-4)
VP_TOL = dict(rtol=1e-5, atol=1e-5)
SUM_TOL = dict(rtol=1e-6, atol=1e-6)   # float32 sums of up to 4 N(0, 1) terms in gloo's order

JAX_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, sys.argv[2])
import _torch_mesh_ranks as ranks
from repro.utils.compat import make_mesh_auto
from repro.models.moe import MoEConfig, init_moe_params, moe_dense, moe_ep
from repro.models.moe_tp import moe_tp
from repro.kernels import ops as kops
from repro.graphs.generators import erdos_renyi
from repro.graphs.partition import partition_by_dst_block

out = {}
x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 16))
w = np.random.default_rng(2).normal(size=(4, 8, 16)).astype(np.float32)
out["x"], out["w"] = np.asarray(x), w
for name in ("ep", "tp"):
    cfg = ranks.moe_cfg(name, MoEConfig)
    fn = moe_ep if name == "ep" else moe_tp
    p = jax.tree.map(lambda a: a[0], init_moe_params(jax.random.PRNGKey(0), cfg, 1))
    out.update({f"{name}/p/{k}": np.asarray(v) for k, v in p.items()})
    y, aux = moe_dense(x, p, cfg)
    out[f"{name}/dense/y"], out[f"{name}/dense/aux"] = np.asarray(y), np.asarray(aux)
    meshes = [None] + [make_mesh_auto(s, ranks.AXES) for s in ranks.MOE_MESHES]
    for mesh in meshes:
        for sp in ((False, True) if name == "ep" and mesh is not None else (False,)):
            f = lambda x, p: fn(x, p, cfg, mesh=mesh, sp=sp)
            y, aux = jax.jit(f)(x, p)
            gx, gp = jax.jit(jax.grad(lambda x, p: (f(x, p)[0] * w).sum(),
                                      argnums=(0, 1)))(x, p)
            key = "single" if mesh is None else ranks.tag(mesh.devices.shape)
            base = f"{name}/{key}/sp{int(sp)}"
            out[base + "/y"], out[base + "/aux"] = np.asarray(y), np.asarray(aux)
            out[base + "/g/x"] = np.asarray(gx)
            out.update({f"{base}/g/{k}": np.asarray(v) for k, v in gp.items()})

n = ranks.VP_N
g = erdos_renyi(n, 0.05, seed=3)
h = np.random.default_rng(0).normal(size=(n, ranks.VP_D)).astype(np.float32)
out["vp/w"] = np.random.default_rng(4).normal(size=(n, ranks.VP_D)).astype(np.float32)
for world in ranks.MESHES.values():
    for shape in world:
        blocks, sub = shape
        src, dst, _ = partition_by_dst_block(g, blocks)
        bounds = np.searchsorted(dst, np.arange(0, n + 1, n // blocks))
        per = int(np.ceil(max(np.diff(bounds)) / sub) * sub)
        src_p = np.full(per * blocks, n, np.int32)
        dst_p = np.full(per * blocks, n, np.int32)
        for b in range(blocks):
            lo, hi = bounds[b], bounds[b + 1]
            src_p[b * per:b * per + hi - lo] = src[lo:hi]
            dst_p[b * per:b * per + hi - lo] = dst[lo:hi]
        vals = np.where((src_p < n)[:, None], h[np.minimum(src_p, n - 1)], 0.0)
        vals = vals.astype(np.float32)
        mesh = make_mesh_auto(shape, ranks.AXES)

        def run(v, ids):
            with kops.segment_output_sharding(mesh, ("data",), min_segments=1):
                return kops.vp_segment_sum(v, ids, n)

        run = jax.jit(run)
        key = f"vp/{ranks.tag(shape)}"
        out[key + "/ids"], out[key + "/vals"] = dst_p, vals
        out[key + "/out"] = np.asarray(run(jnp.asarray(vals), jnp.asarray(dst_p)))
        out[key + "/grad"] = np.asarray(jax.jit(jax.grad(
            lambda v: (run(v, jnp.asarray(dst_p)) * out["vp/w"]).sum()))(jnp.asarray(vals)))
np.savez(sys.argv[1], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory) -> dict:
    """Inputs, sharded outputs and gradients of the JAX package (4 fabricated
    devices, one subprocess)."""
    path = tmp_path_factory.mktemp("jax_mesh") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(path), str(ROOT / "tests")],
                         env=env, capture_output=True, text=True, timeout=JAX_TIMEOUT_S)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}"
    return dict(np.load(path))


def _spawn(world: int, tmp: Path, ref_path: Path) -> list[dict]:
    """The ranks of ``world`` over a gloo group (file rendezvous in ``tmp``),
    all killed once ``SPAWN_TIMEOUT_S`` has passed since the spawn; each
    rank's output goes to a file."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    init = f"file://{tmp / 'rendezvous'}"
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "_torch_mesh_ranks.py"), str(r),
                 str(world), init, str(ref_path), str(tmp / f"rank{r}.npz")], env=env,
                stdout=out, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
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
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{logs[r].read_text()}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda w: f"world{w}")
def world(request, jax_ref, tmp_path_factory) -> tuple[int, list[dict]]:
    """(world size, each rank's answers) for every mesh of that world."""
    if request.param == 1:
        from repro_torch.core.distributed import make_mesh

        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return 1, [ranks.scripted(make_mesh((1, 1), ranks.AXES, device="cpu"), jax_ref)]
        finally:
            torch.set_num_threads(n)
    tmp = tmp_path_factory.mktemp(f"mesh_world{request.param}")
    ref_path = tmp / "ref.npz"
    np.savez(ref_path, **jax_ref)
    return request.param, _spawn(request.param, tmp, ref_path)


def _coords(shape, rank: int) -> tuple[int, int]:
    return rank // shape[1], rank % shape[1]


def _meshes(world: int):
    return ranks.MESHES[world]


# ---------------------------------------------------------------------------
# the collectives alone
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("label", sorted(ranks.COLL_AXES))
def test_collective_values_and_counts(world, label):
    """all_reduce_sum, all_reduce_max, all_gather and all_to_all over every
    axis set equal their numpy closed forms on every rank; each call counts
    one collective, a world of one too."""
    w, answers = world
    for shape in _meshes(w):
        key = f"{ranks.tag(shape)}/coll/{label}"
        for r, ans in enumerate(answers):
            want = ranks.expected_collectives(shape, r, label)
            np.testing.assert_allclose(ans[f"{key}/sum"], want["sum"], **SUM_TOL)
            for kind in ("max", "gather", "a2a", "sum_grad"):
                np.testing.assert_array_equal(ans[f"{key}/{kind}"], want[kind])
            for kind in ("sum", "max", "gather", "a2a"):
                assert int(ans[f"{key}/{kind}/calls"]) == 1, (shape, r, kind)
            assert int(ans[f"{key}/sum_grad/calls"]) == 0


@pytest.mark.parametrize("label", sorted(ranks.COLL_AXES))
def test_collective_backward(world, label):
    """The backward rules: all_reduce_sum the identity (no collective),
    all_gather the summed cotangents' own slice, all_to_all the same
    all-to-all, sum_grad the summed cotangent (one collective each)."""
    w, answers = world
    for shape in _meshes(w):
        key = f"{ranks.tag(shape)}/coll/{label}"
        for r, ans in enumerate(answers):
            want = ranks.expected_collectives(shape, r, label)
            np.testing.assert_array_equal(ans[f"{key}/sum/grad"], want["sum/grad"])
            np.testing.assert_array_equal(ans[f"{key}/a2a/grad"], want["a2a/grad"])
            for kind in ("gather", "sum_grad"):
                np.testing.assert_allclose(ans[f"{key}/{kind}/grad"], want[f"{kind}/grad"],
                                           **SUM_TOL)
            assert int(ans[f"{key}/sum/grad_calls"]) == 0
            for kind in ("gather", "a2a", "sum_grad"):
                assert int(ans[f"{key}/{kind}/grad_calls"]) == 1, (shape, r, kind)


def test_sub_axis_groups():
    """make_mesh's slices: the "model" ranks {0, 1} and {2, 3} and the
    "data" ranks {0, 2} and {1, 3} of a (2, 2) mesh, nothing for an axis of
    one rank or the whole mesh, in one fixed order."""
    from repro_torch.core.collective import slices

    assert list(slices((2, 2), ranks.AXES)) == [
        (("data",), [[0, 2], [1, 3]]), (("model",), [[0, 1], [2, 3]])]
    assert list(slices((4, 1), ranks.AXES)) == []
    assert list(slices((2, 3, 2), ("a", "b", "c")))[3] == (
        ("a", "b"), [[0, 2, 4, 6, 8, 10], [1, 3, 5, 7, 9, 11]])


def test_world_of_one_meshes_compare_equal():
    """Two meshes over the same group, layout and device are equal (the
    fused buckets key on it), and a world of one's collectives return
    their input."""
    from repro_torch.core import collective
    from repro_torch.core.distributed import make_mesh

    a = make_mesh((1, 1), ranks.AXES, device="cpu")
    assert a == make_mesh((1, 1), ranks.AXES, device="cpu")
    t = torch.ones(3)
    before = collective.collectives
    for fn in (collective.all_reduce_sum, collective.all_gather, collective.all_reduce_max):
        assert fn(t, a, "model") is t
    assert collective.all_to_all(t[:1], a) is not None
    assert collective.collectives - before == 4
    assert collective.all_reduce_sum(t, None) is t


# ---------------------------------------------------------------------------
# moe_ep and moe_tp over a mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tk, model_size, cf, want", [
    (16384, 2, 1.25, 10240), (10, 1, 1.0, 16), (3, 4, 1.0, 8), (64, 4, 1.0, 16)])
def test_moe_capacity(tk, model_size, cf, want):
    """A peer's capacity: round(tk / model_size * cf) up to a multiple of 8,
    at least 8 (the reference's moe_ep)."""
    from repro_torch.models.moe import capacity

    assert capacity(tk, model_size, cf) == want


def _assemble(answers, shape, key: str, sp: bool) -> np.ndarray:
    """The [B, S, D] output from the ranks' blocks (rank (d, 0) for each data
    block without sp: the "model" ranks hold the same tokens)."""
    rows = []
    for d in range(shape[0]):
        if sp:
            rows.append(np.concatenate([answers[d * shape[1] + m][key]
                                        for m in range(shape[1])], axis=1))
        else:
            rows.append(answers[d * shape[1]][key])
    return np.concatenate(rows, axis=0)


def _moe_shape(w: int) -> tuple[int, int]:
    """The world's one mesh that runs the MoE cases."""
    (shape,) = [s for s in _meshes(w) if s in ranks.MOE_MESHES]
    return shape


MOE_CASES = pytest.mark.parametrize("case", ranks.moe_cases(),
                                    ids=lambda c: f"{c[0]}-sp{int(c[2])}")


@pytest.fixture(scope="module")
def unsharded(jax_ref) -> dict:
    """The port's own unsharded outputs and gradients (mesh=None), and the
    gradient of the mean of each token block's ``aux`` for every split."""
    from repro_torch.models import moe_dense, moe_ep, moe_params_from_jax, moe_tp
    from repro_torch.models.moe import MoEConfig

    out = {}
    for name, layout in (("ep", "ep"), ("tp", "tp")):
        cfg = ranks.moe_cfg(name, MoEConfig)
        tree = {k.split("/")[-1]: v for k, v in jax_ref.items() if k.startswith(f"{name}/p/")}
        p = moe_params_from_jax(tree, cfg, device="cpu")
        for v in p.values():
            v.requires_grad_(True)
        x = torch.from_numpy(jax_ref["x"]).requires_grad_(True)
        fn = moe_ep if layout == "ep" else moe_tp
        y, aux = fn(x, p, cfg)
        names = sorted(p)
        grads = torch.autograd.grad((y * torch.from_numpy(jax_ref["w"])).sum(),
                                    [x] + [p[k] for k in names])
        out[name] = dict(y=y.detach().numpy(), aux=float(aux.detach()),
                         dense=moe_dense(x, p, cfg)[0].detach().numpy(),
                         g={k: g.numpy() for k, g in zip(["x"] + names, grads)})
        for shape in ranks.MOE_MESHES:
            for sp in (False, True):
                blocks = [ranks.token_block(jax_ref["x"], shape, c, sp)
                          for c in np.ndindex(*shape)]
                if not sp:
                    blocks = blocks[::shape[1]]
                auxes = [fn(torch.from_numpy(b.copy()), p, cfg)[1] for b in blocks]
                mean = sum(auxes) / len(auxes)
                g = torch.autograd.grad(mean, p["router"])[0]
                out[f"{name}/{ranks.tag(shape)}/sp{int(sp)}/g_aux"] = g.numpy()
                out[f"{name}/{ranks.tag(shape)}/sp{int(sp)}/aux"] = float(mean.detach())
                out[f"{name}/{ranks.tag(shape)}/sp{int(sp)}/block"] = blocks[0].shape[0] * \
                    blocks[0].shape[1]
    return out


@MOE_CASES
def test_moe_matches_jax_sharded(world, jax_ref, unsharded, case):
    """moe_ep (sp both ways) and moe_tp over each mesh of the world: the
    ranks' blocks put together equal JAX's sharded output and the port's
    dense oracle at rtol = atol = 3e-4, the ranks along "model" that hold
    the same tokens agree bit for bit. aux equals JAX's and the mean of the
    token blocks' own aux (rtol 1e-5), and the dense oracle's at rtol 0.2
    for blocks of 16 tokens or more, as tests/test_distributed.py holds it
    (8-token blocks, with sp on (2, 2), depart further, in JAX as here)."""
    w, answers = world
    shape, (name, _, sp) = _moe_shape(w), case
    key = f"{ranks.tag(shape)}/{name}/sp{int(sp)}"
    y = _assemble(answers, shape, f"{key}/y", sp)
    np.testing.assert_allclose(y, jax_ref[f"{name}/{ranks.tag(shape)}/sp{int(sp)}/y"],
                               **MOE_TOL)
    np.testing.assert_allclose(y, unsharded[name]["dense"], **MOE_TOL)
    np.testing.assert_allclose(y, jax_ref[f"{name}/dense/y"], **MOE_TOL)
    if not sp:
        for r, ans in enumerate(answers):
            np.testing.assert_array_equal(ans[f"{key}/y"],
                                          answers[r - r % shape[1]][f"{key}/y"])
    want_aux = float(jax_ref[f"{name}/{ranks.tag(shape)}/sp{int(sp)}/aux"])
    split = f"{name}/{ranks.tag(shape)}/sp{int(sp)}"
    for ans in answers:
        np.testing.assert_allclose(float(ans[f"{key}/aux"]), want_aux, rtol=1e-5)
        np.testing.assert_allclose(float(ans[f"{key}/aux"]), unsharded[f"{split}/aux"],
                                   rtol=1e-5)
        if unsharded[f"{split}/block"] >= 16:  # tests/test_distributed.py's 16-token blocks
            np.testing.assert_allclose(float(ans[f"{key}/aux"]),
                                       float(jax_ref[f"{name}/dense/aux"]), rtol=0.2)


@MOE_CASES
def test_moe_gradients_match_unsharded(world, jax_ref, unsharded, case):
    """The ranks' gradients equal the port's unsharded ones (and JAX's
    sharded ones, which equal JAX's unsharded): x by block, the expert
    shards put together, every weight summed over the data axis (over
    "model" too with sp), the aux gradient of the router against the mean of
    the token blocks' aux."""
    w, answers = world
    shape, (name, layout, sp) = _moe_shape(w), case
    key = f"{ranks.tag(shape)}/{name}/sp{int(sp)}"
    want, jax_g = unsharded[name]["g"], f"{name}/{ranks.tag(shape)}/sp{int(sp)}/g"
    gx = _assemble(answers, shape, f"{key}/g/x", sp)
    np.testing.assert_allclose(gx, want["x"], **MOE_TOL)
    np.testing.assert_allclose(gx, jax_ref[f"{jax_g}/x"], **MOE_TOL)
    split = {"ep": {"wg": 0, "wi": 0, "wo": 0}, "tp": {"wg": 2, "wi": 2, "wo": 1}}[layout]
    for k in want:
        if k == "x":
            continue
        per = {}
        for r, ans in enumerate(answers):
            c = _coords(shape, r)
            if not sp and k not in split and c[1]:
                continue  # whole on every "model" rank: count it once
            part = c[1] if k in split else 0
            per[part] = per.get(part, 0) + ans[f"{key}/g/{k}"]
        got = (np.concatenate([per[i] for i in sorted(per)], axis=split[k])
               if k in split else per[0])
        np.testing.assert_allclose(got, want[k], **MOE_TOL, err_msg=k)
        np.testing.assert_allclose(got, jax_ref[f"{jax_g}/{k}"], **MOE_TOL, err_msg=k)
    g_aux = sum(ans[f"{key}/g_aux/router"] for r, ans in enumerate(answers)
                if sp or _coords(shape, r)[1] == 0)
    np.testing.assert_allclose(g_aux, unsharded[f"{name}/{ranks.tag(shape)}/sp{int(sp)}/g_aux"],
                               rtol=1e-4, atol=1e-6)


@MOE_CASES
def test_moe_collective_counts(world, case):
    """moe_ep over "model" of two ranks or more: three all-to-alls forward
    (the replicas, their expert ids, the outputs back) and two backward;
    moe_tp: one sum over "model" forward and one backward (``sum_grad``);
    aux one sum over the axes that split the tokens, where they are more
    than one rank."""
    w, answers = world
    shape, (name, _, sp) = _moe_shape(w), case
    key = f"{ranks.tag(shape)}/{name}/sp{int(sp)}"
    token_ranks = shape[0] * (shape[1] if sp and name == "ep" else 1)
    for ans in answers:
        fwd = {k.split("/fwd/")[1]: int(v) for k, v in ans.items() if k.startswith(key + "/fwd/")}
        bwd = {k.split("/bwd/")[1]: int(v) for k, v in ans.items() if k.startswith(key + "/bwd/")}
        aux_axes = "data+model" if sp and name == "ep" else "data"
        want_fwd = {f"all_reduce_sum/{aux_axes}": 1} if token_ranks > 1 else {}
        if name == "ep":
            want_fwd.update({"all_to_all/model": 3} if shape[1] > 1 else {})
            want_bwd = {"all_to_all/model": 2} if shape[1] > 1 else {}
        else:
            want_fwd["all_reduce_sum/model"] = want_fwd.get("all_reduce_sum/model", 0) + 1
            want_bwd = {"all_reduce_sum/model": 1}
        assert fwd == want_fwd, (shape, name, sp, fwd)
        assert bwd == want_bwd, (shape, name, sp, bwd)


# ---------------------------------------------------------------------------
# vp_segment_sum
# ---------------------------------------------------------------------------
def _vp_gather(answers, shape, key: str) -> np.ndarray:
    """The [N, D] output from the node blocks (rank (d, 0) for block d)."""
    return np.concatenate([answers[d * shape[1]][key] for d in range(shape[0])])


@pytest.mark.parametrize("kernel", [0, 1], ids=["plain", "k1"])
def test_vp_segment_sum_matches_jax(world, jax_ref, kernel):
    """Each mesh's node blocks put together equal JAX's ``vp_segment_sum``
    and the unsharded segment sum at rtol = atol = 1e-5; the ranks of one
    block agree bit for bit; one sum over the sub-axes where they hold more
    than one rank, none in the backward."""
    from repro_torch.kernels.ref import segment_sum_ref

    w, answers = world
    for shape in _meshes(w):
        key = f"{ranks.tag(shape)}/vp/k{kernel}"
        out = _vp_gather(answers, shape, f"{key}/out")
        ref = f"vp/{ranks.tag(shape)}"
        np.testing.assert_allclose(out, jax_ref[f"{ref}/out"], **VP_TOL)
        want = segment_sum_ref(torch.from_numpy(jax_ref[f"{ref}/vals"]),
                               torch.from_numpy(jax_ref[f"{ref}/ids"]), ranks.VP_N).numpy()
        np.testing.assert_allclose(out, want, **VP_TOL)
        for r, ans in enumerate(answers):
            np.testing.assert_array_equal(ans[f"{key}/out"],
                                          answers[r - r % shape[1]][f"{key}/out"])
            assert int(ans[f"{key}/calls"]) == (1 if shape[1] > 1 else 0)
            assert int(ans[f"{key}/grad_calls"]) == 0


@pytest.mark.parametrize("kernel", [0, 1], ids=["plain", "k1"])
def test_vp_segment_sum_gradient(world, jax_ref, kernel):
    """The ranks' gradients of their lanes put together equal JAX's and the
    unsharded sum's gradient (each lane its row's cotangent, padding lanes
    zero)."""
    from repro_torch.kernels.ref import segment_sum_ref

    w, answers = world
    for shape in _meshes(w):
        ref = f"vp/{ranks.tag(shape)}"
        got = np.concatenate([ans[f"{ranks.tag(shape)}/vp/k{kernel}/grad"] for ans in answers])
        np.testing.assert_allclose(got, jax_ref[f"{ref}/grad"], **VP_TOL)
        vals = torch.from_numpy(jax_ref[f"{ref}/vals"]).requires_grad_(True)
        out = segment_sum_ref(vals, torch.from_numpy(jax_ref[f"{ref}/ids"]), ranks.VP_N)
        (want,) = torch.autograd.grad((out * torch.from_numpy(jax_ref["vp/w"])).sum(), vals)
        np.testing.assert_allclose(got, want.numpy(), **VP_TOL)


def test_vp_segment_sum_unsorted_and_flat(world):
    """Lanes that do not ascend are sorted (one fallback a call on every
    rank) and give the sorted lanes' sums; 1-D values give the first column."""
    w, answers = world
    for shape in _meshes(w):
        key = f"{ranks.tag(shape)}/vp"
        for ans in answers:
            assert int(ans[f"{key}/unsorted/fallbacks"]) == 1
            np.testing.assert_allclose(ans[f"{key}/unsorted/out"], ans[f"{key}/k1/out"],
                                       **VP_TOL)
            np.testing.assert_allclose(ans[f"{key}/flat/out"], ans[f"{key}/k1/out"][:, 0],
                                       **VP_TOL)


def test_segment_output_sharding_takes_the_mesh_order():
    """Node axes out of the mesh's order are refused: the blocks would not
    be laid out as all_gather over those axes lays them."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.kernels import ops

    mesh = make_mesh((1, 1), ranks.AXES, device="cpu")
    with pytest.raises(ValueError, match="mesh's order"):
        with ops.segment_output_sharding(mesh, ("model", "data")):
            pass
    with ops.segment_output_sharding(mesh, ranks.AXES, min_segments=1):
        out = ops.vp_segment_sum(torch.ones(3, 2), torch.tensor([0, 1, 1]), 2)
    torch.testing.assert_close(out, torch.tensor([[1.0, 1.0], [2.0, 2.0]]))


def test_vp_segment_sum_needs_the_hint():
    from repro_torch.kernels import ops

    with pytest.raises(RuntimeError, match="segment_output_sharding"):
        ops.vp_segment_sum(torch.zeros(4, 2), torch.zeros(4, dtype=torch.int32), 8)
    assert not ops._hint_active(1 << 20)
