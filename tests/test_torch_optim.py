"""The port's optimizers, schedules, gradient utilities and int8 compression
against the JAX package's ``optim/`` on the CPU, from numpy-seeded inputs.

Tolerances: parameters and optimizer state within rtol 1e-6, atol 1e-7
after 5 updates (float32 reductions, the global norm's and Adafactor's
means, sum in another order in each library; the step counter is an int32
and equal); schedules within rtol 1e-6 (float32 cosines of two libraries);
the global norm within rtol 1e-6. ``quantize_int8``'s scales are bitwise
equal and its codes equal but at rounding ties (none in these inputs).
``compressed_psum`` equals JAX's on a 1-device mesh and, at 2 and 4 gloo
ranks, its float32 numpy closed form, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_train_ranks as ranks  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.data import lm_token_batches as jax_lm_batches  # noqa: E402
from repro.utils.compat import make_mesh_auto, shard_map_compat  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.data import lm_token_batches  # noqa: E402
from repro_torch.utils.tree import leaves_with_paths, tree_map  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-7)
SPAWN_TIMEOUT_S = 120


def _params_np(seed=0):
    """A tree with nested dicts, a list, a leaf big enough to factor
    (128 x 160), a 3-D leaf and a vector."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"w": f(4, 5), "big": f(128, 160), "b": f(7),
            "nested": {"x": f(3, 2), "layers": [f(2, 3, 4), f(6)]}}


def _grads_np(seed):
    return jax.tree.map(lambda a: (a * 3).astype(np.float32), _params_np(100 + seed))


def _to_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _host_leaves(tree) -> list:
    """(key, numpy leaf) in JAX's order, of a port or a JAX tree."""
    return leaves_with_paths(tree_map(
        lambda x: x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x), tree))


def _assert_trees_close(got, want, **tol):
    g, w = _host_leaves(got), _host_leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype, k
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, err_msg=k, **(tol or TOL))


OPTIMIZERS = {
    "adamw": lambda m, clip: m.adamw(1e-2, grad_clip=clip),
    "adafactor": lambda m, clip: m.adafactor(1e-2, weight_decay=0.01, grad_clip=clip),
    "sgdm": lambda m, clip: m.sgdm(1e-2, grad_clip=clip),
}


@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "noclip"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_jax(name, clip):
    jopt, topt = OPTIMIZERS[name](joptim, clip), OPTIMIZERS[name](optim, clip)
    p_np = _params_np()
    jp, tp = _to_jax(p_np), _to_torch(p_np)
    js, ts = jopt.init(jp), topt.init(tp)
    _assert_trees_close(ts, js)
    for k in range(5):
        g = _grads_np(k)
        jp, js = jopt.update(_to_jax(g), js, jp)
        tp, ts = topt.update(_to_torch(g), ts, tp)
    _assert_trees_close(tp, jp)
    _assert_trees_close(ts, js)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"]) == 5
    if name == "adafactor":  # the 128 x 160 leaf is factored, the others are not
        assert set(ts["v"]["big"]) == {"vr", "vc"} and set(ts["v"]["w"]) == {"v"}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_is_pure_and_keeps_bf16(name):
    """update returns new tensors and leaves its inputs as they were; a
    bfloat16 parameter stays bfloat16, as JAX's _cast_like keeps it."""
    opt = OPTIMIZERS[name](optim, 1.0)
    p = _to_torch(_params_np())
    p["half"] = torch.ones(4, 4, dtype=torch.bfloat16)
    state = opt.init(p)
    grads = dict(_to_torch(_grads_np(0)), half=torch.full((4, 4), 0.5, dtype=torch.bfloat16))
    before = [t.clone() for _, t in leaves_with_paths((p, state, grads))]
    new_p, new_state = opt.update(grads, state, p)
    after = [t for _, t in leaves_with_paths((p, state, grads))]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert new_p["half"].dtype == torch.bfloat16 and new_p["w"].dtype == torch.float32
    assert not torch.equal(new_p["w"], p["w"])


@pytest.mark.parametrize("sched", ["constant", "cosine"])
def test_schedules_match_jax(sched):
    make = {"constant": lambda m: m.constant(3e-4),
            "cosine": lambda m: m.linear_warmup_cosine(1e-3, 10, 100, final_frac=0.1)}[sched]
    jf, tf = make(joptim), make(optim)
    steps = np.arange(121, dtype=np.int32)
    want = np.array([np.asarray(jf(jnp.asarray(s))) for s in steps])
    got = np.array([tf(torch.tensor(s)).numpy() for s in steps])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    t = tf(torch.tensor(3, dtype=torch.int32))
    assert t.dtype == torch.float32 and t.dim() == 0
    assert float(tf(3)) == float(t)  # a Python int step too


def test_global_norm_and_clip_match_jax():
    g = _grads_np(3)
    jn = float(joptim.global_norm(_to_jax(g)))
    tn = optim.global_norm(_to_torch(g))
    assert tn.dtype == torch.float32
    np.testing.assert_allclose(float(tn), jn, rtol=1e-6)
    for max_norm in (0.5, 1e6):  # clipped, and left as it is
        jc, jgn = joptim.clip_by_global_norm(_to_jax(g), max_norm)
        tc, tgn = optim.clip_by_global_norm(_to_torch(g), max_norm)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
        _assert_trees_close(tc, jc)


@pytest.mark.parametrize("shape", [(64, 32), (3, 16, 8), (50,), ()])
def test_quantize_int8_matches_jax(shape):
    x = np.asarray(np.random.default_rng(len(shape)).normal(size=shape) * 5, np.float32)
    jq, js = joptim.quantize_int8(jnp.asarray(x))
    tq, ts = optim.quantize_int8(torch.from_numpy(x))
    assert ts.shape == js.shape and tq.dtype == torch.int8
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
    ties = int(np.sum(np.asarray(jq) != tq.numpy()))
    assert ties == 0, f"{ties} codes differ"
    np.testing.assert_array_equal(optim.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(joptim.dequantize_int8(jq, js)))


@pytest.mark.parametrize("name", list(ranks.PSUM_SHAPES))
def test_compressed_psum_world1_matches_jax(name):
    from jax.sharding import PartitionSpec as P

    from repro_torch.core import collective
    from repro_torch.core.distributed import make_mesh

    x = ranks.psum_block(name, 0)
    mesh = make_mesh_auto((1,), ("d",))
    want = shard_map_compat(lambda xl: joptim.compressed_psum(xl[0], "d"), mesh=mesh,
                            in_specs=(P("d"),), out_specs=P(), check_vma=False)(x[None])
    before = collective.collectives
    got = optim.compressed_psum(torch.from_numpy(x), make_mesh(device="cpu"))
    assert collective.collectives - before == 2  # the scales' max, the int32 sum
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), ranks.psum_closed_form(name, 1))


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def psum_ranks(request, tmp_path_factory):
    from repro_torch.checkpoint import CheckpointManager

    tmp = tmp_path_factory.mktemp(f"psum{request.param}")
    CheckpointManager(str(tmp / "ckpt" / "elastic")).save(
        ranks.ELASTIC_STEP, ranks.elastic_state(torch), blocking=True)
    return request.param, ranks.spawn(request.param, tmp, tmp / "ckpt", SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("name", list(ranks.PSUM_SHAPES))
def test_compressed_psum_over_gloo_ranks(psum_ranks, name):
    """Every rank gets the closed form's sum bit for bit, in two
    collectives."""
    world, outs = psum_ranks
    want = ranks.psum_closed_form(name, world)
    for out in outs:
        np.testing.assert_array_equal(out[f"psum/{name}"], want)
        assert int(out[f"psum/{name}/collectives"]) == 2
    exact = sum(ranks.psum_block(name, r) for r in range(world))
    assert np.abs(want - exact).max() <= 0.02 * np.abs(exact).max()


@pytest.mark.parametrize("start", [0, 3])
def test_lm_token_batches_equal_jax(start):
    a = lm_token_batches(100, 2, 8, seed=3, start_step=start)
    b = jax_lm_batches(100, 2, 8, seed=3, start_step=start)
    for _ in range(4):
        x, y = next(a), next(b)
        assert x.keys() == y.keys() and x["step"] == y["step"]
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype == np.int32
            np.testing.assert_array_equal(x[k], y[k])


def test_lm_stream_resume_exact():
    a = lm_token_batches(100, 2, 8, seed=3)
    first = [next(a) for _ in range(5)]
    resumed = next(lm_token_batches(100, 2, 8, seed=3, start_step=3))
    np.testing.assert_array_equal(resumed["tokens"], first[3]["tokens"])

