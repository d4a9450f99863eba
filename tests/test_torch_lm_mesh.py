"""The port's transformer over a mesh against the JAX package on the CPU:
the specs of the five FULL configs, the train kind's sharded loss and
gradients, a train step and the sharded optimizers against one device,
prefill and decode in their cache layouts, ``build_step(mesh=)``'s meta, and
``restore_elastic`` of a JAX state saved on a 2 x 4 mesh.

The JAX side runs once, in one subprocess with 8 fabricated CPU devices
(the main process keeps its one device), and writes its inputs and answers
to a file: the reference's specs (``param_specs``, ``param_specs_zero3``,
``cache_specs`` and ``_lm_decode``'s cache spec through ``build_step``) at
the (1, 1), (2, 4) and (16, 16) layouts, its loss and gradients (one
device for the dense configs, whose sharded program computes the same; the
MoE config's sharded program on every mesh, whose aux is each token
block's), prefill and decode, the meta of every LM cell at 2 x 4, and a
train state saved on 2 x 4. The port runs tests/_torch_lm_mesh_ranks.py over
a mesh of one in this process and in 2, 4 and 8 processes, one a rank,
over a gloo group, each spawn killed past ``SPAWN_TIMEOUT_S``. Tolerances:
the loss at rtol 2e-4 (tests/test_distributed.py:92's), gradients, logits
and caches at rtol = atol = 3e-4.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_lm_mesh_ranks as ranks  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT_S = 180  # a whole world's spawn; killed past it
JAX_TIMEOUT_S = 400
LOSS_RTOL = 2e-4
TOL = dict(rtol=3e-4, atol=3e-4)
LM_ARCHS = ("qwen2.5-3b", "mistral-nemo-12b", "phi3-mini-3.8b", "deepseek-v3-671b",
            "grok-1-314b")
SPEC_LAYOUTS = ((1, 1), (2, 4), (16, 16))
JAX_PARTS = ("serve", "single", "mla:1x2", "mla:2x1", "mla:2x2", "mla:2x4")

JAX_SCRIPT = r"""
import json, sys
from dataclasses import replace
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P
sys.path.insert(0, sys.argv[2])
import _torch_lm_mesh_ranks as ranks
from repro.utils.compat import make_mesh_auto
from repro.configs import get_arch
from repro.checkpoint import CheckpointManager
from repro.launch import steps as jsteps
from repro.launch.mesh import dp_axes
from repro.models.layers import ShardCtx
from repro.models.moe import MoEConfig
from repro.models.transformer import (TransformerConfig, init_params, loss_fn, forward,
                                      decode_step, init_cache, param_specs,
                                      param_specs_zero3, cache_specs)

out, specs = {}, {}
f32 = jnp.float32
cfgs = ranks.lm_configs(TransformerConfig, MoEConfig, f32)
ptrees = {name: init_params(jax.random.PRNGKey(i), cfg) for i, (name, cfg) in
          enumerate(cfgs.items())}
for name, p in ptrees.items():
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    for path, leaf in flat:
        out["p/" + name + "/" + "/".join(k.key for k in path)] = np.asarray(leaf)

def tup(s):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(s)]

def tree_specs(t):
    return jax.tree.map(tup, t, is_leaf=lambda x: isinstance(x, P))

PART = sys.argv[5]   # "serve": specs, meta, serving, the state; else the losses
mesh24 = make_mesh_auto((2, 4), ("data", "model"))
# the reference's specs of the FULL configs
for shape in ([(1, 1), (2, 4), (16, 16)] if PART == "serve" else []):
    key = f"{shape[0]}x{shape[1]}"
    mesh = AbstractMesh(shape, ("data", "model"))
    for a in sys.argv[3].split(","):
        arch = get_arch(a)
        cfg = arch.full
        d = specs.setdefault(f"{key}/{a}", {})
        d["param"] = tree_specs(param_specs(cfg, mesh))
        d["zero3"] = tree_specs(param_specs_zero3(cfg, mesh))
        d["cache"] = jax.tree.map(tup, cache_specs(cfg, dp_axes(mesh)),
                                  is_leaf=lambda x: isinstance(x, P))
        for s in ("decode_32k", "long_500k"):
            b = jsteps.build_step(a, s, mesh)
            d[s] = {k: tup(v.spec) for k, v in b.out_shardings[1].items()}

# build_step's meta at 2 x 4
meta = {}
for a in (sys.argv[3].split(",") if PART == "serve" else []):
    for s in get_arch(a).shapes:
        meta[f"{a}:{s.name}"] = {k: float(v) for k, v in
                                 jsteps.build_step(a, s.name, mesh24).meta.items()}

# the train kind's loss and gradients: 2 microbatches of 2 rows
def train(name, mesh=None):
    cfg, p = replace(cfgs[name], flash_q_chunk=ranks.TRAIN_SEQ), ptrees[name]
    b = ranks.train_batch(cfg.vocab)
    kw, put = {}, jnp.asarray
    if mesh is not None:
        ctx = ShardCtx(mesh=mesh, dp=("data",), sp=True)
        kw = dict(ctx=ctx, mesh=mesh)
        sh = jax.tree.map(lambda s: NamedSharding(mesh, s), param_specs(cfg, mesh),
                          is_leaf=lambda x: isinstance(x, P))
        p = jax.tree.map(lambda a, s: jax.device_put(a, s), p, sh)
        put = lambda a: jax.device_put(a, NamedSharding(mesh, P(ctx.dp, None)))
    f = jax.jit(jax.value_and_grad(lambda p, t, l: loss_fn(p, t, l, cfg, **kw)))
    loss, grads = 0.0, None
    for i in range(2):
        l, g = f(p, put(b["tokens"][2 * i:2 * i + 2]), put(b["labels"][2 * i:2 * i + 2]))
        loss = loss + l / 2
        grads = jax.tree.map(lambda g: g / 2, g) if grads is None else \
            jax.tree.map(lambda a, g: a + g / 2, grads, g)
    return loss, grads

def put_grads(prefix, loss, grads):
    out[prefix + "/loss"] = np.asarray(loss)
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[prefix + "/g/" + "/".join(k.key for k in path)] = np.asarray(leaf)

if PART != "serve":
    if PART == "single":
        for name in ("gqa", "gqa66", "mla"):
            put_grads(f"train/{name}/single", *train(name))
    else:   # "mla:<d>x<m>" (a mesh of one is one device)
        shape = tuple(int(n) for n in PART[4:].split("x"))
        put_grads(f"train/{PART[4:]}".replace("train/", "train/mla/"),
                  *train("mla", make_mesh_auto(shape, ("data", "model"))))
    np.savez(sys.argv[1], **out)
    print("OK")
    sys.exit(0)

# prefill (one compile a config; the batch-of-one cases take row 0) and decode
pre = {}
for name in ("gqa", "mla"):
    cfg = cfgs[name]
    toks = jnp.asarray(ranks.tokens(cfg.vocab, ranks.BATCH, ranks.SEQ + ranks.NEW, 7))
    lg, _, cache = jax.jit(lambda p, t: forward(p, t, cfg, return_cache=True))(
        ptrees[name], toks[:, :ranks.SEQ])
    pre[name] = (np.asarray(lg[:, -1]), {k: np.asarray(v) for k, v in cache.items()})
for name, (cfg, batch) in ranks.serve_cases(cfgs).items():
    base = name.split("-")[0]
    lg, cache0 = pre[base]
    cache0 = {k: v[:, :batch] for k, v in cache0.items()}
    out[f"serve/{name}/prefill"] = lg[:batch]
    out.update({f"serve/{name}/cache/{k}": v for k, v in cache0.items()})
    c = {k: jnp.asarray(v) for k, v in ranks.decode_cache(
        cfg, batch, cache0, lambda *a: init_cache(*a)).items()}
    toks = jnp.asarray(ranks.tokens(cfg.vocab, batch, ranks.SEQ + ranks.NEW, 7))
    step = jax.jit(lambda p, c, t, n: decode_step(p, c, t, n, cfg))
    logits = []
    for t in range(ranks.decode_start(cfg), ranks.SEQ + ranks.NEW):
        lg, c = step(ptrees[base], c, toks[:, t], jnp.asarray(t, jnp.int32))
        logits.append(np.asarray(lg))
    out[f"serve/{name}/decode"] = np.stack(logits, axis=1)

# a train state saved on 2 x 4: bfloat16 parameters, float32 AdamW moments
cfg = replace(cfgs["gqa"], param_dtype=jnp.bfloat16)
p = jax.tree.map(lambda a: a.astype(jnp.bfloat16), ptrees["gqa"])
rng = np.random.default_rng(9)
mu = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), f32), p)
nu = jax.tree.map(lambda a: jnp.asarray(rng.random(size=a.shape), f32), p)
state = {"params": p, "opt": {"step": jnp.asarray(7, jnp.int32), "mu": mu, "nu": nu}}
sh = jax.tree.map(lambda s: NamedSharding(mesh24, s), param_specs(cfg, mesh24),
                  is_leaf=lambda x: isinstance(x, P))
rep = NamedSharding(mesh24, P())
state = {"params": jax.tree.map(jax.device_put, state["params"], sh),
         "opt": {"step": jax.device_put(state["opt"]["step"], rep),
                 "mu": jax.tree.map(jax.device_put, mu, sh),
                 "nu": jax.tree.map(jax.device_put, nu, sh)}}
CheckpointManager(sys.argv[4]).save(7, state, blocking=True)
for path, leaf in jax.tree_util.tree_flatten_with_path(mu)[0]:
    out["state/mu/" + "/".join(k.key for k in path)] = np.asarray(leaf)
out["ckpt_dir"] = np.array(sys.argv[4])
np.savez(sys.argv[1], **out)
with open(sys.argv[1] + ".json", "w") as f:
    json.dump({"specs": specs, "meta": meta}, f)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory) -> dict:
    """The JAX package's inputs and answers (8 fabricated devices; the
    serving part, the one-device losses and the MoE config's loss on each
    mesh in subprocesses at once)."""
    tmp = tmp_path_factory.mktemp("jax_lm_mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = {part: subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / f"{part.replace(':', '_')}.npz"),
         str(ROOT / "tests"),
         ",".join(LM_ARCHS), str(tmp / "ckpt"), part],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in JAX_PARTS}
    deadline = time.monotonic() + JAX_TIMEOUT_S
    out = {}
    try:
        for part, p in procs.items():
            stdout, stderr = p.communicate(timeout=max(deadline - time.monotonic(), 0.0))
            assert p.returncode == 0, f"{part}\nSTDOUT:\n{stdout}\nSTDERR:\n{stderr}"
            out.update(np.load(tmp / f"{part.replace(':', '_')}.npz"))
    finally:
        for p in procs.values():
            p.kill()
    out.update(json.loads((tmp / "serve.npz.json").read_text()))
    out["tmp_dir"] = np.array(str(tmp))
    return out


def _start(world: int, tmp: Path, ref_path: Path) -> list:
    """The ranks of ``world`` over a gloo group (file rendezvous in
    ``tmp``), each writing its answers to a file."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    init = f"file://{tmp / 'rendezvous'}"
    procs = []
    for r in range(world):
        with open(tmp / f"rank{r}.log", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "_torch_lm_mesh_ranks.py"), str(r),
                 str(world), init, str(ref_path), str(tmp / f"rank{r}.npz")], env=env,
                stdout=out, stderr=subprocess.STDOUT))
    return procs


def _finish(world: int, procs: list, tmp: Path, deadline: float) -> list[dict]:
    """Each rank's answers, every rank killed once ``deadline`` has passed."""
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
def spawned(jax_ref, tmp_path_factory):
    """Worlds 2, 4 and 8 started at once, as soon as JAX's answers are in:
    ``{world: (procs, directory, deadline)}``; every rank is killed at the
    module's end if it still runs."""
    arrays = {k: v for k, v in jax_ref.items() if isinstance(v, np.ndarray)}
    base = tmp_path_factory.mktemp("lm_mesh_worlds")
    ref_path = base / "ref.npz"
    np.savez(ref_path, **arrays)
    out = {}
    for w in (2, 4, 8):
        tmp = base / f"world{w}"
        tmp.mkdir()
        out[w] = (_start(w, tmp, ref_path), tmp, time.monotonic() + SPAWN_TIMEOUT_S)
    yield out
    for procs, _, _ in out.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", params=[1, 2, 4, 8], ids=lambda w: f"world{w}")
def world(request, jax_ref, spawned) -> tuple[int, list[dict]]:
    """(world size, each rank's answers) for every mesh of that world."""
    if request.param == 1:
        import torch.distributed as dist

        from repro_torch.core.distributed import make_mesh

        assert not dist.is_initialized()
        arrays = {k: v for k, v in jax_ref.items() if isinstance(v, np.ndarray)}
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return 1, [ranks.scripted(make_mesh((1, 1), ranks.AXES, device="cpu"), arrays)]
        finally:
            torch.set_num_threads(n)
    procs, tmp, deadline = spawned[request.param]
    return request.param, _finish(request.param, procs, tmp, deadline)


def _names(jax_tree: dict, prefix: str, cfg) -> dict:
    """JAX's stacked leaves under ``prefix`` (``.../dense_blocks/attn/wq``)
    by the port's parameter names, one a layer."""
    from repro_torch.models.convert import lm_state_from_jax

    tree = ranks._unflatten({k[len(prefix):]: v for k, v in jax_tree.items()
                             if k.startswith(prefix)})
    return lm_state_from_jax({"params": tree, "opt": {}})["params"]


def _cfgs():
    from repro_torch.models import MoEConfig, TransformerConfig

    return ranks.lm_configs(TransformerConfig, MoEConfig, torch.float32)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------
def _norm(spec, ndim: int):
    from repro_torch.models.shard import norm_spec

    return norm_spec(spec, ndim)


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("layout", SPEC_LAYOUTS, ids=ranks.tag)
def test_specs_match_the_reference(jax_ref, arch, layout):
    """param_specs, param_specs_zero3 (every leaf), cache_specs and
    _lm_decode's cache spec (decode_32k, long_500k) of a FULL config equal
    the reference's, its stacked layer entry dropped."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import MeshLayout, dp_axes
    from repro_torch.models import transformer as lm

    cfg = get_arch(arch).full
    mesh = MeshLayout(layout, ranks.AXES)
    ref = jax_ref["specs"][f"{ranks.tag(layout)}/{arch}"]
    shapes = lm.param_shapes(cfg)
    for kind, fn in (("param", lm.param_specs), ("zero3", lm.param_specs_zero3)):
        want = lm.specs_from_jax(ref[kind], cfg)
        got = fn(cfg, mesh)
        assert set(got) == set(want) == set(shapes), kind
        for k, s in shapes.items():
            assert _norm(got[k], len(s)) == _norm(want[k], len(s)), (kind, k, got[k], want[k])
    cache = lm.init_cache(cfg, 2, 8, device="meta")
    for kind, got in (("cache", lm.cache_specs(cfg, dp_axes(mesh))),
                      ("decode_32k", lm.decode_cache_specs(cfg, mesh, 128)),
                      ("long_500k", lm.decode_cache_specs(
                          cfg if cfg.attn == "mla" else
                          dataclasses.replace(cfg, sliding_window=4096), mesh, 1))):
        assert set(got) == set(ref[kind]), kind
        for k in got:
            nd = cache[k].dim() if k in cache else 5
            assert _norm(got[k], nd) == _norm(ref[kind][k], nd), (kind, k)


def test_zero3_specs_cover_every_leaf():
    """tests/test_models_lm.py:186: the zero3 specs name every parameter
    of qwen2.5's smoke config, on a mesh of one."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.models import transformer as lm

    cfg = get_arch("qwen2.5-3b").smoke
    specs = lm.param_specs_zero3(cfg, MeshLayout((1, 1), ranks.AXES))
    assert set(specs) == set(lm.param_shapes(cfg))


def test_build_step_meta_matches_the_reference(jax_ref):
    """build_step(mesh=)'s meta of every LM cell at the reference's 2 x 4
    layout (a MeshLayout: no ranks) equals the reference's."""
    from repro_torch.launch import build_step
    from repro_torch.launch.mesh import MeshLayout

    mesh = MeshLayout((2, 4), ranks.AXES)
    for cell, want in jax_ref["meta"].items():
        arch, shape = cell.split(":")
        got = build_step(arch, shape, mesh=mesh).meta
        assert set(got) == set(want), cell
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=f"{cell} {k}")


def test_mesh_helpers_match_the_reference():
    """dp_axes and n_devices of a layout are the reference's; a local mesh
    without a process group is a world of one over ("data", "model"); a
    ShardCtx's layouts: the sequence over tp with sp, the heads over tp
    where they divide."""
    from repro.launch import mesh as jmesh

    from repro_torch.launch import MeshLayout, dp_axes, make_local_mesh, n_devices
    from repro_torch.models import ShardCtx

    for shape, axes in (((2, 4), ranks.AXES), ((2, 16, 16), ("pod", "data", "model"))):
        fake = type("M", (), {"axis_names": axes, "shape": dict(zip(axes, shape))})()
        layout = MeshLayout(shape, axes)
        assert dp_axes(layout) == jmesh.dp_axes(fake)
        assert n_devices(layout) == jmesh.n_devices(fake)
    mesh = make_local_mesh(device="cpu")
    assert (mesh.shape, mesh.axis_names, mesh.size) == ((1, 1), ranks.AXES, 1)
    ctx = ShardCtx(MeshLayout((2, 4), ranks.AXES), ("data",), sp=True)
    assert ctx.tp_size() == 4 and ctx.act3() == (("data",), "model", None)
    assert ctx.act4(8)[2] == "model" and ctx.act4(2)[2] is None


def test_layout_steps_refuse_to_run():
    from repro_torch.launch import build_step
    from repro_torch.launch.mesh import MeshLayout

    step = build_step("qwen2.5-3b", "prefill_32k", mesh=MeshLayout((2, 4), ranks.AXES))
    with pytest.raises(ValueError, match="layout"):
        step.fn(None, None)
    dcn = build_step("dcn-v2", "train_batch", mesh=MeshLayout((2, 4), ranks.AXES))
    with pytest.raises(ValueError, match="layout"):
        dcn.fn({}, None, None)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _meshes(w: int):
    return ranks.MESHES[w]


def _want_train(jax_ref, name: str, shape) -> tuple[float, dict, object]:
    cfg = _cfgs()[name]
    src = (f"train/mla/{ranks.tag(shape)}" if name == "mla" and shape != (1, 1)
           else f"train/{name}/single")
    return float(jax_ref[f"{src}/loss"]), _names(jax_ref, f"{src}/g/", cfg), cfg


@pytest.mark.parametrize("name", ["gqa", "gqa66", "mla"])
def test_sharded_loss_and_gradients_match_jax(world, jax_ref, name):
    """The train kind's loss (2 microbatches) equals JAX's (the MoE
    config's sharded program on the same mesh) at rtol 2e-4 on every rank,
    and its gradients, put together, equal jax.grad's at 3e-4: tp_sp, and
    zero3 for the dense configs."""
    w, answers = world
    for shape in _meshes(w):
        loss, grads, _ = _want_train(jax_ref, name, shape)
        for layout in (("tp_sp", "zero3") if name != "mla" else ("tp_sp",)):
            base = f"{ranks.tag(shape)}/{name}/{layout}"
            for ans in answers:
                np.testing.assert_allclose(float(ans[f"{base}/loss"]), loss, rtol=LOSS_RTOL)
            for k, g in grads.items():
                np.testing.assert_allclose(answers[0][f"{base}/g/{k}"], g, **TOL,
                                           err_msg=f"{base} {k}")


@pytest.mark.parametrize("name", ["gqa", "mla"])
def test_train_step_matches_one_device(world, jax_ref, name):
    """One train step (AdamW) over the mesh gives the one-device step's
    loss and new parameters (the one-device step is held to JAX's in
    tests/test_torch_lm_train.py)."""
    from repro_torch.launch.steps import train_state
    from repro_torch.models import lm_params_from_jax

    w, answers = world
    cfg = _cfgs()[name]
    tree = ranks._unflatten({k[len(f"p/{name}/"):]: v for k, v in jax_ref.items()
                             if isinstance(v, np.ndarray) and k.startswith(f"p/{name}/")})
    step = ranks.build_train_step(cfg, "adamw", "tp_sp", None)
    model = lm_params_from_jax(tree, cfg, device="cpu")
    torch.set_float32_matmul_precision("highest")
    state = train_state(model, step.opt)
    new_p, _, loss = step.fn(state["params"], state["opt"], ranks.train_batch(cfg.vocab))
    for shape in _meshes(w):
        base = f"{ranks.tag(shape)}/{name}/tp_sp"
        if name != "mla":   # the MoE's aux is each token block's over a mesh
            np.testing.assert_allclose(float(answers[0][f"{base}/step_loss"]), float(loss),
                                       rtol=LOSS_RTOL)
        for k, v in new_p.items():
            np.testing.assert_allclose(answers[0][f"{base}/new/{k}"], v.numpy(), **TOL,
                                       err_msg=f"{base} {k}")


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_sharded_optimizers_match_one_device(world, jax_ref, opt):
    """AdamW and Adafactor (factored at 8 x 8 and up) over this rank's
    slices, two updates, equal the one-device updates: the clip's global
    norm counts each leaf once, the factored means sum over the ranks that
    split a row or a column."""
    from repro_torch.models import lm_params_from_jax
    from repro_torch.optim import adafactor, adamw

    w, answers = world
    cfg = _cfgs()["gqa"]
    tree = ranks._unflatten({k[len("p/gqa/"):]: v for k, v in jax_ref.items()
                             if isinstance(v, np.ndarray) and k.startswith("p/gqa/")})
    params = {k: v.detach() for k, v in lm_params_from_jax(tree, cfg, device="cpu")
              .named_parameters()}
    rng = np.random.default_rng(5)
    grads = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
             for k, v in params.items()}
    o = adamw(1e-3) if opt == "adamw" else adafactor(1e-2, min_dim_factored=8)
    st = o.init(params)
    for _ in range(2):
        params, st = o.update(grads, st, params)
    for shape in _meshes(w):
        for k, v in params.items():
            np.testing.assert_allclose(answers[0][f"{ranks.tag(shape)}/opt/{opt}/{k}"],
                                       v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["gqa", "mla"])
def test_prefill_matches_jax(world, jax_ref, name):
    """Prefill under ShardCtx(mesh, dp, sp=True): the last position's
    logits and the cache (cache_specs' layout, the sequence over 'model'),
    put together, equal JAX's at 3e-4."""
    w, answers = world
    for shape in _meshes(w):
        base = f"{ranks.tag(shape)}/serve/{name}"
        np.testing.assert_allclose(answers[0][f"{base}/prefill"],
                                   jax_ref[f"serve/{name}/prefill"], **TOL)
        keys = [k for k in answers[0] if k.startswith(f"{base}/cache/")]
        assert keys
        for k in keys:
            np.testing.assert_allclose(answers[0][k],
                                       jax_ref[f"serve/{name}/cache/{k.split('/')[-1]}"],
                                       **TOL, err_msg=k)


@pytest.mark.parametrize("name", ["gqa", "gqa-b1", "gqa-int8", "mla", "mla-b1"])
def test_decode_matches_jax(world, jax_ref, name):
    """Decode steps in _lm_decode's cache layout (GQA head_dim over
    'model'; a batch of one with a window: the sequence over 'data'; MLA's
    latent over 'model', or its sequence over every axis at a batch of
    one; int8 entries and scales) equal JAX's logits at 3e-4 on every rank;
    greedy tokens equal."""
    w, answers = world
    want = jax_ref[f"serve/{name}/decode"]
    for shape in _meshes(w):
        for ans in answers:
            got = ans[f"{ranks.tag(shape)}/serve/{name}/decode"]
            np.testing.assert_allclose(got, want, **TOL)
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["tp", "zero3"])
def test_restore_elastic_of_a_jax_state_by_specs(world, jax_ref, layout):
    """A JAX train state saved on its 2 x 4 mesh (bfloat16 parameters)
    restores onto every port mesh by specs, bit for bit, each rank its
    slices; written again through lm_sharded_layout it holds the whole
    arrays in JAX's layout."""
    w, answers = world
    cfg = _cfgs()["gqa"]
    params = _names(jax_ref, "p/gqa/", cfg)
    mu = _names(jax_ref, "state/mu/", cfg)
    for shape in _meshes(w):
        base = f"{ranks.tag(shape)}/restore/{layout}"
        for ans in answers:
            assert int(ans[f"{base}/step"]) == 7
            assert str(ans[f"{base}/dtype"]) == "torch.bfloat16"
            assert int(ans[f"{base}/rewritten_step"]) == 8
        for k, v in params.items():
            bf = torch.from_numpy(np.asarray(v, dtype=np.float32)).bfloat16().float().numpy()
            np.testing.assert_array_equal(answers[0][f"{base}/params/{k}"], bf, err_msg=k)
            for ans in answers:
                np.testing.assert_array_equal(ans[f"{base}/rewritten/{k}"], bf, err_msg=k)
        for k, v in mu.items():
            np.testing.assert_array_equal(answers[0][f"{base}/mu/{k}"], v, err_msg=k)
