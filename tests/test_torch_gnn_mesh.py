"""The port's GNN train kind over a mesh against the JAX package on the
CPU: a GCN and a SchNet train step over (1, 1), (2, 1), (1, 2) and (2, 2)
meshes under ``segment_output_sharding(mesh, ("data",), min_segments=1)``
(``ogb_products``' node blocks) and with no node blocks (the other shapes),
K1 on (its plain version here) and off.

The JAX side runs once, in one subprocess with 4 fabricated CPU devices,
and writes its parameters, batches (the edge lanes partitioned by dst block
for each mesh, tests/test_distributed.py:184's layout) and
``jax.value_and_grad`` of the losses under the reference's hint, and on one
device, to a file. The port runs tests/_torch_gnn_mesh_ranks.py over a mesh
of one in this process and in 2 and 4 processes over a gloo group, each
spawn killed past ``SPAWN_TIMEOUT_S``: the loss at rtol 1e-5, the
gradients at rtol = atol = 1e-5 (float32 sums in another order), and the
step's new parameters against the one-device step's.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_gnn_mesh_ranks as ranks  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT_S = 120
JAX_TIMEOUT_S = 300
TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)

JAX_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, sys.argv[2])
import _torch_gnn_mesh_ranks as ranks
from repro.utils.compat import make_mesh_auto
from repro.kernels import ops as kops
from repro.models.gnn import (GCNConfig, SchNetConfig, gcn_init, gcn_loss, schnet_init,
                              schnet_loss)

def key_of(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

out = {}
cfgs = ranks.gnn_configs(GCNConfig, SchNetConfig)
fns = {"gcn": (gcn_init, gcn_loss), "schnet": (schnet_init, schnet_loss)}
params = {}
for i, (name, cfg) in enumerate(cfgs.items()):
    params[name] = fns[name][0](jax.random.PRNGKey(i), cfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params[name])[0]:
        out[f"p/{name}/{key_of(path)}"] = np.asarray(leaf)
for shape in [(1, 1), (2, 1), (1, 2), (2, 2)]:
    tag = ranks.tag(shape)
    mesh = make_mesh_auto(shape, ranks.AXES)
    for name, batch in ranks.batches(shape).items():
        cfg, loss = cfgs[name], fns[name][1]
        out.update({f"b/{tag}/{name}/{k}": v for k, v in batch.items()})
        feed = {k: jnp.asarray(v) for k, v in batch.items()}
        feed["n_graphs"] = ranks.GRAPHS
        f = lambda p: loss(p, feed, cfg)

        def hinted(p):
            with kops.segment_output_sharding(mesh, ("data",), min_segments=1):
                return f(p)
        for kind, fn in (("hint", hinted), ("single", f)):
            l, g = jax.jit(jax.value_and_grad(fn))(params[name])
            out[f"j/{tag}/{name}/{kind}/loss"] = np.asarray(l)
            for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
                out[f"j/{tag}/{name}/{kind}/g/{key_of(path)}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory) -> dict:
    path = tmp_path_factory.mktemp("jax_gnn_mesh") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(path), str(ROOT / "tests")],
                         env=env, capture_output=True, text=True, timeout=JAX_TIMEOUT_S)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}"
    return dict(np.load(path))


def _spawn(world: int, tmp: Path, ref_path: Path) -> list[dict]:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    init = f"file://{tmp / 'rendezvous'}"
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "_torch_gnn_mesh_ranks.py"), str(r),
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
    if request.param == 1:
        from repro_torch.core.distributed import make_mesh

        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return 1, [ranks.scripted(make_mesh((1, 1), ranks.AXES, device="cpu"), jax_ref)]
        finally:
            torch.set_num_threads(n)
    tmp = tmp_path_factory.mktemp(f"gnn_mesh_world{request.param}")
    ref_path = tmp / "ref.npz"
    np.savez(ref_path, **jax_ref)
    return request.param, _spawn(request.param, tmp, ref_path)


def _port_names(name: str, jax_keys: dict) -> dict:
    """JAX's gradient leaves by the port's parameter names (an MLP layer's
    ``(w, b)`` as ``<i>.weight`` transposed and ``<i>.bias``)."""
    out = {}
    for k, v in jax_keys.items():
        parts = k.split("/")
        if name == "gcn":
            out[f"w.{parts[1]}"] = v
        elif parts[0] == "embed":
            out["embed"] = v
        else:
            *mlp, layer, wb = parts
            out[".".join(mlp + [layer, "weight" if wb == "0" else "bias"])] = \
                v.T if wb == "0" else v
    return out


@pytest.mark.parametrize("name", ["gcn", "schnet"])
@pytest.mark.parametrize("layout", sorted(ranks.LAYOUTS))
@pytest.mark.parametrize("kernel", [0, 1], ids=["plain", "k1"])
def test_gnn_step_matches_jax(world, jax_ref, name, layout, kernel):
    """The train kind's loss and gradients over each mesh of the world
    equal jax.value_and_grad under the reference's hint (and on one device)
    on every rank; with the kernel on, K1 runs once a node sum a rank
    (GCN: 3 a step, SchNet: 2), none with it off."""
    w, answers = world
    for shape in ranks.MESHES[w]:
        tag = ranks.tag(shape)
        base = f"{tag}/{name}/{layout}/k{kernel}"
        for kind in ("hint", "single"):
            want = _port_names(name, {k[len(f"j/{tag}/{name}/{kind}/g/"):]: v
                                      for k, v in jax_ref.items()
                                      if k.startswith(f"j/{tag}/{name}/{kind}/g/")})
            for r, ans in enumerate(answers):
                np.testing.assert_allclose(float(ans[f"{base}/loss"]),
                                           float(jax_ref[f"j/{tag}/{name}/{kind}/loss"]),
                                           rtol=TOL["rtol"])
                for k, v in want.items():
                    np.testing.assert_allclose(ans[f"{base}/g/{k}"], v, **TOL,
                                               err_msg=f"{base} rank {r} {k} vs {kind}")
        for ans in answers:
            k1 = int(ans[f"{base}/k1_calls"])
            assert k1 == (({"gcn": 3, "schnet": 2}[name]) if kernel else 0), (base, k1)


@pytest.mark.parametrize("name", ["gcn", "schnet"])
def test_gnn_mesh_step_matches_one_device(world, jax_ref, name):
    """One AdamW step over the mesh gives every rank the one-device step's
    new parameters (the one-device step is held to JAX's in
    tests/test_torch_gnn.py)."""
    import dataclasses

    from repro_torch.launch.steps import train_state
    from repro_torch.models import GCNConfig, SchNetConfig

    torch.set_float32_matmul_precision("highest")
    w, answers = world
    cfg = dataclasses.replace(ranks.gnn_configs(GCNConfig, SchNetConfig)[name], kernel=False)
    for shape in ranks.MESHES[w]:
        tag = ranks.tag(shape)
        step = ranks.build(cfg, "molecule", None, ranks.GRAPHS)
        state = train_state(ranks.params_of(name, cfg, jax_ref), step.opt)
        data = {k.split("/")[-1]: v for k, v in jax_ref.items()
                if k.startswith(f"b/{tag}/{name}/")}
        new_p, _, _ = step.fn(state["params"], state["opt"], data)
        for layout in ranks.LAYOUTS:
            for ans in answers:
                for k, v in new_p.items():
                    np.testing.assert_allclose(ans[f"{tag}/{name}/{layout}/k1/new/{k}"],
                                               v.numpy(), **STEP_TOL, err_msg=k)


def test_gnn_mesh_step_kernel_true_on_one_device_raises():
    """On one device K1 has no backward: kernel=True still raises there."""
    import dataclasses

    from repro_torch.models import GCNConfig, SchNetConfig

    cfg = dataclasses.replace(ranks.gnn_configs(GCNConfig, SchNetConfig)["gcn"], kernel=True)
    with pytest.raises(NotImplementedError, match="over a mesh"):
        ranks.build(cfg, "molecule", None, ranks.GRAPHS)
