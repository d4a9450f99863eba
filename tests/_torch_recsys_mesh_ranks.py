"""One rank of the port's DCN-v2 over a mesh on the CPU: the sequence that
tests/test_torch_recsys_mesh.py runs at world sizes 1 (in process), 2 and 4
(one process a rank over a gloo group) and holds against the JAX package.

    python tests/_torch_recsys_mesh_ranks.py RANK WORLD INIT_METHOD REF.npz OUT.npz [MODE]

For every mesh of its world over ``("data", "model")``, from the JAX
package's parameters and batches (read from ``REF.npz``), through
``launch.steps.build_step(mesh=)`` with the registry patched to the small
config below: the serve kind at ``multi_hot`` 1 (ids out of range, wrapped
and on each rank's boundary rows) and 4 (kernel off, and on: K5's wrapper,
its plain version on the CPU), the bags against one device's, the retrieval
kind, and one train step (loss, gradients and the parameters after AdamW),
with the collectives it made by kind (``collective.traffic``). Every tensor
it returns is put back whole over the mesh first. MODE ``traffic`` runs
only :func:`train_traffic` at (2, 1), REF.npz unread
(tests/test_torch_dryrun.py holds it against the dry run of the same step). With ``-`` for ``REF.npz`` it runs :func:`card`
on cuda:0 (tests/test_torch_gpu.py). It imports torch and the port only.
"""
from __future__ import annotations

import json
import sys
from dataclasses import replace

import numpy as np

AXES = ("data", "model")
MESHES = {1: [(1, 1)], 2: [(1, 2), (2, 1)], 4: [(2, 2)]}
ROWS = 1000                     # table rows: 500 a rank over 2, 250 over 4
SERVE_B, TRAIN_B, CANDIDATES = 8, 16, 64
# one-hot ids: every rank's boundary rows, ids in [-R, 0) (wrapped), ids past
# the table either way (NaN)
SPECIAL_IDS = (0, 249, 250, 499, 500, 749, 750, 999, -1, -ROWS, ROWS, ROWS + 7, -ROWS - 1)


def tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def dcn_config(config_cls, multi_hot: int = 1, **kw):
    """``configs/dcn_v2.py:SMOKE``'s widths, built by either package's class."""
    return config_cls(name="dcn-smoke", n_dense=13, n_sparse=26, embed_dim=8,
                      table_rows=ROWS, n_cross_layers=2, mlp=(64, 32), multi_hot=multi_hot,
                      **kw)


def batches() -> dict:
    """The batches of every case (numpy, seeded)."""
    rng = np.random.default_rng(29)
    one = rng.integers(0, ROWS, (SERVE_B, 26, 1)).astype(np.int32)
    flat = one.reshape(-1)
    flat[:len(SPECIAL_IDS) * 7:7] = SPECIAL_IDS            # spread over rows and tables
    hot = rng.integers(-8, ROWS + 8, (SERVE_B, 26, 4)).astype(np.int32)
    hot[0, :len(SPECIAL_IDS), 0] = SPECIAL_IDS
    return {
        "serve1/dense": rng.normal(size=(SERVE_B, 13)).astype(np.float32),
        "serve1/sparse_ids": one,
        "serve4/dense": rng.normal(size=(SERVE_B, 13)).astype(np.float32),
        "serve4/sparse_ids": hot,
        "retr/dense": rng.normal(size=(1, 13)).astype(np.float32),
        "retr/sparse_ids": rng.integers(0, ROWS, (1, 26, 1)).astype(np.int32),
        "retr/candidates": rng.normal(size=(CANDIDATES, 8)).astype(np.float32),
        "train/dense": rng.normal(size=(TRAIN_B, 13)).astype(np.float32),
        "train/sparse_ids": rng.integers(0, ROWS, (TRAIN_B, 26, 1)).astype(np.int32),
        "train/labels": rng.integers(0, 2, TRAIN_B).astype(np.int32),
    }


def part(ref: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


def unflatten(flat: dict) -> dict:
    """``{"a/0/b": leaf}`` as nested dicts and lists (digit keys index lists)."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(out)


def build(cfg, shape_name: str, mesh, device="cpu"):
    """DCN-v2's step of one shape with ``cfg`` as the arch's config."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps

    arch = replace(get_arch("dcn-v2"), full=cfg)
    saved = steps.get_arch
    steps.get_arch = lambda name: arch
    try:
        return steps.build_step("dcn-v2", shape_name, device=device, mesh=mesh)
    finally:
        steps.get_arch = saved


def whole(t, spec, mesh):
    """A rank's slice put back whole over the mesh (every rank holds it),
    as numpy."""
    from repro_torch.models.shard import gather

    return gather(t.contiguous(), spec, mesh).cpu().numpy()


def rows_of(t, mesh, axes):
    """This rank's block of rows of a step's output, gathered whole, as
    numpy."""
    from repro_torch.core import collective

    return collective.all_gather(t.contiguous(), mesh, axes).cpu().numpy()


def traffic() -> dict:
    from repro_torch.core import collective

    return {k: dict(v) for k, v in collective.traffic.items()}


def train_grad(mesh, ref: dict) -> tuple:
    """The train kind's (step, state, batch, loss, gradients) at the batch
    of ``REF.npz``, and the collectives its gradient made by kind."""
    from repro_torch.core import collective
    from repro_torch.launch.steps import train_state
    from repro_torch.models import DCNConfig, dcn_params_from_jax

    cfg = dcn_config(DCNConfig, kernel=False)
    step = build(cfg, "train_batch", mesh)
    model = dcn_params_from_jax(unflatten(part(ref, "p/")), cfg, mesh=mesh)
    state = train_state(model, step.opt, (mesh, step.specs))
    data = part(ref, "b/train/")
    collective.traffic.clear()
    loss, grads = step.grad(state["params"], data)
    return step, state, data, loss, grads, traffic()


def train_traffic(mesh) -> dict:
    """The collectives, by kind, of the train kind's gradient over ``mesh``
    (a live mesh, or a dry one on the meta device) from :func:`seeded`'s
    model and :func:`batches`' train batch."""
    from repro_torch.core import collective
    from repro_torch.launch.steps import train_state
    from repro_torch.models import DCNConfig

    cfg = dcn_config(DCNConfig, kernel=False)
    step = build(cfg, "train_batch", mesh, device=mesh.device)
    state = train_state(to_mesh(seeded(cfg), mesh, step.specs), step.opt, (mesh, step.specs))
    collective.traffic.clear()
    step.grad(state["params"], part(batches(), "train/"))
    return traffic()


def scripted(mesh, ref: dict) -> dict:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import DCNConfig, dcn_params_from_jax, embedding_bag

    torch.set_float32_matmul_precision("highest")
    key, out = tag(mesh.shape), {}
    dp = tuple(a for a in AXES if a != "model")
    tree = unflatten(part(ref, "p/"))
    calls = []
    real = ops.segment_embed

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    ops.segment_embed = counted
    try:
        for hot, kernel in ((1, False), (4, False), (4, True)):
            cfg = dcn_config(DCNConfig, multi_hot=hot, kernel=kernel)
            step = build(cfg, "serve_p99", mesh)
            model = dcn_params_from_jax(tree, cfg, mesh=mesh)
            data = part(ref, f"b/serve{hot}/")
            base = f"{key}/serve{hot}/k{int(kernel)}"
            del calls[:]
            logits = step.fn(model, data)
            out[f"{base}/k5_calls"] = np.array(len(calls))
            out[f"{base}/logits"] = rows_of(logits, mesh, dp)
            # the bags against one device's, from the same parameters
            one = dcn_params_from_jax(tree, cfg, device="cpu")
            ids = torch.as_tensor(data["sparse_ids"])
            with torch.inference_mode():
                got = embedding_bag(model.tables, ids, cfg, mesh)
                want = embedding_bag(one.tables, ids, cfg)
            out[f"{base}/bags"] = got.numpy()
            out[f"{base}/bags_bitwise"] = np.array(bool(torch.equal(
                torch.nan_to_num(got), torch.nan_to_num(want)) and torch.equal(
                got.isnan(), want.isnan())))
        cfg = dcn_config(DCNConfig, kernel=False)
        step = build(cfg, "retrieval_cand", mesh)
        model = dcn_params_from_jax(tree, cfg, mesh=mesh)
        scores = step.fn(model, part(ref, "b/retr/"))
        out[f"{key}/retr/scores"] = rows_of(scores.T, mesh, None).T
        out[f"{key}/retr/meta_rows"] = np.array(step.meta["rows"])
    finally:
        ops.segment_embed = real

    step, state, data, loss, grads, moved = train_grad(mesh, ref)
    out[f"{key}/train/loss"] = np.array(float(loss))
    out[f"{key}/train/traffic"] = np.array(json.dumps(moved))
    for k, g in grads.items():
        out[f"{key}/train/g/{k}"] = whole(g, step.specs[k], mesh)
    new_p, new_o, loss2 = step.fn(state["params"], state["opt"], data)
    out[f"{key}/train/loss2"] = np.array(float(loss2))
    for k, v in new_p.items():
        out[f"{key}/train/new/{k}"] = whole(v, step.specs[k], mesh)
        out[f"{key}/train/mu/{k}"] = whole(new_o["mu"][k], step.specs[k], mesh)
    return out


def to_mesh(model, mesh, specs):
    """A whole ``DCNv2`` as this rank's slices over ``mesh``, on its device."""
    import torch

    from repro_torch.models import DCNv2
    from repro_torch.models.shard import local_slice

    out = DCNv2(model.cfg, mesh=mesh)
    theirs = dict(model.named_parameters())
    with torch.no_grad():
        for k, p in out.named_parameters():
            p.copy_(local_slice(theirs[k].detach(), specs[k], mesh))
    return out


def seeded(cfg):
    """The small DCN-v2 drawn on the CPU from seed 0 (the card mode's and
    its CPU answers', no JAX)."""
    import torch

    from repro_torch.models import dcn_init

    return dcn_init(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def card(shape) -> dict:
    """The card mode over ``shape`` with every rank on cuda:0: serve at
    multi_hot 4 with K5 on this rank's rows (its launches) and at 1, and one
    train step (loss, gradients, new parameters put back whole, bitwise
    repeatability), from :func:`seeded`'s model."""
    import torch

    from repro_torch.core.distributed import make_mesh
    from repro_torch.kernels import embed
    from repro_torch.launch.steps import train_state
    from repro_torch.models import DCNConfig

    torch.set_float32_matmul_precision("highest")
    mesh = make_mesh(shape, AXES, device="cuda:0")
    dp = tuple(a for a in AXES if a != "model")
    data, key, out = batches(), tag(shape), {}
    for hot in (1, 4):
        cfg = dcn_config(DCNConfig, multi_hot=hot, kernel=None)
        step = build(cfg, "serve_p99", mesh, device=None)
        model = to_mesh(seeded(cfg), mesh, step.specs)
        before = embed.launches
        logits = step.fn(model, part(data, f"serve{hot}/"))
        out[f"{key}/serve{hot}/k5_launches"] = np.array(embed.launches - before)
        out[f"{key}/serve{hot}/logits"] = rows_of(logits, mesh, dp)
    cfg = dcn_config(DCNConfig, kernel=None)
    step = build(cfg, "train_batch", mesh, device=None)
    model = to_mesh(seeded(cfg), mesh, step.specs)
    state = train_state(model, step.opt, (mesh, step.specs))
    batch = part(data, "train/")
    loss, grads = step.grad(state["params"], batch)
    out[f"{key}/train/loss"] = np.array(float(loss))
    for k, g in grads.items():
        out[f"{key}/train/g/{k}"] = whole(g, step.specs[k], mesh)
    new_p, _, loss2 = step.fn(state["params"], state["opt"], batch)
    again = step.fn(state["params"], state["opt"], batch)
    out[f"{key}/train/bitwise"] = np.array(bool(torch.equal(again[2], loss2) and all(
        torch.equal(again[0][k], v) for k, v in new_p.items())))
    for k, v in new_p.items():
        out[f"{key}/train/new/{k}"] = whole(v, step.specs[k], mesh)
    return out


def main(argv: list[str]) -> int:
    """``REF.npz`` ``-`` is the card mode (:func:`card`): world 2 over
    (1, 2), every rank on cuda:0."""
    rank, world, init, ref_path, out_path, *mode = argv
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import make_mesh

    torch.set_num_threads(1)
    on_card = ref_path == "-"
    if on_card:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, world_size=int(world), rank=int(rank))
    try:
        out = {}
        if on_card:
            out.update(card((1, 2)))
        elif mode == ["traffic"]:
            out["traffic"] = np.array(json.dumps(train_traffic(
                make_mesh((2, 1), AXES, device="cpu"))))
        else:
            ref = dict(np.load(ref_path))
            for shape in MESHES[int(world)]:
                out.update(scripted(make_mesh(shape, AXES, device="cpu"), ref))
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))


# The JAX side, run by the tests in a subprocess with 8 fabricated CPU
# devices: ``python -c JAX_SCRIPT OUT.npz TESTS_DIR PART``. PART "ref" writes
# the JAX package's parameters, batches and answers (one device, and the
# reference's shardings at (2, 2), impl="xla") and ``build_step``'s meta
# (OUT.npz.json); PART "hlo" writes the compiled HLO text of the sharded
# programs and of a lax.scan whose body makes a collective.
JAX_SCRIPT = r"""
import json, sys
from dataclasses import replace
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AbstractMesh, PartitionSpec as P
sys.path.insert(0, sys.argv[2])
import _torch_recsys_mesh_ranks as ranks
from repro.utils.compat import make_mesh_auto, shard_map_compat
from repro.configs import get_arch
from repro.launch import steps as jsteps
from repro.models import recsys as jrec

PART = sys.argv[3]
AXES = ("data", "model")
real_get_arch = jsteps.get_arch
out, meta, hlo = {}, {}, {}

def key_of(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + key_of(path)] = np.asarray(leaf)

def bundle(cfg, shape, mesh):
    jsteps.get_arch = lambda name: replace(real_get_arch("dcn-v2"), full=cfg)
    try:
        return jsteps.build_step("dcn-v2", shape, mesh)
    finally:
        jsteps.get_arch = real_get_arch

def jitted(b):
    return jax.jit(b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings,
                   donate_argnums=b.donate_argnums)

cfg1 = ranks.dcn_config(jrec.DCNConfig, 1, impl="xla")
cfg4 = ranks.dcn_config(jrec.DCNConfig, 4, impl="xla")
params = jrec.dcn_init(jax.random.PRNGKey(0), cfg1)
data = ranks.batches()
batch = lambda pre: {k: jnp.asarray(v) for k, v in ranks.part(data, pre).items()}
fresh = lambda: jax.tree.map(jnp.array, params)
meshes = {"1x1": make_mesh_auto((1, 1), AXES), "2x2": make_mesh_auto((2, 2), AXES)}
for tag, mesh in meshes.items():
    if PART == "hlo" and tag == "1x1":
        continue
    progs = {}
    for hot, cfg in ((1, cfg1), (4, cfg4)):
        b = bundle(cfg, "serve_p99", mesh)
        progs[f"serve{hot}"] = (jitted(b), (fresh(), batch(f"serve{hot}/")))
    b = bundle(cfg1, "retrieval_cand", mesh)
    progs["retr"] = (jitted(b), (fresh(), batch("retr/")))
    b = bundle(cfg1, "train_batch", mesh)
    opt = jsteps.make_optimizer("adamw")
    progs["train"] = (jitted(b), (fresh(), opt.init(fresh()), batch("train/")))
    grad = jax.jit(jax.value_and_grad(lambda p, x: jrec.dcn_loss(p, x, cfg1)),
                   in_shardings=(b.in_shardings[0], b.in_shardings[2]))
    if PART == "hlo":
        for name, (f, args) in progs.items():
            hlo[f"{tag}/{name}"] = f.lower(*args).compile().as_text()
        hlo[f"{tag}/grad"] = grad.lower(fresh(), batch("train/")).compile().as_text()
        continue
    for hot in (1, 4):
        f, args = progs[f"serve{hot}"]
        out[f"j/{tag}/serve{hot}/logits"] = np.asarray(f(*args))
    f, args = progs["retr"]
    out[f"j/{tag}/retr/scores"] = np.asarray(f(*args))
    loss, g = grad(fresh(), batch("train/"))
    out[f"j/{tag}/train/loss"] = np.asarray(loss)
    put(f"j/{tag}/train/g/", g)
    f, args = progs["train"]
    new_p, new_o, loss2 = f(*args)
    out[f"j/{tag}/train/loss2"] = np.asarray(loss2)
    put(f"j/{tag}/train/new/", new_p)
    put(f"j/{tag}/train/mu/", new_o["mu"])

if PART == "hlo":
    # a scan whose body makes one all-reduce a trip
    mesh = meshes["2x2"]
    def body(c, x):
        return c + jax.lax.psum(x, "data"), None
    f = shard_map_compat(lambda xs: jax.lax.scan(body, jnp.zeros(xs.shape[1:]), xs)[0],
                         mesh=mesh, in_specs=P(None, "data"), out_specs=P("data"),
                         check_vma=False)
    hlo["2x2/scan"] = jax.jit(f).lower(jnp.ones((5, 8))).compile().as_text()
    with open(sys.argv[1] + ".json", "w") as fh:
        json.dump(hlo, fh)
    print("OK")
    sys.exit(0)

put("p/", params)
out.update({"b/" + k: v for k, v in data.items()})
for layout in ((2, 4), (16, 16)):
    tag = f"{layout[0]}x{layout[1]}"
    try:
        mesh = (make_mesh_auto(layout, AXES) if layout == (2, 4)
                else AbstractMesh(layout, AXES))
        for s in get_arch("dcn-v2").shapes:
            meta[f"{tag}/{s.name}"] = {k: float(v) for k, v in
                                       jsteps.build_step("dcn-v2", s.name, mesh).meta.items()}
    except Exception as e:  # an AbstractMesh this JAX does not take: no 16 x 16 meta
        meta[f"{tag}/error"] = repr(e)
np.savez(sys.argv[1], **out)
with open(sys.argv[1] + ".json", "w") as fh:
    json.dump(meta, fh)
print("OK")
"""
