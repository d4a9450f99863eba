"""The port's training runtime on the CPU against the JAX package: the
checkpoint manager (its own tests, and checkpoints read across the two
packages), DCN-v2's loss, gradient and train step, the fault-tolerant loop
(recovery, the held-rename race, resume, straggler re-dispatch) and
``peel_with_restarts`` at worlds 1 and 2, with ``restore_elastic``.

Tolerances: DCN-v2's loss and gradient within rtol 1e-5 (float32 products
221 wide and sums in another order in each library), three AdamW steps
within rtol 1e-5, atol 1e-6 on the parameters. Everything else is exact:
checkpoints restore bit for bit, a recovered run equals the uninterrupted
one bit for bit, and the peel's triple (the density's float32 bits, the
mask, the passes) equals JAX's and the port's ``pbahmani``.
"""
import json
import os
import threading
import time
from dataclasses import replace
from typing import NamedTuple
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_train_ranks as ranks  # noqa: E402
from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.launch.steps import build_step as jax_build_step  # noqa: E402
from repro.launch.train import peel_with_restarts as jax_peel_with_restarts  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.utils.compat import make_mesh_auto  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import collective, pbahmani  # noqa: E402
from repro_torch.core.distributed import make_mesh  # noqa: E402
from repro_torch.data import recsys_batches  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    LoopConfig, build_step, make_optimizer, peel_with_restarts, restore_elastic,
    run_training, train_state,
)
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.models import DCNConfig, dcn_init, dcn_loss, dcn_params_from_jax  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

WIDTHS = dict(table_rows=500, embed_dim=8, n_cross_layers=2, mlp=(32, 16))
LOSS_TOL = dict(rtol=1e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
SPAWN_TIMEOUT_S = 120


def _train_bundle(cfg: DCNConfig):
    """``build_step("dcn-v2", "train_batch")`` on the CPU with ``cfg`` as
    the arch's full config (``get_arch`` patched for the call)."""
    arch = replace(get_arch("dcn-v2"), full=cfg)
    with mock.patch.object(steps_mod, "get_arch", lambda name: arch):
        return build_step("dcn-v2", "train_batch", device="cpu")


# ---------------------------------------------------------------------------
# the checkpoint manager (tests/test_checkpoint_train.py's, on the port)
# ---------------------------------------------------------------------------
def test_roundtrip_and_prune(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.arange(12.0).reshape(3, 4), "step": 5,
             "nested": [torch.ones(2), {"b": torch.zeros(3)}]}
    for s in (10, 20, 30):
        mgr.save(s, state, blocking=True)
    assert mgr.all_steps() == [20, 30]
    target = {"w": torch.zeros(3, 4), "step": 0,
              "nested": [torch.zeros(2), {"b": torch.zeros(3)}]}
    step, restored = mgr.restore(target)
    assert step == 30
    np.testing.assert_array_equal(restored["w"], np.arange(12.0).reshape(3, 4))
    assert restored["step"] == 5 and isinstance(restored["step"], int)


def test_atomic_no_partial_checkpoint(tmp_path):
    """A .tmp dir (simulated crash mid-save) is never listed as a step."""
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, {"a": torch.ones(3)}, blocking=True)
    os.makedirs(tmp_path / "step_2.tmp")      # crashed save
    (tmp_path / "step_2.tmp" / "leaf_00000.npy").touch()
    assert mgr.all_steps() == [1]
    step, _ = mgr.restore({"a": np.zeros(3)})
    assert step == 1


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.ones((3, 4))}, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"a": np.zeros((4, 4))})


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(7, {"a": torch.full((1000, 100), 3.0)})
    mgr.wait()
    assert mgr.latest_step() == 7


def test_save_snapshots_before_returning(tmp_path):
    """The write on the thread sees the state as it was at save(): the
    snapshot is a copy, even of a CPU tensor."""
    mgr = CheckpointManager(str(tmp_path))
    t = torch.ones(5)
    host = mgr.save(1, {"t": t})
    t.fill_(7.0)
    mgr.wait()
    np.testing.assert_array_equal(mgr.restore({"t": t})[1]["t"], np.ones(5))
    np.testing.assert_array_equal(host["t"], np.ones(5))


def test_bfloat16_leaf_raises_naming_it(tmp_path):
    """A bfloat16 leaf round-trips bit for bit (its bits on disk as the JAX
    package writes them), and restoring it into a leaf of another dtype
    raises a TypeError that names it."""
    emb = torch.tensor([1 / 3, -2.5, 1e-40, float("inf")], dtype=torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": {"emb": emb}}, blocking=True)
    _, back = mgr.restore({"params": {"emb": torch.zeros(4, dtype=torch.bfloat16)}})
    got = back["params"]["emb"]
    assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16),
                                                       emb.view(torch.int16))
    with pytest.raises(TypeError, match="params/emb"):
        mgr.restore({"params": {"emb": torch.zeros(4)}})


def test_failed_async_write_raises_on_wait(tmp_path):
    class Broken(CheckpointManager):
        def _publish(self, tmp, final):
            raise OSError("disk full")

    mgr = Broken(str(tmp_path))
    mgr.save(1, {"a": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()


# ---------------------------------------------------------------------------
# checkpoints read across the two packages
# ---------------------------------------------------------------------------
class Pair(NamedTuple):
    left: object
    right: object


def _cross_tree(lib):
    """Nested dicts (keys out of order), lists, a NamedTuple, None, a Python
    int and float32, int32 and bool leaves, as ``lib`` arrays."""
    rng = np.random.default_rng(4)
    f32 = rng.normal(size=(3, 4)).astype(np.float32)
    i32 = rng.integers(-9, 9, 6).astype(np.int32)
    b = rng.random(5) < 0.5
    return {"z": lib(f32), "a": [lib(i32), {"y": lib(b), "c": None}],
            "pair": Pair(lib(np.float32(2.5) * np.ones(2, np.float32)), None),
            "count": 11, "scalar": lib(np.array(7, np.int32))}


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step}", "manifest.json")) as f:
        return json.load(f)["leaves"]


def _assert_cross_equal(restored, want_np):
    assert restored["count"] == 11 and isinstance(restored["count"], int)
    assert restored["a"][1]["c"] is None and restored["pair"].right is None
    got = [restored["z"], restored["a"][0], restored["a"][1]["y"], restored["pair"].left,
           restored["scalar"]]
    want = [want_np["z"], want_np["a"][0], want_np["a"][1]["y"], want_np["pair"].left,
            want_np["scalar"]]
    for g, w in zip(got, want):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_jax_writes_port_restores(tmp_path):
    JCheckpointManager(str(tmp_path / "j")).save(3, _cross_tree(jnp.asarray), blocking=True)
    target = _cross_tree(lambda a: torch.zeros(a.shape, dtype=torch.from_numpy(
        np.asarray(a)).dtype))
    step, restored = CheckpointManager(str(tmp_path / "j")).restore(target)
    assert step == 3
    _assert_cross_equal(restored, _cross_tree(np.asarray))


def test_port_writes_jax_restores(tmp_path):
    CheckpointManager(str(tmp_path / "t")).save(3, _cross_tree(torch.from_numpy),
                                                blocking=True)
    target = _cross_tree(np.zeros_like)
    step, restored = JCheckpointManager(str(tmp_path / "t")).restore(target)
    assert step == 3
    _assert_cross_equal(restored, _cross_tree(np.asarray))


def test_manifest_keys_equal_jax(tmp_path):
    JCheckpointManager(str(tmp_path / "j")).save(1, _cross_tree(jnp.asarray), blocking=True)
    CheckpointManager(str(tmp_path / "t")).save(1, _cross_tree(torch.from_numpy),
                                                blocking=True)
    j, t = _manifest(tmp_path / "j", 1), _manifest(tmp_path / "t", 1)
    assert j == t  # the same keys, each in the same leaf file
    assert "pair/left" in t and "a/1/y" in t and len(t) == 6


# ---------------------------------------------------------------------------
# DCN-v2: the loss, its gradient and the train kind against JAX
# ---------------------------------------------------------------------------
def _jcfg(multi_hot=1):
    return jrec.DCNConfig(**WIDTHS, multi_hot=multi_hot, impl="xla")


def _tcfg(multi_hot=1, kernel=False):
    return DCNConfig(**WIDTHS, multi_hot=multi_hot, kernel=kernel)


def _batch(seed, b=12, multi_hot=1):
    rng = np.random.default_rng(seed)
    return {"dense": rng.normal(size=(b, 13)).astype(np.float32),
            "sparse_ids": rng.integers(0, 500, (b, 26, multi_hot)).astype(np.int32),
            "labels": rng.integers(0, 2, b).astype(np.int32)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("multi_hot", [1, 4])
def test_dcn_loss_and_gradient_match_jax(multi_hot):
    jp = jrec.dcn_init(jax.random.PRNGKey(2), _jcfg(multi_hot))
    batch = _batch(5, multi_hot=multi_hot)
    jloss, jgrads = jax.value_and_grad(jrec.dcn_loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, _jcfg(multi_hot))
    model = dcn_params_from_jax(_np_tree(jp), _tcfg(multi_hot), "cpu")
    loss = dcn_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    want = dict(dcn_params_from_jax(_np_tree(jgrads), _tcfg(multi_hot), "cpu")
                .named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].detach().numpy(),
                                   rtol=1e-5, atol=1e-8, err_msg=name)


def test_train_steps_match_jax():
    """Three AdamW steps of the train kind == JAX's value_and_grad(dcn_loss)
    plus opt.update, from JAX's weights."""
    jcfg, tcfg = _jcfg(), _tcfg()
    jp = jrec.dcn_init(jax.random.PRNGKey(3), jcfg)
    jopt = jadamw(3e-4)
    jo = jopt.init(jp)
    step = _train_bundle(tcfg)
    state = train_state(dcn_params_from_jax(_np_tree(jp), tcfg, "cpu"), make_optimizer("adamw"))
    params, opt_state = state["params"], state["opt"]
    for k in range(3):
        batch = _batch(20 + k)
        jloss, g = jax.value_and_grad(jrec.dcn_loss)(
            jp, {n: jnp.asarray(v) for n, v in batch.items()}, jcfg)
        jp, jo = jopt.update(g, jo, jp)
        params, opt_state, loss = step.fn(params, opt_state, batch)
        np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    assert int(opt_state["step"]) == int(jo["step"]) == 3
    for tree, jtree in ((params, jp), (opt_state["mu"], jo["mu"]), (opt_state["nu"], jo["nu"])):
        want = dict(dcn_params_from_jax(_np_tree(jtree), tcfg, "cpu").named_parameters())
        for name, t in tree.items():
            np.testing.assert_allclose(t.numpy(), want[name].detach().numpy(), **STEP_TOL,
                                       err_msg=name)


def test_train_step_is_pure():
    cfg = _tcfg()
    step = _train_bundle(cfg)
    state = train_state(dcn_init(cfg, device="cpu"), make_optimizer("adamw"))
    before = {k: v.clone() for k, v in state["params"].items()}
    a = step.fn(state["params"], state["opt"], _batch(1))
    b = step.fn(state["params"], state["opt"], _batch(1))
    assert all(torch.equal(before[k], v) for k, v in state["params"].items())
    assert torch.equal(a[2], b[2]) and all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    assert all(not v.requires_grad for v in a[0].values())


def test_train_meta_matches_jax():
    port = build_step("dcn-v2", "train_batch", device="cpu")
    ref = jax_build_step("dcn-v2", "train_batch", make_local_mesh())
    assert (port.name, port.kind) == (ref.name, ref.kind) == ("dcn-v2:train_batch", "train")
    assert port.meta == ref.meta


def test_train_kind_refuses_k5_and_tf32():
    """K5 has no backward: a multi-hot config with the kernel on raises
    instead of taking another path; the plain bag (kernel off) trains."""
    with pytest.raises(NotImplementedError, match="K5"):
        _train_bundle(_tcfg(4, kernel=True))
    cfg = _tcfg(4)
    step = _train_bundle(cfg)
    state = train_state(dcn_init(cfg, device="cpu"), make_optimizer("adamw"))
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            step.fn(state["params"], state["opt"], _batch(2, multi_hot=4))
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.isfinite(step.fn(state["params"], state["opt"], _batch(2, multi_hot=4))[2])


# ---------------------------------------------------------------------------
# the fault-tolerant loop
# ---------------------------------------------------------------------------
def _dcn_setup(b=16):
    cfg = get_arch("dcn-v2").smoke
    step = _train_bundle(cfg)
    opt = make_optimizer("adamw")

    def init_state():
        return train_state(dcn_init(cfg, device="cpu"), opt)

    def step_fn(state, batch):
        p, o, loss = step.fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, loss

    return step_fn, init_state, lambda start: recsys_batches(cfg, b, seed=9, start_step=start)


def _assert_same_run(res, ref):
    """Every final tensor of ``res`` equals ``ref``'s, bit for bit."""
    for k, v in ref.final_state["params"].items():
        assert torch.equal(res.final_state["params"][k], v), k
    for k in ("mu", "nu"):
        for name, v in ref.final_state["opt"][k].items():
            assert torch.equal(res.final_state["opt"][k][name], v), (k, name)
    assert int(res.final_state["opt"]["step"]) == int(ref.final_state["opt"]["step"])


@pytest.fixture(scope="module")
def dcn_reference():
    step_fn, init_state, data = _dcn_setup()
    return run_training(step_fn, init_state, data, None, LoopConfig(total_steps=12))


def _injector(fail_at: set, raised: threading.Event | None = None):
    def inject(s):
        if s in fail_at:
            fail_at.discard(s)
            if raised is not None:
                raised.set()
            raise RuntimeError("simulated worker loss")
    return inject


def test_loop_failure_recovery_bit_identical(tmp_path, dcn_reference):
    """Failures before any checkpoint (re-init) and after one: the losses
    after recovery and every final tensor equal the uninterrupted run."""
    step_fn, init_state, data = _dcn_setup()
    res = run_training(step_fn, init_state, data, CheckpointManager(str(tmp_path), keep=3),
                       LoopConfig(total_steps=12, ckpt_every=4),
                       failure_injector=_injector({1, 6}))
    ref = dcn_reference.losses
    assert res.restarts == 2 and res.losses == ref[:1] + ref[:6] + ref[4:]
    _assert_same_run(res, dcn_reference)


class HeldRename(CheckpointManager):
    """A manager whose rename of ``step_{hold}`` waits until the failure has
    been raised and the directory has then been read (``wait()`` or
    ``latest_step()``): the rename lands right after that first read."""

    def __init__(self, directory, hold: int, raised: threading.Event, **kw):
        super().__init__(directory, **kw)
        self.hold, self.raised, self.release = hold, raised, threading.Event()

    def _publish(self, tmp, final):
        if final.endswith(f"step_{self.hold}"):
            assert self.release.wait(timeout=60)
        super()._publish(tmp, final)

    def _let_go(self):
        if self.raised.is_set() and not self.release.is_set():
            self.release.set()
            if self._thread is not None:
                self._thread.join()

    def wait(self):
        self._let_go()
        super().wait()

    def latest_step(self):
        out = super().latest_step()
        self._let_go()
        return out


def _jax_style_recovery(ckpt, template):
    """The JAX package's two reads (``launch/train.py:97-104``): the step,
    then ``restore`` with no step, which reads the directory again."""
    last = ckpt.latest_step()
    _, host = ckpt.restore(template)
    return last, host


def test_held_rename_race(tmp_path, dcn_reference):
    """The save of step 8 is still on its thread when the failure at step 9
    is raised. The port waits, reads the step once and restores it: a
    consistent (step, state) pair, and a run bit-identical to the
    uninterrupted one. JAX's two reads on the same manager pair step 4 with
    step 8's state."""
    step_fn, init_state, data = _dcn_setup()
    raised = threading.Event()
    ckpt = HeldRename(str(tmp_path / "port"), 8, raised, keep=3)
    res = run_training(step_fn, init_state, data, ckpt, LoopConfig(total_steps=12, ckpt_every=4),
                       failure_injector=_injector({9}, raised))
    ref = dcn_reference.losses
    assert res.restarts == 1 and res.losses == ref[:9] + ref[8:]
    _assert_same_run(res, dcn_reference)

    state = init_state()
    raised = threading.Event()
    ckpt = HeldRename(str(tmp_path / "jax"), 8, raised, keep=3)
    for s in (4, 8):
        state["opt"]["step"] = torch.tensor(s, dtype=torch.int32)
        ckpt.save(s, state, blocking=(s == 4))
    raised.set()
    last, host = _jax_style_recovery(ckpt, state)
    assert (last, int(host["opt"]["step"])) == (4, 8)   # inconsistent
    raised = threading.Event()
    ckpt = HeldRename(str(tmp_path / "port2"), 8, raised, keep=3)
    for s in (4, 8):
        state["opt"]["step"] = torch.tensor(s, dtype=torch.int32)
        ckpt.save(s, state, blocking=(s == 4))
    raised.set()
    ckpt.wait()
    last = ckpt.latest_step()
    _, host = ckpt.restore(state, step=last)
    assert (last, int(host["opt"]["step"])) == (8, 8)   # consistent


def test_loop_resumes_from_checkpoint(tmp_path, dcn_reference):
    step_fn, init_state, data = _dcn_setup()
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    run_training(step_fn, init_state, data, ckpt, LoopConfig(total_steps=8, ckpt_every=4))
    res = run_training(step_fn, init_state, data, ckpt, LoopConfig(total_steps=12, ckpt_every=4))
    assert res.resumed_from == 8 and len(res.losses) == 4
    assert res.losses == dcn_reference.losses[8:]
    _assert_same_run(res, dcn_reference)


def test_straggler_redispatched_once():
    """A step that sleeps once, past the running median, runs again from the
    state it was given: redispatched == 1 and the run equals one without
    the sleep."""
    opt = adamw(1e-2)
    target = torch.linspace(-1, 1, 16)

    def init_state():
        p = {"w": torch.zeros(16)}
        return {"params": p, "opt": opt.init(p)}

    def make_step(sleep_at):
        def step_fn(state, batch):
            time.sleep(0.02)
            if batch["step"] in sleep_at:
                sleep_at.discard(batch["step"])
                time.sleep(2.0)
            w = state["params"]["w"].detach().requires_grad_()
            loss = torch.sum((w * batch["x"] - target) ** 2)
            (g,) = torch.autograd.grad(loss, [w])
            p, o = opt.update({"w": g}, state["opt"], state["params"])
            return {"params": p, "opt": o}, loss.detach()
        return step_fn

    def data(start):
        s = start
        while True:
            yield {"step": s, "x": torch.full((16,), 1.0 + 0.1 * s)}
            s += 1

    cfg = LoopConfig(total_steps=12, straggler_factor=25.0, min_steps_for_median=8)
    ref = run_training(make_step(set()), init_state, data, None, cfg)
    res = run_training(make_step({10}), init_state, data, None, cfg)
    assert (ref.redispatched, res.redispatched) == (0, 1)
    assert res.losses == ref.losses
    assert torch.equal(res.final_state["params"]["w"], ref.final_state["params"]["w"])


# ---------------------------------------------------------------------------
# peel_with_restarts and restore_elastic, worlds 1 and 2
# ---------------------------------------------------------------------------
def _triple(r) -> tuple:
    return ranks.bits(r["density"]), int(r["passes"]), np.asarray(r["mask"]).tobytes()


@pytest.fixture(scope="module")
def jax_peels(tmp_path_factory) -> dict:
    """JAX's ``peel_with_restarts`` on a 1-device mesh for every graph and
    failure point of the scripted sequence."""
    root = tmp_path_factory.mktemp("jax_peels")
    mesh = make_mesh_auto((1, 1), ("data", "model"))
    out = {}
    for gname, g in ranks.graphs(jgen).items():
        _, _, passes = pbahmani(ranks.graphs(generators)[gname], eps=ranks.EPS, device="cpu")
        for fail in ranks.fail_points(passes):
            ck = JCheckpointManager(str(root / f"{gname}_{fail}"), keep=2)
            out[(gname, fail)] = jax_peel_with_restarts(g, mesh, eps=ranks.EPS, ckpt=ck,
                                                        fail_at_pass=fail)
    return out


@pytest.mark.parametrize("gname", ["planted", "rmat"])
def test_peel_with_restarts_world1_equals_jax(tmp_path, jax_peels, gname):
    g = ranks.graphs(generators)[gname]
    want = pbahmani(g, eps=ranks.EPS, device="cpu")
    mesh = make_mesh(device="cpu")
    for fail in ranks.fail_points(want[2]):
        before = collective.collectives
        r = peel_with_restarts(g, mesh, ranks.EPS, CheckpointManager(str(tmp_path / str(fail))),
                               fail_at_pass=fail)
        assert _triple(r) == _triple(jax_peels[(gname, fail)]) == _triple(
            dict(density=want[0], mask=want[1], passes=want[2])), fail
        assert collective.collectives - before == r["passes"] + 1  # the degrees', one a pass


def test_peel_with_restarts_counts_restores(tmp_path, monkeypatch):
    """One restore at the failure point and none without one; the kernel
    path (plain versions on the CPU) gives the same triple."""
    g = ranks.graphs(generators)["planted"]
    calls = []
    real = CheckpointManager.restore
    monkeypatch.setattr(CheckpointManager, "restore",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    mesh = make_mesh(device="cpu")
    off = peel_with_restarts(g, mesh, ranks.EPS, CheckpointManager(str(tmp_path / "a")),
                             fail_at_pass=2, kernel=False)
    assert len(calls) == 1
    on = peel_with_restarts(g, mesh, ranks.EPS, CheckpointManager(str(tmp_path / "b")),
                            kernel=True)
    assert len(calls) == 1 and _triple(on) == _triple(off)


def test_peel_resumes_from_jax_checkpoints(tmp_path, jax_peels):
    """JAX's peel_with_restarts writes a checkpoint a pass; with the steps
    after pass 2 deleted, the port resumes from pass 2 and ends with JAX's
    triple."""
    import shutil

    jg = ranks.graphs(jgen)["planted"]
    mesh = make_mesh_auto((1, 1), ("data", "model"))
    d = tmp_path / "jax"
    want = jax_peel_with_restarts(jg, mesh, eps=ranks.EPS,
                                  ckpt=JCheckpointManager(str(d), keep=100))
    ck = CheckpointManager(str(d), keep=100)
    for s in ck.all_steps():
        if s > 2:
            shutil.rmtree(d / f"step_{s}")
    assert ck.latest_step() == 2
    before = collective.collectives
    got = peel_with_restarts(ranks.graphs(generators)["planted"], make_mesh(device="cpu"),
                             ranks.EPS, ck)
    assert _triple(got) == _triple(want)
    assert collective.collectives - before == 1 + want["passes"] - 2  # passes 3.. only


def test_restore_elastic_onto_cpu(tmp_path):
    state = ranks.elastic_state(torch)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(ranks.ELASTIC_STEP, state)   # async: restore_elastic waits for it
    template = {"w": torch.zeros(6, 4), "mask": torch.zeros(9, dtype=torch.bool),
                "step": torch.zeros((), dtype=torch.int32),
                "rows": [torch.zeros(5, dtype=torch.int32), torch.ones(2)]}
    step, got = restore_elastic(ckpt, template, device="cpu")
    assert step == ranks.ELASTIC_STEP
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        assert a.dtype == b.dtype and a.device.type == "cpu" and torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            restore_elastic(ckpt, template)


@pytest.fixture(scope="module")
def world2(tmp_path_factory) -> list[dict]:
    tmp = tmp_path_factory.mktemp("train_world2")
    CheckpointManager(str(tmp / "ckpt" / "elastic")).save(
        ranks.ELASTIC_STEP, ranks.elastic_state(torch), blocking=True)
    return ranks.spawn(2, tmp, tmp / "ckpt", SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("gname", ["planted", "rmat"])
def test_peel_with_restarts_world2_equals_jax(world2, jax_peels, gname):
    """Two gloo ranks, each with its own checkpoint directory: every rank's
    triple equals JAX's, with one collective for the degrees and one a
    pass."""
    _, _, passes = pbahmani(ranks.graphs(generators)[gname], eps=ranks.EPS, device="cpu")
    for fail in ranks.fail_points(passes):
        want = _triple(jax_peels[(gname, fail)])
        for out in world2:
            key = f"peel/{gname}/{fail}"
            got = (int(out[key][0]), int(out[key][1]), out[key + "/mask"].tobytes())
            assert got == want, (fail, key)
            assert int(out[key][2]) == int(out[key][1]) + 1


def test_restore_elastic_onto_gloo_mesh(world2):
    want = ranks.elastic_state(torch)
    for out in world2:
        assert int(out["elastic/step"]) == ranks.ELASTIC_STEP
        assert int(out["elastic/on_mesh_device"]) == 1
        for k in ("w", "mask", "step"):
            np.testing.assert_array_equal(out[f"elastic/{k}"], want[k].numpy())
        np.testing.assert_array_equal(out["elastic/rows0"], want["rows"][0].numpy())


def test_multi_hot_train_loop_on_plain_bag(tmp_path):
    """A multi-hot config trains with the kernel off, through the loop with a
    failure, bit-identical to its uninterrupted run."""
    cfg = replace(get_arch("dcn-v2").smoke, multi_hot=4, kernel=False)
    step = _train_bundle(cfg)
    opt = make_optimizer("adamw")

    def step_fn(state, batch):
        p, o, loss = step.fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, loss

    def init_state():
        return train_state(dcn_init(cfg, device="cpu"), opt)

    data = lambda s: recsys_batches(cfg, 8, seed=2, start_step=s)  # noqa: E731
    cfg_loop = LoopConfig(total_steps=6, ckpt_every=2)
    ref = run_training(step_fn, init_state, data, None, cfg_loop)
    res = run_training(step_fn, init_state, data, CheckpointManager(str(tmp_path)), cfg_loop,
                       failure_injector=_injector({3}))
    assert res.restarts == 1 and res.losses == ref.losses[:3] + ref.losses[2:]
    _assert_same_run(res, ref)
