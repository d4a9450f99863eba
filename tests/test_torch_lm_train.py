"""The port's LM training against the JAX package on the CPU: ``loss_fn``
and its gradient (GQA with bias, MLA, the MoE router and ``aux``, the MTP
loss), the ``train`` kind over three steps (microbatches with float32 and
bfloat16 accumulation, AdamW and Adafactor), remat and the flash k-block
recompute (bitwise no-ops), the step's purity, the LM twins of
tests/test_checkpoint_train.py's loop tests, and bfloat16 / LM checkpoints
read across the two packages.

Inputs are made from numpy seeds; JAX's parameters (``init_params(PRNGKey
(seed), cfg)``) are carried across with ``lm_params_from_jax``.
Tolerances:
  * ``loss_fn``: the loss within rtol 1e-5, each gradient leaf within 1e-4
    normwise (float32 products and sums in another order: ~1e-6 seen);
  * the train kind, each of three steps from the same state (JAX's step
    before it, carried across exactly; a chained run would hold the
    trajectory, which a router's near-tie or an Adafactor sign flip
    (below) sends apart, not the step):
    - float32 accumulation (qwen2.5, mistral-nemo, phi3; AdamW): the loss
      rtol 1e-5, parameters rtol 1e-5 with atol 1e-5 (about lr / 30: the
      key bias's gradient is zero in exact arithmetic, so AdamW steps it on
      rounding noise in both packages), moments rtol 1e-4 with an atol of
      1e-6 of the moment tree's largest entry (the key bias's moments are
      that noise);
    - bfloat16 accumulation (grok-1, deepseek-v3; Adafactor, 8
      microbatches): the loss rtol 1e-5, each parameter leaf within 2e-3
      normwise with at most 0.1 % of its entries off by more than 1e-4, and
      each second moment within 2e-3 normwise. A gradient entry that rounds
      to the other neighbouring bfloat16 moves its moment by 2^-8, and
      Adafactor's first updates are about 10 lr whatever the gradient's
      size, so an entry near zero whose sign flips moves by 2e-2 (seen: one
      of grok's 65,536 ``wo`` entries at step 1, 8.7e-4 normwise; moments
      6.2e-4 at most);
  * the tiny loop's losses against JAX's loop: rtol 1e-5;
  * everything else bit for bit: remat on == off, the flash recompute on ==
    off, a step run twice, a recovered loop == the uninterrupted one, and
    checkpoints (bfloat16 included) in either direction.
"""
import json
from dataclasses import replace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_lm import bf16, jax_params, np_tree, port_model, tokens, torch_cfg  # noqa: E402
from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs.common import Shape as JShape  # noqa: E402
from repro.data import lm_token_batches as jlm_token_batches  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.launch.train import LoopConfig as JLoopConfig  # noqa: E402
from repro.launch.train import run_training as jrun_training  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.common import Shape  # noqa: E402
from repro_torch.data import lm_token_batches  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    LoopConfig, build_step, make_optimizer, restore_elastic, run_training, train_state,
)
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.models import (  # noqa: E402
    LM_STATE_LAYOUT, Transformer, layers, lm_state_from_jax, lm_state_to_jax, loss_fn,
)
from repro_torch.optim import adamw  # noqa: E402

LM_ARCHS = ["qwen2.5-3b", "mistral-nemo-12b", "phi3-mini-3.8b", "grok-1-314b",
            "deepseek-v3-671b"]
LOSS_RTOL, GRAD_NORMWISE = 1e-5, 1e-4
F32_STEP = dict(loss_rtol=1e-5, p_rtol=1e-5, p_atol=1e-5, m_rtol=1e-4, m_atol_frac=1e-6)
BF16_STEP = dict(loss_rtol=1e-5, p_normwise=2e-3, p_atol=1e-4, p_share=1e-3,
                 m_normwise=2e-3)
TRAIN_SEQ, TRAIN_GB = 16, 8      # train_4k cut: 8 rows, one a microbatch at m = 8


@pytest.fixture(autouse=True)
def _highest():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(before)


def _np(tree):
    """A tree of tensors / JAX arrays as float64-comparable numpy."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy() if tree.is_floating_point() else tree.numpy()
    a = np.asarray(tree)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _pairs(got: dict, want: dict, path=()):
    """(key path, port leaf, JAX leaf) over JAX's tree."""
    for k, w in want.items():
        if isinstance(w, dict):
            yield from _pairs(got[k], w, path + (k,))
        else:
            yield "/".join(path + (k,)), got[k], w


def _normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / scale) if scale else float(np.linalg.norm(got))


def _port_grads(jcfg, toks, labs):
    cfg = torch_cfg(jcfg)
    model = port_model(jcfg)
    leaves = {k: v.detach().requires_grad_() for k, v in model.named_parameters()}
    loss = loss_fn(model, torch.as_tensor(toks), torch.as_tensor(labs), cfg, params=leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), lm_state_to_jax(
        {"params": {k: _np(g) for k, g in zip(leaves, grads)}, "opt": {}})["params"]


def _check_loss_and_grads(jcfg, toks, labs):
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, jnp.asarray(toks), jnp.asarray(labs), jcfg)))(jax_params(jcfg))
    loss, grads = _port_grads(jcfg, toks, labs)
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    for key, got, want in _pairs(grads, _np(jgrads)):
        assert got.shape == want.shape, key
        assert _normwise(got, want) <= GRAD_NORMWISE, (key, _normwise(got, want))


# ---------------------------------------------------------------------------
# loss_fn and its gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_gradient_match_jax(arch):
    """The loss (cross-entropy, deepseek's 0.1 x MTP, the MoE archs'
    router_aux_coef x aux) and every parameter's gradient at SMOKE, float32,
    against jax.value_and_grad of the reference's loss_fn."""
    jcfg = jget_arch(arch).smoke
    _check_loss_and_grads(jcfg, tokens((2, 16), jcfg.vocab, seed=3),
                          tokens((2, 16), jcfg.vocab, seed=4))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v3-671b"])
def test_loss_and_gradient_on_the_flash_path_match_jax(arch):
    """At 2,048 positions both packages run chunked flash attention (two q
    blocks of 1,024 by four k blocks of 512) in the trunk and, for
    deepseek, in the MTP block: the loss and gradients as above."""
    jcfg = replace(jget_arch(arch).smoke, flash_q_chunk=1024, flash_k_chunk=512)
    _check_loss_and_grads(jcfg, tokens((1, 2048), jcfg.vocab, seed=5),
                          tokens((1, 2048), jcfg.vocab, seed=6))


def test_mtp_loss_matters_and_aux_is_summed():
    """deepseek's loss without its MTP term is the cross-entropy plus the
    routers' aux, as in JAX; with it the loss moves by 0.1 x the MTP loss."""
    jcfg = jget_arch("deepseek-v3-671b").smoke
    toks, labs = tokens((2, 12), jcfg.vocab, seed=7), tokens((2, 12), jcfg.vocab, seed=8)
    for mtp in (True, False):
        c = replace(jcfg, mtp=mtp)
        want = jt.loss_fn(jax_params(jcfg), jnp.asarray(toks), jnp.asarray(labs), c)
        got = loss_fn(port_model(jcfg), torch.as_tensor(toks), torch.as_tensor(labs),
                      torch_cfg(c))
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# remat and the flash k-block recompute are no-ops, bit for bit
# ---------------------------------------------------------------------------
def _loss_grads(model, cfg, toks, labs):
    leaves = {k: v.detach().requires_grad_() for k, v in model.named_parameters()}
    loss = loss_fn(model, toks, labs, cfg, params=leaves)
    return [loss.detach(), *torch.autograd.grad(loss, list(leaves.values()))]


@pytest.mark.parametrize("arch,seq", [("qwen2.5-3b", 2048), ("deepseek-v3-671b", 2048),
                                      ("grok-1-314b", 32)])
def test_remat_on_equals_off_bitwise(arch, seq):
    """Per-block remat (a block's forward again in the backward) gives the
    loss and every gradient bit for bit as without it, and the block's MoE
    recompute reads its group sizes once more."""
    cfg = replace(get_arch(arch).smoke, flash_q_chunk=1024, flash_k_chunk=512)
    model = port_model(jget_arch(arch).smoke, seed=1)
    rng = np.random.default_rng(2)
    toks, labs = (torch.as_tensor(rng.integers(0, cfg.vocab, (1, seq))) for _ in range(2))
    from repro_torch.models import moe
    real, reads = moe._ragged_swiglu, []

    def counted(*a):
        reads.append(1)
        return real(*a)

    out = {}
    with mock.patch.object(moe, "_ragged_swiglu", counted):
        for remat in (False, True):
            reads.clear()
            out[remat] = _loss_grads(model, replace(cfg, remat=remat), toks, labs)
            out[remat, "reads"] = len(reads)
    assert all(torch.equal(a, b) for a, b in zip(out[False], out[True]))
    assert out[True, "reads"] == 2 * out[False, "reads"] == 2 * cfg.n_moe_layers


def test_flash_recompute_on_equals_off_bitwise():
    """flash_attention under autograd recomputes each k-block in the
    backward; with the recompute replaced by a direct call, the output and
    the gradients of q, k and v are the same bits. Under no_grad (and
    inference_mode) no k-block is checkpointed."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, 256, 4, 16)).astype(np.float32))
               for _ in range(3))
    g_out = torch.as_tensor(rng.normal(size=(2, 256, 4, 16)).astype(np.float32))

    def run():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = layers.flash_attention(*leaves, q_chunk=64, k_chunk=32)
        return [o.detach(), *torch.autograd.grad(o, leaves, g_out)]

    calls = []
    real = layers.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    with mock.patch.object(layers, "checkpoint", counted):
        with_recompute = run()
        n = len(calls)
        with torch.no_grad():
            layers.flash_attention(q, k, v, q_chunk=64, k_chunk=32)
        assert len(calls) == n == 4 * 8
    with mock.patch.object(layers, "checkpoint", lambda fn, *a, **kw: fn(*a)):
        without = run()
    assert all(torch.equal(a, b) for a, b in zip(with_recompute, without))


# ---------------------------------------------------------------------------
# the train kind
# ---------------------------------------------------------------------------
def _train_steps(arch, seq=TRAIN_SEQ, gb=TRAIN_GB):
    """Both packages' train_4k steps with SMOKE as arch.full and the shape
    cut to ``[gb, seq]``."""
    ja, ta = jget_arch(arch), get_arch(arch)
    jarch = replace(ja, full=ja.smoke, shapes=(JShape("train_4k", "train",
                                                      dict(seq_len=seq, global_batch=gb)),))
    tarch = replace(ta, full=ta.smoke, shapes=(Shape("train_4k", "train",
                                                     dict(seq_len=seq, global_batch=gb)),))
    with mock.patch.object(jsteps, "get_arch", lambda _: jarch):
        jstep = jsteps.build_step(arch, "train_4k", make_local_mesh())
    with mock.patch.object(steps_mod, "get_arch", lambda _: tarch):
        tstep = build_step(arch, "train_4k", device="cpu")
    return ja, jstep, tstep


def _opt_np(opt: dict) -> dict:
    return {k: _np(v) if isinstance(v, dict) else v for k, v in opt.items()}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_kind_matches_jax(arch):
    """Three steps of the train kind (the arch's microbatches, accumulation
    dtype and optimizer) == JAX's build_step(arch, "train_4k",
    make_local_mesh()) at SMOKE, each step from the same state (JAX's
    previous step carried across exactly): the loss, every parameter and
    the optimizer's moments (tolerances in the module docstring)."""
    ja, jstep, tstep = _train_steps(arch)
    assert tstep.cfg.flash_k_chunk == TRAIN_SEQ
    assert tstep.cfg.flash_q_chunk == TRAIN_SEQ   # min(1024, seq) and seq agree here
    jcfg = ja.smoke
    p = jax_params(jcfg)
    o = jsteps.make_optimizer(ja.optimizer).init(p)
    fn = jax.jit(jstep.fn)
    data = lm_token_batches(jcfg.vocab, TRAIN_GB, TRAIN_SEQ, seed=2)
    bf = ja.grad_accum_dtype == "bfloat16"
    tol = BF16_STEP if bf else F32_STEP
    for i in range(3):
        b = next(data)
        state = _port_state({"params": p, "opt": o})
        tp, to, loss = tstep.fn(state["params"], state["opt"], b)
        p, o, jloss = fn(p, o, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=tol["loss_rtol"])
        got = lm_state_to_jax({"params": _np(tp), "opt": _opt_np(to)})
        assert int(to["step"]) == int(o["step"]) == i + 1
        for key, g, w in _pairs(got["params"], _np(p)):
            if bf:
                off = float((np.abs(g - w) > tol["p_atol"]).mean())
                assert _normwise(g, w) <= tol["p_normwise"] and off <= tol["p_share"], (
                    i, key, _normwise(g, w), off)
            else:
                np.testing.assert_allclose(g, w, rtol=tol["p_rtol"], atol=tol["p_atol"],
                                           err_msg=f"step {i}: {key}")
        want_opt = _opt_np(_np(o))
        for moment in (k for k in want_opt if k != "step"):
            pairs = list(_pairs(got["opt"][moment], want_opt[moment]))
            largest = max(np.abs(w).max() for _, _, w in pairs)
            for key, g, w in pairs:
                if bf:
                    assert _normwise(g, w) <= tol["m_normwise"], (i, moment, key, _normwise(g, w))
                else:
                    np.testing.assert_allclose(g, w, rtol=tol["m_rtol"],
                                               atol=tol["m_atol_frac"] * largest,
                                               err_msg=f"step {i}: {moment}/{key}")


def test_train_kind_layouts_and_accumulators():
    """The configs the step runs: zero3 archs (qwen2.5, phi3) chunk queries
    and keys at min(1024, seq), the others run one q block of the whole
    sequence; the accumulator is the arch's grad_accum_dtype."""
    for arch in LM_ARCHS:
        step = build_step(arch, "train_4k", device="cpu")
        want_q = 1024 if get_arch(arch).train_layout == "zero3" else 4096
        assert (step.cfg.flash_q_chunk, step.cfg.flash_k_chunk) == (want_q, 1024), arch
        assert step.kind == "train" and step.meta["tokens"] == 256 * 4096
    assert [get_arch(a).microbatches for a in LM_ARCHS] == [1, 4, 1, 8, 8]
    assert [get_arch(a).grad_accum_dtype for a in LM_ARCHS] == ["float32"] * 3 + ["bfloat16"] * 2


@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v3-671b", "mistral-nemo-12b"])
def test_train_step_is_pure(arch):
    """The step changes nothing it is given (parameters, optimizer state,
    batch) and, run twice from one state, gives the same bits."""
    ja, _, tstep = _train_steps(arch)
    state = train_state(port_model(ja.smoke), make_optimizer(ja.optimizer))
    batch = next(lm_token_batches(ja.smoke.vocab, TRAIN_GB, TRAIN_SEQ, seed=4))
    before = jax.tree.map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                          else np.copy(x) if isinstance(x, np.ndarray) else x, (state, batch))
    runs = [tstep.fn(state["params"], state["opt"], batch) for _ in range(2)]
    same = jax.tree.map(lambda a, b: bool((a == b).all()) if hasattr(a, "shape") else a == b,
                        (state, batch), before)
    assert all(jax.tree.leaves(same))
    a, b = (jax.tree.leaves((p, o, loss)) for p, o, loss in runs)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the LM twins of tests/test_checkpoint_train.py's loop tests
# ---------------------------------------------------------------------------
TINY = jt.TransformerConfig(name="t", n_layers=2, d_model=16, n_heads=2, n_kv_heads=2,
                            d_ff=32, vocab=64)


def _tiny_setup(tmp_path, subdir):
    """tests/test_checkpoint_train.py's _tiny_setup on the port: JAX's
    PRNGKey(0) weights, AdamW(1e-2, no decay), loss_fn's gradient; its
    checkpoints in JAX's layout."""
    cfg = torch_cfg(TINY)
    opt = adamw(1e-2, weight_decay=0.0)
    skeleton = Transformer(cfg, device="meta")

    def init_state():
        return train_state(port_model(TINY), opt)

    def step(state, batch):
        toks, labs = torch.as_tensor(batch["tokens"]), torch.as_tensor(batch["labels"])
        loss, grads = steps_mod._value_and_grad(
            lambda leaves: loss_fn(skeleton, toks, labs, cfg, leaves), state["params"])
        p2, o2 = opt.update(grads, state["opt"], state["params"])
        return {"params": p2, "opt": o2}, loss

    def data(start):
        return lm_token_batches(64, 2, 8, seed=9, start_step=start)

    ckpt = (CheckpointManager(str(tmp_path / subdir), keep=3, layout=LM_STATE_LAYOUT)
            if subdir else None)
    return step, init_state, data, ckpt


def _same_state(a, b) -> bool:
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def tiny_reference(tmp_path_factory):
    step, init_state, data, _ = _tiny_setup(tmp_path_factory.mktemp("ref"), "")
    return run_training(step, init_state, data, None, LoopConfig(total_steps=12, ckpt_every=4,
                                                                 log_every=100))


def test_loop_failure_recovery_bit_identical(tmp_path, tiny_reference):
    """Two injected failures (steps 6 and 9) with async checkpoints every 4
    steps: the run restarts twice and ends with the uninterrupted run's
    losses and state, bit for bit; its checkpoints hold JAX's keys."""
    step, init_state, data, ckpt = _tiny_setup(tmp_path, "a")
    fail_at = {6, 9}

    def injector(s):
        if s in fail_at:
            fail_at.discard(s)
            raise RuntimeError("simulated worker loss")

    res = run_training(step, init_state, data, ckpt, LoopConfig(total_steps=12, ckpt_every=4,
                                                                log_every=100),
                       failure_injector=injector)
    ref = tiny_reference
    assert res.restarts == 2
    assert res.losses == ref.losses[:6] + ref.losses[4:9] + ref.losses[8:]
    assert _same_state(res.final_state, ref.final_state)
    keys = json.load(open(tmp_path / "a" / "step_12" / "manifest.json"))["leaves"]
    assert "params/dense_blocks/attn/wq" in keys and "opt/mu/dense_blocks/wg" in keys


def test_loop_resumes_from_checkpoint(tmp_path, tiny_reference):
    """A second invocation resumes at step 8 (not from zero) and ends where
    the uninterrupted 12-step run ends, bit for bit; restore_elastic puts
    the newest checkpoint on the CPU in the state's dtypes."""
    step, init_state, data, ckpt = _tiny_setup(tmp_path, "b")
    run_training(step, init_state, data, ckpt, LoopConfig(total_steps=8, ckpt_every=4))
    res = run_training(step, init_state, data, ckpt, LoopConfig(total_steps=12, ckpt_every=4))
    assert res.resumed_from == 8 and len(res.losses) == 4
    assert res.losses == tiny_reference.losses[8:]
    assert _same_state(res.final_state, tiny_reference.final_state)
    last, state = restore_elastic(ckpt, init_state(), device="cpu")
    assert last == 12 and _same_state(state, tiny_reference.final_state)


def test_loop_losses_match_jax(tmp_path, tiny_reference):
    """The tiny loop's 12 losses == the JAX package's run_training of the
    same setup (tests/test_checkpoint_train.py's _tiny_setup) within rtol
    1e-5."""
    opt = jadamw(1e-2, weight_decay=0.0)

    def init_state():
        p = jt.init_params(jax.random.PRNGKey(0), TINY)
        return {"params": p, "opt": opt.init(p)}

    @jax.jit
    def step(state, batch):
        toks, labs = jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"])
        loss, g = jax.value_and_grad(lambda q: jt.loss_fn(q, toks, labs, TINY))(state["params"])
        p2, o2 = opt.update(g, state["opt"], state["params"])
        return {"params": p2, "opt": o2}, loss

    ref = jrun_training(step, init_state,
                        lambda s: jlm_token_batches(64, 2, 8, seed=9, start_step=s), None,
                        JLoopConfig(total_steps=12, ckpt_every=4, log_every=100))
    np.testing.assert_allclose(tiny_reference.losses, ref.losses, rtol=1e-5)


# ---------------------------------------------------------------------------
# bfloat16 and LM checkpoints across the two packages
# ---------------------------------------------------------------------------
def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jax_state(arch, dtype_bf16: bool, steps: int = 1):
    """JAX's ``{"params", "opt"}`` of an arch's SMOKE config (bfloat16 if
    asked) after ``steps`` updates of its optimizer on random gradients."""
    jcfg = bf16(jget_arch(arch).smoke) if dtype_bf16 else jget_arch(arch).smoke
    opt = jsteps.make_optimizer(jget_arch(arch).optimizer)
    p = jax_params(jcfg)
    o = opt.init(p)

    @jax.jit
    def update(p, o, key):
        g = jax.tree.map(lambda x: jax.random.normal(key, x.shape, x.dtype), p)
        return opt.update(g, o, p)

    for i in range(steps):
        p, o = update(p, o, jax.random.PRNGKey(i))
    return jcfg, {"params": p, "opt": o}


def _port_state(jstate: dict) -> dict:
    """The same state in the port's layout as CPU tensors (bfloat16 kept)."""
    def tensor(a):
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return lm_state_from_jax(jax.tree.map(tensor, np_tree(jstate)))


def _assert_same_bits(got, want):
    la, lb = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


def test_bfloat16_round_trip(tmp_path):
    """bfloat16 tensors (with a float32 and an int leaf) come back bit for
    bit, NaN, infinities and subnormals included, by an async save."""
    w = torch.tensor([1 / 3, -0.0, float("inf"), float("nan"), 1e-40, 3e38],
                     dtype=torch.bfloat16)
    state = {"w": w, "m": torch.randn(4, 3, dtype=torch.bfloat16),
             "f": torch.ones(2), "step": torch.tensor(7, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path))
    host = mgr.save(1, state)
    mgr.wait()
    assert host["w"].dtype == np.dtype("V2")
    _, back = mgr.restore(state)
    for k in state:
        got = torch.as_tensor(back[k])
        assert got.dtype == state[k].dtype and np.array_equal(_bits(got), _bits(state[k])), k


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v3-671b"])
def test_port_restores_jax_lm_checkpoint_bitwise(tmp_path, arch):
    """A JAX-written bfloat16 LM train state (AdamW's or Adafactor's after
    one update) restores into the port's state, through LM_STATE_LAYOUT and
    restore_elastic, bit for bit."""
    _, jstate = _jax_state(arch, dtype_bf16=True)
    JCheckpointManager(str(tmp_path), async_save=False).save(1, jstate)
    want = _port_state(jstate)
    template = jax.tree.map(torch.zeros_like, want)
    mgr = CheckpointManager(str(tmp_path), layout=LM_STATE_LAYOUT)
    step, host = mgr.restore(template)
    assert step == 1
    _assert_same_bits(jax.tree.map(torch.as_tensor, host), want)
    _, placed = restore_elastic(mgr, template, device="cpu")
    _assert_same_bits(placed, want)


@pytest.mark.parametrize("arch,dtype_bf16", [("qwen2.5-3b", True), ("deepseek-v3-671b", True),
                                             ("grok-1-314b", False)])
def test_port_lm_checkpoint_files_equal_jax(tmp_path, arch, dtype_bf16):
    """The port's checkpoint of a state and the JAX package's of the same
    state: the same leaf keys and file names, and every .npy file the same
    bytes (bfloat16 as |V2). The JAX package restores the port's float32
    files as its own."""
    _, jstate = _jax_state(arch, dtype_bf16)
    JCheckpointManager(str(tmp_path / "jax"), async_save=False).save(2, jstate)
    CheckpointManager(str(tmp_path / "port"), async_save=False,
                      layout=LM_STATE_LAYOUT).save(2, _port_state(jstate))
    man = {who: json.load(open(tmp_path / who / "step_2" / "manifest.json"))["leaves"]
           for who in ("jax", "port")}
    assert man["jax"] == man["port"] and len(man["jax"]) > 20
    for fn in man["jax"].values():
        a = (tmp_path / "jax" / "step_2" / fn).read_bytes()
        assert a == (tmp_path / "port" / "step_2" / fn).read_bytes(), fn
    if not dtype_bf16:
        target = jax.tree.map(np.zeros_like, np_tree(jstate))
        _, back = JCheckpointManager(str(tmp_path / "port")).restore(target)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree(jstate))):
            assert np.array_equal(a, b)


def test_jax_restore_of_bfloat16_is_the_references_fault(tmp_path):
    """The reference's fault the port does not copy: the JAX package writes
    a bfloat16 leaf as |V2 and its restore hands back that |V2 array, which
    jnp.asarray refuses. The port reads the same file into bfloat16 bit for
    bit, and the JAX package reads the port's file as it reads its own."""
    w = jnp.arange(4, dtype=jnp.bfloat16) / 3
    JCheckpointManager(str(tmp_path / "jax"), async_save=False).save(1, {"w": w})
    _, back = JCheckpointManager(str(tmp_path / "jax")).restore({"w": np.zeros(4)})
    assert back["w"].dtype == np.dtype("V2")
    with pytest.raises(TypeError, match="V2"):
        jnp.asarray(back["w"])
    want = torch.from_numpy(np.asarray(w).view(np.int16).copy()).view(torch.bfloat16)
    _, got = CheckpointManager(str(tmp_path / "jax")).restore(
        {"w": torch.zeros(4, dtype=torch.bfloat16)})
    assert np.array_equal(_bits(got["w"]), _bits(want))
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(1, {"w": want})
    _, theirs = JCheckpointManager(str(tmp_path / "port")).restore({"w": np.zeros(4)})
    assert np.array_equal(theirs["w"].view(np.int16), back["w"].view(np.int16))


def test_lm_state_layout_round_trips_every_arch():
    """lm_state_to_jax then lm_state_from_jax is the identity on each arch's
    SMOKE train state (AdamW and Adafactor trees), and the JAX layout has
    exactly JAX's keys and shapes."""
    for arch in LM_ARCHS:
        jcfg = jget_arch(arch).smoke
        opt = make_optimizer(jget_arch(arch).optimizer)
        state = train_state(port_model(jcfg), opt)
        jax_tree = lm_state_to_jax(state)
        want = jax.eval_shape(lambda: {"params": jt.init_params(jax.random.PRNGKey(0), jcfg),
                                       "opt": jsteps.make_optimizer(
                                           jget_arch(arch).optimizer).init(
                                           jt.init_params(jax.random.PRNGKey(0), jcfg))})
        got_shapes = jax.tree.map(lambda t: tuple(t.shape), jax_tree)
        assert got_shapes == jax.tree.map(lambda s: tuple(s.shape), want), arch
        back = lm_state_from_jax(jax_tree)
        assert back["params"].keys() == state["params"].keys()
        assert _same_state(back, state), arch
