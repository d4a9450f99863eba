"""The port's transformer family against the JAX package: the layers
(``rms_norm``, ``apply_rope``, ``swiglu``, ``_attend``, ``flash_attention``),
the MoE (``_route``, ``moe_dense``, ``moe_ep``, ``moe_tp``), the model
(``forward``, ``init_cache``, ``decode_step``, the parameter counts) and
``lm_params_from_jax``, at the JAX tests' own configs
(tests/test_models_lm.py's ``gqa_cfg`` and ``mla_moe_cfg``) and every arch's
``SMOKE`` config. JAX's parameters come from ``init_params(PRNGKey(0),
cfg)`` and are carried across; inputs are made from a seed with numpy.

Tolerances. Float32: rtol 1e-5, atol 1e-5 (products and sums in another
order by each library; measured at most 4e-6 absolute on the SMOKE
logits). bfloat16 copies of two SMOKE configs (qwen2.5, GQA, and deepseek,
MLA + MoE): logits, cache and the MoE's aux within 3e-2 normwise (about
eight bfloat16 roundings, 2^-8 each: XLA keeps float32 inside its fused
elementwise chains where torch rounds after each op, so the two round at
different places; measured 0.8-1.4e-2), and greedy tokens need not agree
there. The int8 decode cache: entries within 1 (a float32 value an ulp
either side of a rounding boundary) and scales within rtol 2e-6 (a scale
is its key's largest entry over 127, and the float32 keys differ by an ulp
or two: measured 1.06e-6). Rotary embeddings are held against JAX
compiled, as its forward and decode run them: its inverse frequencies are
folded into constants there, and the port computes the same bits
(``layers.rope_freqs``). The port's own twins of
the JAX tests keep their tolerances.
"""
import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_lm import (  # noqa: E402
    bf16, jax_decode, jax_forward, jax_params, jnp_np, np_tree, port_model, to_np, tokens,
    torch_cfg, torch_moe,
)
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.moe_tp import moe_tp as jmoe_tp  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm_params_from_jax  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.moe_tp import moe_tp as tmoe_tp  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_NORMWISE = 3e-2
LM_ARCHS = ["qwen2.5-3b", "mistral-nemo-12b", "phi3-mini-3.8b", "grok-1-314b",
            "deepseek-v3-671b"]

GQA = jt.TransformerConfig(name="t", n_layers=3, d_model=32, n_heads=4, n_kv_heads=2,
                           d_ff=64, vocab=101, qkv_bias=True, rope_theta=1e4)
MLA_MOE = jt.TransformerConfig(
    name="t2", n_layers=4, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
    vocab=101, attn="mla", q_lora_rank=24, kv_lora_rank=16, qk_nope_dim=8,
    qk_rope_dim=4, v_head_dim=8, n_dense_layers=2, mtp=True,
    moe=jmoe.MoEConfig(n_experts=4, top_k=2, d_model=32, d_ff=48, n_shared=1,
                       capacity_factor=4.0))
CONFIGS = {"gqa_cfg": GQA, "mla_moe_cfg": MLA_MOE,
           **{a: jget_arch(a).smoke for a in LM_ARCHS}}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _normal(shape, seed=0):
    return _rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(to_np(got) if torch.is_tensor(got) else got, jnp_np(want),
                               **(tol or TOL))


def _normwise(got, want) -> float:
    got = to_np(got).astype(np.float64)
    want = jnp_np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rms_norm_matches_jax():
    x, scale = _normal((2, 7, 48), 1), _normal((48,), 2)
    _close(tl.rms_norm(torch.as_tensor(x), torch.as_tensor(scale)),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(scale)))


@pytest.mark.parametrize("offset", [0, 4093, 524_280])
def test_apply_rope_matches_jax(offset):
    """Rotary embedding at positions from 0 up to long_500k's last ones,
    against JAX compiled, as its forward and decode run it (its scan bodies
    and jitted steps fold the inverse frequencies into constants): the
    inverse frequencies bit for bit."""
    x = _normal((2, 8, 3, 16), 3)
    pos = (offset + np.arange(8))[None, :].astype(np.int32)
    for theta in (1e4, 1e6):
        rope = jax.jit(lambda a, p, theta=theta: jl.apply_rope(a, p, theta))
        _close(tl.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta),
               rope(jnp.asarray(x), jnp.asarray(pos)))
        for hd in (4, 16, 96, 128):
            np.testing.assert_array_equal(
                tl.rope_freqs(hd, theta).numpy(),
                np.asarray(jax.jit(lambda hd=hd, theta=theta: jl.rope_freqs(hd, theta))()))


def test_swiglu_matches_jax():
    x, wg, wi, wo = (_normal(s, i) for i, s in enumerate(((3, 5, 32), (32, 48), (32, 48),
                                                           (48, 32))))
    _close(tl.swiglu(*map(torch.as_tensor, (x, wg, wi, wo)), torch.float32),
           jl.swiglu(*map(jnp.asarray, (x, wg, wi, wo)), jnp.float32))


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False, kv_len=9),
                                dict(causal=True, window=5), dict(causal=True, q_offset=3),
                                dict(causal=True, q_offset=2, window=4, kv_len=10)],
                         ids=["causal", "kv_len", "window", "offset", "all"])
def test_attend_matches_jax(kw):
    q, k, v = _normal((2, 8, 4, 24), 4), _normal((2, 12, 2, 24), 5), _normal((2, 12, 2, 16), 6)
    _close(tl._attend(*map(torch.as_tensor, (q, k, v)), **kw),
           jl._attend(*map(jnp.asarray, (q, k, v)), **kw))


@pytest.mark.parametrize("qc,kc", [(32, 32), (128, 32), (64, 128)])
def test_flash_matches_jax(qc, kc):
    """The (qc, kc) cases of test_flash_matches_plain, with MLA's dv != hd:
    the port's flash against JAX's, and against the port's plain path at
    that test's tolerance."""
    q, k, v = _normal((2, 128, 4, 24), 7), _normal((2, 128, 2, 24), 8), _normal((2, 128, 2, 16), 9)
    got = tl.flash_attention(*map(torch.as_tensor, (q, k, v)), causal=True, q_chunk=qc,
                             k_chunk=kc)
    _close(got, jl.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True, q_chunk=qc,
                                   k_chunk=kc))
    _close(got, to_np(tl._attend(*map(torch.as_tensor, (q, k, v)), causal=True)),
           rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("sq,sk,qc,kc", [(96, 96, 64, 32), (128, 100, 32, 32)])
def test_flash_refuses_partial_blocks(sq, sk, qc, kc):
    """JAX reshapes Sq into whole q blocks (and raises otherwise) and scans
    Sk // k_chunk whole k blocks; the port raises on either remainder and
    never pads."""
    q, k = torch.zeros(1, sq, 2, 8), torch.zeros(1, sk, 2, 8)
    with pytest.raises(ValueError, match="multiples"):
        tl.flash_attention(q, k, k, q_chunk=qc, k_chunk=kc)
    if sq % qc:
        with pytest.raises(TypeError):
            jl.flash_attention(jnp.zeros((1, sq, 2, 8)), jnp.zeros((1, sk, 2, 8)),
                               jnp.zeros((1, sk, 2, 8)), q_chunk=qc, k_chunk=kc)


def test_cross_entropy_matches_jax():
    logits, labels = _normal((3, 5, 11), 10), _rng(11).integers(0, 11, (3, 5)).astype(np.int32)
    for z in (0.0, 1e-4):
        _close(tl.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels), z),
               jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
MOE = jmoe.MoEConfig(n_experts=8, top_k=2, d_model=16, d_ff=32, n_shared=1,
                     capacity_factor=8.0)


def _moe_params(cfg, seed=0):
    """JAX's one-layer MoE parameters, and the same as torch tensors."""
    p = jax.tree.map(lambda a: a[0], jmoe.init_moe_params(jax.random.PRNGKey(seed), cfg, 1))
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("top_k,router", [(2, "random"), (3, "random"), (2, "zero")])
def test_route_matches_jax(top_k, router):
    """idx exactly (a zero router ties every expert: lower index first, as
    lax.top_k), gates and aux within tolerance."""
    cfg = replace(MOE, top_k=top_k)
    x = _normal((24, 16), 12)
    w = _normal((16, 8), 13) if router == "random" else np.zeros((16, 8), np.float32)
    jg, ji, ja = jmoe._route(jnp.asarray(x), jnp.asarray(w), cfg)
    tg, ti, ta = tmoe._route(torch.as_tensor(x), torch.as_tensor(w), torch_moe(cfg))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if router == "zero":
        assert (ti.numpy() == np.arange(top_k)).all()
    _close(tg, jg)
    _close(ta, ja)


@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_paths_match_jax(n_shared):
    """moe_dense, moe_ep and moe_tp against JAX's (output and aux), and the
    port's moe_ep and moe_tp against its own moe_dense (test_moe_paths_agree's
    tolerance)."""
    cfg = replace(MOE, n_shared=n_shared)
    jp, tp = _moe_params(cfg)
    x = _normal((2, 12, 16), 14)
    tcfg = torch_moe(cfg)
    with torch.no_grad():
        dense = tmoe.moe_dense(torch.as_tensor(x), tp, tcfg)
        for name, jfn, tfn in (("dense", jmoe.moe_dense, None),
                               ("ep", jmoe.moe_ep, tmoe.moe_ep),
                               ("tp", jmoe_tp, tmoe_tp)):
            got = dense if tfn is None else tfn(torch.as_tensor(x), tp, tcfg)
            want = jfn(jnp.asarray(x), jp, cfg)
            _close(got[0], want[0])
            _close(got[1], want[1])
            _close(got[0], to_np(dense[0]), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("capacity_factor", [1.0, 0.5])
def test_moe_capacity_drops_match_jax(capacity_factor):
    """test_moe_capacity_drops_are_bounded's tight case. On one device the
    capacity rounds up to at least T*k at capacity_factor 1.0, so nothing
    drops there; at 0.5 the replicas past the capacity drop, the same ones
    in both packages (their tokens lose that expert's share)."""
    cfg = jmoe.MoEConfig(n_experts=4, top_k=2, d_model=16, d_ff=32,
                         capacity_factor=capacity_factor)
    jp, tp = _moe_params(cfg)
    x = _normal((4, 32, 16), 15)
    with torch.no_grad():
        got, aux = tmoe.moe_ep(torch.as_tensor(x), tp, torch_moe(cfg))
        dense = tmoe.moe_dense(torch.as_tensor(x), tp, torch_moe(cfg))[0]
    want, jaux = jmoe.moe_ep(jnp.asarray(x), jp, cfg)
    _close(got, want)
    _close(aux, jaux)
    assert torch.isfinite(got).all() and float(got.abs().sum()) > 0
    short = (~torch.isclose(got, dense, rtol=2e-4, atol=2e-4)).any(-1).sum()
    assert (int(short) > 0) == (capacity_factor < 1.0)


def test_moe_ep_mesh_raises():
    """moe_ep and moe_tp run over a mesh (tests/test_torch_mesh.py): a mesh
    without the ``tp`` axis raises, and a world of one over ("data", "model")
    gives the single-device body's bits."""
    from repro_torch.core.distributed import make_mesh

    _, tp = _moe_params(MOE)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 4, 16)).astype(np.float32))
    flat = make_mesh(device="cpu")
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    for fn in (tmoe.moe_ep, tmoe_tp):
        with pytest.raises(ValueError, match="not axes of the mesh"):
            fn(x, tp, torch_moe(MOE), mesh=flat)
        got, aux = fn(x, tp, torch_moe(MOE), mesh=mesh)
        want, waux = fn(x, tp, torch_moe(MOE))
        assert torch.equal(got, want) and torch.equal(aux, waux)


def test_init_moe_params_shapes_match_jax():
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), MOE, 3)
    tp = tmoe.init_moe_params(torch_moe(MOE), 3, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _forward_pair(jcfg, toks):
    model = port_model(jcfg)
    with torch.no_grad():
        got = tt.forward(model, torch.as_tensor(toks), torch_cfg(jcfg), return_cache=True)
    want = jax_forward(jcfg)(jax_params(jcfg), jnp.asarray(toks))
    return model, got, want


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name):
    """Logits, aux and the returned (post-rope, stacked) cache."""
    jcfg = CONFIGS[name]
    _, (logits, aux, cache), (jlogits, jaux, jcache) = _forward_pair(
        jcfg, tokens((2, 16), jcfg.vocab))
    _close(logits, jlogits)
    _close(aux, jaux)
    assert cache.keys() == jcache.keys()
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape, k
        _close(cache[k], jcache[k])


def test_forward_flash_matches_jax():
    """A prompt of 2,048 tokens takes the flash path (two 1,024-key blocks,
    one 2,048-query block at flash_q_chunk=seq) in both packages."""
    jcfg = replace(jget_arch("qwen2.5-3b").smoke, n_layers=1, flash_q_chunk=2048)
    _, (logits, _, cache), (jlogits, _, jcache) = _forward_pair(
        jcfg, tokens((1, 2048), jcfg.vocab, seed=2))
    _close(logits, jlogits)
    _close(cache["k"], jcache["k"])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v3-671b"])
def test_forward_bf16_matches_jax(arch):
    """A bfloat16 copy of a SMOKE config: normwise within BF16_NORMWISE."""
    jcfg = bf16(jget_arch(arch).smoke)
    model, (logits, aux, cache), (jlogits, jaux, jcache) = _forward_pair(
        jcfg, tokens((2, 16), jcfg.vocab))
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert _normwise(logits, jlogits) <= BF16_NORMWISE
    assert abs(float(aux) - float(jaux)) <= BF16_NORMWISE * max(abs(float(jaux)), 1e-3)
    for k in cache:
        assert cache[k].dtype == torch.bfloat16
        assert _normwise(cache[k], jcache[k]) <= BF16_NORMWISE, k


@pytest.mark.parametrize("kind", ["float", "int8", "window", "mla", "bf16"])
def test_init_cache_matches_jax(kind):
    jcfg = {"float": GQA, "int8": replace(GQA, kv_cache_dtype="int8"),
            "window": replace(GQA, sliding_window=32), "mla": MLA_MOE,
            "bf16": bf16(GQA)}[kind]
    got = tt.init_cache(torch_cfg(jcfg), 2, 64, device="cpu")
    want = jt.init_cache(jcfg, 2, 64)
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not got[k].any()
    if kind == "window":
        assert got["k"].shape[2] == 32


def _decode_both(jcfg, toks, steps, cache_len0=0, max_len=None):
    """Step-by-step decode in both packages from init_cache: each step's
    logits, then both final caches."""
    b = toks.shape[0]
    max_len = max_len or cache_len0 + steps
    model, tcfg = port_model(jcfg), torch_cfg(jcfg)
    cache = tt.init_cache(tcfg, b, max_len, device="cpu")
    jcache = jt.init_cache(jcfg, b, max_len)
    step = jax_decode(jcfg)
    out = []
    with torch.no_grad():
        for t in range(steps):
            lg, cache = tt.decode_step(model, cache, torch.as_tensor(toks[:, t]),
                                       cache_len0 + t, tcfg)
            jlg, jcache = step(jax_params(jcfg), jcache, jnp.asarray(toks[:, t]),
                               jnp.asarray(cache_len0 + t, jnp.int32))
            out.append((lg, jlg))
    return out, cache, jcache


@pytest.mark.parametrize("kind", ["gqa", "mla_moe", "window", "deepseek"])
def test_decode_step_matches_jax(kind):
    """decode_step against JAX's, logits at every step and the cache after
    (the window case wraps its 8-entry ring twice)."""
    jcfg = {"gqa": GQA, "mla_moe": MLA_MOE, "window": replace(GQA, sliding_window=8),
            "deepseek": jget_arch("deepseek-v3-671b").smoke}[kind]
    out, cache, jcache = _decode_both(jcfg, tokens((2, 20), jcfg.vocab), 20)
    for lg, jlg in out:
        _close(lg, jlg)
    for k in cache:
        _close(cache[k], jcache[k])


def test_decode_step_int8_cache_matches_jax():
    """The int8 cache: logits within tolerance, entries within 1, scales
    within rtol 2e-6."""
    jcfg = replace(GQA, kv_cache_dtype="int8")
    out, cache, jcache = _decode_both(jcfg, tokens((2, 12), jcfg.vocab), 12)
    for lg, jlg in out:
        _close(lg, jlg)
    for k in ("k", "v"):
        assert cache[k].dtype == torch.int8
        diff = np.abs(cache[k].numpy().astype(np.int32) - np.asarray(jcache[k]).astype(np.int32))
        assert diff.max() <= 1
    for k in ("k_scale", "v_scale"):
        _close(cache[k], jcache[k], rtol=2e-6, atol=0)


def test_decode_step_at_a_tensor_cache_len_and_past_the_end():
    """cache_len may be a 0-d tensor; a slot past the cache's end writes its
    last entry, as JAX's dynamic_update_slice clamps."""
    jcfg = GQA
    model, tcfg = port_model(jcfg), torch_cfg(jcfg)
    toks = tokens((2,), jcfg.vocab)
    cache = tt.init_cache(tcfg, 2, 4, device="cpu")
    with torch.no_grad():
        lg, cache = tt.decode_step(model, cache, torch.as_tensor(toks), torch.tensor(6), tcfg)
    jlg, jcache = jt.decode_step(jax_params(jcfg), jt.init_cache(jcfg, 2, 4), jnp.asarray(toks),
                                 jnp.asarray(6, jnp.int32), jcfg)
    _close(lg, jlg)
    _close(cache["k"], jcache["k"])
    assert cache["k"][:, :, 3].any() and not cache["k"][:, :, :3].any()


# -- the port's own twins of tests/test_models_lm.py ------------------------
def _twin_model(jcfg):
    return port_model(jcfg), torch_cfg(jcfg)


@pytest.mark.parametrize("cfg_name", ["gqa_cfg", "mla_moe_cfg"])
def test_decode_matches_prefill(cfg_name):
    model, cfg = _twin_model(CONFIGS[cfg_name])
    toks = torch.as_tensor(tokens((2, 16), cfg.vocab))
    with torch.no_grad():
        logits, _ = tt.forward(model, toks, cfg)
        cache = tt.init_cache(cfg, 2, 16, device="cpu")
        outs = []
        for t in range(12):
            lg, cache = tt.decode_step(model, cache, toks[:, t], t, cfg)
            outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), logits[:, :12].numpy(),
                               rtol=6e-3, atol=6e-3)


@pytest.mark.parametrize("cfg_name", ["gqa_cfg", "mla_moe_cfg"])
def test_prefill_cache_continues(cfg_name):
    model, cfg = _twin_model(CONFIGS[cfg_name])
    toks = torch.as_tensor(tokens((2, 16), cfg.vocab))
    with torch.no_grad():
        _, _, cache = tt.forward(model, toks, cfg, return_cache=True)
        cache = {k: torch.nn.functional.pad(v, (0, 0) * (v.ndim - 3) + (0, 4))
                 for k, v in cache.items()}
        nxt = torch.full((2,), 5)
        lg, _ = tt.decode_step(model, cache, nxt, 16, cfg)
        ref, _ = tt.forward(model, torch.cat([toks, nxt[:, None]], 1), cfg)
    np.testing.assert_allclose(lg.numpy(), ref[:, -1].numpy(), rtol=6e-3, atol=6e-3)


def test_prefill_equals_forward_last_position():
    """transformer.prefill: the last position's logits and the cache of
    forward(..., return_cache=True)."""
    model, cfg = _twin_model(MLA_MOE)
    toks = torch.as_tensor(tokens((2, 16), cfg.vocab))
    with torch.no_grad():
        logits, _, cache = tt.forward(model, toks, cfg, return_cache=True)
        last, cache2 = tt.prefill(model, toks, cfg)
    np.testing.assert_allclose(last.numpy(), logits[:, -1].numpy(), **TOL)
    assert all(torch.equal(cache[k], cache2[k]) for k in cache)


def test_sliding_window_decode():
    """Ring-buffer window cache == full cache when seq <= window."""
    cfg_w = replace(GQA, sliding_window=32)
    model, cfg = _twin_model(GQA)
    tcfg_w = torch_cfg(cfg_w)
    toks = torch.as_tensor(tokens((2, 20), cfg.vocab))
    cache_full = tt.init_cache(cfg, 2, 20, device="cpu")
    cache_win = tt.init_cache(tcfg_w, 2, 64, device="cpu")
    assert cache_win["k"].shape[2] == 32
    with torch.no_grad():
        for t in range(20):
            lg_f, cache_full = tt.decode_step(model, cache_full, toks[:, t], t, cfg)
            lg_w, cache_win = tt.decode_step(model, cache_win, toks[:, t], t, tcfg_w)
    np.testing.assert_allclose(lg_w.numpy(), lg_f.numpy(), rtol=5e-3, atol=5e-3)


def test_int8_kv_cache_decode():
    """int8 KV cache: <=3% rel error, >= 90 % greedy agreement vs forward."""
    model, cfg = _twin_model(GQA)
    cfg8 = replace(cfg, kv_cache_dtype="int8")
    toks = torch.as_tensor(tokens((2, 24), cfg.vocab))
    with torch.no_grad():
        ref, _ = tt.forward(model, toks, cfg)
        cache = tt.init_cache(cfg8, 2, 24, device="cpu")
        assert cache["k"].dtype == torch.int8 and "k_scale" in cache
        outs = []
        for t in range(24):
            lg, cache = tt.decode_step(model, cache, toks[:, t], t, cfg8)
            outs.append(lg)
    dec = torch.stack(outs, 1)
    rel = float((dec - ref).abs().max() / ref.abs().max())
    assert rel < 0.03, rel
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    assert agree >= 0.9, agree


def test_decode_cache_must_match_depth():
    model, cfg = _twin_model(GQA)
    cache = tt.init_cache(replace(cfg, n_layers=2), 2, 8, device="cpu")
    with pytest.raises(ValueError, match="holds 2 layers"):
        tt.decode_step(model, cache, torch.zeros(2, dtype=torch.long), 0, cfg)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_counts_match_jax(arch):
    """n_params and n_active_params of the published FULL configs, from the
    shapes alone (the meta device; JAX: eval_shape)."""
    jfull, tfull = jget_arch(arch).full, get_arch(arch).full
    assert tfull.n_params() == jfull.n_params()
    assert tfull.n_active_params() == jfull.n_active_params()


def test_param_count_sane():
    """The port's twin of test_param_count_sane."""
    cfg = tt.TransformerConfig(name="c", n_layers=2, d_model=16, n_heads=2, n_kv_heads=2,
                               d_ff=32, vocab=64, n_dense_layers=1,
                               moe=tmoe.MoEConfig(n_experts=4, top_k=2, d_model=16, d_ff=32))
    total, active = cfg.n_params(), cfg.n_active_params()
    assert 0 < active < total and total - active == (4 - 2) * 3 * 16 * 32


@pytest.mark.parametrize("name", ["mla_moe_cfg", "qwen2.5-3b"])
def test_lm_params_from_jax_round_trip(name):
    """Every leaf of JAX's pytree lands in its named parameter, unstacked
    by layer, bit for bit (bfloat16 leaves through float32)."""
    for jcfg in (CONFIGS[name], bf16(CONFIGS[name])):
        tree = np_tree(jax_params(jcfg))
        model = lm_params_from_jax(tree, torch_cfg(jcfg), "cpu")
        params = dict(model.named_parameters())
        assert params["dense_blocks.0.attn.wq_a" if jcfg.attn == "mla"
                      else "dense_blocks.1.attn.wq"].shape == (
            tree["dense_blocks"]["attn"]["wq_a" if jcfg.attn == "mla" else "wq"].shape[1:])
        n = 0
        for group in ("dense_blocks", "moe_blocks"):
            for key, leaf in jax.tree_util.tree_leaves_with_path(tree.get(group, {})):
                path = ".".join(str(getattr(k, "key", k)) for k in key)
                for i in range(leaf.shape[0]):
                    got = params[f"{group}.{i}.{path}"]
                    assert got.dtype == torch_cfg(jcfg).param_dtype
                    np.testing.assert_array_equal(to_np(got), leaf[i].astype(np.float32))
                    n += 1
        np.testing.assert_array_equal(to_np(model.embed),
                                      tree["embed"].astype(np.float32))
        assert n > 0


def test_lm_params_from_jax_checks_names_and_shapes():
    tree = np_tree(jax_params(GQA))
    with pytest.raises(ValueError, match="lacks"):
        lm_params_from_jax(tree, torch_cfg(replace(GQA, n_layers=4)), "cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["lm_head"] = bad["lm_head"][:, :-1]
    with pytest.raises(ValueError, match="lm_head"):
        lm_params_from_jax(bad, torch_cfg(GQA), "cpu")


def test_init_params_draws_from_the_generator():
    """init_params: the reference's distributions (norms one, biases zero,
    embed std 0.02, matrices fan_in^-0.5), the same values for the same
    generator seed and others for another."""
    cfg = torch_cfg(replace(MLA_MOE, d_model=64, d_ff=128))
    a = tt.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    b = tt.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    c = tt.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa["lm_head"], pc["lm_head"])
    assert (pa["dense_blocks.0.ln1"] == 1).all() and (pa["mtp.ln"] == 1).all()
    assert (pa["dense_blocks.0.attn.q_norm"] == 1).all()
    pa = {k: v.detach() for k, v in pa.items()}
    assert abs(float(pa["embed"].std()) - 0.02) < 0.002
    w = pa["moe_blocks.0.moe.wo"]
    assert abs(float(w.std()) * w.shape[-2] ** 0.5 - 1) < 0.05
    g = torch_cfg(GQA)
    assert (dict(tt.init_params(g, device="cpu").named_parameters())[
        "dense_blocks.0.attn.bq"] == 0).all()
    assert {k: tuple(v.shape) for k, v in pa.items()} == {
        k: tuple(v.shape) for k, v in tt.Transformer(cfg, device="meta").named_parameters()}


def test_configs_fields_cover_jax():
    """The port's TransformerConfig and MoEConfig have JAX's fields and
    defaults (dtypes mapped)."""
    jf = {f.name: f.default for f in dataclasses.fields(jt.TransformerConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tt.TransformerConfig)}
    assert jf.keys() == tf.keys()
    for k in jf:
        if k in ("param_dtype", "compute_dtype"):
            assert tf[k] == torch.float32 and jf[k] == jnp.float32
        else:
            assert tf[k] == jf[k], k
    jm = {f.name: f.default for f in dataclasses.fields(jmoe.MoEConfig)}
    tm = {f.name: f.default for f in dataclasses.fields(tmoe.MoEConfig)}
    assert jm.keys() == tm.keys()
