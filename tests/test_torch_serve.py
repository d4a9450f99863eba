"""The port's LM serving path against the JAX package: ``serve_batch``
(greedy tokens bit for bit, determinism, the int8 config both packages
refuse, seeded sampling), the five LM configs and ``all_archs()``, and the
``prefill`` and ``decode`` kinds of ``build_step`` (their outputs at a
``SMOKE`` config patched in as arch.full, and their ``meta`` at the
published ``FULL`` configs for the 5 x 3 serving cells).

JAX's parameters come from ``init_params(PRNGKey(seed), cfg)`` and are
carried across with ``lm_params_from_jax``; prompts are made from a seed
with numpy. Tolerances: greedy tokens and ``meta`` exactly; the steps'
float32 logits and caches within rtol 1e-5, atol 1e-5 (tests/test_torch_lm.py).
"""
import dataclasses
from dataclasses import replace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_lm import (  # noqa: E402
    jax_params, jnp_np, np_tree, port_model, to_np, tokens, torch_cfg,
)
from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import all_archs as jall_archs  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.launch.serve import serve_batch as jserve_batch  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import ARCH_IDS, all_archs, get_arch  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    build_step, make_optimizer, serve_batch, serve_metrics_endpoint, train_state,
)
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch.serve import check_servable  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LM_ARCHS = [a for a in JAX_ARCH_IDS if jget_arch(a).family == "lm"]
SERVE_SHAPES = ["prefill_32k", "decode_32k", "long_500k"]


def _serve_both(arch, seed, prompts, new):
    jcfg = jget_arch(arch).smoke
    want = jserve_batch(jax_params(jcfg, seed), jcfg, prompts, max_new_tokens=new)
    got = serve_batch(port_model(jcfg, seed), torch_cfg(jcfg), prompts, max_new_tokens=new,
                      device="cpu")
    return jcfg, got, want


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v3-671b"])
def test_serve_greedy_matches_jax(arch):
    """The greedy continuation bit for bit, and its first token the argmax
    of JAX's prefill logits (tests/test_serve.py's check)."""
    cfg = jget_arch(arch).smoke
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    jcfg, got, want = _serve_both(arch, 0, prompts, 8)
    assert got.outputs.shape == (2, 8) and got.outputs.dtype == np.int32
    np.testing.assert_array_equal(got.outputs, want.outputs)
    assert (got.prefill_tokens, got.decoded_tokens) == (want.prefill_tokens, want.decoded_tokens)
    logits, _ = jt.forward(jax_params(jcfg), jnp.asarray(prompts), jcfg)
    np.testing.assert_array_equal(got.outputs[:, 0], np.asarray(jnp.argmax(logits[:, -1], -1)))


def test_serve_deterministic():
    """tests/test_serve.py's phi3 case: two runs equal, and equal to JAX's."""
    cfg = get_arch("phi3-mini-3.8b").smoke
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (3, 6)).astype(np.int32)
    model = port_model(jget_arch("phi3-mini-3.8b").smoke, seed=1)
    a = serve_batch(model, cfg, prompts, max_new_tokens=5, device="cpu")
    b = serve_batch(model, cfg, prompts, max_new_tokens=5, device="cpu")
    np.testing.assert_array_equal(a.outputs, b.outputs)
    _, _, want = _serve_both("phi3-mini-3.8b", 1, prompts, 5)
    np.testing.assert_array_equal(a.outputs, want.outputs)


def test_serve_int8_config_raises_in_both_packages():
    """phi3-mini's FULL config keeps an int8 cache: the prefill cache holds
    float k/v without scales. The JAX package fails inside the decode with
    a dtype error; the port refuses it up front with a ValueError."""
    jcfg = replace(jget_arch("phi3-mini-3.8b").smoke, kv_cache_dtype="int8")
    prompts = tokens((2, 6), jcfg.vocab)
    with pytest.raises(TypeError, match="same dtypes"):
        jserve_batch(jax_params(jcfg), jcfg, prompts, max_new_tokens=3)
    with pytest.raises(ValueError, match="int8"):
        serve_batch(port_model(jcfg), torch_cfg(jcfg), prompts, max_new_tokens=3, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        check_servable(get_arch("phi3-mini-3.8b").full)
    check_servable(replace(get_arch("deepseek-v3-671b").full, kv_cache_dtype="int8"))  # MLA


def test_serve_sampling_is_seeded():
    """greedy=False draws from a torch.Generator seeded with ``seed`` (its
    draws are not jax.random.categorical's): the same seed gives the same
    tokens, another seed others."""
    jcfg = jget_arch("qwen2.5-3b").smoke
    model, cfg = port_model(jcfg), torch_cfg(jcfg)
    prompts = tokens((4, 6), cfg.vocab)
    runs = [serve_batch(model, cfg, prompts, 12, greedy=False, seed=s, device="cpu").outputs
            for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert runs[0].min() >= 0 and runs[0].max() < cfg.vocab


def test_serve_refuses_a_model_on_another_device():
    jcfg = jget_arch("qwen2.5-3b").smoke
    with pytest.raises(ValueError, match="runs on meta"):
        serve_batch(port_model(jcfg), torch_cfg(jcfg), tokens((1, 4), 256), 2, device="meta")


def test_serve_metrics_endpoint_starts_and_closes():
    server = serve_metrics_endpoint(port=0)
    try:
        assert server.port > 0 and "127.0.0.1" in server.url
    finally:
        server.close()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_match_jax(arch):
    """FULL and SMOKE field for field (dtypes mapped), and the Arch's
    fields and shapes."""
    port, ref = get_arch(arch), jget_arch(arch)
    assert port.full == torch_cfg(ref.full)
    assert port.smoke == torch_cfg(ref.smoke)
    for f in dataclasses.fields(ref):
        if f.name == "shapes":
            assert [dataclasses.astuple(s) for s in port.shapes] == [
                dataclasses.astuple(s) for s in ref.shapes]
        elif f.name not in ("full", "smoke"):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name


def test_all_archs_match_jax():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert [a.name for a in all_archs()] == [a.name for a in jall_archs()]
    assert [a.family for a in all_archs()] == [a.family for a in jall_archs()]


# ---------------------------------------------------------------------------
# the step factory
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SERVE_SHAPES + ["train_4k"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_build_step_meta_matches_jax(arch, shape):
    """The analytic meta of the published FULL configs at n_dev = 1 ==
    JAX's build_step on a one-device mesh (train_4k: 6 N_active D plus
    attention, the parameter streams of each microbatch)."""
    port = build_step(arch, shape, device="cpu")
    ref = jsteps.build_step(arch, shape, make_local_mesh())
    assert (port.name, port.kind) == (ref.name, ref.kind)
    assert port.meta == ref.meta


def _steps(arch, shape):
    """Both packages' steps of one cell with the arch's SMOKE config in
    place of FULL (as tests/test_torch_gnn.py patches get_arch)."""
    jarch = replace(jget_arch(arch), full=jget_arch(arch).smoke)
    tarch = replace(get_arch(arch), full=get_arch(arch).smoke)
    with mock.patch.object(jsteps, "get_arch", lambda _: jarch):
        jstep = jsteps.build_step(arch, shape, make_local_mesh())
    with mock.patch.object(steps_mod, "get_arch", lambda _: tarch):
        tstep = build_step(arch, shape, device="cpu")
    return jarch.full, jstep, tstep


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_kind_matches_jax(arch):
    """(last logits, cache) of the prefill kind == JAX's prefill step."""
    jcfg, jstep, tstep = _steps(arch, "prefill_32k")
    assert tstep.cfg.flash_q_chunk == 32768 and tstep.cfg.flash_k_chunk == 1024
    toks = tokens((2, 16), jcfg.vocab, seed=5)
    last, cache = tstep.fn(port_model(jcfg), toks)
    jlast, jcache = jstep.fn(jax_params(jcfg), jnp.asarray(toks))
    np.testing.assert_allclose(to_np(last), jnp_np(jlast), **TOL)
    assert cache.keys() == jcache.keys()
    for k in cache:
        np.testing.assert_allclose(to_np(cache[k]), jnp_np(jcache[k]), **TOL)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_kind_matches_jax(arch, shape):
    """Three steps of the decode kind == JAX's decode step: at the start of
    a 64-entry cache, and for long_500k at cache_len near 524,287 over the
    4,096-entry window ring (GQA) or a 64-entry latent cache (MLA; its
    writes clamp to the last entry in both packages)."""
    jcfg, jstep, tstep = _steps(arch, shape)
    long = shape == "long_500k"
    if long and jcfg.attn != "mla":
        assert tstep.cfg.sliding_window == 4096
        jcfg = replace(jcfg, sliding_window=4096)
    assert tstep.cfg == torch_cfg(jcfg)
    start = 524_284 if long else 0
    max_len = 524_288 if tstep.cfg.sliding_window else 64
    model, params = port_model(jcfg), jax_params(jcfg)
    cache = tt.init_cache(tstep.cfg, 2, max_len, device="cpu")
    jcache = jt.init_cache(jcfg, 2, max_len)
    toks = tokens((2, 3), jcfg.vocab, seed=6)
    for t in range(3):
        lg, cache = tstep.fn(model, cache, toks[:, t], start + t)
        jlg, jcache = jstep.fn(params, jcache, jnp.asarray(toks[:, t]),
                               jnp.asarray(start + t, jnp.int32))
        np.testing.assert_allclose(to_np(lg), jnp_np(jlg), **TOL)
    for k in cache:
        np.testing.assert_allclose(to_np(cache[k]), jnp_np(jcache[k]), **TOL)


def test_prefill_then_decode_kinds_serve_like_serve_batch():
    """The slice end to end: the prefill kind, the cache padded, then the
    decode kind step by step reproduce serve_batch's greedy tokens, which
    equal JAX's (test_serve_greedy_matches_jax)."""
    jcfg, _, prefill_step = _steps("qwen2.5-3b", "prefill_32k")
    _, _, decode_step = _steps("qwen2.5-3b", "decode_32k")
    model = port_model(jcfg)
    prompts = tokens((2, 8), jcfg.vocab, seed=0)
    last, cache = prefill_step.fn(model, prompts)
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 5)) for k, v in cache.items()}
    out = [last.argmax(-1)]
    for i in range(5):
        lg, cache = decode_step.fn(model, cache, out[-1], 8 + i)
        out.append(lg.argmax(-1))
    want = serve_batch(model, torch_cfg(jcfg), prompts, 6, device="cpu").outputs
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(), want)


def test_lm_train_kind_raises_and_steps_check_their_device():
    """Every LM kind refuses inputs on another device than its own, and
    TF32: the train kind (now built for every arch) raises on parameters
    on the CPU when it runs on ``meta``, the prefill kind on a model."""
    jcfg, _, tstep = _steps("qwen2.5-3b", "prefill_32k")
    state = train_state(port_model(jcfg), make_optimizer("adamw"))
    with pytest.raises(ValueError, match="the parameters are on cpu"):
        build_step("qwen2.5-3b", "train_4k", device="meta").fn(
            state["params"], state["opt"], {"tokens": tokens((1, 4), 256),
                                            "labels": tokens((1, 4), 256)})
    with pytest.raises(ValueError, match="the model is on cpu"):
        build_step("qwen2.5-3b", "prefill_32k", device="meta").fn(port_model(jcfg),
                                                                  tokens((1, 4), 256))
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            tstep.fn(port_model(jcfg), tokens((1, 4), 256))
    finally:
        torch.set_float32_matmul_precision(before)


def test_whole_slice_param_tree_round_trip():
    """Every SMOKE config's JAX pytree carries across into a model whose
    parameter count is the config's n_params, equal to JAX's."""
    for arch in LM_ARCHS:
        jcfg = jget_arch(arch).smoke
        model = port_model(jcfg)
        n = sum(p.numel() for p in model.parameters())
        leaves = jax.tree.leaves(np_tree(jax_params(jcfg)))
        assert n == sum(a.size for a in leaves) == jcfg.n_params() == torch_cfg(jcfg).n_params()
