"""The port's DCN-v2 slice against the JAX package: configs, the data
pipeline, the EmbeddingBag, the forward and retrieval, and the step factory,
at the widths of tests/test_recsys.py (500 rows a table, embed_dim 8, 2 cross
layers, MLP 32-16).

The JAX package runs with impl="xla" and impl="pallas" (Pallas interpret
mode on the CPU, as its own tests run it). The port runs with the kernel off
(the plain path) and on (K5's wrapper, which on a CPU tensor runs its plain
version after the sort); tests/test_torch_gpu.py holds the CUDA kernel
against the plain path on the card. JAX's weights are carried across with
``dcn_params_from_jax``.

Tolerances: rtol 1e-5, atol 1e-6 for the embedding bags (float32 sums of up
to four rows, taken in another order); rtol 1e-4, atol 1e-5 for logits and
scores (float32 products 221 wide, summed in another order by each
library's matrix product).
"""
from dataclasses import replace
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import common as jcommon  # noqa: E402
from repro.configs import dcn_v2 as jdcn  # noqa: E402
from repro.data import recsys_batches as jax_batches  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.launch.steps import build_step as jax_build_step  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.configs import common as tcommon  # noqa: E402
from repro_torch.configs import dcn_v2 as tdcn  # noqa: E402
from repro_torch.data import recsys_batches  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import build_step  # noqa: E402
from repro_torch.models import (  # noqa: E402
    DCNConfig, dcn_forward, dcn_init, dcn_params_from_jax, embedding_bag, retrieval_score,
)

WIDTHS = dict(table_rows=500, embed_dim=8, n_cross_layers=2, mlp=(32, 16))
BAG_TOL = dict(rtol=1e-5, atol=1e-6)
OUT_TOL = dict(rtol=1e-4, atol=1e-5)


def _jcfg(multi_hot=1, cross_rank=0, impl="xla"):
    return jrec.DCNConfig(**WIDTHS, multi_hot=multi_hot, cross_rank=cross_rank, impl=impl)


def _tcfg(multi_hot=1, cross_rank=0, kernel=False):
    return DCNConfig(**WIDTHS, multi_hot=multi_hot, cross_rank=cross_rank, kernel=kernel)


@lru_cache(maxsize=None)
def _jax_params(cross_rank):
    return jrec.dcn_init(jax.random.PRNGKey(0), _jcfg(cross_rank=cross_rank))


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def _port_model(cross_rank=0, multi_hot=1, kernel=False):
    return dcn_params_from_jax(_numpy_tree(_jax_params(cross_rank)),
                               _tcfg(multi_hot, cross_rank, kernel), "cpu")


def _ids(seed, b, multi_hot, lo=0, hi=500):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, (b, 26, multi_hot)).astype(np.int32)


@lru_cache(maxsize=None)
def _jax_bag(multi_hot, impl, seed, lo, hi):
    ids = _ids(seed, 6, multi_hot, lo, hi)
    out = jrec.embedding_bag(_jax_params(0)["tables"], jnp.asarray(ids),
                             _jcfg(multi_hot, impl=impl))
    return ids, np.asarray(out)


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------
def test_configs_match_jax():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert tcommon.RECSYS_SHAPES == tuple(
        tcommon.Shape(s.name, s.kind, dict(s.dims), s.note) for s in jcommon.RECSYS_SHAPES)
    assert tcommon.GNN_SHAPES == tuple(
        tcommon.Shape(s.name, s.kind, dict(s.dims), s.note) for s in jcommon.GNN_SHAPES)
    assert [s.dims for s in tcommon.lm_shapes(True)] == [s.dims for s in jcommon.lm_shapes(True)]
    assert tcommon.sampled_subgraph_dims(1024, (15, 10)) == jcommon.sampled_subgraph_dims(
        1024, (15, 10))
    for port, ref in ((tdcn.FULL, jdcn.FULL), (tdcn.SMOKE, jdcn.SMOKE)):
        fields = {k: v for k, v in vars(ref).items() if k != "impl"}
        assert {k: v for k, v in vars(port).items() if k != "kernel"} == fields
        assert port.kernel is None
    arch = get_arch("dcn-v2")
    assert (arch.name, arch.family, arch.optimizer, arch.source) == (
        jdcn.ARCH.name, jdcn.ARCH.family, jdcn.ARCH.optimizer, jdcn.ARCH.source)
    assert arch.full.d_in == 13 + 26 * 16 == 429


@pytest.mark.parametrize("multi_hot,seed,start", [(1, 0, 0), (4, 3, 0), (4, 0, 5)])
def test_recsys_batches_equal_jax(multi_hot, seed, start):
    cfg_t, cfg_j = _tcfg(multi_hot), _jcfg(multi_hot)
    port, ref = recsys_batches(cfg_t, 33, seed, start), jax_batches(cfg_j, 33, seed, start)
    for _ in range(3):
        a, b = next(port), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


# ---------------------------------------------------------------------------
# the EmbeddingBag
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("multi_hot", [1, 4])
def test_embedding_bag_matches_jax(multi_hot, impl, kernel):
    ids, exp = _jax_bag(multi_hot, impl, 1, 0, 500)
    model = _port_model(multi_hot=multi_hot, kernel=kernel)
    with torch.no_grad():
        out = embedding_bag(model.tables, torch.from_numpy(ids), model.cfg)
    assert out.shape == (6, 26 * 8) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), exp, **BAG_TOL)


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("multi_hot", [1, 4])
def test_embedding_bag_invalid_ids_match_jax(multi_hot, kernel):
    """Ids outside [0, R): multi-hot bags drop them (K5's contract); the
    one-hot gather keeps jnp.take's semantics (negative ids from the end,
    the rest NaN)."""
    ids, exp = _jax_bag(multi_hot, "xla", 2, -600, 700)
    assert (ids < -500).any() and (ids >= 500).any() and ((ids < 0) & (ids >= -500)).any()
    model = _port_model(multi_hot=multi_hot, kernel=kernel)
    with torch.no_grad():
        out = embedding_bag(model.tables, torch.from_numpy(ids), model.cfg).numpy()
    np.testing.assert_allclose(out, exp, **BAG_TOL)
    assert np.isnan(out).any() == (multi_hot == 1)


@pytest.mark.parametrize("kernel,multi_hot,bumps", [(True, 4, 0), (False, 4, 0),
                                                     (True, 1, 0)])
def test_unsorted_fallback_counted_once_per_bag_call(kernel, multi_hot, bumps):
    """The multi-hot bag ids are built ascending and go to K5 with
    presorted=True, so no embedding_bag call sorts or bumps the counter,
    with the kernel on or off; the one-hot gather reaches no K5. (JAX's
    embedding_bag passes presorted=False and counts every call.)"""
    model = _port_model(multi_hot=multi_hot, kernel=kernel)
    ids = torch.from_numpy(_ids(4, 5, multi_hot))
    before = ops.unsorted_fallback_count
    with torch.no_grad():
        embedding_bag(model.tables, ids, model.cfg)
        embedding_bag(model.tables, ids, model.cfg)
    assert ops.unsorted_fallback_count == before + 2 * bumps


@pytest.mark.parametrize("b", [1, 5])
def test_kernel_bag_hands_k5_the_ids_view_and_contiguous_bag_ids(monkeypatch, b):
    """What the CUDA wrapper needs, checked here where the plain path does
    not need it: the ids go to K5 as the [T, B, M] view of the batch (no
    copy, last axis contiguous) and the bag ids are contiguous and
    ascending, also for a batch of one row (where a reshape of the expanded
    ids would be a stride-0 view)."""
    seen, real = [], ops.segment_embed_sorted

    def spy(tables, gather_ids, seg_ids, weights=None, *, num_segments):
        seen.append((gather_ids, seg_ids))
        return real(tables, gather_ids, seg_ids, weights, num_segments=num_segments)

    monkeypatch.setattr(ops, "segment_embed_sorted", spy)
    model = _port_model(multi_hot=4, kernel=True)
    ids = torch.from_numpy(_ids(6, b, 4))
    with torch.no_grad():
        embedding_bag(model.tables, ids, model.cfg)
    (gid, seg), = seen
    assert gid.shape == (26, b, 4) and gid.data_ptr() == ids.data_ptr() and gid.stride(-1) == 1
    assert seg.is_contiguous() and seg.dtype == torch.int32
    assert torch.equal(seg, torch.arange(b, dtype=torch.int32).repeat_interleave(4))


def test_kernel_bag_refuses_autograd():
    """K5 has no backward yet: with grad on and tables that require it, the
    kernel path raises; the plain path trains."""
    ids = torch.from_numpy(_ids(5, 3, 4))
    model = _port_model(multi_hot=4, kernel=True)
    with pytest.raises(RuntimeError, match="no backward"):
        embedding_bag(model.tables, ids, model.cfg)
    plain = _port_model(multi_hot=4, kernel=False)
    embedding_bag(plain.tables, ids, plain.cfg).sum().backward()
    assert plain.tables.grad is not None and plain.tables.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# forward and retrieval
# ---------------------------------------------------------------------------
def _batch(seed, b=16, multi_hot=4):
    cfg = _jcfg(multi_hot)
    return {k: v for k, v in next(jax_batches(cfg, b, seed)).items()
            if k in ("dense", "sparse_ids")}


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("cross_rank", [0, 4])
def test_dcn_forward_matches_jax(cross_rank, impl, kernel):
    batch = _batch(7)
    exp = np.asarray(jrec.dcn_forward(_jax_params(cross_rank),
                                      {k: jnp.asarray(v) for k, v in batch.items()},
                                      _jcfg(4, cross_rank, impl)))
    model = _port_model(cross_rank, multi_hot=4, kernel=kernel)
    with torch.no_grad():
        out = dcn_forward(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert out.shape == (16,)
    np.testing.assert_allclose(out.numpy(), exp, **OUT_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("b", [1, 33])
@pytest.mark.parametrize("cross_rank", [0, 4])
def test_presorted_bag_forward_matches_jax(cross_rank, b, impl):
    """The kernel path's bag (ids as a [T, B, M] view, bag ids built
    ascending and passed presorted, no sort) against JAX, which transposes
    and sorts: the bags and the full- and low-rank forward at multi_hot 4,
    for a single row and an odd batch, with no sort counted."""
    batch = _batch(11 + b, b=b)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    exp_bag = np.asarray(jrec.embedding_bag(_jax_params(cross_rank)["tables"],
                                            jb["sparse_ids"], _jcfg(4, cross_rank, impl)))
    exp = np.asarray(jrec.dcn_forward(_jax_params(cross_rank), jb, _jcfg(4, cross_rank, impl)))
    model = _port_model(cross_rank, multi_hot=4, kernel=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    before = ops.unsorted_fallback_count
    with torch.no_grad():
        bag = embedding_bag(model.tables, tb["sparse_ids"], model.cfg)
        out = dcn_forward(model, tb)
    assert ops.unsorted_fallback_count == before
    np.testing.assert_allclose(bag.numpy(), exp_bag, **BAG_TOL)
    assert out.shape == (b,)
    np.testing.assert_allclose(out.numpy(), exp, **OUT_TOL)


@pytest.mark.parametrize("multi_hot", [1, 4])
@pytest.mark.parametrize("cross_rank", [0, 4])
def test_retrieval_score_matches_jax(cross_rank, multi_hot):
    batch = _batch(8, b=3, multi_hot=multi_hot)
    batch["candidates"] = np.random.default_rng(8).normal(size=(1000, 8)).astype(np.float32)
    exp = np.asarray(jrec.retrieval_score(_jax_params(cross_rank),
                                          {k: jnp.asarray(v) for k, v in batch.items()},
                                          _jcfg(multi_hot, cross_rank, "pallas")))
    model = _port_model(cross_rank, multi_hot=multi_hot, kernel=True)
    with torch.no_grad():
        out = retrieval_score(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert out.shape == (3, 1000)
    np.testing.assert_allclose(out.numpy(), exp, **OUT_TOL)


def test_params_from_jax_round_trip():
    """Every JAX leaf lands in the port, transposed into nn.Linear's layout."""
    for rank in (0, 4):
        tree = _numpy_tree(_jax_params(rank))
        model = dcn_params_from_jax(tree, _tcfg(cross_rank=rank), "cpu")
        np.testing.assert_array_equal(model.tables.detach().numpy(), tree["tables"])
        for layer, w, b in zip(model.cross, tree["cross_w"], tree["cross_b"]):
            if rank:
                np.testing.assert_array_equal(layer[0].weight.detach().numpy().T, w[0])
                np.testing.assert_array_equal(layer[1].weight.detach().numpy().T, w[1])
                np.testing.assert_array_equal(layer[1].bias.detach().numpy(), b)
            else:
                np.testing.assert_array_equal(layer.weight.detach().numpy().T, w)
                np.testing.assert_array_equal(layer.bias.detach().numpy(), b)
        for lin, (w, b) in zip(model.mlp, tree["mlp"]):
            np.testing.assert_array_equal(lin.weight.detach().numpy().T, w)
            np.testing.assert_array_equal(lin.bias.detach().numpy(), b)
    with pytest.raises(ValueError, match="rank"):
        dcn_params_from_jax(_numpy_tree(_jax_params(0)), _tcfg(cross_rank=4), "cpu")
    with pytest.raises(ValueError, match="tables"):
        dcn_params_from_jax(_numpy_tree(_jax_params(0)), replace(_tcfg(), table_rows=499),
                            "cpu")


@pytest.mark.parametrize("cross_rank", [0, 4])
def test_dcn_init_shapes_and_scales(cross_rank):
    cfg = _tcfg(cross_rank=cross_rank)
    gen = torch.Generator().manual_seed(1)
    model = dcn_init(cfg, device="cpu", generator=gen).requires_grad_(False)
    ref = _jax_params(cross_rank)
    assert tuple(model.tables.shape) == ref["tables"].shape
    assert abs(float(model.tables.std()) - 0.01) < 1e-3
    for lin, (w, b) in zip(model.mlp, ref["mlp"]):
        assert tuple(lin.weight.shape) == w.shape[::-1] and not lin.bias.any()
        assert abs(float(lin.weight.std()) * w.shape[0] ** 0.5 - 1) < 0.3
    again = dcn_init(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


# ---------------------------------------------------------------------------
# the step factory
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk", "retrieval_cand"])
def test_step_meta_matches_jax(shape):
    port = build_step("dcn-v2", shape, device="cpu")
    ref = jax_build_step("dcn-v2", shape, make_local_mesh())
    assert (port.name, port.kind) == (ref.name, ref.kind)
    assert port.meta == ref.meta


@pytest.mark.parametrize("multi_hot", [1, 4])
def test_steps_equal_forward_and_retrieval(multi_hot):
    model = _port_model(multi_hot=multi_hot, kernel=True)
    batch = _batch(9, b=12, multi_hot=multi_hot)
    serve = build_step("dcn-v2", "serve_p99", device="cpu")
    got = serve.fn(model, batch)
    assert got.shape == (12,)
    with torch.no_grad():
        want = dcn_forward(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert torch.equal(got, want)
    exp = np.asarray(jrec.dcn_forward(_jax_params(0), {k: jnp.asarray(v) for k, v in
                                                       batch.items()}, _jcfg(multi_hot)))
    np.testing.assert_allclose(got.numpy(), exp, **OUT_TOL)

    batch["candidates"] = np.random.default_rng(9).normal(size=(777, 8)).astype(np.float32)
    retr = build_step("dcn-v2", "retrieval_cand", device="cpu")
    got = retr.fn(model, batch)
    with torch.no_grad():
        want = retrieval_score(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (12, 777) and torch.equal(got, want)


def test_step_refuses_tf32_and_other_devices():
    model = _port_model(multi_hot=4)
    batch = _batch(10, b=4)
    step = build_step("dcn-v2", "serve_p99", device="cpu")
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            step.fn(model, batch)
    finally:
        torch.set_float32_matmul_precision(before)
    with pytest.raises(ValueError, match="runs on meta"):
        build_step("dcn-v2", "serve_p99", device="meta").fn(model, batch)


@pytest.mark.parametrize("arch,shape,error", [
    ("qwen2.5-3b", "train_4k", None),  # ported: the LM train kind builds
    ("gcn-cora", "full_graph_sm", None),  # ported: the GNN train kind builds
    ("dcn-v2", "train_batch", None),  # ported: the train kind builds
    ("no-such-arch", None, KeyError),
    ("dcn-v2", "no_such_shape", KeyError),
])
def test_unported_archs_and_kinds_raise(arch, shape, error):
    """Every arch and kind is ported, the LM train kind included; an
    unknown arch or shape raises (shape None: the arch's first shape, after
    get_arch)."""
    if error is None:
        assert build_step(arch, shape, device="cpu").kind == "train"
        return
    with pytest.raises(error):
        if shape is None:
            build_step(arch, get_arch(arch).shapes[0].name, device="cpu")
        else:
            build_step(arch, shape, device="cpu")


def test_whole_slice_smoke_config():
    """The arch's own smoke config, made multi-hot, through the step with JAX's
    weights: logits equal JAX's pallas path."""
    cfg_j = replace(jdcn.SMOKE, multi_hot=4, impl="pallas")
    params = jrec.dcn_init(jax.random.PRNGKey(3), cfg_j)
    cfg_t = replace(tdcn.SMOKE, multi_hot=4, kernel=True)
    model = dcn_params_from_jax(_numpy_tree(params), cfg_t, "cpu")
    batch = next(recsys_batches(cfg_t, 32, seed=4))
    got = build_step("dcn-v2", "serve_p99", device="cpu").fn(model, batch)
    exp = jrec.dcn_forward(params, {k: jnp.asarray(batch[k]) for k in ("dense", "sparse_ids")},
                           cfg_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **OUT_TOL)
