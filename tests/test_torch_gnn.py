"""The port's GNN slice against the JAX package: the GCN, SchNet, EGNN and
MACE configs, ``gnn_batch``, ``GraphBatcher``, ``NeighborSampler``, the four
forwards, losses and gradients, one AdamW step of the train kind, and the
step factory's meta, at the widths of tests/test_models_gnn.py on its
4-graph readout batch.

The JAX package runs with impl="xla" and impl="pallas" (Pallas interpret
mode on the CPU, as its own tests run it). The port runs with the kernel off
(the plain ``index_add_`` sums) and on (the edge lanes stably sorted by dst
once a forward, then K1's wrapper, which on a CPU tensor runs its plain
version); tests/test_torch_gpu.py holds the CUDA kernel against the plain
path on the card. JAX's weights are carried across with
``gnn_params_from_jax``.

Tolerances: forwards within rtol 1e-5, atol 1e-5 (float32 products and sums
in another order; measured at most 1e-7 of the output's size); losses within
rtol 1e-5; each gradient leaf within rtol 1e-4 plus 1e-5 of the leaf's
largest entry; one AdamW step at the test widths within rtol 1e-5, atol 1e-6
on parameters and moments (the update is lr * m / sqrt(v) at step 1, so it
is held where the float32 gradients are well above their rounding: every
entry at these widths; at FULL's width the moments are held as gradients
and the parameters against the update recomputed from them); the symmetry tests at
the JAX tests' rtol 2e-3, atol 2e-4. Data, sampler blocks, configs and the
RBF centers are equal bit for bit.
"""
import dataclasses
from dataclasses import replace
from functools import lru_cache
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.spatial.transform as st_rot

torch = pytest.importorskip("torch")

from repro.configs import egnn as jegnn_cfg  # noqa: E402
from repro.configs import gcn_cora as jgcn_cfg  # noqa: E402
from repro.configs import mace as jmace_cfg  # noqa: E402
from repro.configs import schnet as jschnet_cfg  # noqa: E402
from repro.data import GraphBatcher as JGraphBatcher  # noqa: E402
from repro.data import gnn_batch as jgnn_batch  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.graphs.graph import Graph as JGraph  # noqa: E402
from repro.graphs.sampler import NeighborSampler as JNeighborSampler  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro_torch.configs import egnn as tegnn_cfg  # noqa: E402
from repro_torch.configs import gcn_cora as tgcn_cfg  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs import mace as tmace_cfg  # noqa: E402
from repro_torch.configs import schnet as tschnet_cfg  # noqa: E402
from repro_torch.core import kcore_decompose  # noqa: E402
from repro_torch.data import GraphBatcher, gnn_batch  # noqa: E402
from repro_torch.graphs import Graph  # noqa: E402
from repro_torch.graphs import generators as tgen  # noqa: E402
from repro_torch.graphs.sampler import NeighborSampler  # noqa: E402
from repro_torch.kernels import ops, segsum  # noqa: E402
from repro_torch.launch import build_step, make_optimizer, train_state  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.models import gnn as tg  # noqa: E402
from repro_torch.models import gnn_params_from_jax  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
SYM_TOL = dict(rtol=2e-3, atol=2e-4)   # tests/test_models_gnn.py's


@dataclasses.dataclass(frozen=True)
class Model:
    """One GNN at the widths of tests/test_models_gnn.py, in both packages."""
    widths: dict
    jcfg: type
    tcfg: type
    jinit: object
    jforward: object
    jloss: object
    tforward: object
    tloss: object
    arch: str

    def j(self, impl="xla"):
        return self.jcfg(**self.widths, impl=impl)

    def t(self, kernel=False):
        return self.tcfg(**self.widths, kernel=kernel)


MODELS = {
    "gcn": Model(dict(d_feat=20, d_hidden=8), jg.GCNConfig, tg.GCNConfig, jg.gcn_init,
                 jg.gcn_forward, jg.gcn_loss, tg.gcn_forward, tg.gcn_loss, "gcn-cora"),
    "schnet": Model(dict(n_rbf=16, d_hidden=16), jg.SchNetConfig, tg.SchNetConfig,
                    jg.schnet_init, jg.schnet_forward, jg.schnet_loss, tg.schnet_forward,
                    tg.schnet_loss, "schnet"),
    "egnn": Model(dict(d_hidden=16, n_layers=2), jg.EGNNConfig, tg.EGNNConfig, jg.egnn_init,
                  jg.egnn_forward, jg.egnn_loss, tg.egnn_forward, tg.egnn_loss, "egnn"),
    "mace": Model(dict(d_hidden=16, n_layers=1), jg.MACEConfig, tg.MACEConfig, jg.mace_init,
                  jg.mace_forward, jg.mace_loss, tg.mace_forward, tg.mace_loss, "mace"),
}
NAMES = list(MODELS)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@lru_cache(maxsize=None)
def _jax_params(name, seed=0):
    m = MODELS[name]
    return m.jinit(jax.random.PRNGKey(seed), m.j())


def _port_model(name, kernel=False, seed=0):
    m = MODELS[name]
    return gnn_params_from_jax(_np_tree(_jax_params(name, seed)), m.t(kernel), "cpu")


def _readout_batch(graph, batcher):
    """tests/test_models_gnn.py's batch: gnn_batch of erdos_renyi(60, 0.1,
    seed=4) with features and geometry, 4 graphs for the readout."""
    b = batcher(graph, d_feat=20, geometric=True, seed=1)
    b["graph_id"] = np.sort(np.random.default_rng(0).integers(0, 4, graph.n_nodes)
                            ).astype(np.int32)
    b["n_graphs"] = 4
    b["energy"] = np.random.default_rng(2).normal(size=4).astype(np.float32)
    return b


@lru_cache(maxsize=None)
def _batches():
    jb = _readout_batch(jgen.erdos_renyi(60, 0.1, seed=4), jgnn_batch)
    tb = _readout_batch(tgen.erdos_renyi(60, 0.1, seed=4), gnn_batch)
    return jb, tb


def _jax_batch(b):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in b.items()}


def _torch_batch(b):
    return {k: (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v)
            for k, v in b.items()}


def _energy(name, out):
    return out[0] if name == "egnn" else out


def _grad_close(got, want, err_msg=""):
    """A gradient-like leaf: rtol 1e-4 plus 1e-5 of the leaf's largest entry."""
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max(),
                               err_msg=err_msg)


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("port,ref", [(tgcn_cfg, jgcn_cfg), (tschnet_cfg, jschnet_cfg),
                                      (tegnn_cfg, jegnn_cfg), (tmace_cfg, jmace_cfg)],
                         ids=["gcn-cora", "schnet", "egnn", "mace"])
def test_configs_match_jax(port, ref):
    for p, r in ((port.FULL, ref.FULL), (port.SMOKE, ref.SMOKE)):
        assert {k: v for k, v in vars(p).items() if k != "kernel"} == {
            k: v for k, v in vars(r).items() if k != "impl"}
        assert p.kernel is None and r.impl == "xla"
    a, b = port.ARCH, ref.ARCH
    assert (a.name, a.family, a.optimizer, a.source, a.note, a.microbatches) == (
        b.name, b.family, b.optimizer, b.source, b.note, b.microbatches)
    assert [(s.name, s.kind, s.dims, s.note) for s in a.shapes] == [
        (s.name, s.kind, s.dims, s.note) for s in b.shapes]
    assert get_arch(a.name) is a


def test_batches_equal_jax():
    """The readout batch of the forward tests, and tests/test_models_gnn.py's
    own, are the same arrays in both packages."""
    jb, tb = _batches()
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
        assert np.asarray(tb[k]).dtype == np.asarray(jb[k]).dtype


@pytest.mark.parametrize("kw", [
    dict(d_feat=20, geometric=True, seed=1),
    dict(d_feat=None, geometric=True, n_graphs=3, seed=5),
    dict(d_feat=7, n_classes=3, seed=0),
    dict(d_feat=4, geometric=True, graph_id=np.arange(300, dtype=np.int32) % 5, n_graphs=5,
         seed=9),
])
def test_gnn_batch_equal_jax(kw):
    tb = gnn_batch(tgen.erdos_renyi(300, 0.02, seed=2), **kw)
    jb = jgnn_batch(jgen.erdos_renyi(300, 0.02, seed=2), **kw)
    assert tb.keys() == jb.keys()
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
        assert np.asarray(tb[k]).dtype == np.asarray(jb[k]).dtype


@pytest.mark.parametrize("shape,seed,geometric", [((30, 64, 8), 0, True), ((30, 64, 8), 3, False),
                                                  ((5, 9, 40), 1, True)])
def test_graph_batcher_equal_jax(shape, seed, geometric):
    tb = GraphBatcher(*shape).random_batch(seed=seed, geometric=geometric)
    jb = JGraphBatcher(*shape).random_batch(seed=seed, geometric=geometric)
    assert tb.keys() == jb.keys()
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
        assert np.asarray(tb[k]).dtype == np.asarray(jb[k]).dtype


@pytest.mark.parametrize("coreness", [False, True], ids=["uniform", "coreness"])
@pytest.mark.parametrize("fanout,batch", [((5, 3), 16), ((15, 10), 8), ((4,), 33)])
def test_sampler_blocks_equal_jax(coreness, fanout, batch):
    """Blocks of the same graph, seed and coreness are equal, over three
    draws in a row (the generator's state carries over); the graph has
    isolated vertices, so seeds and children without neighbours pad with -1."""
    tgraph, jgraph = tgen.erdos_renyi(500, 0.01, seed=3), jgen.erdos_renyi(500, 0.01, seed=3)
    core = kcore_decompose(tgraph, device="cpu")[0] if coreness else None
    ts = NeighborSampler(tgraph, fanout, coreness=core, seed=7)
    js = JNeighborSampler(jgraph, fanout, coreness=core, seed=7)
    assert ts.block_shape(batch) == js.block_shape(batch)
    np.testing.assert_array_equal(ts.indices, js.indices)
    rng = np.random.default_rng(batch)
    isolated = np.flatnonzero(tgraph.degrees() == 0)
    padded = 0
    for _ in range(3):
        seeds = rng.choice(500, batch, replace=False)
        seeds[0] = isolated[0]
        tb, jb = ts.sample(seeds), js.sample(seeds)
        assert tb.keys() == jb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
            assert np.asarray(tb[k]).dtype == np.asarray(jb[k]).dtype
        padded += int((tb["node_ids"] < 0).sum())
    assert padded > 0


@pytest.mark.parametrize("n_rbf,cutoff", [(300, 10.0), (16, 5.0), (8, 5.0), (4, 5.0),
                                          (16, 10.0), (7, 0.3), (2, 1.7), (1, 3.0), (1000, 6.5)])
def test_rbf_centers_bitwise(n_rbf, cutoff):
    """The RBF centers are jnp.linspace's float32 bits (gnn.py's
    _rbf_expand)."""
    got = tg._rbf_centers(n_rbf, cutoff, torch.device("cpu")).numpy()
    want = np.asarray(jnp.linspace(0.0, cutoff, n_rbf))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ---------------------------------------------------------------------------
# forwards, losses, gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kernel", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, kernel, impl):
    m = MODELS[name]
    jb, tb = _batches()
    ref = m.jforward(_jax_params(name), _jax_batch(jb), m.j(impl))
    model = _port_model(name, kernel)
    before = ops.unsorted_fallback_count
    with torch.no_grad():
        out = m.tforward(model, _torch_batch(tb))
    # with the kernel on, the edge lanes sort once a forward and the readout
    # over graph_id once (each counted); JAX sorts in each of its _seg calls
    sorts = {"gcn": 1, "schnet": 2, "egnn": 2, "mace": 2}[name]
    assert ops.unsorted_fallback_count - before == (sorts if kernel else 0)
    refs = ref if isinstance(ref, tuple) else (ref,)
    outs = out if isinstance(out, tuple) else (out,)
    for o, r in zip(outs, refs):
        assert o.dtype == torch.float32 and tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **FWD_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_jax(name):
    """The loss and every gradient leaf against jax.value_and_grad of the
    JAX loss (impl="xla", the path both packages train on)."""
    m = MODELS[name]
    jb, tb = _batches()
    val, grads = jax.value_and_grad(m.jloss)(_jax_params(name), _jax_batch(jb), m.j())
    model = _port_model(name)
    loss = m.tloss(model, _torch_batch(tb))
    names = [k for k, _ in model.named_parameters()]
    got = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(val), **LOSS_TOL)
    want = dict(gnn_params_from_jax(_np_tree(grads), m.t(), "cpu").named_parameters())
    unused = []
    for k, g in zip(names, got):
        w = want[k].detach().numpy()
        if g is None:  # EGNN's last phi_x: JAX's gradient is exactly 0
            unused.append(k)
            assert not w.any(), k
            continue
        _grad_close(g.numpy(), w, err_msg=k)
    assert all(k.startswith("layers.1.phi_x.") for k in unused)
    assert bool(unused) == (name == "egnn")


@pytest.mark.parametrize("name", NAMES)
def test_kernel_on_under_grad_raises(name):
    """K1 has no backward: the port's forward with the kernel on raises when
    a parameter requires a gradient, as jax.grad through the JAX package's
    Pallas kernel raises; under no_grad it runs."""
    m = MODELS[name]
    jb, tb = _batches()
    with pytest.raises(NotImplementedError):
        jax.grad(m.jloss)(_jax_params(name), _jax_batch(jb), m.j("pallas"))
    model = _port_model(name, kernel=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        m.tforward(model, _torch_batch(tb))
    with torch.no_grad():
        m.tforward(model, _torch_batch(tb))


def test_k1_guard_on_values_that_require_grad():
    """The guard is K1's own, on every device: a tensor that requires a
    gradient raises under grad mode; detached or under no_grad it sums."""
    vals = torch.ones(6, 3, requires_grad=True)
    ids = torch.tensor([0, 0, 1, 2, 2, 4], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="no backward"):
        segsum.segment_sum_sorted(vals, ids, num_segments=4)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.segment_sum(vals, ids.flip(0), num_segments=4, presorted=False)
    want = torch.tensor([[2.0] * 3, [1.0] * 3, [2.0] * 3, [0.0] * 3])
    with torch.no_grad():
        assert torch.equal(segsum.segment_sum_sorted(vals, ids, num_segments=4), want)
    assert torch.equal(segsum.segment_sum_sorted(vals.detach(), ids, num_segments=4), want)


@pytest.mark.parametrize("kernel", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("name", NAMES)
def test_padded_edges_inert(name, kernel):
    """Sentinel (src/dst == N) edges change no model's output (the JAX
    test's rtol 1e-5)."""
    m = MODELS[name]
    _, tb = _batches()
    b = _torch_batch(tb)
    n = b["graph_id"].shape[0]
    b2 = dict(b, src=torch.cat([b["src"], torch.full((13,), n, dtype=torch.int32)]),
              dst=torch.cat([b["dst"], torch.full((13,), n, dtype=torch.int32)]))
    model = _port_model(name, kernel)
    with torch.no_grad():
        e1, e2 = _energy(name, m.tforward(model, b)), _energy(name, m.tforward(model, b2))
    np.testing.assert_allclose(e2.numpy(), e1.numpy(), rtol=1e-5)


@pytest.mark.parametrize("name", ["schnet", "egnn", "mace"])
def test_energy_rotation_invariant(name):
    m = MODELS[name]
    _, tb = _batches()
    b = _torch_batch(tb)
    rot = torch.from_numpy(st_rot.Rotation.random(random_state=1).as_matrix()).float()
    model = _port_model(name, kernel=True)
    with torch.no_grad():
        e1 = _energy(name, m.tforward(model, b))
        e2 = _energy(name, m.tforward(model, dict(b, pos=b["pos"] @ rot.T)))
    np.testing.assert_allclose(e2.numpy(), e1.numpy(), **SYM_TOL)


def test_egnn_coordinates_equivariant_and_mace_translation_invariant():
    _, tb = _batches()
    b = _torch_batch(tb)
    rot = torch.from_numpy(st_rot.Rotation.random(random_state=2).as_matrix()).float()
    egnn = _port_model("egnn", kernel=True)
    mace = _port_model("mace", kernel=True)
    with torch.no_grad():
        _, x1 = tg.egnn_forward(egnn, b)
        _, x2 = tg.egnn_forward(egnn, dict(b, pos=b["pos"] @ rot.T))
        e1 = tg.mace_forward(mace, b)
        e2 = tg.mace_forward(mace, dict(b, pos=b["pos"] + torch.tensor([10.0, -3.0, 2.0])))
    np.testing.assert_allclose(x2.numpy(), (x1 @ rot.T).numpy(), **SYM_TOL)
    np.testing.assert_allclose(e2.numpy(), e1.numpy(), **SYM_TOL)


def test_gcn_learns():
    """tests/test_models_gnn.py's test_gcn_learns on the port: 30 AdamW
    steps of the plain path take the loss below 0.7 of its first value."""
    _, tb = _batches()
    b = _torch_batch(tb)
    cfg = tg.GCNConfig(d_feat=20, d_hidden=16, n_classes=7, kernel=False)
    model = tg.gcn_init(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    opt = adamw(5e-2, weight_decay=0.0)
    params = {k: v.detach() for k, v in model.named_parameters()}
    state = opt.init(params)
    losses = []
    for _ in range(30):
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        loss = tg.gcn_loss(model, b, leaves)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        params, state = opt.update(grads, state, {k: v.detach() for k, v in leaves.items()})
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


@pytest.mark.parametrize("name", NAMES)
def test_init_draws_from_the_generator(name):
    """``*_init`` draws JAX's distributions from an explicit generator: the
    same seed gives the same model, another seed another, and the biases are
    zero."""
    m = MODELS[name]
    init = getattr(tg, f"{name}_init")

    def draw(seed):
        return dict(init(m.t(), device="cpu",
                         generator=torch.Generator().manual_seed(seed)).named_parameters())

    a, b, c = draw(0), draw(0), draw(1)
    assert a.keys() == dict(_port_model(name).named_parameters()).keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    assert all(not v.any() for k, v in a.items() if k.endswith(".bias"))


# ---------------------------------------------------------------------------
# the step factory
# ---------------------------------------------------------------------------
@lru_cache(maxsize=None)
def _molecule_batch():
    """A molecule-shape batch (the shape's n_graphs, 128) of small graphs,
    with GCN's features beside the geometry."""
    b = GraphBatcher(6, 10, 128).random_batch(seed=4)
    rng = np.random.default_rng(5)
    n = b["graph_id"].shape[0]
    b["node_feat"] = rng.normal(size=(n, 32)).astype(np.float32)
    b["labels"] = rng.integers(0, 7, n).astype(np.int32)
    b["label_mask"] = rng.random(n) < 0.5
    return b


def _bundles(name, shape="molecule"):
    """Both packages' ``build_step(arch, shape)`` with the test widths as the
    arch's full config (each package's ``get_arch`` patched for the call)."""
    m = MODELS[name]
    jarch = replace(jsteps.get_arch(m.arch), full=m.j())
    tarch = replace(get_arch(m.arch), full=m.t(None))
    with mock.patch.object(jsteps, "get_arch", lambda _: jarch):
        jstep = jsteps.build_step(m.arch, shape, make_local_mesh())
    with mock.patch.object(steps_mod, "get_arch", lambda _: tarch):
        tstep = build_step(m.arch, shape, device="cpu")
    return jstep, tstep


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax(name):
    """One step of the train kind from JAX's weights == JAX's own train step
    (value_and_grad of the loss at impl="xla", then AdamW): the loss, every
    parameter and both moments."""
    m = MODELS[name]
    jstep, tstep = _bundles(name)
    cfg = replace(m.t(), d_feat=32) if name == "gcn" else m.t()
    jcfg = replace(m.j(), d_feat=32) if name == "gcn" else m.j()
    jp = m.jinit(jax.random.PRNGKey(3), jcfg)
    jopt = jsteps.make_optimizer("adamw")
    batch = _molecule_batch()
    jp2, jo2, jloss = jstep.fn(jp, jopt.init(jp), _jax_batch(batch))
    state = train_state(gnn_params_from_jax(_np_tree(jp), cfg, "cpu"), make_optimizer("adamw"))
    params, opt_state, loss = tstep.fn(state["params"], state["opt"], batch)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    assert int(opt_state["step"]) == int(jo2["step"]) == 1
    for tree, jtree in ((params, jp2), (opt_state["mu"], jo2["mu"]), (opt_state["nu"], jo2["nu"])):
        want = dict(gnn_params_from_jax(_np_tree(jtree), cfg, "cpu").named_parameters())
        assert tree.keys() == want.keys()
        for k, t in tree.items():
            np.testing.assert_allclose(t.numpy(), want[k].detach().numpy(), **STEP_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"])
@pytest.mark.parametrize("arch", ["gcn-cora", "schnet", "egnn", "mace"])
def test_build_step_meta_matches_jax(arch, shape):
    """The analytic meta of the published FULL configs at n_dev = 1 ==
    JAX's build_step on a one-device mesh."""
    port = build_step(arch, shape, device="cpu")
    ref = jsteps.build_step(arch, shape, make_local_mesh())
    assert (port.name, port.kind) == (ref.name, ref.kind) == (f"{arch}:{shape}", "train")
    assert port.meta == ref.meta


def test_train_kind_refuses_k1_and_tf32():
    """kernel=True asks for K1's missing backward: build_step raises instead
    of taking another path; kernel=None trains on the plain path (even on
    the CPU, where None is off anyway) and refuses TF32."""
    m = MODELS["gcn"]
    tarch = replace(get_arch("gcn-cora"), full=m.t(True))
    with mock.patch.object(steps_mod, "get_arch", lambda _: tarch):
        with pytest.raises(NotImplementedError, match="K1"):
            build_step("gcn-cora", "molecule", device="cpu")
    _, tstep = _bundles("gcn")
    state = train_state(tg.gcn_init(replace(m.t(), d_feat=32), device="cpu"),
                        make_optimizer("adamw"))
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            tstep.fn(state["params"], state["opt"], _molecule_batch())
    finally:
        torch.set_float32_matmul_precision(before)


def test_train_step_is_pure():
    _, tstep = _bundles("egnn")
    state = train_state(tg.egnn_init(MODELS["egnn"].t(), device="cpu"), make_optimizer("adamw"))
    before = {k: v.clone() for k, v in state["params"].items()}
    a = tstep.fn(state["params"], state["opt"], _molecule_batch())
    b = tstep.fn(state["params"], state["opt"], _molecule_batch())
    assert all(torch.equal(before[k], v) for k, v in state["params"].items())
    assert torch.equal(a[2], b[2]) and all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    assert all(not v.requires_grad for v in a[0].values())


def test_whole_slice_full_gcn_step():
    """gcn-cora's published FULL config on full_graph_sm's size (a seeded
    graph of 2,708 vertices and 10,556 edges, 1,433 features) through both
    packages' steps from JAX's weights: the loss and both moments against
    JAX's (the moments as gradients), every parameter against AdamW's update
    recomputed in float64 from the port's own moments (at this width a few
    float32 gradient entries are near zero, where lr * m / sqrt(v) at step 1
    is not determined by float32), and the forward with the kernel on
    against JAX's."""
    n, m_edges = 2708, 10556
    pairs = np.random.default_rng(0).integers(0, n, (m_edges, 2))
    tgraph, jgraph = Graph.from_edges(pairs, n), JGraph.from_edges(pairs, n)
    tb = gnn_batch(tgraph, d_feat=1433, seed=3)
    jb = jgnn_batch(jgraph, d_feat=1433, seed=3)
    jstep = jsteps.build_step("gcn-cora", "full_graph_sm", make_local_mesh())
    tstep = build_step("gcn-cora", "full_graph_sm", device="cpu")
    jcfg, cfg = jgcn_cfg.FULL, tgcn_cfg.FULL
    jp = jg.gcn_init(jax.random.PRNGKey(0), jcfg)
    jopt = jsteps.make_optimizer("adamw")
    _, jo, jloss = jstep.fn(jp, jopt.init(jp), _jax_batch(jb))
    state = train_state(gnn_params_from_jax(_np_tree(jp), cfg, "cpu"), make_optimizer("adamw"))
    params, opt_state, loss = tstep.fn(state["params"], state["opt"], tb)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    for key in ("mu", "nu"):
        want = dict(gnn_params_from_jax(_np_tree(jo[key]), cfg, "cpu").named_parameters())
        for k, t in opt_state[key].items():
            _grad_close(t.numpy(), want[k].detach().numpy(), err_msg=f"{key} {k}")
    lr, b1, b2, eps, wd = 3e-4, 0.9, 0.95, 1e-8, 0.1   # make_optimizer("adamw") at step 1
    for k, t in params.items():
        p0 = state["params"][k].double()
        mhat = opt_state["mu"][k].double() / (1 - b1)
        nhat = opt_state["nu"][k].double() / (1 - b2)
        want = p0 - lr * (mhat / (nhat.sqrt() + eps) + wd * p0)
        np.testing.assert_allclose(t.numpy(), want.numpy(), **STEP_TOL, err_msg=k)
    on = gnn_params_from_jax(_np_tree(jp), replace(cfg, kernel=True), "cpu")
    with torch.no_grad():
        got = tg.gcn_forward(on, _torch_batch(tb))
    np.testing.assert_allclose(got.numpy(), np.asarray(jg.gcn_forward(jp, _jax_batch(jb), jcfg)),
                               **FWD_TOL)
