"""tp_sp attention where the key heads do not split over ``"model"``: each
rank computes its own sequence block of every head (the reference's
``ShardCtx.act4`` under ``sp``), not every head on every rank.

* ``flash_attention(..., q_offset=)``: a block of queries against every key
  gives the whole call's rows bit for bit (float32, the same chunks), and
  JAX's ``flash_attention`` rows within rtol 1e-6 (the same float32
  operations in another library's order; test_torch_lm.py's flash test
  reads a few 1e-7).
* The layout: ``ShardCtx.act4`` splits the sequence under ``sp`` where the
  heads do not divide.
* The work: the tp_sp train step of tests/_torch_lm_mesh_ranks.py's "gqa"
  config (4 query heads, 2 key heads) on rank 0 of a dry (1, 4) mesh counts
  a quarter of the one-device step's FLOPs within 2 % (every product of the
  step splits four ways); the "mla6" config's (MLA, 6 heads) counts a
  quarter of the one-device step's attention FLOPs, exactly (a quarter of
  the query rows against every key); qwen2.5-3b's ``prefill_32k`` dry-run
  cell at 16 x 16 counts at most twice ``model_flops / devices``.
* The prefill cache: mistral-nemo-12b's ``prefill_32k`` dry-run cell at
  16 x 16 peaks at most at the reference's own dry-run figure, 4.20 GiB a
  rank (each layer's cache holds a copy of this rank's sequence block, not
  a view of the whole gathered sequence: 13.00 GiB before), its FLOPs the
  same.

The values over a mesh are held against JAX by tests/test_torch_lm_mesh.py,
whose world 8 runs the "gqa" and "mla6" configs over (2, 4) through this
layout.
"""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_lm_mesh_ranks as ranks  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

JAX_RTOL = 1e-6
FLOP_RTOL = 0.02
PREFILL_RATIO = 2.0   # qwen2.5-3b prefill_32k: flops / (model_flops / devices)
# mistral-nemo-12b prefill_32k at 16 x 16: the reference's dry-run peak a
# rank (python -m repro.launch.dryrun), and the port's FLOPs a rank
PREFILL_PEAK_GIB = 4.20
MISTRAL_PREFILL_FLOPS = 177296417751040.0


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("o,w,qc,kc", [(0, 16, 8, 8), (8, 8, 8, 16), (16, 16, 16, 8),
                                       (24, 8, 8, 32), (8, 24, 8, 4), (32, 32, 32, 16)])
def test_flash_offset_rows(o, w, qc, kc):
    """Rows ``o:o+w`` of the whole call, bitwise, from the queries of those
    rows at ``q_offset=o``; and JAX's whole call's rows."""
    q, k, v = _normal((2, 64, 4, 8), 1), _normal((2, 64, 2, 8), 2), _normal((2, 64, 2, 8), 3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    whole = tl.flash_attention(tq, tk, tv, q_chunk=qc, k_chunk=kc)
    got = tl.flash_attention(tq[:, o:o + w], tk, tv, q_chunk=qc, k_chunk=kc, q_offset=o)
    assert torch.equal(got, whole[:, o:o + w])
    want = np.asarray(jl.flash_attention(*map(jnp.asarray, (q, k, v)), q_chunk=qc,
                                         k_chunk=kc))[:, o:o + w]
    np.testing.assert_allclose(got.numpy(), want, rtol=JAX_RTOL, atol=JAX_RTOL)


def test_act4_splits_the_sequence_where_the_heads_do_not():
    from repro_torch.launch import MeshLayout
    from repro_torch.models import ShardCtx

    layout = MeshLayout((2, 4), ranks.AXES)
    sp, dec = ShardCtx(layout, ("data",), sp=True), ShardCtx(layout, ("data",))
    assert sp.act4(8, 4) == dec.act4(8, 4) == (("data",), None, "model", None)
    assert sp.act4(4, 2) == sp.act4(6) == (("data",), "model", None, None)
    assert dec.act4(4, 2) == (("data",), None, None, None)


def _step_args(name: str, mesh):
    """(the tp_sp train step of a tests/_torch_lm_mesh_ranks.py config, its
    arguments): on rank 0 of the dry ``mesh`` (meta tensors), or on one CPU
    device."""
    from repro_torch.launch import train_state
    from repro_torch.launch.dryrun import _lm_args
    from repro_torch.models import MoEConfig, TransformerConfig, init_params

    cfg = ranks.lm_configs(TransformerConfig, MoEConfig, torch.float32)[name]
    step = ranks.build_train_step(cfg, "adamw", "tp_sp", mesh)
    if mesh is None:
        model = init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        state = train_state(model, step.opt)
        batch = {k: torch.from_numpy(v) for k, v in ranks.train_batch(cfg.vocab).items()}
        return step, (state["params"], state["opt"], batch)
    shape = ranks._arch(cfg, "adamw", 2, "tp_sp").shape("train_4k")
    return step, _lm_args(step, shape, mesh)[0]


def _step_flops(mesh) -> float:
    """FlopCounterMode's count of the "gqa" config's tp_sp train step."""
    from torch.utils.flop_counter import FlopCounterMode

    step, args = _step_args("gqa", mesh)
    with FlopCounterMode(display=False) as flops:
        step.fn(*args)
    return float(flops.get_total_flops())


def _attention_flops(name: str, mesh) -> float:
    """FlopCounterMode's count inside the attention calls
    (``transformer._flash_or_plain``, the forward) of a config's tp_sp
    train step."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import transformer as lm

    step, args = _step_args(name, mesh)
    real, counted = lm._flash_or_plain, []

    def counting(*a, **kw):
        with FlopCounterMode(display=False) as flops:
            out = real(*a, **kw)
        counted.append(flops.get_total_flops())
        return out

    with mock.patch.object(lm, "_flash_or_plain", counting):
        step.fn(*args)
    assert counted
    return float(sum(counted))


def test_tp_sp_step_splits_its_flops_four_ways():
    from repro_torch.launch import MeshLayout, dry_mesh

    rank0 = _step_flops(dry_mesh(MeshLayout((1, 4), ranks.AXES)))
    one = _step_flops(None)
    assert abs(4 * rank0 / one - 1) <= FLOP_RTOL, (rank0, one)


def test_qwen_prefill_32k_dry_run_flops():
    from repro_torch.launch.dryrun import run_cell

    rec = run_cell("qwen2.5-3b", "prefill_32k", False, verbose=False)
    assert rec["ok"], rec.get("trace")
    assert rec["flops"] / (rec["model_flops"] / rec["devices"]) <= PREFILL_RATIO


def test_mla_attention_splits_four_ways_where_the_heads_do_not():
    """MLA whose 6 heads do not split over 4 model ranks: rank 0 computes
    its quarter of the query rows of every head, against every key (the
    trunk's two layers and the MTP block)."""
    from repro_torch.launch import MeshLayout, dry_mesh
    from repro_torch.models import ShardCtx

    layout = MeshLayout((1, 4), ranks.AXES)
    assert ShardCtx(layout, ("data",), sp=True).act4(6)[2] is None
    rank0 = _attention_flops("mla6", dry_mesh(layout))
    assert 4 * rank0 == _attention_flops("mla6", None)


def test_mistral_prefill_32k_dry_run_peak():
    from repro_torch.launch.dryrun import run_cell

    rec = run_cell("mistral-nemo-12b", "prefill_32k", False, verbose=False)
    assert rec["ok"], rec.get("trace")
    assert rec["peak_bytes"] <= PREFILL_PEAK_GIB * 2 ** 30, rec["peak_bytes"] / 2 ** 30
    assert rec["flops"] == MISTRAL_PREFILL_FLOPS
