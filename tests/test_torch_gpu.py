"""The port's CUDA kernels against their plain versions on the card.

Every test here needs a CUDA device and skips where there is none; run them
on a GPU with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
This file imports no JAX, so it runs where only the port is installed.
Tolerance: 1e-5 for random float32 on short rows (the summation order
differs); exact for 0/1 and integer lanes, and for float32 quarter-integers,
whose sums are exact in any order (the long-row float cases use them).
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cbds_p, kcore_decompose, pbahmani, pbahmani_np  # noqa: E402
from repro_torch.data import recsys_batches  # noqa: E402
from repro_torch.graphs.generators import planted_dense, rmat  # noqa: E402
from repro_torch.kernels import compact, embed, ops, peel, ref, segsum  # noqa: E402
from repro_torch.launch import build_step  # noqa: E402
from repro_torch.models import DCNConfig, dcn_init, embedding_bag  # noqa: E402
from repro_torch.refine import refine  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lanes(rng, e, v, sentinels=7, negatives=0):
    seg = np.sort(rng.integers(0, v, e)).astype(np.int32)
    return np.r_[np.full(negatives, -3, np.int32), seg,
                 np.full(sentinels, v, np.int32)].astype(np.int32)


def _layout_lanes(rng, layout, e, v):
    """Sorted ids for one case of K1: ``random`` (negative ids first,
    sentinels last), ``hub`` (most lanes in one row), ``block`` (ids in the
    first tenth of the rows, then a long empty tail, as a sampled block's),
    ``runs`` (runs of 1-1,499 lanes with gaps, so rows cross the tiles, the
    stages and the spans of the [E, D] path at every offset); ``shift<k>``
    is ``random`` with the values viewed k elements off a 16-byte boundary."""
    if layout in ("random", "shift1", "shift2", "shift3"):
        return _lanes(rng, e, v, negatives=5)
    if layout == "hub":
        ids = np.r_[np.full(e - e // 10, v // 3), rng.integers(0, v, e // 10)]
        return np.r_[np.full(3, -1), np.sort(ids), np.full(5, v + 2)].astype(np.int32)
    if layout == "block":
        return np.r_[np.sort(rng.integers(0, v // 10, e)), np.full(9, v)].astype(np.int32)
    assert layout == "runs"
    lengths = rng.integers(1, 1500, e // 500 + 2)
    rows = np.cumsum(rng.integers(1, 3, lengths.size))
    ids = np.repeat(rows * (v - 1) // (rows[-1] + 1), lengths)[:e]
    return np.r_[np.full(4, -2), ids, np.full(3, v)].astype(np.int32)


@pytest.mark.parametrize("e,d,v,kind,layout", [
    (64, 0, 16, "float32", "random"),
    (1000, 33, 300, "float32", "random"),
    (512, 128, 256, "float32", "random"),
    (100, 200, 50, "float32", "random"),
    (50_000, 0, 40, "quarters", "random"),  # rows past the one-thread length: warp rows
    (50_000, 0, 40, "bool", "random"),
    (50_000, 0, 40, "int32", "random"),
    (70_000, 0, 3, "bool", "random"),       # one hub run of most lanes
    (3000, 0, 2000, "bool", "random"),      # mostly one-thread rows, some empty
    (0, 0, 5, "bool", "random"),            # no lanes at all
    # the [E, D] path at the GNNs' widths and around them, in the three types
    *[(3000 if d < 1152 else 600, d, 300, kind, "random")
      for d in (2, 3, 7, 16, 33, 64, 1152) for kind in ("float32", "int32", "bool")],
    (60_000, 16, 500, "quarters", "hub"),
    (60_000, 16, 500, "int32", "hub"),
    (30_000, 16, 200_000, "float32", "block"),
    (3000, 1152, 20_000, "quarters", "block"),
    *[(40_000 if d < 1152 else 4000, d, 3000, kind, "runs")
      for d in (3, 7, 16, 64, 1152) for kind in ("quarters", "bool")],
    (5000, 16, 400, "float32", "shift1"),   # values off 16 bytes: the plain-load path
    (5000, 7, 400, "int32", "shift2"),
    (5000, 64, 400, "quarters", "shift3"),
    (0, 16, 5, "float32", "random"),        # no lanes: every row zero
    (0, 16, 5, "bool", "random"),
])
def test_kernel_matches_plain(cuda, e, d, v, kind, layout):
    rng = np.random.default_rng(e + d + v)
    seg = _layout_lanes(rng, layout, e, v)
    shape = (seg.size, d) if d else (seg.size,)
    vals = {"float32": lambda: rng.normal(size=shape).astype(np.float32),
            "bool": lambda: rng.random(shape) < 0.5,
            "int32": lambda: rng.integers(-3, 4, shape).astype(np.int32),
            "quarters": lambda: (rng.integers(-8, 8, shape) / 4).astype(np.float32),
            }[kind]()
    out_dtype = torch.float32 if kind in ("float32", "quarters") else torch.int32
    tv, ts = torch.from_numpy(vals).to(cuda), torch.from_numpy(seg).to(cuda)
    if layout.startswith("shift"):
        shift = int(layout[5:])
        base = torch.zeros(tv.numel() + 16, dtype=tv.dtype, device=cuda)
        tv = base[shift:shift + tv.numel()].view(shape)
        tv.copy_(torch.from_numpy(vals))
    before = segsum.launches
    out = segsum.segment_sum_sorted(tv, ts, num_segments=v, out_dtype=out_dtype)
    exp = ref.segment_sum_ref(tv, ts, v, out_dtype)
    torch.cuda.synchronize()
    assert segsum.launches == before + 1
    assert out.dtype == out_dtype and out.shape == exp.shape
    if kind == "float32":
        torch.testing.assert_close(out, exp, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(out, exp)


@pytest.mark.parametrize("shift", range(1, 16))
def test_kernel_unaligned_values(cuda, shift):
    """Values that start off a 16-byte boundary (a view into a larger
    buffer): the vector loads of long rows must still see every lane."""
    rng = np.random.default_rng(shift)
    seg = torch.from_numpy(_lanes(rng, 20_000, 30)).to(cuda)
    base = torch.from_numpy(rng.random(seg.numel() + 16) < 0.5).to(cuda)
    vals = base[shift:shift + seg.numel()]
    out = segsum.segment_sum_sorted(vals, seg, num_segments=30, out_dtype=torch.int32)
    assert torch.equal(out, ref.segment_sum_ref(vals, seg, 30, torch.int32))


def test_kernel_all_sentinel(cuda):
    seg = torch.full((700,), 1 << 20, dtype=torch.int32, device=cuda)
    out = segsum.segment_sum_sorted(torch.ones(700, device=cuda), seg, num_segments=32)
    assert torch.equal(out, torch.zeros(32, device=cuda))


def test_kernel_rejects_non_contiguous(cuda):
    vals = torch.ones(16, 2, device=cuda)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        segsum.segment_sum_sorted(vals, torch.zeros(16, dtype=torch.int32, device=cuda),
                                  num_segments=1)


def test_peel_update_matches_plain(cuda):
    g = rmat(12, 16, seed=0)
    src, dst = (torch.from_numpy(a).to(cuda) for a in g.dst_sorted())
    failed = torch.from_numpy(np.random.default_rng(1).random(g.n_nodes) < 0.3).to(cuda)
    out = ops.peel_update(src, dst, failed, n_nodes=g.n_nodes)
    assert out.dtype == torch.int32
    assert torch.equal(out, ref.peel_update_ref(src, dst, failed, g.n_nodes))


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_pbahmani_kernel_on_card(cuda, eps):
    """Kernel on == kernel off == the numpy oracle, one K2 call a pass."""
    g = rmat(12, 16, seed=0)
    before = peel.launches
    on = pbahmani(g, eps=eps, kernel=True, device=cuda)
    assert peel.launches == before + on[2]
    off = pbahmani(g, eps=eps, kernel=False, device=cuda)
    want = pbahmani_np(g, eps=eps)
    assert on[0] == off[0] and on[2] == off[2] == want[2]
    np.testing.assert_array_equal(on[1], off[1])
    np.testing.assert_array_equal(on[1], want[1])
    assert abs(on[0] - want[0]) <= 1e-6 * want[0]


def test_kcore_and_cbds_kernel_on_card(cuda):
    g = rmat(12, 16, seed=0)
    before = peel.launches
    on = kcore_decompose(g, kernel=True, device=cuda)
    assert peel.launches > before
    off = kcore_decompose(g, kernel=False, device=cuda)
    np.testing.assert_array_equal(on[0], off[0])
    assert on[1:] == off[1:]
    before = segsum.launches
    c_on = cbds_p(g, rounds=3, kernel=True, device=cuda)
    assert segsum.launches == before + 3  # K1: one e_into sum a round
    c_off = cbds_p(g, rounds=3, kernel=False, device=cuda)
    np.testing.assert_array_equal(c_on.pop("member_mask"), c_off.pop("member_mask"))
    assert c_on == c_off


# ---------------------------------------------------------------------------
# K1 on the one-pass segmented-reduction core: rows across warp tiles
# (seg_reduce.cuh: 512 lanes a tile), empty rows at tile edges, views off
# the 16-byte boundary, lane counts off a multiple of 16, float32 sums
# bitwise equal across runs
# ---------------------------------------------------------------------------
TILE = 512


def _tile_edge_lanes(rng):
    """Rows ending just before, on and after tile edges, a row longer than
    four tiles, and gaps of empty rows where tiles meet."""
    rows = [np.zeros(4 * TILE + 37, np.int32), np.full(TILE - 38, 2, np.int32),
            np.full(1, 5, np.int32), np.full(TILE, 9, np.int32),
            np.repeat(np.arange(12, 12 + 2 * 300, 2), 3).astype(np.int32),
            np.full(7, 700, np.int32)]
    return np.r_[np.full(3, -1, np.int32), np.concatenate(rows), np.full(5, 701, np.int32)]


def _values(rng, kind, shape):
    return {"bool": lambda: rng.random(shape) < 0.5,
            "int32": lambda: rng.integers(-3, 4, shape).astype(np.int32),
            "quarters": lambda: (rng.integers(-8, 8, shape) / 4).astype(np.float32)}[kind]()


@pytest.mark.parametrize("kind", ["bool", "int32", "quarters"])
@pytest.mark.parametrize("lanes", ["3 tiles + 5", "tile edges", "2^20 + 3 random"])
def test_kernel_tiles(cuda, kind, lanes):
    rng = np.random.default_rng(len(lanes) + len(kind))
    seg = {"3 tiles + 5": lambda: np.sort(rng.integers(0, 40, 3 * TILE + 5)).astype(np.int32),
           "tile edges": lambda: _tile_edge_lanes(rng),
           "2^20 + 3 random": lambda: np.sort(rng.integers(0, 50_000, (1 << 20) + 3))
           .astype(np.int32)}[lanes]()
    v = 701 if lanes == "tile edges" else int(seg.max()) + 1
    vals = torch.from_numpy(_values(rng, kind, seg.size)).to(cuda)
    ts = torch.from_numpy(seg).to(cuda)
    out_dtype = torch.float32 if kind == "quarters" else torch.int32
    out = segsum.segment_sum_sorted(vals, ts, num_segments=v, out_dtype=out_dtype)
    assert torch.equal(out, ref.segment_sum_ref(vals, ts, v, out_dtype))


@pytest.mark.parametrize("kind", ["int32", "quarters"])
@pytest.mark.parametrize("shift", range(1, 16))
def test_kernel_unaligned_views(cuda, kind, shift):
    """4-byte values and the ids themselves off the 16-byte boundary."""
    rng = np.random.default_rng(100 + shift)
    seg = _tile_edge_lanes(rng)
    base = torch.from_numpy(_values(rng, kind, seg.size + 16)).to(cuda)
    vals = base[shift:shift + seg.size]
    seg_base = torch.from_numpy(np.r_[np.full(16, -1, np.int32), seg]).to(cuda)
    ids = seg_base[shift:shift + seg.size]
    out_dtype = torch.float32 if kind == "quarters" else torch.int32
    for ts in (torch.from_numpy(seg).to(cuda), ids):
        v = vals[:ts.numel()]
        out = segsum.segment_sum_sorted(v, ts, num_segments=701, out_dtype=out_dtype)
        assert torch.equal(out, ref.segment_sum_ref(v, ts, 701, out_dtype))


@pytest.mark.parametrize("d", [1, 16, 1152])
def test_kernel_float_sums_bitwise_repeatable(cuda, d):
    """float32 sums of random values: bitwise equal across two runs
    (crossing rows are added in tile order at D = 1, in span order at
    D > 1) and within 1e-6 of each row's sum of |values| of the exact
    (float64) sum. The plain version's atomic adds change their order from
    run to run, so the bound is taken against float64, not against them: a
    40,000-lane row of normals has |sum| near 200 and sum |values| near
    32,000, and float32 rounding in any order leaves a few 1e-3 of error
    there. At D > 1 rows cross tiles, stages and spans."""
    rng = np.random.default_rng(8)
    hub, rest, v = (40_000, 300_000, 5000) if d < 1152 else (2000, 20_000, 2000)
    seg = torch.from_numpy(np.r_[np.zeros(hub, np.int32),
                                 np.sort(rng.integers(1, v, rest)).astype(np.int32)]).to(cuda)
    shape = (seg.numel(),) if d == 1 else (seg.numel(), d)
    vals = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    a = segsum.segment_sum_sorted(vals, seg, num_segments=v)
    b = segsum.segment_sum_sorted(vals, seg, num_segments=v)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    exact = ref.segment_sum_ref(vals.double(), seg, v, torch.float64)
    scale = ref.segment_sum_ref(vals.double().abs(), seg, v, torch.float64)
    assert bool(((a.double() - exact).abs() <= 1e-6 * scale + 1e-6).all())


# ---------------------------------------------------------------------------
# K2 (peel_edges): the fused edge stage against its plain version, with the
# vertex state in shared memory and through L1/L2
# ---------------------------------------------------------------------------
def _peel_lanes(rng, n, e, hub=0, src_past_n=0, sentinels=9):
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    dst[:hub] = n // 3
    src[hub:hub + src_past_n] = n + rng.integers(0, 3, src_past_n)
    order = np.argsort(dst, kind="stable")
    return (np.r_[src[order], np.full(sentinels, n)].astype(np.int32),
            np.r_[dst[order], np.full(sentinels, n)].astype(np.int32))


@pytest.mark.parametrize("shared_state", [True, False])
@pytest.mark.parametrize("n,e,p_fail,p_active,hub,src_past_n", [
    (50, 3000, 0.3, 0.8, 0, 0),
    (1000, 3 * TILE + 5, 0.5, 0.9, 0, 40),    # src past the sentinel
    (300, 20_000, 1.0, 1.0, 0, 0),            # all failed
    (300, 20_000, 0.0, 1.0, 0, 0),            # none failed
    (300, 20_000, 0.5, 0.0, 0, 0),            # all dead
    (5000, 600, 0.4, 0.7, 0, 0),              # mostly isolated vertices
    (200, 60_000, 0.3, 0.9, 50_000, 0),       # a 50,000-lane hub row
    (1 << 19, 1 << 21, 0.3, 0.9, 0, 0),       # the main path's vertex count
])
def test_peel_edges_matches_plain(cuda, monkeypatch, shared_state, n, e, p_fail, p_active,
                                  hub, src_past_n):
    """K2 with its vertex state in shared memory and through L1/L2."""
    if not shared_state:
        monkeypatch.setattr(peel, "SHARED_STATE_BYTES", 0)
    rng = np.random.default_rng(n + e)
    src, dst = (torch.from_numpy(a).to(cuda)
                for a in _peel_lanes(rng, n, e, hub=hub, src_past_n=src_past_n))
    active = torch.from_numpy(rng.random(n) < p_active).to(cuda)
    failed = active & torch.from_numpy(rng.random(n) < p_fail).to(cuda)
    for act in (active, None):
        for charge in (False, True):
            before = peel.launches
            got = peel.peel_edges_sorted(src, dst, act, failed, n_nodes=n, charge=charge)
            want = ref.peel_edges_ref(src, dst, act, failed, n, charge)
            torch.cuda.synchronize()
            assert peel.launches == before + 1
            assert len(got) == len(want)
            for x, w in zip(got, want):
                assert x.dtype == torch.int32 and torch.equal(x, w)
    assert torch.equal(ops.peel_update(src, dst, failed, n_nodes=n),
                       ref.peel_update_ref(src, dst, failed, n))


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_peel_edges_unaligned_views(cuda, shift):
    rng = np.random.default_rng(shift)
    src, dst = _peel_lanes(rng, 700, 9000)
    sb = torch.from_numpy(np.r_[np.zeros(shift, np.int32), src]).to(cuda)[shift:]
    db = torch.from_numpy(np.r_[np.zeros(shift, np.int32), dst]).to(cuda)[shift:]
    for s, d in ((sb, db), (sb, torch.from_numpy(dst).to(cuda))):
        active = torch.from_numpy(rng.random(700) < 0.8).to(cuda)
        failed = active & torch.from_numpy(rng.random(700) < 0.4).to(cuda)
        got = peel.peel_edges_sorted(s, d, active, failed, n_nodes=700, charge=True)
        for x, w in zip(got, ref.peel_edges_ref(s, d, active, failed, 700, True)):
            assert torch.equal(x, w)


# ---------------------------------------------------------------------------
# K3 (prefix sum) and K4 (stream compaction): exact against the plain
# versions, at the cases of tests/test_kernels.py and beyond the float32
# envelope of the JAX kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("e,kind", [
    (1, "int32"), (7, "int32"), (511, "int32"), (512, "int32"), (513, "int32"),
    (1500, "int32"), (4095, "bool"), (4096, "bool"), (4097, "bool"),
    (3 * 512 + 5, "ones"), (513, "zeros"), (1_000_003, "bool"),
    (4_194_304 * 1 + 17, "signed"),   # int32 with negatives, many tiles
    ((1 << 24) + 5, "ones"),          # total past 2^24: int32 stays exact
])
def test_prefix_sum_matches_plain(cuda, e, kind):
    rng = np.random.default_rng(e)
    x = {"int32": lambda: rng.integers(0, 4, e).astype(np.int32),
         "bool": lambda: rng.random(e) < 0.4,
         "ones": lambda: np.ones(e, bool),
         "zeros": lambda: np.zeros(e, np.int32),
         "signed": lambda: rng.integers(-5, 6, e).astype(np.int32)}[kind]()
    tx = torch.from_numpy(x).to(cuda)
    before = compact.prefix_sum_launches
    out = compact.prefix_sum(tx)
    torch.cuda.synchronize()
    assert compact.prefix_sum_launches == before + 1
    assert out.dtype == torch.int32 and torch.equal(out, ref.prefix_sum_ref(tx))
    if kind == "ones":
        assert int(out[-1]) == e


@pytest.mark.parametrize("shift", [1, 3, 4, 8, 15])
def test_prefix_sum_unaligned(cuda, shift):
    """Inputs and lengths off the 16-byte vector boundary take the scalar
    path for their ragged lanes and must still see every lane."""
    base = torch.from_numpy(np.random.default_rng(shift).random(20_000) < 0.5).to(cuda)
    x = base[shift:shift + 10_001]
    assert torch.equal(compact.prefix_sum(x), ref.prefix_sum_ref(x))
    xi = base.to(torch.int32)[shift:shift + 10_001]
    assert torch.equal(compact.prefix_sum(xi), ref.prefix_sum_ref(xi))


def _scan_input(rng, kind, e):
    if kind == "bool":
        return rng.random(e) < 0.4
    return rng.integers(-7, 8, e).astype(np.int32)


@pytest.mark.parametrize("kind", ["bool", "int32"])
@pytest.mark.parametrize("e", [0, 1, 15, 16, 4095, 4096, 4097, 8191, 8192, 8193, "wave",
                               (1 << 26) + 3])
def test_prefix_sum_one_pass_lengths(cuda, kind, e):
    """The one-pass scan at the edges of a thread's 16 lanes and of a tile
    (8,192 lanes; K4's 4,096 too), past one wave of resident blocks (where
    the look-back waits on tiles still running) and at 2^26 + 3 lanes; one
    launch a call."""
    if e == "wave":  # a tile more than the card holds at once (4 blocks of 8,192
        # lanes an SM, 8 of K4's 4,096), and a ragged end
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        e = (sms * 8 + 1) * compact.TILE + 5
    x = torch.from_numpy(_scan_input(np.random.default_rng(e % 997), kind, e)).to(cuda)
    before = compact.prefix_sum_launches
    out = compact.prefix_sum(x)
    torch.cuda.synchronize()
    assert compact.prefix_sum_launches == before + (1 if e else 0)
    assert out.dtype == torch.int32 and out.shape == (e,)
    assert torch.equal(out, ref.prefix_sum_ref(x))


@pytest.mark.parametrize("kind", ["bool", "int32"])
@pytest.mark.parametrize("shift", [1, 5, 16])
def test_prefix_sum_unaligned_many_tiles(cuda, kind, shift):
    """A view that starts off a 16-byte boundary and spans many tiles: every
    thread's lanes take the scalar path and the tiles still chain."""
    base = torch.from_numpy(_scan_input(np.random.default_rng(shift), kind,
                                        40 * compact.TILE)).to(cuda)
    x = base[shift:shift + 37 * compact.TILE + 3]
    assert torch.equal(compact.prefix_sum(x), ref.prefix_sum_ref(x))


def test_prefix_sum_back_to_back(cuda):
    """Masks in a row, each of another length, the last smaller than the
    first: stale tile status from an earlier call would show here."""
    rng = np.random.default_rng(13)
    xs = [torch.from_numpy(rng.random(e) < p).to(cuda)
          for e, p in [(3_000_017, 0.5), (2_000_003, 0.9), (70_001, 0.1), (524_288, 0.3)]]
    outs = [compact.prefix_sum(x) for x in xs]
    for x, out in zip(xs, outs):
        assert torch.equal(out, ref.prefix_sum_ref(x))


def test_prefix_sum_two_streams(cuda):
    """Calls on two streams at once: each takes its own status words."""
    rng = np.random.default_rng(14)
    xs = [torch.from_numpy(rng.random(1_500_007) < p).to(cuda) for p in (0.3, 0.7)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    for _ in range(4):
        for k, (stream, x) in enumerate(zip(streams, xs)):
            with torch.cuda.stream(stream):
                outs[k].append(compact.prefix_sum(x))
    torch.cuda.synchronize()
    for k, x in enumerate(xs):
        exp = ref.prefix_sum_ref(x)
        assert all(torch.equal(o, exp) for o in outs[k])


def test_scan_ceiling_is_tile_local(cuda):
    """The diagnostic pass without look-back: each 8,192-lane tile holds its
    own inclusive sums, and it counts no K3 launch."""
    x = torch.from_numpy(np.random.default_rng(16).random(3 * 8192 + 5) < 0.5).to(cuda)
    before = compact.prefix_sum_launches
    out = compact.scan_ceiling(x)
    assert compact.prefix_sum_launches == before
    pad = torch.zeros(4 * 8192, dtype=torch.bool, device=cuda)
    pad[:x.shape[0]] = x
    exp = torch.cumsum(pad.view(4, 8192), 1, dtype=torch.int32).view(-1)[:x.shape[0]]
    assert torch.equal(out, exp)


def test_prefix_sum_is_one_launch_after_one_memset(cuda):
    """What the card runs for one call, by the profiler: one memset of the
    status words and one kernel, whatever the length."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(np.random.default_rng(15).random(8 * 1024 * 1024) < 0.5).to(cuda)
    compact.prefix_sum(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        compact.prefix_sum(x)
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    kernels = [n for n in names if "memset" not in n.lower()]
    assert len(names) == 2 and len(kernels) == 1 and "scan_kernel" in kernels[0], names


@pytest.mark.parametrize("e,d,out_size,p_live", [
    (100, 0, 128, 0.5),
    (1500, 0, 1024, 0.7),
    (513, 0, 512, 0.3),
    (64, 0, 16, 0.9),         # overflow: survivors past out_size drop
    (400, 2, 256, 0.6),       # remapped src/dst pairs
    (300, 0, 64, 0.0),        # all dead
    (300, 0, 512, 1.0),       # all live
    (0, 2, 8, 0.5),           # no lanes: all fill
    (1 << 20, 2, 1 << 17, 0.1),
])
def test_stream_compact_matches_plain(cuda, e, d, out_size, p_live):
    rng = np.random.default_rng(e + out_size)
    values = rng.integers(0, 10_000, (e, d) if d else e).astype(np.int32)
    live = rng.random(e) < p_live
    tv, tl = torch.from_numpy(values).to(cuda), torch.from_numpy(live).to(cuda)
    before = compact.stream_compact_launches
    out = compact.stream_compact(tv, tl, out_size=out_size, fill=out_size)
    torch.cuda.synchronize()
    assert compact.stream_compact_launches == before + 1
    assert torch.equal(out, ref.stream_compact_ref(tv, tl, out_size, out_size))


def test_stream_compact_keeps_order(cuda):
    rng = np.random.default_rng(3)
    dst = torch.from_numpy(np.sort(rng.integers(0, 40, 4000)).astype(np.int32)).to(cuda)
    src = torch.from_numpy(rng.integers(0, 40, 4000).astype(np.int32)).to(cuda)
    live = torch.from_numpy(rng.random(4000) < 0.6).to(cuda)
    packed = compact.stream_compact(torch.stack([src, dst], 1), live, out_size=4096,
                                    fill=4096)
    k = int(live.sum())
    assert torch.equal(packed[:k, 1], dst[live]) and torch.equal(packed[:k, 0], src[live])
    assert bool((packed[k:] == 4096).all())


@pytest.mark.parametrize("e,d,out_size,p_live", [
    (1, 2, 4, 1.0),
    (compact.TILE - 1, 2, compact.TILE, 0.5),
    (compact.TILE, 0, compact.TILE, 1.0),
    (compact.TILE + 1, 1, 3 * compact.TILE, 0.4),      # a fill tail of over a tile
    ((1 << 20) + 1, 2, 1 << 17, 0.3),                 # out_size below the live count
    ((1 << 26) + 3, 2, 1 << 24, 0.2),                 # 16,385 tiles: more than one wave
])
def test_stream_compact_tiles_and_waves(cuda, e, d, out_size, p_live):
    """The one-pass kernel across its tile edges and past one wave of
    resident blocks, where the look-back must wait on tiles still running."""
    rng = np.random.default_rng(e % 1000 + d)
    values = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (e, d) if d > 1 else e,
                                           dtype=np.int64).astype(np.int32)).to(cuda)
    live = torch.from_numpy(rng.random(e) < p_live).to(cuda)
    before = (compact.prefix_sum_launches, compact.stream_compact_launches)
    out = compact.stream_compact(values, live, out_size=out_size, fill=-9)
    torch.cuda.synchronize()
    assert (compact.prefix_sum_launches, compact.stream_compact_launches) == (
        before[0], before[1] + 1)
    assert torch.equal(out, ref.stream_compact_ref(values, live, out_size, -9))


def test_stream_compact_back_to_back_masks(cuda):
    """Three calls in a row with a different mask each, the last smaller than
    the first: stale tile status from an earlier call would show here."""
    rng = np.random.default_rng(11)
    for e, p_live in [(3_000_017, 0.5), (2_000_003, 0.9), (70_001, 0.1)]:
        values = torch.from_numpy(rng.integers(0, 1 << 30, (e, 2)).astype(np.int32)).to(cuda)
        live = torch.from_numpy(rng.random(e) < p_live).to(cuda)
        out = compact.stream_compact(values, live, out_size=e // 2, fill=7)
        assert torch.equal(out, ref.stream_compact_ref(values, live, e // 2, 7))


def test_stream_compact_two_streams(cuda):
    """Calls on two streams at once: each takes its own status words."""
    rng = np.random.default_rng(12)
    inputs = [(torch.from_numpy(rng.integers(0, 1000, 1_500_007).astype(np.int32)).to(cuda),
               torch.from_numpy(rng.random(1_500_007) < p).to(cuda)) for p in (0.3, 0.7)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    for _ in range(4):
        for k, (stream, (values, live)) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(stream):
                outs[k].append(compact.stream_compact(values, live, out_size=1_000_000,
                                                      fill=-1))
    torch.cuda.synchronize()
    for k, (values, live) in enumerate(inputs):
        exp = ref.stream_compact_ref(values, live, 1_000_000, -1)
        assert all(torch.equal(o, exp) for o in outs[k])


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_pruned_kernel_on_card(cuda, eps):
    """Pruned with the kernels on == off == unpruned == the numpy oracle on a
    small planted block, with two K3 and three K4 calls a query (the
    resident prep's and the ladder's)."""
    g, _, _ = planted_dense(4096, 64, seed=0)
    compact.prefix_sum_launches = compact.stream_compact_launches = 0
    before = peel.launches
    on = pbahmani(g, eps=eps, pruned=True, kernel=True, device=cuda)
    assert (compact.prefix_sum_launches, compact.stream_compact_launches) == (2, 3)
    assert peel.launches > before
    off = pbahmani(g, eps=eps, pruned=True, kernel=False, device=cuda)
    plain = pbahmani(g, eps=eps, kernel=True, device=cuda)
    want = pbahmani_np(g, eps=eps)
    for got in (off, plain):
        assert got[0] == on[0] and got[2] == on[2]
        np.testing.assert_array_equal(got[1], on[1])
    assert on[2] == want[2] and abs(on[0] - want[0]) <= 1e-6 * want[0]
    np.testing.assert_array_equal(on[1], want[1])


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_resident_prep_on_card_matches_host_prep(cuda, eps):
    """The resident prep on the card (K1, K2, K3, K4) == the host prep on the
    planted block: every integer, best_d1's bits, the masks, perm where a1
    holds, the plan and the bucket arrays lane for lane."""
    from repro_torch.core import prune
    from repro_torch.graphs.convert import to_device

    g, _, _ = planted_dense(4096, 64, seed=0)
    plan = prune.plan_for_graph(g, kernel=True, device=cuda)
    u, v = prune.slot_arrays(g)
    want = prune.prepare_pruned_peel(u, v, g.degrees(), g.n_edges, eps, plan)
    src, dst = to_device(g, cuda, sorted=True)
    got = prune.prepare_pruned_peel_resident(src, dst, g.n_nodes, g.n_edges, eps, plan,
                                             kernel=True)
    assert isinstance(want, prune.PrunedDispatch) and isinstance(got, prune.PrunedDispatch)
    assert (got.n_v1, got.n_e1, got.better1, got.observed, got.plan) == (
        want.n_v1, want.n_e1, want.better1, want.observed, want.plan)
    assert np.float32(got.best_d1).view(np.int32) == np.float32(want.best_d1).view(np.int32)
    a1 = got.a1.cpu().numpy()
    np.testing.assert_array_equal(a1, want.a1)
    np.testing.assert_array_equal(got.active0.cpu().numpy(), want.active0)
    np.testing.assert_array_equal(got.perm.cpu().numpy()[a1], want.perm[want.a1])
    np.testing.assert_array_equal(got.b_src.cpu().numpy(), want.b_src)
    np.testing.assert_array_equal(got.b_dst.cpu().numpy(), want.b_dst)


def test_refine_kernel_on_card(cuda):
    g = rmat(11, 16, seed=0)
    before = peel.launches
    on = refine(g, target_gap=-1.0, max_rounds=3, eps=0.1, kernel=True, device=cuda)
    assert peel.launches > before
    off = refine(g, target_gap=-1.0, max_rounds=3, eps=0.1, kernel=False, device=cuda)
    assert on.certificate == off.certificate and on.history == off.history
    np.testing.assert_array_equal(on.mask, off.mask)


# ---------------------------------------------------------------------------
# K5 (segment_embed): the fused gather and segment-sum against its plain
# version, at the cases of the CPU tests, at DCN-v2's 26 tables, and through
# the model (rtol 1e-5, atol 1e-6 for the bags: float32 sums of a few rows
# in another order; rtol 1e-4, atol 1e-5 for logits and scores). Bags of
# 60 and more rows use quarter-integer tables and weights, whose sums are
# exact in any order: with random floats the plain version's atomic adds
# differ from the kernel's lane order by up to 1.5e-5 on 300-row bags
# (measured on the H100), past the short bags' tolerance.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t,n,d,e,v,weighted,invalid,quarters", [
    (1, 50, 16, 1000, 300, True, False, False),   # the cases of tests/test_kernels.py
    (1, 20, 64, 200, 64, False, False, False),
    (1, 100, 8, 64, 8, True, False, False),
    (1, 50, 16, 1000, 300, True, True, False),    # ids < 0 and >= R, seg ids < 0 and >= V
    (1, 30, 7, 500, 40, False, True, False),      # D not a multiple of 4: the scalar path
    (1, 30, 200, 3000, 50, True, False, True),    # rows wider than a warp's vectors
    (1, 10, 16, 5, 400, False, False, False),     # mostly empty bags
    (1, 10, 16, 0, 9, True, False, False),        # no lanes at all
    (3, 1000, 16, 20_000, 64, True, True, True),  # long bags (the UNROLL loop and tail)
    (26, 5000, 16, 4 * 2048, 2048, False, False, False),  # DCN-v2's 26 tables, 4 ids a bag
    (26, 5000, 16, 4 * 2048, 2048, True, True, False),
])
def test_segment_embed_matches_plain(cuda, t, n, d, e, v, weighted, invalid, quarters):
    rng = np.random.default_rng(t + n + d + e)
    lo, hi = (-n, 2 * n) if invalid else (0, n)
    vals = (rng.integers(-8, 8, (t, n, d)) / 4 if quarters
            else rng.normal(size=(t, n, d))).astype(np.float32)
    tables = torch.from_numpy(vals).to(cuda)
    gid = torch.from_numpy(rng.integers(lo, hi, (t, e)).astype(np.int32)).to(cuda)
    seg = np.sort(rng.integers(-3 if invalid else 0, v + 3 if invalid else v, e))
    seg = torch.from_numpy(seg.astype(np.int32)).to(cuda)
    w = rng.integers(0, 8, (t, e)) / 4 if quarters else rng.random((t, e))
    w = torch.from_numpy(w.astype(np.float32)).to(cuda) if weighted else None
    if t == 1:
        tables, gid, w = tables[0], gid[0], None if w is None else w[0]
    before = embed.launches
    out = embed.segment_embed_sorted(tables, gid, seg, w, num_segments=v)
    exp = ref.segment_embed_ref(tables, gid, seg, w, v)
    torch.cuda.synchronize()
    assert embed.launches == before + 1
    assert out.shape == exp.shape and out.dtype == torch.float32
    if quarters:
        assert torch.equal(out, exp)
    else:
        torch.testing.assert_close(out, exp, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_segment_embed_unaligned_table(cuda, shift):
    """A table that starts off a 16-byte boundary takes the scalar path."""
    rng = np.random.default_rng(shift)
    base = torch.from_numpy(rng.normal(size=40 * 16 + 4).astype(np.float32)).to(cuda)
    table = base[shift:shift + 40 * 16].view(40, 16)
    gid = torch.from_numpy(rng.integers(0, 40, 900).astype(np.int32)).to(cuda)
    seg = torch.from_numpy(np.sort(rng.integers(0, 100, 900)).astype(np.int32)).to(cuda)
    out = embed.segment_embed_sorted(table, gid, seg, num_segments=100)
    torch.testing.assert_close(out, ref.segment_embed_ref(table, gid, seg, None, 100),
                               rtol=1e-5, atol=1e-6)


def test_segment_embed_unsorted_and_checks(cuda):
    rng = np.random.default_rng(7)
    tables = torch.from_numpy(rng.normal(size=(4, 60, 8)).astype(np.float32)).to(cuda)
    gid = torch.from_numpy(rng.integers(0, 60, (4, 700)).astype(np.int32)).to(cuda)
    seg = torch.from_numpy(rng.integers(0, 90, 700).astype(np.int32)).to(cuda)
    before = ops.unsorted_fallback_count
    out = ops.segment_embed(tables, gid, seg, num_segments=90, presorted=False)
    assert ops.unsorted_fallback_count == before + 1
    torch.testing.assert_close(out, ref.segment_embed_ref(tables, gid, seg, None, 90),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        embed.segment_embed_sorted(tables, gid[:, ::2], seg[:350].sort().values,
                                   num_segments=90)
    with pytest.raises(RuntimeError, match="no backward"):
        embed.segment_embed_sorted(tables.requires_grad_(), gid, seg.sort().values,
                                   num_segments=90)


@pytest.mark.parametrize("t,m,shift,weighted", [(1, 4, 0, False), (26, 4, 0, False),
                                                (26, 4, 1, False), (5, 3, 0, True),
                                                (26, 1, 0, False), (3, 9, 2, True)])
def test_segment_embed_strided_ids(cuda, t, m, shift, weighted):
    """Ids (and weights) as the [T, B, M] view of [B, T, M] arrays (what
    embedding_bag hands K5): equal to the plain version, bitwise equal to
    the same lanes copied contiguous and across repeated calls; invalid ids
    drop; tables off a 16-byte boundary (shift) take the scalar path."""
    rng = np.random.default_rng(t * 10 + m + shift)
    b, n, d = 3000, 500, 16
    base = torch.from_numpy(rng.normal(size=t * n * d + 4).astype(np.float32)).to(cuda)
    tables = base[shift:shift + t * n * d].view(t, n, d)
    ids = torch.from_numpy(rng.integers(-3, n + 3, (b, t, m)).astype(np.int32)).to(cuda)
    view = ids.permute(1, 0, 2)
    w = (torch.from_numpy(rng.random((b, t, m)).astype(np.float32)).to(cuda).permute(1, 0, 2)
         if weighted else None)
    seg = torch.arange(b, dtype=torch.int32, device=cuda)[:, None].expand(b, m).contiguous()
    seg = seg.view(-1)
    before = embed.launches
    out = embed.segment_embed_sorted(tables, view, seg, w, num_segments=b)
    again = embed.segment_embed_sorted(tables, view, seg, w, num_segments=b)
    flat = embed.segment_embed_sorted(tables, view.reshape(t, -1).contiguous(), seg,
                                      None if w is None else w.reshape(t, -1).contiguous(),
                                      num_segments=b)
    torch.cuda.synchronize()
    assert embed.launches == before + 3
    assert torch.equal(out, again) and torch.equal(out, flat)
    torch.testing.assert_close(out, ref.segment_embed_ref(tables, view, seg, w, b),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("t", [1, 26])
def test_segment_embed_bag_sizes(cuda, t):
    """Empty bags and bags of 1, 4 and 1,000 lanes side by side (the bounds'
    guess misses and the search takes over), with invalid ids; quarter-
    integer data, so the sums are exact in any order."""
    rng = np.random.default_rng(40 + t)
    sizes = np.array([0, 1, 4, 1000, 0, 4, 4, 1, 0, 0, 4, 1000, 1, 4] * 20)
    seg = torch.from_numpy(np.repeat(np.arange(sizes.size), sizes).astype(np.int32)).to(cuda)
    n, d, e = 800, 16, int(sizes.sum())
    tables = torch.from_numpy((rng.integers(-8, 8, (t, n, d)) / 4).astype(np.float32)).to(cuda)
    gid = torch.from_numpy(rng.integers(-5, n + 5, (t, e)).astype(np.int32)).to(cuda)
    out = embed.segment_embed_sorted(tables, gid, seg, num_segments=sizes.size + 2)
    exp = ref.segment_embed_ref(tables, gid, seg, None, sizes.size + 2)
    torch.cuda.synchronize()
    assert torch.equal(out, exp)


@pytest.mark.parametrize("cross_rank", [0, 4])
def test_dcn_kernel_on_card(cuda, cross_rank):
    """DCN-v2 at the CPU tests' widths, multi-hot: K5 on == the plain path on
    the same module, through the serve and retrieval steps."""
    cfg = DCNConfig(table_rows=500, embed_dim=8, n_cross_layers=2, mlp=(32, 16),
                    cross_rank=cross_rank, multi_hot=4, kernel=True)
    model = dcn_init(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    plain = dataclasses.replace(cfg, kernel=False)
    batch = next(recsys_batches(cfg, 64, seed=1))
    ids = torch.from_numpy(batch["sparse_ids"]).to(cuda)
    with torch.no_grad():
        before = embed.launches
        bags = embedding_bag(model.tables, ids, cfg)
        assert embed.launches == before + 1
        torch.testing.assert_close(bags, embedding_bag(model.tables, ids, plain),
                                   rtol=1e-5, atol=1e-6)
    serve = build_step("dcn-v2", "serve_p99")
    on = serve.fn(model, batch)
    model.cfg = plain
    off = serve.fn(model, batch)
    torch.testing.assert_close(on, off, rtol=1e-4, atol=1e-5)
    batch["candidates"] = np.random.default_rng(2).normal(size=(5000, 8)).astype(np.float32)
    retr = build_step("dcn-v2", "retrieval_cand")
    off = retr.fn(model, batch)
    model.cfg = cfg
    torch.testing.assert_close(retr.fn(model, batch), off, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the streaming engine on the card
# ---------------------------------------------------------------------------
def _stream_events(rng, n, n_batches, events):
    """Churn batches of 80 % inserts and 20 % deletes of present edges."""
    edges: set = set()
    for _ in range(n_batches):
        ins = rng.integers(0, n, (events * 4 // 5, 2))
        pool = np.asarray(sorted(edges)) if edges else np.zeros((0, 2), np.int64)
        dels = pool[rng.choice(len(pool), min(events // 5, len(pool)), replace=False)]
        edges -= {(int(u), int(v)) for u, v in dels}
        edges |= {(min(int(u), int(v)), max(int(u), int(v))) for u, v in ins if u != v}
        yield ins, dels


def _same_answer(a, b):
    assert np.float32(a.density).view(np.int32) == np.float32(b.density).view(np.int32)
    assert a.passes == b.passes and (a.pruned, a.refreshed) == (b.pruned, b.refreshed)
    np.testing.assert_array_equal(a.mask, b.mask)
    np.testing.assert_array_equal(a.warm_mask, b.warm_mask)


def test_stream_engine_on_card_matches_off_and_cpu(cuda):
    """300 churn batches into engines on the card with the kernels on and
    off and one on the CPU: the same answer after every batch, the
    refreshes and refined queries included, and the same cbds."""
    from repro_torch.stream import DeltaEngine

    cfg = dict(n_nodes=600, eps=0.1, capacity=2048, refresh_every=6)
    engines = [DeltaEngine(**cfg, kernel=True, device=cuda),
               DeltaEngine(**cfg, kernel=False, device=cuda),
               DeltaEngine(**cfg, device="cpu")]
    before = peel.launches
    rng = np.random.default_rng(0)
    for i, (ins, dels) in enumerate(_stream_events(rng, 600, 300, 40)):
        for eng in engines:
            eng.apply_updates(insert=ins, delete=dels)
        answers = [eng.query(refine=i % 50 == 49, max_refine_rounds=4) for eng in engines]
        for other in answers[1:]:
            _same_answer(answers[0], other)
    assert peel.launches > before and engines[0].metrics.n_pruned_queries > 0
    assert engines[0].metrics.n_refreshes > 10
    cb = [eng.cbds() for eng in engines]
    for other in cb[1:]:
        assert other["density"] == cb[0]["density"] and other["k_star"] == cb[0]["k_star"]
        np.testing.assert_array_equal(other["member_mask"], cb[0]["member_mask"])


def test_stream_kernel_passes_see_sorted_lanes(cuda, monkeypatch):
    """Every K2 and K1 hand-off of a kernel-mode engine (warm, pruned and
    refined queries, refreshes, cbds) ascends in dst, checked on the card."""
    from repro_torch.stream import DeltaEngine

    real_k2, real_k1 = peel.peel_edges_sorted, ops.segment_sum_sorted
    checked, n_k1 = [], [0]

    def k2(src, dst, active, failed, **kw):
        checked.append(bool(torch.all(dst[1:] >= dst[:-1])))
        return real_k2(src, dst, active, failed, **kw)

    def k1(values, seg_ids, **kw):
        n_k1[0] += 1
        checked.append(bool(torch.all(seg_ids[1:] >= seg_ids[:-1])))
        return real_k1(values, seg_ids, **kw)

    monkeypatch.setattr(peel, "peel_edges_sorted", k2)
    monkeypatch.setattr(ops, "segment_sum_sorted", k1)
    for pruned in (True, False):
        eng = DeltaEngine(400, eps=0.1, capacity=2048, refresh_every=5, pruned=pruned,
                          kernel=True, device=cuda)
        for i, (ins, dels) in enumerate(_stream_events(np.random.default_rng(1), 400, 30, 60)):
            eng.apply_updates(insert=ins, delete=dels)
            eng.query(refine=i % 10 == 9, max_refine_rounds=3)
        eng.cbds()
    assert len(checked) > 100 and all(checked)
    assert n_k1[0] > 0


def test_stream_lane_perm_consistent_after_resort(cuda):
    """Patch, re-sort, patch again, re-sort: dst and the degrees equal a fresh
    resync's, and lane_perm still sends each slot's two lanes to its (u, v)."""
    from repro_torch.stream import DeltaEngine

    eng = DeltaEngine(5000, capacity=1 << 15, refresh_every=10**9, pruned=False,
                      kernel=True, device=cuda)
    rng = np.random.default_rng(2)
    eng.apply_updates(insert=rng.integers(0, 5000, (20000, 2)))
    for _ in range(2):
        pool = np.asarray(sorted(eng.buffer._slot))
        eng.apply_updates(insert=rng.integers(0, 5000, (3000, 2)),
                          delete=pool[rng.choice(len(pool), 2000, replace=False)])
        assert not eng._sorted
        eng._lanes()
        assert bool(torch.all(eng._dst[1:] >= eng._dst[:-1]))
    got = [x.clone() for x in (eng._src, eng._dst, eng._deg, eng._lane_perm)]
    eng._resync_device()
    assert torch.equal(got[1], eng._dst) and torch.equal(got[2], eng._deg)
    u, v = (torch.from_numpy(a).to(cuda) for a in eng.buffer.host_view())
    cap = eng.buffer.capacity
    for s, d, p in ((got[0], got[1], got[3]), (eng._src, eng._dst, eng._lane_perm)):
        p = p.long()
        assert torch.equal(s[p[:cap]], u) and torch.equal(d[p[:cap]], v)
        assert torch.equal(s[p[cap:]], v) and torch.equal(d[p[cap:]], u)
        assert torch.equal(torch.sort(p).values, torch.arange(2 * cap, device=cuda))


# ---------------------------------------------------------------------------
# row-batched K1 and K2 (the fused tenants' passes) and the fused flush
# ---------------------------------------------------------------------------
def _row_lanes(rng, g, L, v, hub=False):
    """[g, L] int32 lanes, each row dst-sorted with a ragged sentinel tail;
    row 1 (when there is one) all sentinel. ``hub``: row 0 has no tail and
    three quarters of its lanes share one dst (a run across many tiles)."""
    src = rng.integers(0, v, (g, L)).astype(np.int32)
    dst = rng.integers(0, v, (g, L)).astype(np.int32)
    for r in range(g):
        k = 0 if r == 1 else int(rng.integers(0, L + 1))
        if hub and r == 0:
            k = L
            dst[r, :3 * L // 4] = v // 2
        src[r, k:], dst[r, k:] = v, v
        order = np.argsort(dst[r], kind="stable")
        src[r], dst[r] = src[r][order], dst[r][order]
    return src, dst


@pytest.mark.parametrize("g,L,v", [(1, 5000, 300), (3, 1, 4), (5, 777, 40), (7, 513, 1),
                                   (32, 4096, 1024), (4, 70_000, 3), (2, 0, 6),
                                   (9, 1000, 20_000)])
def test_peel_edges_rows_matches_plain(cuda, g, L, v):
    """K2's rows entry against its plain version at ragged G and L: rows
    shorter than a tile and rows of many tiles, hub runs, an empty row, a
    row of one vertex, with and without the live mask and the charges, and
    on unaligned views."""
    rng = np.random.default_rng(g * 31 + L + v)
    src, dst = _row_lanes(rng, g, L, v)
    active = rng.random((g, v)) < 0.85
    failed = rng.random((g, v)) < 0.35
    for shift in (0, 1):
        flat = [torch.from_numpy(np.r_[np.zeros(shift, np.int32), x.ravel()]).to(cuda)
                for x in (src, dst)]
        s, d = (t[shift:].view(g, L) for t in flat)
        a, f = (torch.from_numpy(x).to(cuda) for x in (active, failed))
        for act in (a, None):
            for charge in (False, True):
                before = peel.rows_launches
                got = peel.peel_edges_rows(s, d, act, f, n_nodes=v, charge=charge)
                assert peel.rows_launches == before + (1 if g and v else 0)
                want = ref.peel_edges_rows_ref(s.cpu(), d.cpu(), None if act is None
                                               else act.cpu(), f.cpu(), v, charge)
                for x, w in zip(got, want):
                    assert torch.equal(x.cpu(), w), (shift, act is None, charge)


@pytest.mark.parametrize("g,L,v,kind", [(1, 3000, 100, "bool"), (6, 513, 7, "int32"),
                                        (32, 4096, 1024, "bool"), (3, 1, 1, "bool"),
                                        (4, 50_000, 2, "int32")])
def test_segment_sum_rows_matches_plain(cuda, g, L, v, kind):
    rng = np.random.default_rng(g + L + v)
    _, seg = _row_lanes(rng, g, L, v)
    vals = (rng.random((g, L)) < 0.5 if kind == "bool"
            else rng.integers(-4, 5, (g, L)).astype(np.int32))
    before = segsum.rows_launches
    got = segsum.segment_sum_rows_sorted(torch.from_numpy(vals).to(cuda),
                                         torch.from_numpy(seg).to(cuda), num_segments=v)
    assert segsum.rows_launches == before + 1
    want = ref.segment_sum_rows_ref(torch.from_numpy(vals), torch.from_numpy(seg), v)
    assert torch.equal(got.cpu(), want)


def _rows_case(cuda, g, L, v, hub, shift, seed):
    """Lanes of _row_lanes as [g, L] views shifted ``shift`` ints off a
    16-byte boundary, with live and failed masks, on the card."""
    rng = np.random.default_rng(seed)
    src, dst = _row_lanes(rng, g, L, v, hub)
    flat = [torch.from_numpy(np.r_[np.zeros(shift, np.int32), x.ravel()]).to(cuda)
            for x in (src, dst)]
    s, d = (t[shift:].view(g, L) for t in flat)
    a, f = (torch.from_numpy(rng.random((g, v)) < p).to(cuda) for p in (0.85, 0.35))
    return s, d, a, f


def _check_rows_kernels(s, d, a, f, v):
    """K2's rows entry (live mask and none, charges and none) and K1's (bool
    and int32 values) against their plain versions, one launch a call."""
    g = s.shape[0]
    for act in (a, None):
        for charge in (False, True):
            before = peel.rows_launches
            got = peel.peel_edges_rows(s, d, act, f, n_nodes=v, charge=charge)
            assert peel.rows_launches == before + (1 if g and v else 0)
            want = ref.peel_edges_rows_ref(s.cpu(), d.cpu(), None if act is None
                                           else act.cpu(), f.cpu(), v, charge)
            for x, w in zip(got, want):
                assert torch.equal(x.cpu(), w), (act is None, charge)
    for vals in (d < v // 2, (s % 7 - 3).int()):
        before = segsum.rows_launches
        got = segsum.segment_sum_rows_sorted(vals, d, num_segments=v)
        assert segsum.rows_launches == before + 1
        assert torch.equal(got.cpu(), ref.segment_sum_rows_ref(vals.cpu(), d.cpu(), v))


@pytest.mark.parametrize("g,L,v,hub", [(2, 2600, 30, True), (6, 20_000, 300, True),
                                       (1, 3000, 50, False), (130, 777, 20, False),
                                       (64, 4096, 512, False), (3, 90, 1, False),
                                       (3, 1030, 1, True), (40, 40, 64, False),
                                       (30, 13, 100, False)])
def test_rows_kernels_row_local_edges(cuda, g, L, v, hub):
    """The row-local rows kernels where their spans cut: a hub run across
    many tiles and spans, one row (G = 1), more rows than SMs (G = 130),
    rows of one vertex, L not a multiple of 4, an all-sentinel row, rows of
    fewer lanes than a thread holds (a thread then sees lanes before the
    row, small ids and the sentinel together); aligned and unaligned
    (shift 1) views."""
    for shift in (0, 1):
        _check_rows_kernels(*_rows_case(cuda, g, L, v, hub, shift, g * 7 + L + v), v)


@pytest.mark.parametrize("budget,v", [(1024, 4096), (1024, 4112), (None, 262_144),
                                      (None, 262_160)])
def test_peel_edges_rows_shared_state_budget(cuda, monkeypatch, budget, v):
    """Both sides of ROWS_SHARED_STATE_BYTES (a row's packed state in shared
    memory up to it, its bytes through L1/L2 past it): at a lowered budget
    (4,096 vertices just fit 1 KB, 4,112 do not) and at the default 64 KB
    (262,144 vertices fit, 262,160 do not)."""
    if budget is not None:
        monkeypatch.setattr(peel, "ROWS_SHARED_STATE_BYTES", budget)
    fits = peel.load_library().peel_state_bytes(v) <= peel.ROWS_SHARED_STATE_BYTES
    assert fits == (v in (4096, 262_144))
    for shift in (0, 1):
        _check_rows_kernels(*_rows_case(cuda, 3, 5000, v, True, shift, v + shift), v)


def test_rows_kernels_bitwise_repeatable(cuda):
    """Two launches of each rows kernel on the same inputs give the same bits
    (the crossing runs are integer atomics, exact in any order)."""
    s, d, a, f = _rows_case(cuda, 8, 40_000, 700, True, 0, 5)
    one = peel.peel_edges_rows(s, d, a, f, n_nodes=700, charge=True)
    one = [x.clone() for x in one]
    two = peel.peel_edges_rows(s, d, a, f, n_nodes=700, charge=True)
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    k1 = segsum.segment_sum_rows_sorted(d < 700, d, num_segments=700).clone()
    assert torch.equal(k1, segsum.segment_sum_rows_sorted(d < 700, d, num_segments=700))


@pytest.mark.parametrize("n", [300, 2000])
def test_fused_flush_on_card_matches_off_and_cpu(cuda, n):
    """A bucket of fused tenants (pruned and unpruned) on the card with the
    kernels on and off, and on the CPU: the same answers after every churn
    batch, fixed-round refinement included; the kernel-on flush launches
    K2's rows entry (the dense bucket for its pruned members' pass 0) and
    leaves every row sorted."""
    from repro_torch.stream import FusedEngine, FusedPool, ingest_group, query_group

    names = [f"t{i}" for i in range(6)]
    groups = []
    for kernel, dev in ((True, cuda), (False, cuda), (None, "cpu")):
        pool = FusedPool()
        groups.append({k: FusedEngine(k, pool, n, eps=0.1, capacity=4096, refresh_every=4,
                                      pruned=i % 2 == 0, kernel=kernel, device=dev)
                       for i, k in enumerate(names)})
    rng = np.random.default_rng(n)
    streams = {k: _stream_events(rng, n, 12, 300) for k in names}
    before = peel.rows_launches
    for step in range(12):
        upd = {k: next(streams[k]) for k in names}
        answers = []
        for grp in groups:
            ingest_group(upd, grp)
            answers.append(query_group(grp, refine=step % 6 == 5, target_gap=-1.0,
                                       max_refine_rounds=3))
        for k in names:
            for other in answers[1:]:
                _same_answer(answers[0][k], other[k])
        batch = groups[0]["t0"].batch
        for lane in batch.lane_of.values():
            if not batch._unsorted[lane]:
                assert bool(torch.all(batch._dst[lane][1:] >= batch._dst[lane][:-1]))
    assert peel.rows_launches > before


# ---------------------------------------------------------------------------
# the sharded tier on the card (core/distributed.py)
# ---------------------------------------------------------------------------
@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A real NCCL group of one rank on the card (file rendezvous, no
    network), torn down after the test."""
    import torch.distributed as dist

    from repro_torch.core.distributed import make_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rdzv'}",
                            world_size=1, rank=0)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def test_nccl_mesh_of_one_on_card(nccl_mesh):
    from repro_torch.core import collective

    assert nccl_mesh.device.type == "cuda" and nccl_mesh.group is not None
    assert (nccl_mesh.rank, nccl_mesh.size) == (0, 1)
    t = torch.arange(5, dtype=torch.int32, device=nccl_mesh.device)
    before = collective.collectives
    assert torch.equal(collective.all_reduce_sum(t.clone(), nccl_mesh), t)
    assert collective.collectives == before + 1


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_pbahmani_distributed_on_card(nccl_mesh, eps):
    """Kernel on == kernel off == the single-device peel == numpy; one K2
    launch and one collective a pass (and one each for the degrees: K1 and
    its all-reduce)."""
    from repro_torch.core import collective, distributed

    g = rmat(12, 16, seed=1)
    want = pbahmani(g, eps=eps, device=nccl_mesh.device)
    k2, k1, coll = peel.launches, segsum.launches, collective.collectives
    got = distributed.pbahmani_distributed(g, nccl_mesh, eps=eps, kernel=True)
    assert (peel.launches - k2, segsum.launches - k1, collective.collectives - coll) == (
        got[2], 1, got[2] + 1)
    off = distributed.pbahmani_distributed(g, nccl_mesh, eps=eps, kernel=False)
    oracle = pbahmani_np(g, eps=eps)
    for other in (want, off, oracle):
        assert np.float32(got[0]).view(np.int32) == np.float32(other[0]).view(np.int32)
        assert got[2] == other[2]
        np.testing.assert_array_equal(got[1], other[1])
    c = distributed.cbds_distributed(g, nccl_mesh)
    ref_c = cbds_p(g, device=nccl_mesh.device)
    assert c["density"] == ref_c["density"] and c["k_star"] == ref_c["k_star"]
    np.testing.assert_array_equal(c["member_mask"], ref_c["member_mask"])


def test_sharded_stream_engine_on_card(nccl_mesh):
    """A sharded DeltaEngine on the card (NCCL mesh of one) == the
    single-device engine on the card, after every churn batch, refined
    queries and cbds included; a fused+sharded bucket too."""
    from repro_torch.stream import DeltaEngine, GraphRegistry, ingest_group, query_group

    cfg = dict(n_nodes=600, eps=0.1, capacity=2048, refresh_every=6)
    sh = DeltaEngine(**cfg, sharded=True, mesh=nccl_mesh)
    single = DeltaEngine(**cfg, device=nccl_mesh.device)
    assert sh.device == nccl_mesh.device and not sh.kernel
    rng = np.random.default_rng(3)
    for i, (ins, dels) in enumerate(_stream_events(rng, 600, 40, 40)):
        for eng in (sh, single):
            eng.apply_updates(insert=ins, delete=dels)
        kw = dict(refine=i % 10 == 9, target_gap=-1.0, max_refine_rounds=3)
        _same_answer(sh.query(**kw), single.query(**kw))
    assert sh.metrics.n_pruned_queries > 0 and sh.metrics.n_refreshes > 2
    a, b = sh.cbds(), single.cbds()
    assert a["density"] == b["density"] and a["k_star"] == b["k_star"]
    regs = [GraphRegistry(fused=True, sharded=True, mesh=nccl_mesh, eps=0.1),
            GraphRegistry(fused=True, eps=0.1, device=nccl_mesh.device)]
    for reg in regs:
        for i in range(4):
            reg.register(f"t{i}", n_nodes=2000, pruned=i % 2 == 0)
    streams = {f"t{i}": _stream_events(rng, 2000, 5, 400) for i in range(4)}
    for _ in range(5):
        upd = {k: next(s) for k, s in streams.items()}
        answers = []
        for reg in regs:
            ingest_group(upd, reg.engines())
            answers.append(query_group(reg.engines()))
        for k in upd:
            _same_answer(answers[0][k], answers[1][k])


# ---------------------------------------------------------------------------
# the training runtime on the card (optim/, checkpoint/, launch/train.py)
# ---------------------------------------------------------------------------
def _train_bundle(cfg, device):
    """``build_step("dcn-v2", "train_batch")`` with ``cfg`` as the arch's
    full config (``get_arch`` patched for the call)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps

    arch = dataclasses.replace(get_arch("dcn-v2"), full=cfg)
    with mock.patch.object(steps, "get_arch", lambda name: arch):
        return build_step("dcn-v2", "train_batch", device=device)


def _to(device, tree):
    if isinstance(tree, dict):
        return {k: _to(device, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(device, v) for v in tree)
    return tree.to(device)


def _train_loop(cfg, device):
    from repro_torch.launch import make_optimizer, train_state

    step = _train_bundle(cfg, device)
    opt = make_optimizer("adamw")

    def step_fn(state, batch):
        p, o, loss = step.fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, loss

    def init_state():
        return train_state(dcn_init(cfg, device=device), opt)

    return step_fn, init_state, lambda s: recsys_batches(cfg, 512, seed=3, start_step=s)


def test_train_step_deterministic_on_card(cuda, tmp_path):
    """DCN-v2 training on the card is bitwise repeatable (the one-hot bag's
    table gradient is F.embedding's sorted backward), and a run with two
    injected failures and async checkpoints equals the uninterrupted one;
    a multi-hot config with K5 on refuses to train."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.launch import LoopConfig, run_training

    cfg = dataclasses.replace(get_arch("dcn-v2").smoke, table_rows=50_000)
    step_fn, init_state, data = _train_loop(cfg, cuda)
    loop = LoopConfig(total_steps=6, ckpt_every=3)
    runs = [run_training(step_fn, init_state, data, None, loop) for _ in range(2)]
    fail_at = {1, 4}

    def inject(s):
        if s in fail_at:
            fail_at.discard(s)
            raise RuntimeError("simulated worker loss")

    runs.append(run_training(step_fn, init_state, data, CheckpointManager(str(tmp_path), keep=1),
                             loop, failure_injector=inject))
    ref = runs[0]
    assert runs[1].losses == ref.losses and runs[2].restarts == 2
    assert runs[2].losses == ref.losses[:1] + ref.losses[:4] + ref.losses[3:]
    for other in runs[1:]:
        for k, v in ref.final_state["params"].items():
            assert torch.equal(other.final_state["params"][k], v), k
            assert torch.equal(other.final_state["opt"]["mu"][k], ref.final_state["opt"]["mu"][k])
    with pytest.raises(NotImplementedError, match="K5"):
        _train_bundle(dataclasses.replace(cfg, multi_hot=4), cuda)


@pytest.mark.parametrize("multi_hot", [1, 4])
def test_train_steps_on_card_match_cpu(cuda, multi_hot):
    """Three AdamW steps of the train kind on the card == the same steps on
    the CPU (which tests/test_torch_train.py holds against JAX), from the
    same weights and batches: the loss, every parameter, mu and nu within
    rtol 1e-5, atol 1e-6, and the step equal."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import make_optimizer, train_state

    torch.set_float32_matmul_precision("highest")
    cfg = dataclasses.replace(get_arch("dcn-v2").smoke, multi_hot=multi_hot, kernel=False)
    steps = {d: _train_bundle(cfg, d) for d in ("cpu", cuda)}
    state = train_state(dcn_init(cfg, device="cpu"), make_optimizer("adamw"))
    states = {"cpu": (state["params"], state["opt"]),
              cuda: _to(cuda, (state["params"], state["opt"]))}
    data = recsys_batches(cfg, 64, seed=11)
    for _ in range(3):
        batch, losses = next(data), {}
        for d, step in steps.items():
            p, o, losses[d] = step.fn(*states[d], batch)
            states[d] = (p, o)
        np.testing.assert_allclose(float(losses[cuda]), float(losses["cpu"]), rtol=1e-5)
    (p_cpu, o_cpu), (p_card, o_card) = states["cpu"], states[cuda]
    assert int(o_card["step"]) == int(o_cpu["step"]) == 3
    for got, want in ((p_card, p_cpu), (o_card["mu"], o_cpu["mu"]), (o_card["nu"], o_cpu["nu"])):
        for k, v in want.items():
            np.testing.assert_allclose(got[k].cpu().numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_peel_with_restarts_on_card(nccl_mesh, tmp_path, monkeypatch):
    """peel_with_restarts with kernel=None runs K1 once and K2 once a pass on
    the card, one collective for the degrees and one a pass, one restore at
    the failure point, and equals pbahmani on the card and numpy."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import collective
    from repro_torch.launch import peel_with_restarts

    g = rmat(12, 16, seed=1)
    want = pbahmani(g, eps=0.1, device=nccl_mesh.device)
    restores = []
    real = CheckpointManager.restore
    monkeypatch.setattr(CheckpointManager, "restore",
                        lambda self, *a, **k: restores.append(1) or real(self, *a, **k))
    k2, k1, coll = peel.launches, segsum.launches, collective.collectives
    got = peel_with_restarts(g, nccl_mesh, 0.1, CheckpointManager(str(tmp_path)), fail_at_pass=2)
    assert (peel.launches - k2, segsum.launches - k1, collective.collectives - coll,
            len(restores)) == (got["passes"], 1, got["passes"] + 1, 1)
    oracle = pbahmani_np(g, eps=0.1)
    for other in (want, oracle):
        assert np.float32(got["density"]).view(np.int32) == np.float32(other[0]).view(np.int32)
        assert got["passes"] == other[2]
        np.testing.assert_array_equal(got["mask"], other[1])


def test_compressed_psum_on_card(nccl_mesh):
    from repro_torch.core import collective
    from repro_torch.optim import compressed_psum, quantize_int8

    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32))
    before = collective.collectives
    got = compressed_psum(x.to(nccl_mesh.device), nccl_mesh).cpu()
    assert collective.collectives - before == 2
    q, s = quantize_int8(x)
    assert torch.equal(got, q.to(torch.int32).to(torch.float32) * s)


def test_optim_quotients_on_card_equal_cpu(cuda):
    """The warmup's and int8 quantization's quotients give the CPU's float32
    bits on the card (a tensor divisor: CUDA divides by a Python scalar
    through its reciprocal)."""
    from repro_torch.optim import linear_warmup_cosine, quantize_int8

    sched = linear_warmup_cosine(1e-3, 7, 100)
    for s in range(7):  # the warmup: a product and a quotient
        a = sched(torch.tensor(s, dtype=torch.int32))
        b = sched(torch.tensor(s, dtype=torch.int32, device=cuda)).cpu()
        assert torch.equal(a, b), s
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(300, 77)).astype(np.float32) * 9)
    q, s = quantize_int8(x)
    qc, sc = quantize_int8(x.to(cuda))
    assert torch.equal(sc.cpu(), s) and torch.equal(qc.cpu(), q)


# ---------------------------------------------------------------------------
# the GNNs: K1 at [E, D] float32 and message passing on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [1, 3, 16, 64, 1152])
def test_kernel_float_rows_at_gnn_widths(cuda, d):
    """K1's float32 [E, D] path at the GNNs' widths (degrees, EGNN's xw, GCN,
    SchNet/EGNN, MACE's 9 x 128), with sentinel and negative ids: within
    1e-5 of the plain version and bitwise equal across two runs."""
    rng = np.random.default_rng(d)
    e, v = (2000, 300) if d == 1152 else (40_000, 3000)
    seg = torch.from_numpy(_lanes(rng, e, v, sentinels=9, negatives=4)).to(cuda)
    shape = (seg.shape[0], d) if d > 1 else (seg.shape[0],)
    vals = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    before = segsum.launches
    a = segsum.segment_sum_sorted(vals, seg, num_segments=v)
    b = segsum.segment_sum_sorted(vals, seg, num_segments=v)
    torch.cuda.synchronize()
    assert segsum.launches == before + 2
    torch.testing.assert_close(a, ref.segment_sum_ref(vals, seg, v), rtol=1e-5, atol=1e-5)
    assert torch.equal(a, b)


def test_kernel_float_rows_empty_runs(cuda):
    """K1's [E, D] path where long runs of rows have no lanes (a sampled
    block's ids end far below its row count): ids only in [70_000, 71_000)
    of 200_000 rows, with sentinels; against the plain version."""
    rng = np.random.default_rng(5)
    v = 200_000
    ids = np.sort(rng.integers(70_000, 71_000, 30_000)).astype(np.int32)
    seg = torch.from_numpy(np.r_[ids, np.full(7, v, np.int32)]).to(cuda)
    vals = torch.from_numpy(rng.normal(size=(seg.shape[0], 16)).astype(np.float32)).to(cuda)
    out = segsum.segment_sum_sorted(vals, seg, num_segments=v)
    torch.testing.assert_close(out, ref.segment_sum_ref(vals, seg, v), rtol=1e-5, atol=1e-5)
    assert not out[:70_000].any() and not out[71_000:].any()


def test_kernel_refuses_grad_on_card(cuda):
    """A CUDA tensor that requires a gradient never leaves K1 without a
    grad_fn: it raises, under grad mode, on both entries."""
    vals = torch.ones(5, 4, device=cuda, requires_grad=True)
    ids = torch.tensor([0, 1, 1, 3, 4], dtype=torch.int32, device=cuda)
    before = segsum.launches
    with pytest.raises(NotImplementedError, match="no backward"):
        segsum.segment_sum_sorted(vals, ids, num_segments=4)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.segment_sum(vals, ids.flip(0), num_segments=4, presorted=False)
    assert segsum.launches == before
    with torch.no_grad():
        out = segsum.segment_sum_sorted(vals, ids, num_segments=4)
    assert segsum.launches == before + 1 and not out.requires_grad


def _gnn_case(arch, device):
    """A SMOKE-config model (seeded on ``device``) and a batch: GCN on a
    seeded graph with features, the geometric models on 8 small graphs."""
    from repro_torch.configs import get_arch
    from repro_torch.data import GraphBatcher, gnn_batch
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.models import gnn

    cfg = get_arch(arch).smoke
    init = {"gcn-cora": gnn.gcn_init, "schnet": gnn.schnet_init, "egnn": gnn.egnn_init,
            "mace": gnn.mace_init}[arch]
    model = init(cfg, device=device, generator=torch.Generator(device=device).manual_seed(2))
    if arch == "gcn-cora":
        batch = gnn_batch(erdos_renyi(400, 0.03, seed=5), d_feat=cfg.d_feat,
                          n_classes=cfg.n_classes, seed=1)
    else:
        batch = GraphBatcher(30, 64, 8).random_batch(seed=3)
    return model, {k: torch.as_tensor(v, device=device) if isinstance(v, np.ndarray) else v
                   for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["gcn-cora", "schnet", "egnn", "mace"])
def test_gnn_forward_on_card(cuda, arch):
    """Each GNN's SMOKE config on the card: the forward with K1 on (one K1
    launch a ``_seg`` call, bitwise repeatable) against the same module with
    the kernel off (atomic index_add_) and against the CPU, within 1e-5;
    with a parameter that requires a gradient the kernel path raises."""
    torch.set_float32_matmul_precision("highest")
    model, batch = _gnn_case(arch, cuda)
    assert model.cfg.kernel is None  # SMOKE: on for a CUDA device
    cfg = model.cfg = dataclasses.replace(model.cfg, kernel=True)
    calls = {"gcn-cora": lambda: 1 + cfg.n_layers, "schnet": lambda: cfg.n_interactions + 1,
             "egnn": lambda: 3 * cfg.n_layers + 1, "mace": lambda: cfg.n_layers + 1}[arch]()
    with pytest.raises(NotImplementedError, match="no backward"):
        model(batch)
    before = segsum.launches
    with torch.no_grad():
        on, again = model(batch), model(batch)
        torch.cuda.synchronize()
        assert segsum.launches - before == 2 * calls
        model.cfg = dataclasses.replace(cfg, kernel=False)
        off = model(batch)
        cpu_batch = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in batch.items()}
        host = model.to("cpu")(cpu_batch)
    assert segsum.launches - before == 2 * calls
    outs = [x if isinstance(x, tuple) else (x,) for x in (on, again, off, host)]
    for a, b, c, h in zip(*outs):
        assert torch.equal(a, b)
        torch.testing.assert_close(c, a, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(h, a.cpu(), rtol=1e-5, atol=1e-5)
        assert torch.isfinite(a).all()


def test_gnn_train_step_on_card_matches_cpu(cuda):
    """One step of the GNN train kind (MACE's SMOKE config on the molecule
    shape's 128 small graphs) on the card against the CPU from the same
    weights: the loss within rtol 1e-5, mu and nu within rtol 1e-4 plus 1e-5
    of each leaf's largest entry (float32 gradients summed by atomics in
    another order); kernel=True refuses to build."""
    from repro_torch.configs import get_arch
    from repro_torch.data import GraphBatcher
    from repro_torch.launch import make_optimizer, steps, train_state
    from repro_torch.models import gnn

    torch.set_float32_matmul_precision("highest")
    arch = dataclasses.replace(get_arch("mace"), full=get_arch("mace").smoke)
    with mock.patch.object(steps, "get_arch", lambda name: arch):
        bundles = {d: build_step("mace", "molecule", device=d) for d in ("cpu", cuda)}
    state = train_state(gnn.mace_init(arch.full, device="cpu"), make_optimizer("adamw"))
    batch = GraphBatcher(30, 64, 128).random_batch(seed=7)
    out = {"cpu": bundles["cpu"].fn(state["params"], state["opt"], batch),
           cuda: bundles[cuda].fn(*_to(cuda, (state["params"], state["opt"])), batch)}
    np.testing.assert_allclose(float(out[cuda][2]), float(out["cpu"][2]), rtol=1e-5)
    for key in ("mu", "nu"):
        for k, want in out["cpu"][1][key].items():
            w = want.numpy()
            np.testing.assert_allclose(out[cuda][1][key][k].cpu().numpy(), w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max(), err_msg=f"{key} {k}")
    arch_k1 = dataclasses.replace(arch, full=dataclasses.replace(arch.full, kernel=True))
    with mock.patch.object(steps, "get_arch", lambda name: arch_k1):
        with pytest.raises(NotImplementedError, match="K1"):
            build_step("mace", "molecule", device=cuda)


def test_rbf_centers_on_card_equal_cpu(cuda):
    """SchNet's and MACE's RBF centers (jnp.linspace's bits, which
    tests/test_torch_gnn.py holds) are the same float32 bits on the card."""
    from repro_torch.models import gnn

    for n_rbf, cutoff in ((300, 10.0), (16, 5.0), (8, 5.0), (4, 5.0), (1000, 6.5)):
        assert torch.equal(gnn._rbf_centers(n_rbf, cutoff, cuda).cpu(),
                           gnn._rbf_centers(n_rbf, cutoff, torch.device("cpu")))


LM_ARCHS = ("qwen2.5-3b", "mistral-nemo-12b", "phi3-mini-3.8b", "grok-1-314b",
            "deepseek-v3-671b")


def _lm_smoke(arch, device, seed=0):
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params

    cfg = get_arch(arch).smoke
    return cfg, init_params(cfg, device=device,
                            generator=torch.Generator(device=device).manual_seed(seed))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_on_card_matches_cpu(cuda, arch):
    """Each LM's SMOKE forward (float32, TF32 off) on the card against the
    same weights on the CPU: logits, aux and the cache within 1e-5, and the
    rotary inverse frequencies bitwise equal."""
    from repro_torch.models import forward, layers

    torch.set_float32_matmul_precision("highest")
    cfg, model = _lm_smoke(arch, "cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 24)))
    with torch.inference_mode():
        want = forward(model, toks, cfg, return_cache=True)
        got = forward(model.to(cuda), toks.to(cuda), cfg, return_cache=True)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=1e-5)
    for k in want[2]:
        torch.testing.assert_close(got[2][k].cpu(), want[2][k], rtol=1e-5, atol=1e-5)
    assert torch.equal(layers.rope_freqs(cfg.hd, cfg.rope_theta, cuda).cpu(),
                       layers.rope_freqs(cfg.hd, cfg.rope_theta))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v3-671b"])
def test_serve_batch_on_card_bitwise_repeatable(cuda, arch):
    """serve_batch on the card twice from the same weights: the same tokens,
    and the first one the argmax of the prefill's last logits."""
    from repro_torch.launch import serve_batch
    from repro_torch.models import prefill

    cfg, model = _lm_smoke(arch, cuda)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (3, 8)).astype(np.int32)
    a = serve_batch(model, cfg, prompts, max_new_tokens=6, device=cuda)
    b = serve_batch(model, cfg, prompts, max_new_tokens=6, device=cuda)
    assert np.array_equal(a.outputs, b.outputs) and a.outputs.shape == (3, 6)
    with torch.inference_mode():
        last, _ = prefill(model, torch.as_tensor(prompts, device=cuda), cfg)
    assert np.array_equal(a.outputs[:, 0], last.argmax(-1).cpu().numpy())


def test_moe_ep_equals_dense_on_card(cuda):
    """deepseek's SMOKE MoE layer: moe_ep (per-expert products over sorted
    rows, the group sizes read once) == moe_dense within 2e-4 on the card,
    bitwise repeatable, and == the CPU's moe_ep within 1e-5."""
    from repro_torch.models import moe

    torch.set_float32_matmul_precision("highest")
    cfg, model = _lm_smoke("deepseek-v3-671b", cuda)
    p = model.moe_blocks[0].moe
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator(device=cuda).manual_seed(3),
                    device=cuda)
    with torch.inference_mode():
        ep, aux = moe.moe_ep(x, p, cfg.moe)
        again, _ = moe.moe_ep(x, p, cfg.moe)
        dense, aux_d = moe.moe_dense(x, p, cfg.moe)
        host, _ = moe.moe_ep(x.cpu(), {k: v.cpu() for k, v in p.items()}, cfg.moe)
    assert torch.equal(ep, again)
    torch.testing.assert_close(ep, dense, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(aux, aux_d)
    torch.testing.assert_close(ep.cpu(), host, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# LM training on the card (loss_fn, the train kind, bfloat16 checkpoints)
# ---------------------------------------------------------------------------
LM_TRAIN_ARCHS = ("qwen2.5-3b", "deepseek-v3-671b", "grok-1-314b")   # GQA, MLA + MTP, MoE


def _lm_train_step(arch, device, seq=64, gb=8):
    """The train_4k kind with SMOKE as arch.full (float32) and the shape cut
    to ``[gb, seq]``: the arch's microbatches, accumulation and optimizer."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import Shape
    from repro_torch.launch import steps

    a = get_arch(arch)
    a = dataclasses.replace(a, full=a.smoke, shapes=(
        Shape("train_4k", "train", dict(seq_len=seq, global_batch=gb)),))
    with mock.patch.object(steps, "get_arch", lambda _: a):
        return a, build_step(arch, "train_4k", device=device)


def _lm_train_batch(vocab, seed, device, seq=64, gb=8):
    rows = torch.as_tensor(np.random.default_rng(seed).integers(0, vocab, (gb, seq + 1)),
                           device=device)
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


@pytest.mark.parametrize("arch", LM_TRAIN_ARCHS)
def test_lm_train_steps_on_card_bitwise_repeatable(cuda, arch):
    """Two train-kind steps on the card, run twice from one state: the same
    losses and every parameter and moment bit for bit (the embedding's and
    the MoE's gathers sum their backward in a fixed order, the MoE's
    replicas are an expand)."""
    from repro_torch.launch import make_optimizer, train_state
    from repro_torch.utils.tree import leaves_with_paths

    torch.set_float32_matmul_precision("highest")
    a, step = _lm_train_step(arch, cuda)
    cfg, model = _lm_smoke(arch, cuda, seed=3)
    state = train_state(model, make_optimizer(a.optimizer))
    batches = [_lm_train_batch(cfg.vocab, s, cuda) for s in (1, 2)]
    runs = []
    for _ in range(2):
        p, o, losses = state["params"], state["opt"], []
        for b in batches:
            p, o, loss = step.fn(p, o, b)
            losses.append(loss)
        runs.append((losses, leaves_with_paths({"params": p, "opt": o})))
    (la, xa), (lb, xb) = runs
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert [k for k, _ in xa] == [k for k, _ in xb]
    for (k, x), (_, y) in zip(xa, xb):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("arch", LM_TRAIN_ARCHS)
def test_lm_train_step_on_card_matches_cpu(cuda, arch):
    """One float32 train-kind step (TF32 off) on the card against the same
    step on the CPU (which tests/test_torch_lm_train.py holds against JAX),
    from the same weights and batch, with that test's tolerances: the loss
    within rtol 1e-5; with float32 accumulation (qwen2.5) parameters within
    rtol 1e-5, atol 1e-5 and moments within rtol 1e-4 with an atol of 1e-6
    of the moment's largest entry; with bfloat16 accumulation (deepseek,
    grok: an entry may round to the other neighbouring bfloat16) each leaf
    within 2e-3 normwise."""
    from repro_torch.launch import make_optimizer, train_state

    torch.set_float32_matmul_precision("highest")
    a, step_cpu = _lm_train_step(arch, "cpu")
    _, step_card = _lm_train_step(arch, cuda)
    cfg, model = _lm_smoke(arch, "cpu", seed=5)
    opt = make_optimizer(a.optimizer)
    state = train_state(model, opt)
    batch = _lm_train_batch(cfg.vocab, 6, "cpu")
    p, o, loss = step_cpu.fn(state["params"], state["opt"], batch)
    card = {k: v.to(cuda) for k, v in state["params"].items()}
    pc, oc, loss_c = step_card.fn(card, opt.init(card), {k: v.to(cuda) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss_c), float(loss), rtol=1e-5)
    bf = a.grad_accum_dtype == "bfloat16"

    def normwise(got, want):
        got, want = got.cpu().double(), want.double()
        return float((got - want).norm() / want.norm()) if float(want.norm()) else 0.0

    for k, want in p.items():
        if bf:
            assert normwise(pc[k], want) <= 2e-3, k
        else:
            torch.testing.assert_close(pc[k].cpu(), want, rtol=1e-5, atol=1e-5)
    for moment in (m for m in o if m != "step"):
        flat = {k: (v if isinstance(v, dict) else {"": v}) for k, v in o[moment].items()}
        largest = max(float(x.abs().max()) for d in flat.values() for x in d.values())
        for k, d in flat.items():
            for sub, want in d.items():
                got = oc[moment][k][sub] if sub else oc[moment][k]
                if bf:
                    assert normwise(got, want) <= 2e-3, (moment, k, sub)
                else:
                    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-6 * largest)


def test_bfloat16_checkpoint_round_trip_from_cuda(cuda, tmp_path):
    """bfloat16 CUDA tensors (an LM train state in JAX's layout) written by
    an async save and put back on the card by restore_elastic: bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.launch import make_optimizer, restore_elastic, train_state
    from repro_torch.models import LM_STATE_LAYOUT, init_params
    from repro_torch.utils.tree import leaves_with_paths

    cfg = dataclasses.replace(get_arch("deepseek-v3-671b").smoke, param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    model = init_params(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
    state = train_state(model, make_optimizer("adafactor"))
    mgr = CheckpointManager(str(tmp_path), layout=LM_STATE_LAYOUT)
    mgr.save(4, state)
    step, back = restore_elastic(mgr, state, device=cuda)
    assert step == 4
    for (k, x), (_, y) in zip(leaves_with_paths(back), leaves_with_paths(state)):
        assert x.device.type == "cuda" and x.dtype == y.dtype and torch.equal(x, y), k


# ---------------------------------------------------------------------------
# sub-axis meshes: the collectives through gloo on the card, vp_segment_sum's
# K1, the MoE layers over a mesh of one
# ---------------------------------------------------------------------------
def test_sub_axis_collectives_four_ranks_on_card(cuda, tmp_path):
    """Four gloo ranks on cuda:0 over the (2, 2) and (4, 1) meshes: the four
    collectives over every axis set (the sub-axis groups included) in float32
    and bfloat16 equal their numpy closed forms, with their backward
    (tests/_torch_mesh_ranks.py, its card mode)."""
    import os
    import subprocess
    import sys
    import time
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    import _torch_mesh_ranks as mr

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(root / "tests" / "_torch_mesh_ranks.py"),
                               str(r), "4", f"file://{tmp_path / 'rdzv'}", "-",
                               str(tmp_path / f"rank{r}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(4)]
    deadline = time.monotonic() + 180
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 0.0))[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("four ranks on the card did not finish in 180 s")
    for r, p in enumerate(procs):
        assert p.returncode == 0, logs[r].decode()[-4000:]
    for r in range(4):
        ans = dict(np.load(tmp_path / f"rank{r}.npz"))
        for shape in mr.MESHES[4]:
            for label in mr.COLL_AXES:
                want = mr.expected_collectives(shape, r, label)
                for dt, tol in (("torch.float32", dict(rtol=1e-6, atol=1e-6)),
                                ("torch.bfloat16", dict(rtol=2e-2, atol=2e-2))):
                    key = f"{dt}/{mr.tag(shape)}/coll/{label}"
                    for kind in ("sum", "max", "gather", "a2a", "sum_grad", "sum/grad",
                                 "gather/grad", "a2a/grad", "sum_grad/grad"):
                        np.testing.assert_allclose(ans[f"{key}/{kind}"], want[kind], **tol,
                                                   err_msg=f"{key}/{kind}")


@pytest.mark.parametrize("d", [0, 16])
def test_vp_segment_sum_k1_on_card(cuda, d):
    """vp_segment_sum over a mesh of one on the card: K1 once a call (K1 on)
    equals the plain version and the CPU's, unsorted lanes are sorted and
    counted, and the gradient (no K1 backward) equals the CPU's."""
    from repro_torch.core.distributed import make_mesh

    rng = np.random.default_rng(d)
    n, e = 5000, 60_000
    ids = np.r_[np.sort(rng.integers(0, n, e)), np.full(9, n)].astype(np.int32)
    vals = rng.normal(size=(ids.shape[0], d) if d else ids.shape[0]).astype(np.float32)
    w = rng.normal(size=(n, d) if d else n).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        v = torch.from_numpy(vals).to(dev).requires_grad_(True)
        i = torch.from_numpy(ids).to(dev)
        with ops.segment_output_sharding(mesh, ("data",), min_segments=1):
            k1 = segsum.launches
            on = ops.vp_segment_sum(v, i, n)
            launched = segsum.launches - k1
            off = ops.vp_segment_sum(v.detach(), i, n, kernel=False)
            (g,) = torch.autograd.grad((on * torch.from_numpy(w).to(dev)).sum(), v)
            before = ops.unsorted_fallback_count
            flip = torch.flip(torch.arange(i.shape[0], device=dev), [0])
            unsorted = ops.vp_segment_sum(v.detach()[flip], i[flip], n)
            out[dev.type] = (on.detach().cpu(), off.cpu(), g.cpu(), unsorted.cpu(),
                             ops.unsorted_fallback_count - before, launched)
    on, off, g, unsorted, fallbacks, launched = out["cuda"]
    assert launched == 1 and fallbacks == 1
    torch.testing.assert_close(on, off, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(on, out["cpu"][0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(unsorted, on, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g, out["cpu"][2], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["ep", "tp"])
def test_moe_mesh_of_one_on_card(cuda, kind):
    """moe_ep and moe_tp over a ("data", "model") mesh of one on the card:
    the single-device body's bits, in bfloat16."""
    from repro_torch.configs import get_arch
    from repro_torch.core.distributed import make_mesh
    from repro_torch.models import init_moe_params, moe_ep, moe_tp

    cfg = dataclasses.replace(get_arch("deepseek-v3-671b").smoke.moe,
                              compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(4)
    p = {k: v[0] for k, v in init_moe_params(cfg, 1, torch.bfloat16, device=cuda,
                                             generator=gen).items()}
    x = torch.randn((2, 64, cfg.d_model), generator=gen, device=cuda).to(torch.bfloat16)
    fn = moe_ep if kind == "ep" else moe_tp
    mesh = make_mesh((1, 1), ("data", "model"), device=cuda)
    with torch.inference_mode():
        got, aux = fn(x, p, cfg, mesh=mesh)
        want, waux = fn(x, p, cfg)
    assert torch.equal(got, want) and torch.equal(aux, waux)
