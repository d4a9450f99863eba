"""The port's CUDA kernels against their plain versions on the card.

Every test here needs a CUDA device and skips where there is none; run them
on a GPU with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
This file imports no JAX, so it runs where only the port is installed.
Tolerance: 1e-5 for random float32 on short rows (the summation order
differs); exact for 0/1 and integer lanes, and for float32 quarter-integers,
whose sums are exact in any order (the long-row float cases use them).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cbds_p, kcore_decompose, pbahmani, pbahmani_np  # noqa: E402
from repro_torch.graphs.generators import planted_dense, rmat  # noqa: E402
from repro_torch.kernels import compact, ops, ref, segsum  # noqa: E402
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


@pytest.mark.parametrize("e,d,v,kind", [
    (64, 0, 16, "float32"),
    (1000, 33, 300, "float32"),
    (512, 128, 256, "float32"),
    (100, 200, 50, "float32"),
    (50_000, 0, 40, "quarters"),  # rows past the one-thread length: warp rows
    (50_000, 0, 40, "bool"),
    (50_000, 0, 40, "int32"),
    (70_000, 0, 3, "bool"),       # one hub run of most lanes
    (3000, 0, 2000, "bool"),      # mostly one-thread rows, some empty
    (0, 0, 5, "bool"),            # no lanes at all
])
def test_kernel_matches_plain(cuda, e, d, v, kind):
    rng = np.random.default_rng(e + d + v)
    seg = _lanes(rng, e, v, negatives=5)
    shape = (seg.size, d) if d else (seg.size,)
    vals = {"float32": lambda: rng.normal(size=shape).astype(np.float32),
            "bool": lambda: rng.random(shape) < 0.5,
            "int32": lambda: rng.integers(-3, 4, shape).astype(np.int32),
            "quarters": lambda: (rng.integers(-8, 8, shape) / 4).astype(np.float32),
            }[kind]()
    out_dtype = torch.float32 if kind in ("float32", "quarters") else torch.int32
    tv, ts = torch.from_numpy(vals).to(cuda), torch.from_numpy(seg).to(cuda)
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
    """Kernel on == kernel off == the numpy oracle, one K1 call a pass."""
    g = rmat(12, 16, seed=0)
    before = segsum.launches
    on = pbahmani(g, eps=eps, kernel=True, device=cuda)
    assert segsum.launches == before + on[2]
    off = pbahmani(g, eps=eps, kernel=False, device=cuda)
    want = pbahmani_np(g, eps=eps)
    assert on[0] == off[0] and on[2] == off[2] == want[2]
    np.testing.assert_array_equal(on[1], off[1])
    np.testing.assert_array_equal(on[1], want[1])
    assert abs(on[0] - want[0]) <= 1e-6 * want[0]


def test_kcore_and_cbds_kernel_on_card(cuda):
    g = rmat(12, 16, seed=0)
    on, off = (kcore_decompose(g, kernel=k, device=cuda) for k in (True, False))
    np.testing.assert_array_equal(on[0], off[0])
    assert on[1:] == off[1:]
    c_on, c_off = (cbds_p(g, rounds=3, kernel=k, device=cuda) for k in (True, False))
    np.testing.assert_array_equal(c_on.pop("member_mask"), c_off.pop("member_mask"))
    assert c_on == c_off


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


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_pruned_kernel_on_card(cuda, eps):
    """Pruned with the kernels on == off == unpruned == the numpy oracle on a
    small planted block, with two K4 calls (and two K3 scans) a query."""
    g, _, _ = planted_dense(4096, 64, seed=0)
    compact.prefix_sum_launches = compact.stream_compact_launches = 0
    on = pbahmani(g, eps=eps, pruned=True, kernel=True, device=cuda)
    assert (compact.prefix_sum_launches, compact.stream_compact_launches) == (2, 2)
    off = pbahmani(g, eps=eps, pruned=True, kernel=False, device=cuda)
    plain = pbahmani(g, eps=eps, kernel=True, device=cuda)
    want = pbahmani_np(g, eps=eps)
    for got in (off, plain):
        assert got[0] == on[0] and got[2] == on[2]
        np.testing.assert_array_equal(got[1], on[1])
    assert on[2] == want[2] and abs(on[0] - want[0]) <= 1e-6 * want[0]
    np.testing.assert_array_equal(on[1], want[1])


def test_refine_kernel_on_card(cuda):
    g = rmat(11, 16, seed=0)
    on, off = (refine(g, target_gap=-1.0, max_rounds=3, eps=0.1, kernel=k, device=cuda)
               for k in (True, False))
    assert on.certificate == off.certificate and on.history == off.history
    np.testing.assert_array_equal(on.mask, off.mask)
