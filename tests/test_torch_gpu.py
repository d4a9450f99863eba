"""The port's CUDA kernel against its plain version on the card.

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
from repro_torch.graphs.generators import rmat  # noqa: E402
from repro_torch.kernels import ops, ref, segsum  # noqa: E402

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
