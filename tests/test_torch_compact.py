"""The port's prefix sum (K3) and stream compaction (K4) against the JAX
package's Pallas kernels (interpret mode on the CPU, as tests/test_kernels.py
runs them), on the cases of that file: lengths around the scan tile,
extremes, all dead, all live, 2-D payloads and overflow.

On the CPU the port's wrappers run their plain versions
(tests/test_torch_gpu.py holds the CUDA kernels against them on the card).
Every comparison is exact: the values are integers and both packages are
exact inside the 2^24 envelope these cases stay in.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import compact as jcompact  # noqa: E402
from repro_torch.kernels import compact, ref  # noqa: E402

P_TILE = jcompact.P_TILE


def _scan_both(x: np.ndarray):
    want = np.asarray(jcompact.prefix_sum(jnp.asarray(x)))
    got = compact.prefix_sum(torch.from_numpy(x))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    return got.numpy(), want


def _compact_both(values: np.ndarray, live: np.ndarray, out_size: int, fill: int):
    want = np.asarray(jcompact.stream_compact(jnp.asarray(values), jnp.asarray(live),
                                              out_size=out_size, fill=fill))
    got = compact.stream_compact(torch.from_numpy(values), torch.from_numpy(live),
                                 out_size=out_size, fill=fill)
    assert got.dtype == torch.int32
    return got.numpy(), want


@pytest.mark.parametrize("e", [1, 7, P_TILE - 1, P_TILE, P_TILE + 1, 1500])
def test_prefix_sum_matches_jax(e):
    x = np.random.default_rng(e).integers(0, 4, e).astype(np.int32)
    got, want = _scan_both(x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.cumsum(x))


def test_prefix_sum_bool_and_extremes_match_jax():
    for x in (np.ones(3 * P_TILE + 5, bool), np.zeros(P_TILE + 1, np.int32),
              np.random.default_rng(2).random(2000) < 0.3):
        got, want = _scan_both(x)
        np.testing.assert_array_equal(got, want)
    assert compact.prefix_sum(torch.zeros(0, dtype=torch.bool)).shape == (0,)


@pytest.mark.parametrize("e,out_size,p_live", [
    (100, 128, 0.5),
    (1500, 1024, 0.7),
    (513, 512, 0.3),
    (64, 16, 0.9),     # overflow: survivors > out_size must drop, not wrap
])
def test_stream_compact_matches_jax(e, out_size, p_live):
    rng = np.random.default_rng(e + out_size)
    values = rng.integers(0, 10_000, e).astype(np.int32)
    live = rng.random(e) < p_live
    got, want = _compact_both(values, live, out_size, out_size)
    np.testing.assert_array_equal(got, want)


def test_stream_compact_2d_and_order_match_jax():
    """[E, 2] payloads (remapped src/dst pairs) compact row-wise, survivors
    keep lane order (a dst-sorted parent stays dst-sorted), and the tail is
    the fill."""
    rng = np.random.default_rng(3)
    e, out_size = 400, 256
    dst = np.sort(rng.integers(0, 40, e)).astype(np.int32)
    src = rng.integers(0, 40, e).astype(np.int32)
    live = rng.random(e) < 0.6
    got, want = _compact_both(np.stack([src, dst], axis=1), live, out_size, out_size)
    np.testing.assert_array_equal(got, want)
    k = int(live.sum())
    np.testing.assert_array_equal(got[:k, 1], dst[live])
    assert (np.diff(got[:k, 1]) >= 0).all() and (got[k:] == out_size).all()


def test_stream_compact_all_dead_all_live_match_jax():
    vals = np.arange(300, dtype=np.int32)
    for live, out_size, fill in [(np.zeros(300, bool), 64, -7),
                                 (np.ones(300, bool), 512, 512)]:
        got, want = _compact_both(vals, live, out_size, fill)
        np.testing.assert_array_equal(got, want)
    got = compact.stream_compact(torch.zeros((0, 2), dtype=torch.int32),
                                 torch.zeros(0, dtype=torch.bool), out_size=4, fill=9)
    assert torch.equal(got, torch.full((4, 2), 9, dtype=torch.int32))


K4_TILE = compact.TILE  # lanes a tile of the one-pass K4 kernel


@pytest.mark.parametrize("e,d,out_size,p_live", [
    (K4_TILE - 1, 2, K4_TILE, 0.5),        # one tile, not full
    (K4_TILE, 0, K4_TILE, 0.7),            # exactly one tile
    (K4_TILE + 1, 2, 2 * K4_TILE, 0.5),    # a second tile of one lane
    (3 * K4_TILE + 7, 2, 2 * K4_TILE, 0.6),  # several tiles; out_size below the live count
    (2 * K4_TILE + 3, 0, 5 * K4_TILE, 0.2),  # a fill tail longer than one tile
    (2 * K4_TILE, 0, K4_TILE, 0.0),        # all dead
    (2 * K4_TILE + 1, 2, 3 * K4_TILE, 1.0),  # all live
])
def test_stream_compact_tile_edges_match_jax(e, d, out_size, p_live):
    """K4's plain version against JAX's stream_compact (Pallas interpret) at
    the edges of the port's kernel tiles, where the look-back, the overflow
    drop and the fill tail change hands between blocks."""
    rng = np.random.default_rng(e + d + out_size)
    values = rng.integers(-10_000, 10_000, (e, d) if d else e).astype(np.int32)
    live = rng.random(e) < p_live
    got, want = _compact_both(values, live, out_size, -5)
    np.testing.assert_array_equal(got, want)
    k = min(int(live.sum()), out_size)
    np.testing.assert_array_equal(got[:k], values[live][:k])
    assert (got[k:] == -5).all()


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        compact.prefix_sum(torch.ones(4, dtype=torch.int64))
    with pytest.raises(TypeError):
        compact.prefix_sum(torch.ones(2, 2, dtype=torch.int32))
    with pytest.raises(TypeError):
        compact.stream_compact(torch.ones(4), torch.ones(4, dtype=torch.bool),
                               out_size=4, fill=0)
    with pytest.raises(TypeError):
        compact.stream_compact(torch.ones(4, dtype=torch.int32),
                               torch.ones(4, dtype=torch.int32), out_size=4, fill=0)
    with pytest.raises(ValueError, match="int32"):
        compact.stream_compact(torch.ones(4, dtype=torch.int32),
                               torch.ones(4, dtype=torch.bool), out_size=4, fill=2**31)


def test_cpu_wrappers_are_the_plain_versions_and_launch_nothing():
    x = torch.from_numpy(np.random.default_rng(5).random(999) < 0.5)
    before = (compact.prefix_sum_launches, compact.stream_compact_launches)
    assert torch.equal(compact.prefix_sum(x), ref.prefix_sum_ref(x))
    vals = torch.arange(999, dtype=torch.int32)
    assert torch.equal(compact.stream_compact(vals, x, out_size=600, fill=-1),
                       ref.stream_compact_ref(vals, x, 600, -1))
    assert (compact.prefix_sum_launches, compact.stream_compact_launches) == before
