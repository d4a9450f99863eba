"""The benchmark's arithmetic on hand-made inputs: rates, percentiles,
spreads, the union of device intervals, idle shares, rooflines, and each
per-layer reader on a made-up observation."""
import types

import pytest

from dsgbench import profiling, roofline, stats
from dsgbench.harness import Observation, Window, load_reader
from dsgbench.profiling import DeviceEvent, TraceReading


def test_rate():
    assert stats.rate(300, 1.5) == 200.0
    with pytest.raises(ValueError):
        stats.rate(3, 0.0)


@pytest.mark.parametrize("q, want", [(50, 50.5), (95, 95.05), (99, 99.01)])
def test_percentile_interpolates_between_ranks(q, want):
    assert stats.percentile(range(1, 101), q) == pytest.approx(want)


def test_percentile_of_one_value_and_of_none():
    assert stats.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_union_counts_overlaps_once():
    assert stats.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert stats.union_length([]) == 0.0


def test_gaps_and_clipping_to_the_window():
    busy = [(1, 2), (1.5, 3), (6, 12)]
    assert stats.gaps(busy, 0, 10) == [(0, 1), (3, 6)]
    assert stats.union_length(stats.clip(busy, 0, 10)) == 6.0
    assert stats.clip([(-5, 1), (9, 20), (11, 12)], 0, 10) == [(0, 1), (9, 10)]


def test_k2_bytes_and_roofline_share():
    assert roofline.k2_bytes(15_482_624, 524_288) == 15_482_624 * 8 + 524_288 * 6 + 4
    # exactly the bound's time reads 100 %
    b = roofline.k2_bytes(1000, 100)
    assert roofline.share_pct(b, b / roofline.HBM_BYTES_PER_S) == pytest.approx(100.0)
    with pytest.raises(ValueError):
        roofline.share_pct(1, 0.0)


def reading():
    r = TraceReading(window=(0.0, 1000.0))
    r.events = [DeviceEvent("void peel_kernel<64>(int const*)", 100, 160),
                DeviceEvent("pack_kernel(unsigned char const*)", 90, 100),
                DeviceEvent("indexFuncLargeIndex", 150, 300),
                DeviceEvent("Memcpy DtoH (Device -> Pageable)", 700, 710),
                DeviceEvent("void peel_rows_kernel<0>(int const*)", 800, 820)]
    r.ranges = [("dsgbench:pbahmani", 0, 1000), ("obs:query", 400, 600)]
    return r


def test_busy_and_breakdown_of_a_reading():
    r = reading()
    assert r.window_s == pytest.approx(1e-3)
    assert r.busy_s() == pytest.approx((300 - 90 + 10 + 20) / 1e6)
    b = profiling.breakdown(r)
    assert b["device_ops"][0] == ["indexFuncLargeIndex", pytest.approx(150e-6)]
    labels = dict(b["idle_gaps"])
    # the gap 300..700 has its middle (500) inside obs:query, the innermost range
    assert labels["obs:query"] == pytest.approx(400e-6)
    assert labels["dsgbench:pbahmani"] == pytest.approx((90 + 90 + 180) / 1e6)


def obs(**kw):
    o = Observation(reading=reading(), answers_profiled=4, answers_synced=10, syncs=120,
                    spans_s={"flush": [0.1, 0.3], "ingest_many": [0.2]},
                    counters_profiled={"k2_launches": 2}, k2_bytes=335_000_000)
    for k, v in kw.items():
        setattr(o, k, v)
    return o


@pytest.mark.parametrize("name, want", [
    ("device_idle_pct", 100.0 * (1 - 240e-6 / 1e-3)),
    ("launches_per_answer", 5 / 4),
    ("host_syncs_per_answer", 12.0),
    # 2 launches x 335 MB at 3.35 TB/s is 200 us, over 70 us of pack + peel
    ("k2_roofline_pct", 100.0 * 200 / 70),
    ("flush_ms", 200.0),
    ("ingest_ms", 200.0),
])
def test_per_layer_readers(name, want):
    assert load_reader("metrics", name).read(obs()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["device_idle_pct", "launches_per_answer", "k2_roofline_pct"])
def test_trace_readers_read_nothing_without_a_trace(name):
    assert load_reader("metrics", name).read(obs(reading=None)) is None
    assert load_reader("metrics", name).read(obs(reading=TraceReading(window=(0.0, 1.0)))) is None


@pytest.mark.parametrize("name, empty", [("host_syncs_per_answer", {"syncs": None}),
                                         ("flush_ms", {"spans_s": {}}),
                                         ("ingest_ms", {"spans_s": {}}),
                                         ("k2_roofline_pct", {"k2_bytes": None}),
                                         ("k2_roofline_pct", {"counters_profiled": {}})])
def test_readers_read_nothing_where_there_is_nothing(name, empty):
    assert load_reader("metrics", name).read(obs(**empty)) is None


def test_end_to_end_readers():
    w = Window(answers=400, seconds=2.0, latencies_s=[i / 1000 for i in range(1, 101)],
               setup_s=7.5)
    assert load_reader("e2e", "answers_per_s").read(w) == 200.0
    assert load_reader("e2e", "answer_p95_ms").read(w) == pytest.approx(95.05)
    assert load_reader("e2e", "setup_s").read(w) == 7.5


def test_reading_from_profiler_like_events():
    from torch.autograd import DeviceType

    def ev(name, dev, a, b):
        return types.SimpleNamespace(name=name, device_type=dev,
                                     time_range=types.SimpleNamespace(start=a, end=b))

    r = profiling.reading_from_events([
        ev("dsgbench:window", DeviceType.CPU, 10, 90),
        ev("dsgbench:flush", DeviceType.CPU, 20, 80),
        ev("aten::add", DeviceType.CPU, 21, 22),
        ev("obs:fused_flush", DeviceType.CUDA, 30, 40),     # a label on the device's timeline
        ev("void peel_rows_kernel<0>()", DeviceType.CUDA, 31, 35),
    ])
    assert r.window == (10, 90)
    assert [e.name for e in r.events] == ["void peel_rows_kernel<0>()"]
    assert r.ranges == [("dsgbench:flush", 20, 80)]


def test_a_reading_without_a_window_range_takes_the_host_clock():
    from torch.autograd import DeviceType

    def ev(name, a, b):
        return types.SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                                     time_range=types.SimpleNamespace(start=a, end=b))

    r = profiling.reading_from_events([ev("peel_kernel", 5000, 5100),
                                       ev("Memcpy DtoH (Device -> Pageable)", 5050, 5200)],
                                      host_window_s=1e-3)
    assert r.window is None and r.window_s == 1e-3
    assert len(r.inside()) == 2
    assert r.busy_s() == pytest.approx(200e-6)
    o = obs(reading=r, answers_profiled=2)
    assert load_reader("metrics", "device_idle_pct").read(o) == pytest.approx(80.0)
    assert load_reader("metrics", "launches_per_answer").read(o) == 1.0


def test_the_mask_reservoir_keeps_a_uniform_sample_of_copies():
    import numpy as np

    from dsgbench.drivers import Reservoir

    res = Reservoir(3, 4, np.random.default_rng(0))
    masks = [np.array([i % 2, 1, 0, i % 3], dtype=bool) for i in range(50)]
    for k, m in enumerate(masks):
        res.offer(k, m)
        m[:] = False   # the program's array is not kept
    assert res.seen == 50 and len(res.items) == 3
    for k, kept in res.items:
        assert kept.tolist() == [bool(k % 2), True, False, bool(k % 3)]
    # every answer is as likely to be kept: over many streams each index's share is near 3/50
    hits = np.zeros(50)
    for seed in range(2000):
        r = Reservoir(3, 1, np.random.default_rng(seed))
        for k in range(50):
            r.offer(k, np.ones(1, dtype=bool))
        hits[[k for k, _ in r.items]] += 1
    assert np.all(np.abs(hits / 2000 - 3 / 50) < 0.025)
