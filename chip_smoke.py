#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernel from ``src/repro_torch/csrc`` and drives the
port's main path at full width: P-Bahmani and CBDS-P on the Graph500 RMAT
graph ``rmat(19, 16, seed=0)`` (524,288 vertices, 15,482,624 edge lanes, the
largest Graph500 scale inside the 2^24-lane exactness envelope). Phases:

  1. card and build: ``nvidia-smi`` name and power limit, versions, build time;
  2. the kernel against its plain version on the card, at the main path's
     shape and at the cases of ``tests/test_kernels.py``, with times;
  3. ``peel_threshold`` float32 bits, card against CPU and numpy;
  4. P-Bahmani, kernel on against kernel off and the numpy oracle;
  5. CBDS-P and k-core, kernel on against kernel off and the numpy oracles;
  6. a JSON line of every kernel, then the card's name and power limit, then
     the result line ``{"ok": true, "device": {...}}``.

Every check raises on failure, so the script exits non-zero and prints no
result line. It also exits non-zero where there is no CUDA device, or when
the ``repro_torch`` package is not beside it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

SCALE = 19
EDGE_FACTOR = 16
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
REPLACES = "src/repro/kernels/segsum.py:118"
# The JAX package's numpy oracles on rmat(19, 16, seed=0): (passes, |S|) of
# pbahmani_np per eps, and (k*, m_v, m_e) of kcore_np (minutes on a host
# CPU, too slow to rerun here; the same oracle is rerun at scale 15 below).
EXPECTED_PEEL = {19: {0.1: (5, 5204), 0.0: (7, 1185)}}
EXPECTED_CORE = {19: (186, 5036, 1549727)}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one ``fn()`` over ``iters`` calls, after a warm
    call, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wall_s(fn, runs: int) -> list[float]:
    import torch

    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------
def kernel_cases(device: str, seed: int = 0):
    """(name, values, seg_ids, num_segments, out_dtype, tol) on ``device``:
    the cases of tests/test_kernels.py plus negative ids. tol None means
    exact equality."""
    import torch

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def sorted_ids(e, v):
        return np.sort(rng.integers(0, v, e)).astype(np.int32)

    cases = []
    for e, d, v in [(64, 0, 16), (1000, 33, 300), (512, 128, 256),
                    (2048, 16, 1000), (513, 7, 100), (100, 200, 50)]:
        vals = rng.normal(size=(e, d) if d else (e,)).astype(np.float32)
        cases.append((f"shape e={e} d={d} v={v}", t(vals), t(sorted_ids(e, v)), v,
                      torch.float32, 1e-5))
    seg = sorted_ids(500, 64)
    cases.append(("bf16 [500,8]", t(rng.normal(size=(500, 8)).astype(np.float32)).to(torch.bfloat16),
                  t(seg), 64, torch.float32, 2e-2))
    ints = rng.integers(0, 3, (500, 8)).astype(np.int32)
    cases.append(("int32 [500,8] -> f32", t(ints), t(seg), 64, torch.float32, None))
    cases.append(("int32 [500,8] -> i32", t(ints), t(seg), 64, torch.int32, None))
    cases.append(("sentinel padding", t(np.ones(6, np.float32)),
                  t(np.array([0, 1, 1, 7, 8, 100], np.int32)), 7, torch.float32, None))
    cases.append(("all sentinel", t(np.ones(700, np.float32)),
                  t(np.full(700, 1 << 20, np.int32)), 32, torch.float32, None))
    cases.append(("one segment straddles", t(np.ones(1537, np.float32)),
                  t(np.zeros(1537, np.int32)), 4, torch.float32, None))
    hub = np.r_[np.zeros(3, np.int32), np.full(50_000, 1, np.int32), np.full(7, 2, np.int32)]
    cases.append(("hub row of 50000 lanes, bool -> i32", t(rng.random(hub.size) < 0.5),
                  t(hub), 3, torch.int32, None))
    dup = np.sort(np.r_[np.full(510, 3), np.full(5, 4), np.full(509, 5)]).astype(np.int32)
    cases.append(("duplicates at run boundaries", t(np.ones(dup.size, np.float32)),
                  t(dup), 8, torch.float32, None))
    neg = np.sort(np.r_[rng.integers(-50, 0, 40), rng.integers(0, 30, 300)]).astype(np.int32)
    cases.append(("negative ids", t(rng.normal(size=neg.size).astype(np.float32)),
                  t(neg), 30, torch.float32, 1e-5))
    cases.append(("negative ids, bool -> i32", t(rng.random(neg.size) < 0.5), t(neg), 30,
                  torch.int32, None))
    return cases


def compare(out, exp, tol) -> float:
    import torch

    check(out.dtype == exp.dtype and out.shape == exp.shape,
          f"kernel gave {out.dtype} {tuple(out.shape)}, plain {exp.dtype} {tuple(exp.shape)}")
    if tol is None:
        check(torch.equal(out, exp), "kernel and plain version differ (exact case)")
        return float((out.double() - exp.double()).abs().max()) if out.numel() else 0.0
    check(torch.allclose(out, exp, rtol=tol, atol=tol),
          f"kernel and plain version differ beyond rtol=atol={tol}")
    return float((out - exp).abs().max()) if out.numel() else 0.0


def phase_kernels(g, device: str) -> tuple[dict, dict]:
    import torch

    from repro_torch.graphs.convert import to_device
    from repro_torch.kernels import ops, ref, segsum

    max_err = 0.0
    for name, vals, seg, v, out_dtype, tol in kernel_cases(device):
        out = segsum.segment_sum_sorted(vals, seg, num_segments=v, out_dtype=out_dtype)
        exp = ref.segment_sum_ref(vals, seg, v, out_dtype)
        torch.cuda.synchronize()
        err = compare(out, exp, tol)
        max_err = max(max_err, err)
        log(f"  K1 {name}: ok (max abs err {err:g}, tol {tol or 'exact'})")

    # presorted=False sorts first and counts it
    rng = np.random.default_rng(9)
    seg_u = torch.from_numpy(rng.integers(0, 99, 777).astype(np.int32)).to(device)
    vals_u = torch.from_numpy(rng.normal(size=(777, 12)).astype(np.float32)).to(device)
    before = ops.unsorted_fallback_count
    out = ops.segment_sum(vals_u, seg_u, num_segments=99, presorted=False)
    max_err = max(max_err, compare(out, ref.segment_sum_ref(vals_u, seg_u, 99), 1e-5))
    check(ops.unsorted_fallback_count == before + 1, "unsorted fallback not counted")
    log("  K1 presorted=False: ok, counted")

    # the main path's shape: dst-sorted lanes of the graph, 0/1 lanes
    src_s, dst_s = to_device(g, device, sorted=True)
    e, v = dst_s.shape[0], g.n_nodes
    lane_rng = np.random.default_rng(1)
    fail = torch.from_numpy(lane_rng.random(e) < 0.5).to(device)
    fail_i32 = fail.to(torch.int32)
    fail_f32 = fail.to(torch.float32)
    results = {}
    for label, vals, out_dtype in [("bool -> int32 (peel_delta)", fail, torch.int32),
                                   ("int32 -> int32", fail_i32, torch.int32),
                                   ("float32 -> float32", fail_f32, torch.float32)]:
        out = segsum.segment_sum_sorted(vals, dst_s, num_segments=v, out_dtype=out_dtype)
        exp = ref.segment_sum_ref(vals, dst_s, v, out_dtype)
        torch.cuda.synchronize()
        max_err = max(max_err, compare(out, exp, None))
        ms = time_ms(lambda: segsum.segment_sum_sorted(vals, dst_s, num_segments=v,
                                                       out_dtype=out_dtype))
        plain = time_ms(lambda: ref.segment_sum_ref(vals, dst_s, v, out_dtype))
        # yardstick: one index_add_ into V+1 rows over ids already clamped,
        # with values in the accumulator's type (index_add_ takes no bool)
        acc = torch.zeros(v + 1, dtype=out_dtype, device=device)
        ids = dst_s.clamp(max=v)
        vals_lib = vals.to(out_dtype)
        lib = time_ms(lambda: acc.index_add_(0, ids, vals_lib))
        n_bytes = e * 4 + e * vals.element_size() + v * out.element_size()
        b, by = bound_ms(n_bytes, e)
        results[label] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by)
        log(f"  K1 main shape E={e} V={v} {label}: exact; kernel_ms={ms:.6f} "
            f"plain_ms={plain:.6f} library_ms={lib:.6f} bound_ms={b:.6f} ({by})")

    # peel_update (K2): a wrapper on K1, exact against its plain version
    failed = torch.from_numpy(np.random.default_rng(2).random(v) < 0.3).to(device)
    out = ops.peel_update(src_s, dst_s, failed, n_nodes=v)
    exp = ref.peel_update_ref(src_s, dst_s, failed, v)
    torch.cuda.synchronize()
    check(out.dtype == torch.int32 and torch.equal(out, exp), "peel_update differs")
    ms = time_ms(lambda: ops.peel_update(src_s, dst_s, failed, n_nodes=v))
    plain = time_ms(lambda: ref.peel_update_ref(src_s, dst_s, failed, v))
    acc = torch.zeros(v + 1, dtype=torch.int32, device=device)
    ids = dst_s.clamp(max=v)
    src_c = src_s.clamp(max=v - 1)
    lib = time_ms(lambda: acc.index_add_(0, ids, failed[src_c].to(torch.int32)))
    # src, dst lanes and failed read once, delta written once
    b, by = bound_ms(e * 8 + v * 1 + v * 4, 2 * e)
    peel = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by)
    log(f"  peel_update main shape: exact; wrapper_ms={ms:.6f} plain_ms={plain:.6f} "
        f"library_ms={lib:.6f} bound_ms={b:.6f} ({by})")
    return dict(results["bool -> int32 (peel_delta)"], max_abs_err=max_err,
                by_type=results), peel


# ---------------------------------------------------------------------------
# phase 3: peel_threshold bits
# ---------------------------------------------------------------------------
def phase_threshold(device: str, n: int = 4096) -> None:
    import torch

    from repro_torch.core.density import peel_threshold

    rng = np.random.default_rng(3)
    n_e = rng.integers(0, 1 << 24, n).astype(np.int32)
    n_v = rng.integers(0, 1 << 22, n).astype(np.int32)
    for eps in [0.0, 0.05, 0.1, 0.5, 1e-3, 0.3333333333333333, 2.0]:
        cpu = peel_threshold(torch.from_numpy(n_e), torch.from_numpy(n_v), eps)
        dev = peel_threshold(torch.from_numpy(n_e).to(device),
                             torch.from_numpy(n_v).to(device), eps).cpu()
        rho = n_e.astype(np.float32) / np.maximum(n_v.astype(np.float32), np.float32(1))
        ref = np.float32(2.0 * (1.0 + eps)) * rho
        check(np.array_equal(cpu.numpy().view(np.int32), dev.numpy().view(np.int32)),
              f"peel_threshold bits differ between CPU and {device} at eps={eps}")
        check(np.array_equal(cpu.numpy().view(np.int32), ref.view(np.int32)),
              f"peel_threshold bits differ from numpy float32 at eps={eps}")
    log(f"  peel_threshold: {7 * n} cases bit-identical on {device}, CPU and numpy")


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------
def phase_pbahmani(g, device: str, scale: int, timed_runs: int = 3) -> tuple[int, dict]:
    from repro_torch.core import pbahmani, pbahmani_np
    from repro_torch.kernels import segsum

    launches, times = 0, {}
    for eps in (0.1, 0.0):
        t0 = time.perf_counter()
        rho_n, mask_n, passes_n = pbahmani_np(g, eps=eps)
        t_np = time.perf_counter() - t0
        segsum.launches = 0
        rho_k, mask_k, passes_k = pbahmani(g, eps=eps, kernel=True, device=device)
        n_launch = segsum.launches
        rho_s, mask_s, passes_s = pbahmani(g, eps=eps, kernel=False, device=device)
        check(n_launch == passes_k, f"eps={eps}: K1 launched {n_launch} times in "
              f"{passes_k} passes")
        check(rho_k == rho_s and passes_k == passes_s and np.array_equal(mask_k, mask_s),
              f"eps={eps}: kernel on {rho_k, passes_k} differs from off {rho_s, passes_s}")
        check(passes_k == passes_n and np.array_equal(mask_k, mask_n)
              and abs(rho_k - rho_n) <= 1e-6 * rho_n,
              f"eps={eps}: port {rho_k, passes_k} differs from pbahmani_np {rho_n, passes_n}")
        want = EXPECTED_PEEL.get(scale, {}).get(eps)
        check(want is None or want == (passes_k, int(mask_k.sum())),
              f"eps={eps}: (passes, |S|) = {passes_k, int(mask_k.sum())}, expected {want}")
        launches += n_launch
        on = wall_s(lambda: pbahmani(g, eps=eps, kernel=True, device=device), timed_runs)
        off = wall_s(lambda: pbahmani(g, eps=eps, kernel=False, device=device), timed_runs)
        times[eps] = dict(kernel_s=statistics.median(on), scatter_s=statistics.median(off),
                          passes=passes_k)
        log(f"  P-Bahmani eps={eps}: density={rho_k!r} |S|={int(mask_k.sum())} "
            f"passes={passes_k}; on == off == pbahmani_np (numpy {t_np:.2f} s); "
            f"K1 launches={n_launch}; wall median of {timed_runs}: kernel "
            f"{times[eps]['kernel_s']:.6f} s, scatter {times[eps]['scatter_s']:.6f} s")
    return launches, times


def phase_cbds(g, g_small, device: str, scale: int) -> tuple[int, dict]:
    from repro_torch.core import cbds_np, cbds_p, kcore_decompose, kcore_np
    from repro_torch.kernels import segsum

    # numpy oracles at the smaller scale
    core_n = kcore_np(g_small)
    cb_n = cbds_np(g_small, rounds=1)
    for kernel in (True, False):
        core_p = kcore_decompose(g_small, kernel=kernel, device=device)
        cb_p = cbds_p(g_small, rounds=1, kernel=kernel, device=device)
        check(np.array_equal(core_p[0], core_n[0]) and core_p[2:] == core_n[2:]
              and abs(core_p[1] - core_n[1]) <= 1e-6 * core_n[1],
              f"kcore (kernel={kernel}) {core_p[1:]} differs from kcore_np {core_n[1:]}")
        check(cb_p["k_star"] == cb_n["k_star"] and cb_p["n_legit"] == cb_n["n_legit"]
              and np.array_equal(cb_p["member_mask"], cb_n["member_mask"])
              and abs(cb_p["density"] - cb_n["density"]) <= 1e-6 * cb_n["density"],
              f"cbds_p (kernel={kernel}) differs from cbds_np")
    log(f"  small graph |V|={g_small.n_nodes}: kcore and cbds_p (kernel on and off) "
        f"== kcore_np, cbds_np (k*={core_n[2]}, m_v={core_n[3]}, m_e={core_n[4]})")

    segsum.launches = 0
    t0 = time.perf_counter()
    cb_k = cbds_p(g, rounds=1, kernel=True, device=device)
    t_cb_k = time.perf_counter() - t0
    n_cbds = segsum.launches
    check(n_cbds > 0, "CBDS-P did not launch K1")
    t0 = time.perf_counter()
    cb_s = cbds_p(g, rounds=1, kernel=False, device=device)
    t_cb_s = time.perf_counter() - t0
    check(all(np.array_equal(cb_k[f], cb_s[f]) for f in cb_k),
          f"cbds_p kernel on {cb_k['density'], cb_k['k_star']} differs from off "
          f"{cb_s['density'], cb_s['k_star']}")

    segsum.launches = 0
    t0 = time.perf_counter()
    core_k = kcore_decompose(g, kernel=True, device=device)
    t_core_k = time.perf_counter() - t0
    n_core = segsum.launches
    t0 = time.perf_counter()
    core_s = kcore_decompose(g, kernel=False, device=device)
    t_core_s = time.perf_counter() - t0
    check(np.array_equal(core_k[0], core_s[0]) and core_k[1:] == core_s[1:],
          f"kcore kernel on {core_k[1:]} differs from off {core_s[1:]}")
    check(n_core == n_cbds, f"kcore launched K1 {n_core} times, CBDS-P {n_cbds}")
    want = EXPECTED_CORE.get(scale)
    check(want is None or want == core_k[2:],
          f"(k*, m_v, m_e) = {core_k[2:]}, expected {want}")
    check(cb_k["k_star"] == core_k[2] and cb_k["core_density"] == core_k[1],
          "cbds_p's core phase differs from kcore_decompose")
    times = dict(cbds_kernel_s=t_cb_k, cbds_scatter_s=t_cb_s, kcore_kernel_s=t_core_k,
                 kcore_scatter_s=t_core_s, launches=n_cbds)
    log(f"  CBDS-P rounds=1: density={cb_k['density']!r} k*={cb_k['k_star']} "
        f"n_legit={cb_k['n_legit']} |S|={int(cb_k['member_mask'].sum())}; on == off; "
        f"K1 launches={n_cbds}; wall kernel {t_cb_k:.6f} s, scatter {t_cb_s:.6f} s")
    log(f"  k-core: max coreness={int(core_k[0].max())} k*={core_k[2]} m_v={core_k[3]} "
        f"m_e={core_k[4]} density={core_k[1]!r}; on == off; K1 launches={n_core}; "
        f"wall kernel {t_core_k:.6f} s, scatter {t_core_s:.6f} s")
    return n_cbds, times


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU", file=sys.stderr)
        return 2
    try:
        from repro_torch.graphs.generators import rmat
        from repro_torch.kernels import segsum
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    device = "cuda"
    t_start = time.perf_counter()

    log("phase 1: card and build")
    card = card_line()
    log(f"  {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    segsum.load_library()
    log(f"  K1 built and loaded in {time.perf_counter() - t0:.3f} s from {segsum.SOURCE.name}")
    for line in segsum.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    g = rmat(SCALE, EDGE_FACTOR, seed=0)
    g.dst_sorted()
    g_small = rmat(15, EDGE_FACTOR, seed=0)
    log(f"  graphs built on the host in {time.perf_counter() - t0:.3f} s: rmat({SCALE}) "
        f"|V|={g.n_nodes} |E|={g.n_edges} lanes={g.src.shape[0]}")

    log("phase 2: kernels against their plain versions on the card")
    k1, peel = phase_kernels(g, device)

    log("phase 3: peel_threshold bits")
    phase_threshold(device)

    log("phase 4: P-Bahmani at full width")
    peel_launches, peel_times = phase_pbahmani(g, device, SCALE)

    log("phase 5: CBDS-P at full width")
    cbds_launches, cbds_times = phase_cbds(g, g_small, device, SCALE)

    log(f"main path: K1 launches P-Bahmani (eps 0.1 and 0) {peel_launches}, "
        f"CBDS-P {cbds_launches}")
    kernels = [{
        "name": "segment_sum_sorted",
        "route": "cuda",
        "source": "src/repro_torch/csrc/segsum.cu",
        "replaces": REPLACES,
        "launches": peel_launches + cbds_launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "parity": "ok",
    }]
    log(json.dumps({"wrappers": [dict(name="peel_update", kernel="segment_sum_sorted",
                                      library="gather + index_add_", parity="ok", **peel)],
                    "k1_by_type": k1["by_type"],
                    "end_to_end_s": {"pbahmani": {str(k): v for k, v in peel_times.items()},
                                     "cbds": cbds_times},
                    "smoke_s": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
