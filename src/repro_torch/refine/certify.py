"""LP-duality gap certificates for refined densities.

After T refinement rounds (loads.py), ``loads / T`` is a feasible point of
the load-balancing LP dual (every edge charged exactly once per round), so

    rho_best  <=  rho*(G)  <=  max_v loads(v) / T

where rho_best is the best subgraph density any round achieved. Both sides
of the sandwich are ratios of *integers* the device returns exactly
(best_ne / best_nv and max_load / rounds), so the certificate is evaluated
in exact rational arithmetic on the host — Python ints never overflow —
and ``proves_optimal`` is a proof, not a float comparison: when the primal
fraction reaches the dual fraction, rho_best == rho*(G) exactly.

Any round's dual bound stays valid forever on an unchanged graph, so the
anytime engines track the *running minimum* dual fraction across rounds
(``better_fraction``); the reported gap is monotone nonincreasing by
construction — the "gap closing monotonically" contract bench_refine.py
gates.

``refine_round_np`` is the numpy bit-oracle for one device round (same
int32 state, same float32 threshold arithmetic, operation for operation),
and ``oracle_check`` closes the loop against the flow-based exact solver on
graphs small enough to afford it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class GapCertificate:
    """Exact-rational sandwich rho_best <= rho* <= dual for one graph.

    best_ne / best_nv: integer edge/vertex counts of the best subgraph seen
    dual_num / dual_den: max vertex load / round index of the (running-min)
        dual bound — ``dual_num/dual_den >= rho*`` by LP feasibility
    density, dual_bound, gap, rel_gap: float64 conveniences of the above
    proves_optimal: best_ne * dual_den >= dual_num * best_nv (exact ints) —
        the early-exit certificate: density IS the optimum
    """

    best_ne: int
    best_nv: int
    dual_num: int
    dual_den: int
    density: float
    dual_bound: float
    gap: float
    rel_gap: float
    proves_optimal: bool


# repro: proof
def better_fraction(a_num: int, a_den: int, b_num: int, b_den: int) -> bool:
    """True iff a_num/a_den < b_num/b_den (exact; denominators > 0)."""
    return a_num * b_den < b_num * a_den


# repro: proof
def dual_fraction(loads: np.ndarray, rounds: int) -> tuple[int, int]:
    """The k-sweep dual bound as an exact fraction (num, den).

    ``max_v loads(v)/T`` is valid but loose: one surplus vertex dominates
    and the batched rounds rotate it forever. For EVERY k, though,

        rho*  <=  max( avg of top-k loads / T ,  (k-2)/2 )

    — if the optimum S* has |S*| >= k then (since every edge inside S*
    charges a vertex of S*) rho* <= avg_{v in S*} loads(v)/T <= the top-k
    average; otherwise |S*| <= k-1 caps rho* at (|S*|-1)/2 <= (k-2)/2. The
    minimum over k is therefore sound, and averaging washes out the
    rotating surplus — on a clique it proves optimality outright. k is
    *selected* by a float sweep (any choice is sound) and the returned
    fraction is evaluated in exact integers.

    The stored bound D also survives graph updates (the certified-skip
    argument in delta.py): deleting edges only frees load, and if the new
    optimum exceeded D (+ the max-incident insert slack m), its support
    would exceed 2(D+m)+1 >= k, so the top-k average (shifted by at most m
    per vertex) would still cap it — a contradiction.
    """
    loads = np.asarray(loads, dtype=np.int64)
    n = loads.shape[0]
    if n == 0:
        return 0, int(rounds)
    cs = np.cumsum(np.sort(loads)[::-1])
    ks = np.arange(1, n + 1, dtype=np.int64)
    # repro: allow RPR301,RPR302,RPR303 -- float sweep only SELECTS k (any k is sound); the returned fraction is exact
    bounds = np.maximum(cs / (ks * float(rounds)), (ks - 2) / 2.0)
    j = int(np.argmin(bounds))
    k = j + 1
    avg_num, avg_den = int(cs[j]), k * int(rounds)
    clique_num, clique_den = k - 2, 2
    if clique_num * avg_den > avg_num * clique_den:  # exact max of the two
        return clique_num, clique_den
    return avg_num, avg_den


# repro: proof
def make_certificate(best_ne: int, best_nv: int, dual_num: int,
                     dual_den: int) -> GapCertificate:
    best_ne, best_nv = int(best_ne), int(best_nv)
    dual_num, dual_den = int(dual_num), int(max(dual_den, 1))
    # repro: allow RPR301,RPR302 -- float64 convenience field; proves_optimal below is the exact compare
    density = best_ne / best_nv if best_nv > 0 else 0.0
    dual = dual_num / dual_den  # repro: allow RPR302 -- convenience field, not the proof
    proves = best_ne * dual_den >= dual_num * best_nv
    gap = 0.0 if proves else max(dual - density, 0.0)  # repro: allow RPR301 -- reporting only
    rel_gap = 0.0 if proves else (gap / dual if dual > 0 else 0.0)  # repro: allow RPR301,RPR302 -- reporting only
    return GapCertificate(
        best_ne=best_ne, best_nv=best_nv, dual_num=dual_num,
        dual_den=dual_den, density=density, dual_bound=dual, gap=gap,
        rel_gap=rel_gap, proves_optimal=proves,
    )


# repro: proof
def max_fraction(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int]:
    """The not-smaller of two nonnegative fractions (ne, nv); an empty
    denominator loses. Used to host-guard the refined best against the seed
    so ``refined >= seed`` holds exactly, not just up to f32 rounding."""
    a_ne, a_nv = a
    b_ne, b_nv = b
    if b_nv == 0:
        return a
    if a_nv == 0:
        return b
    return b if a_ne * b_nv < b_ne * a_nv else a


# ---------------------------------------------------------------------------
# numpy bit-oracle for one refinement round
# ---------------------------------------------------------------------------
def refine_round_np(
    src: np.ndarray, dst: np.ndarray, deg0: np.ndarray, n_edges: int,
    loads: np.ndarray, best: tuple, eps: float,
) -> tuple[np.ndarray, tuple, int, int]:
    """Replicates one device round in host numpy — same int32 state, same
    float32 threshold arithmetic (operation for operation), same smaller-id
    tie-break. ``src, dst`` are the sentinel-padded symmetric COO arrays,
    ``best = (best_density_f32, best_ne, best_nv, best_mask)``.
    Returns (loads, best, passes_this_round)."""
    n = deg0.shape[0]
    s64 = src.astype(np.int64)
    d64 = dst.astype(np.int64)
    best_density, best_ne, best_nv, best_mask = best
    best_density = np.float32(best_density)
    best_mask = np.asarray(best_mask, dtype=bool).copy()
    loads = loads.astype(np.int64).copy()
    deg = deg0.astype(np.int64).copy()
    active = deg > 0
    n_v = int(active.sum())
    n_e = int(n_edges)
    load_sum = int(loads[active].sum())
    passes = 0
    ext = np.zeros(n + 1, dtype=bool)  # sentinel row for padded lookups
    while n_v > 0:
        key = (loads + deg).astype(np.float32)
        thr = np.float32(1.0 + eps) * (
            np.float32(load_sum + 2 * n_e) / np.float32(max(n_v, 1)))
        min_key = key[active].min() if active.any() else np.float32(np.inf)
        failed = active & ((key <= thr) | (key <= min_key))
        ext[:n] = active
        live = ext[np.minimum(s64, n)] & ext[np.minimum(d64, n)]
        ext[:n] = failed
        fail_s = ext[np.minimum(s64, n)] & live
        fail_d = ext[np.minimum(d64, n)] & live
        delta = np.bincount(d64[fail_s], minlength=n + 1)[:n]
        assign_s = fail_s & (~fail_d | (s64 < d64))
        inc = np.bincount(s64[assign_s], minlength=n + 1)[:n]
        n_e -= int((fail_s | fail_d).sum()) // 2
        active &= ~failed
        deg = np.where(active, deg - delta, 0)
        n_v -= int(failed.sum())
        load_sum -= int(loads[failed].sum())
        loads += inc
        passes += 1
        rho_new = (np.float32(n_e) / np.float32(max(n_v, 1))
                   if n_v > 0 else np.float32(0.0))
        if rho_new > best_density:
            best_density = rho_new
            best_ne, best_nv = n_e, n_v
            best_mask = active.copy()
    best = (best_density, int(best_ne), int(best_nv), best_mask)
    return loads, best, passes


def oracle_check(graph, cert: GapCertificate, tol: float = 1e-9) -> float:
    """Assert the certificate sandwich against the exact flow solver:
    density <= rho*(G) <= dual_bound. Returns rho* for further checks.
    Small graphs only (Goldberg flow is the deliberate non-scaling
    baseline)."""
    from repro_torch.core.exact import exact_densest

    rho_star, _ = exact_densest(graph)
    assert cert.density <= rho_star + tol, (
        f"certificate density {cert.density} exceeds optimum {rho_star}")
    assert cert.dual_bound >= rho_star - tol, (
        f"dual bound {cert.dual_bound} below optimum {rho_star}")
    return float(rho_star)


__all__ = [
    "GapCertificate",
    "make_certificate",
    "better_fraction",
    "dual_fraction",
    "max_fraction",
    "refine_round_np",
    "oracle_check",
]
