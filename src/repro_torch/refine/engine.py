"""Anytime near-optimal refinement: ``refine(graph, target_gap=...)``.

Seeds from a peel result (by default the eps-approximate ``pbahmani`` peel,
pruned or not), then runs weighted-peel rounds (loads.py) until the
exact-rational duality gap (certify.py) closes below ``target_gap`` or
``max_rounds`` is spent. Every round yields a full certificate, so the
caller can stop anywhere with a sound sandwich rho_best <= rho* <= dual.

``refine_resident`` runs the same loop off arrays already on the device,
or with ``mesh=`` off this rank's block of a sharded engine's lanes. This is
the JAX package's ``refine/engine.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.dispatch import (
    assert_exact_envelope, resolve_device, resolve_kernel,
)
from repro_torch.graphs.convert import to_device
from repro_torch.graphs.graph import Graph
from repro_torch.refine.certify import (
    GapCertificate, better_fraction, dual_fraction, make_certificate,
    max_fraction,
)
from repro_torch.refine.loads import _refine_round

# relative duality gap (gap / dual bound) at which refinement declares
# convergence: rel_gap <= g certifies rho_best >= (1 - g) * rho*(G)
DEFAULT_TARGET_GAP = 0.01


@dataclass(frozen=True)
class RoundRecord:
    """One row of the anytime trajectory (certificate after round t)."""

    round: int
    density: float
    dual_bound: float
    gap: float
    rel_gap: float
    passes: int  # cumulative peel passes including the seed peel's


@dataclass
class RefineResult:
    density: float            # best certified density (>= seed, exactly)
    mask: np.ndarray          # bool [n_nodes] achieving ``density``
    dual_bound: float         # running-min LP dual bound (>= rho*)
    gap: float
    rel_gap: float
    rounds: int
    passes: int               # cumulative passes (seed peel + all rounds)
    proved_optimal: bool      # density == rho*(G), proven in exact ints
    converged: bool           # rel_gap <= target_gap within max_rounds
    seed_density: float
    certificate: GapCertificate = None
    history: list = field(default_factory=list)


def _seed_counts(mask: np.ndarray, u: np.ndarray, v: np.ndarray) -> tuple:
    """Exact integer (ne, nv) of the subgraph induced by ``mask`` from host
    endpoint arrays carrying one undirected entry per edge (sentinels fall
    on the appended always-False row)."""
    lv = np.zeros(mask.shape[0] + 1, dtype=bool)
    lv[: mask.shape[0]] = mask
    ne = int((lv[np.minimum(u, mask.shape[0])]
              & lv[np.minimum(v, mask.shape[0])]).sum())
    return ne, int(mask.sum())


def refine_resident(
    src, dst, deg, n_edges: int, n_nodes: int, eps: float,
    seed_ne: int, seed_nv: int, seed_mask: np.ndarray, seed_passes: int,
    target_gap: float, max_rounds: int, kernel: bool = False,
    mesh=None,
) -> tuple[GapCertificate, np.ndarray, int, int, list]:
    """Run refinement rounds off COO lanes and a degree array on the device.

    ``seed_mask`` is full-width (n_nodes); ``seed_ne/seed_nv`` its exact
    induced counts. Returns (certificate, best_mask_full, passes, rounds,
    history). The loop stops as soon as ``rel_gap <= target_gap``; a
    negative target runs exactly ``max_rounds`` rounds. ``max_rounds`` is
    floored at 1: a certificate needs a load round for its dual side.
    ``kernel`` routes each round's edge stage through K2 (the caller
    supplies dst-sorted lanes); certificates are bit-identical either way.
    With ``mesh`` (every rank calling together) ``src``/``dst`` are this
    rank's block of the lanes and each pass makes one all-reduce; the round
    integers are the single-device ones on any rank count.
    """
    max_rounds = max(int(max_rounds), 1)
    dev = src.device

    def scalar(x, dtype):
        return torch.tensor(x, dtype=dtype, device=dev)

    loads = torch.zeros(n_nodes, dtype=torch.int32, device=dev)
    seed_density = (np.float32(seed_ne) / np.float32(seed_nv)
                    if seed_nv > 0 else np.float32(0.0))
    best_density = scalar(float(seed_density), torch.float32)
    best_ne = scalar(seed_ne, torch.int32)
    best_nv = scalar(seed_nv, torch.int32)
    best_mask = torch.tensor(np.asarray(seed_mask, dtype=bool), device=dev)
    passes = scalar(seed_passes, torch.int32)
    n_edges = scalar(n_edges, torch.int32)

    history: list[RoundRecord] = []
    dual_num = dual_den = None
    cert = None
    rounds = 0
    for t in range(1, int(max_rounds) + 1):
        (loads, best_density, best_ne, best_nv, best_mask,
         passes) = _refine_round(
            src, dst, deg, n_edges, loads, best_density, best_ne, best_nv,
            best_mask, passes, n_nodes, eps, kernel, mesh)
        rounds = t
        # host guard: the device best-tracking compares f32 densities; fold
        # the seed back in exactly so refined >= seed always holds
        b_ne, b_nv = max_fraction((best_ne.item(), best_nv.item()),
                                  (seed_ne, seed_nv))
        num, den = dual_fraction(loads.cpu().numpy(), t)
        if dual_num is None or better_fraction(num, den, dual_num, dual_den):
            dual_num, dual_den = num, den
        cert = make_certificate(b_ne, b_nv, dual_num, dual_den)
        history.append(RoundRecord(
            round=t, density=cert.density, dual_bound=cert.dual_bound,
            gap=cert.gap, rel_gap=cert.rel_gap, passes=passes.item()))
        if cert.rel_gap <= target_gap:
            break

    if cert.best_ne == seed_ne and cert.best_nv == seed_nv:
        mask_full = np.asarray(seed_mask, dtype=bool).copy()
    else:
        mask_full = best_mask.cpu().numpy()
    return cert, mask_full, passes.item(), rounds, history


def refine(
    graph: Graph,
    target_gap: float = DEFAULT_TARGET_GAP,
    max_rounds: int = 64,
    eps: float = 0.0,
    pruned: bool = False,
    seed: tuple[float, np.ndarray, int] | None = None,
    kernel: bool | None = None,
    device: torch.device | str | None = None,
) -> RefineResult:
    """Refine a static graph's densest-subgraph estimate toward rho*(G).

    ``seed`` is an optional (density, mask, passes) triple from a previous
    peel; by default the eps-approximate ``pbahmani`` peel (``pruned=True``
    routes the seed through the candidate-pruned path). The result's
    ``density`` is certified within ``rel_gap`` of the optimum and is never
    below the seed's (exact-rational guard, not a float comparison).
    ``device`` and ``kernel`` resolve as in ``pbahmani``; with K2 the lanes
    are the cached dst-sorted view, and the certificates are the same.
    """
    device = resolve_device(device)
    kernel = resolve_kernel(kernel, device)
    n = graph.n_nodes
    # the JAX kernel tier's f32 sums are exact only below 2^24: both
    # packages refuse the same graphs here
    assert_exact_envelope(graph.n_directed, n)
    if n == 0 or graph.n_edges == 0:
        cert = make_certificate(0, 0, 0, 1)
        return RefineResult(
            density=0.0, mask=np.zeros(n, dtype=bool), dual_bound=0.0,
            gap=0.0, rel_gap=0.0, rounds=0, passes=0, proved_optimal=True,
            converged=True, seed_density=0.0, certificate=cert, history=[])
    if seed is None:
        from repro_torch.core.pbahmani import pbahmani

        seed = pbahmani(graph, eps=eps, pruned=pruned, kernel=kernel, device=device)
    seed_density, seed_mask, seed_passes = seed
    seed_mask = np.asarray(seed_mask, dtype=bool)
    half = graph.n_directed // 2
    seed_ne, seed_nv = _seed_counts(
        seed_mask, graph.src[:half], graph.dst[:half])

    src, dst = to_device(graph, device, sorted=kernel)
    deg = torch.from_numpy(graph.degrees().astype(np.int32)).to(device)
    cert, mask_full, passes, rounds, history = refine_resident(
        src, dst, deg, graph.n_edges, n, float(eps),
        seed_ne, seed_nv, seed_mask, int(seed_passes),
        float(target_gap), int(max_rounds), kernel,
    )
    return RefineResult(
        density=cert.density, mask=mask_full[:n], dual_bound=cert.dual_bound,
        gap=cert.gap, rel_gap=cert.rel_gap, rounds=rounds, passes=passes,
        proved_optimal=cert.proves_optimal,
        converged=cert.rel_gap <= target_gap,
        # exact f64 fraction (the f32 seed value can sit an ulp above it)
        seed_density=seed_ne / seed_nv if seed_nv else 0.0,
        certificate=cert, history=history)


__all__ = [
    "DEFAULT_TARGET_GAP",
    "RoundRecord",
    "RefineResult",
    "refine",
    "refine_resident",
]
