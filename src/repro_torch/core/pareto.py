"""Bi-criteria sweeps: trace (period, latency) trade-off curves with the
registered bounded solvers, and compute Pareto fronts.

The port's own copy of ``repro.core.pareto``.  The fronts and grids are
numpy on the host; the sweeps run heuristics and solvers, whose split
scoring runs on ``device`` (``None`` means CUDA, see
:func:`repro_torch.core.heuristics.scoring_device`)."""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from .heuristics import run_heuristic, scoring_device
from .platform import Platform
from .workload import Workload


def pareto_front(points: Iterable, rtol: float = 1e-9) -> list:
    """Non-dominated subset of (period, latency) points, sorted by period.
    Points whose coordinates differ by less than ``rtol`` (relative) are
    considered equal, so floating-point noise cannot leak dominated points."""
    pts = sorted(set((float(a), float(b)) for a, b in points))
    front = []
    best_lat = float("inf")
    for per, lat in pts:
        if lat < best_lat * (1 - rtol):
            # drop a predecessor with (numerically) equal period but worse latency
            while front and per <= front[-1][0] * (1 + rtol) and lat < front[-1][1]:
                front.pop()
            front.append((per, lat))
            best_lat = lat
    return front


def pareto_front_tri(points: Iterable, rtol: float = 1e-9) -> list:
    """Non-dominated subset of (period, latency, reliability) points.

    Period and latency are minimized, reliability is MAXIMIZED (the sequel's
    third criterion).  Point a dominates b when a is no worse on all three
    coordinates (within relative tolerance ``rtol``, so floating-point noise
    cannot leak dominated points) — equal-within-tolerance duplicates
    collapse onto the first in sort order.  Returned sorted by (period,
    latency, -reliability).  O(k^2), fine for portfolio-sized fronts."""
    pts = sorted(set((float(p), float(l), float(r)) for p, l, r in points),
                 key=lambda t: (t[0], t[1], -t[2]))
    front: list = []

    def dominates(a, b):
        return (a[0] <= b[0] * (1 + rtol) and a[1] <= b[1] * (1 + rtol)
                and a[2] >= b[2] * (1 - rtol))

    for cand in pts:
        if any(dominates(f, cand) for f in front):
            continue
        front = [f for f in front if not dominates(cand, f)]
        front.append(cand)
    front.sort(key=lambda t: (t[0], t[1], -t[2]))
    return front


def sweep_heuristic(
    code: str,
    workload: Workload,
    platform: Platform,
    bounds: Sequence[float],
    device=None,
) -> list:
    """Run heuristic ``code`` for every bound; return list of HeuristicResult."""
    with scoring_device(device):
        return [run_heuristic(code, workload, platform, float(b)) for b in bounds]


def sweep_solver(
    name: str,
    workload: Workload,
    platform: Platform,
    bounds: Sequence[float],
    device=None,
) -> list:
    """Registry-level sweep: run a bounded solver for every bound, returning
    one provenance :class:`~repro_torch.core.solvers.Candidate` per bound."""
    from .planner import Objective
    from .solvers import get_solver, solve

    spec = get_solver(name)
    minimize = "latency" if spec.optimizes == "latency" else "period"
    with scoring_device(device) as dev:
        return [solve(name, workload, platform, Objective(minimize, bound=float(b)),
                      device=dev)
                for b in bounds]


def default_period_grid(workload: Workload, platform: Platform, k: int = 20) -> np.ndarray:
    """Geometric grid of fixed-period bounds between the best single-processor
    cycle / p and the single-processor period."""
    from .metrics import period, single_processor_mapping

    hi = period(workload, platform, single_processor_mapping(workload, platform.fastest()))
    lo = max(hi / (2 * platform.p), 1e-9)
    return np.geomspace(lo, hi, k)


def default_latency_grid(workload: Workload, platform: Platform, k: int = 20) -> np.ndarray:
    from .metrics import optimal_latency

    lo = optimal_latency(workload, platform)
    hi = lo * 5.0
    return np.linspace(lo, hi, k)


def tradeoff_curves(workload: Workload, platform: Platform, k: int = 20,
                    device=None) -> dict:
    """For each registered bounded solver, the list of achieved feasible
    (period, latency) points over a grid of bounds (the paper's Figures 2-7
    are averages of these across random instances)."""
    from .solvers import registered_solvers

    out = {}
    pgrid = default_period_grid(workload, platform, k)
    lgrid = default_latency_grid(workload, platform, k)
    with scoring_device(device) as dev:
        for spec in registered_solvers():
            if not spec.needs_bound:
                continue
            grid = pgrid if spec.optimizes == "latency" else lgrid
            res = sweep_solver(spec.name, workload, platform, grid, device=dev)
            out[spec.name] = [(c.period, c.latency) for c in res if c.feasible]
    return out
