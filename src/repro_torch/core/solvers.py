"""Solver registry: every planning algorithm as a uniform, pluggable callable.

The paper contributes a *portfolio* — six polynomial heuristics (H1-H6), DP
baselines, and exact solvers — over the antagonist period/latency criteria.
This module makes that portfolio a first-class, extensible surface: each
algorithm is registered under a stable name with a :class:`SolverSpec`
describing its capabilities, and the planner (:mod:`repro.core.planner`)
selects applicable solvers per :class:`~repro.core.planner.PlanRequest`
instead of hardcoding the list.  Later criteria (energy, reliability),
replicated stages, or heterogeneous-comm solvers plug in with a decorator:

    @register_solver("my-solver", optimizes="period", description="...")
    def _solve_mine(workload, platform, objective):
        return mapping_or_None

A solver callable takes ``(workload, platform, objective)`` and returns
``None`` (no solution), a :class:`~repro.core.metrics.Mapping`, or a
:class:`Solution` (which may carry processor *groups* for replicated/deal
stages and pre-computed metrics).  ``objective.bound`` — when set — is the
constraint on the criterion the solver does *not* optimize.

The port's own copy of ``repro.core.solvers``, with the twelve ungrouped
solvers in the reference's registration order and with its metadata.  The
grouped ones (the deal and replication extensions) are not ported yet.
:func:`solve` takes ``device=None`` (CUDA): the heuristics' split scoring
runs there, read from the :func:`~repro_torch.core.heuristics.scoring_device`
block it opens, so a solver keeps the three-argument signature.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence

from .exact import (dp_homogeneous_period, dp_speed_ordered, exact_min_latency,
                    exact_min_period)
from .exact import brute_force as _brute_force
from .heuristics import NAMES, ScoringDeviceError, run_heuristic, scoring_device
from .metrics import Mapping, evaluate, single_processor_mapping
from .platform import Platform
from .workload import Workload


@dataclasses.dataclass(frozen=True)
class Solution:
    """What a solver hands back: a mapping, optionally processor groups per
    interval (deal/replication extension) and pre-computed metrics.  Metrics
    left as None are filled in by the portfolio runner (vectorized)."""

    mapping: Mapping
    groups: Optional[tuple] = None       # tuple[tuple[int, ...], ...] or None
    period: Optional[float] = None
    latency: Optional[float] = None
    reliability: Optional[float] = None  # sequel's third criterion (replication)


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Capability metadata for a registered solver."""

    name: str
    fn: Callable
    optimizes: str = "both"              # "period" | "latency" | "both"
    needs_bound: bool = False            # meaningful only with objective.bound
    max_p: Optional[int] = None          # exponential solvers: processor ceiling
    supports_groups: bool = False        # may return grouped (deal) solutions
    auto: bool = True                    # part of the default portfolio
    predicate: Optional[Callable] = None  # extra (workload, platform) -> bool
    description: str = ""


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One row of a PlanReport's provenance table: what a solver produced for
    an objective, with metrics, feasibility, and wall time."""

    solver: str
    objective: "object"                  # the Objective this run targeted
    mapping: Optional[Mapping]
    period: float
    latency: float
    feasible: bool
    wall_time: float                     # seconds spent inside the solver
    groups: Optional[tuple] = None
    error: Optional[str] = None
    reliability: Optional[float] = None  # third criterion; None = not evaluated

    @property
    def point(self) -> tuple:
        return (self.period, self.latency)

    @property
    def point_tri(self) -> tuple:
        """(period, latency, reliability); an unevaluated reliability reads
        as 1.0 (no failure model = perfectly reliable)."""
        return (self.period, self.latency,
                self.reliability if self.reliability is not None else 1.0)


_REGISTRY: "dict[str, SolverSpec]" = {}


def register_solver(
    name: str,
    *,
    optimizes: str = "both",
    needs_bound: bool = False,
    max_p: Optional[int] = None,
    supports_groups: bool = False,
    auto: bool = True,
    predicate: Optional[Callable] = None,
    description: str = "",
) -> Callable:
    """Decorator: register ``fn`` as solver ``name`` with capability metadata.

    Registration order is preserved and is the deterministic tie-break order
    of the planner's selection policies."""
    if optimizes not in ("period", "latency", "both"):
        raise ValueError(f"optimizes must be period|latency|both, got {optimizes!r}")

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"solver {name!r} already registered")
        _REGISTRY[name] = SolverSpec(
            name=name, fn=fn, optimizes=optimizes, needs_bound=needs_bound,
            max_p=max_p, supports_groups=supports_groups, auto=auto,
            predicate=predicate, description=description,
        )
        return fn

    return deco


def get_solver(name: str) -> SolverSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown solver {name!r}; registered: {sorted(_REGISTRY)}") from None


def solver_names() -> list:
    return list(_REGISTRY)


def registered_solvers() -> tuple:
    """All SolverSpecs in registration order."""
    return tuple(_REGISTRY.values())


def applicable(
    spec: SolverSpec,
    workload: Workload,
    platform: Platform,
    objective,
    *,
    exact_max_p: Optional[int] = None,
    allow_groups: bool = False,
) -> bool:
    """Can ``spec`` serve ``objective`` on this instance within the size budget?"""
    if spec.optimizes not in ("both", objective.minimize):
        return False
    if spec.max_p is not None:
        cap = spec.max_p if exact_max_p is None else min(spec.max_p, exact_max_p)
        if platform.p > cap:
            return False
    if spec.supports_groups and not allow_groups:
        return False
    if spec.predicate is not None and not spec.predicate(workload, platform):
        return False
    return True


def _bound(objective) -> float:
    return objective.bound if objective.bound is not None else math.inf


def normalize_output(out) -> Optional[Solution]:
    """Coerce a solver's return value (None | Mapping | Solution) to Solution."""
    if out is None:
        return None
    if isinstance(out, Solution):
        return out
    if isinstance(out, Mapping):
        return Solution(mapping=out)
    raise TypeError(f"solver returned {type(out).__name__}, expected Mapping/Solution/None")


def solve(
    name: str,
    workload: Workload,
    platform: Platform,
    objective,
    *,
    exact_max_p: Optional[int] = None,
    device=None,
) -> Candidate:
    """Run one registered solver, timed, and return its provenance Candidate.

    Infeasibility (no mapping, a violated bound) or a solver exception is
    reported in the candidate rather than raised — portfolio runs must not die
    because one member did.  Split scoring runs on ``device`` (``None``:
    CUDA, raising without a card); its failure on the card raises
    :class:`~repro_torch.core.heuristics.ScoringDeviceError`.
    """
    spec = get_solver(name)
    with scoring_device(device):
        if not applicable(spec, workload, platform, objective,
                          exact_max_p=exact_max_p, allow_groups=True):
            return Candidate(name, objective, None, math.inf, math.inf, False, 0.0,
                             error="not applicable")
        t0 = time.perf_counter()
        try:
            sol = normalize_output(spec.fn(workload, platform, objective))
        except ScoringDeviceError:
            raise                    # the card failed, not the solver
        except Exception as ex:  # noqa: BLE001 — portfolio members must not kill the run
            return Candidate(name, objective, None, math.inf, math.inf, False,
                             time.perf_counter() - t0, error=f"{type(ex).__name__}: {ex}")
    wall = time.perf_counter() - t0
    if sol is None:
        return Candidate(name, objective, None, math.inf, math.inf, False, wall)
    per, lat = sol.period, sol.latency
    if per is None or lat is None:
        per, lat = evaluate(workload, platform, sol.mapping)
    return Candidate(name, objective, sol.mapping, float(per), float(lat),
                     meets_bound(objective, float(per), float(lat)), wall,
                     groups=sol.groups, reliability=sol.reliability)


def meets_bound(objective, per: float, lat: float) -> bool:
    """The paper's feasibility rule: the non-minimized criterion must respect
    the bound (unbounded objectives are always feasible for finite metrics)."""
    if not (math.isfinite(per) and math.isfinite(lat)):
        return False
    if objective.bound is None:
        return True
    other = per if objective.minimize == "latency" else lat
    return other <= objective.bound + 1e-12


# ---------------------------------------------------------------------------
# Built-in solvers: the paper portfolio as registry entries
# ---------------------------------------------------------------------------

@register_solver("single", optimizes="both",
                 description="whole chain on the fastest processor (Lemma 1: latency-optimal)")
def _solve_single(workload, platform, objective):
    return single_processor_mapping(workload, platform.fastest())


def _heuristic_solver(code: str):
    def fn(workload, platform, objective):
        res = run_heuristic(code, workload, platform, _bound(objective))
        return res.mapping  # best-effort even when its own bound check failed
    fn.__name__ = f"_solve_{code.lower()}"
    return fn


for _code in ("H1", "H2", "H3", "H4"):
    register_solver(
        _code, optimizes="latency", needs_bound=True,
        description=f"paper heuristic {NAMES[_code]}: min latency s.t. period <= bound",
    )(_heuristic_solver(_code))

for _code in ("H5", "H6"):
    register_solver(
        _code, optimizes="period", needs_bound=True,
        description=f"paper heuristic {NAMES[_code]}: min period s.t. latency <= bound",
    )(_heuristic_solver(_code))


@register_solver("dp-speed-ordered", optimizes="period",
                 description="polynomial DP, exact under speed-ordered assignment")
def _solve_dp_speed_ordered(workload, platform, objective):
    return dp_speed_ordered(workload, platform, latency_cap=_bound(objective))


@register_solver("dp-homogeneous", optimizes="period", auto=False,
                 predicate=lambda wl, pf: bool((pf.s == pf.s[0]).all()),
                 description="exact O(n^2 p) DP for identical processor speeds")
def _solve_dp_homogeneous(workload, platform, objective):
    per, intervals = dp_homogeneous_period(workload, platform.p,
                                           float(platform.s[0]), platform.b)
    return Mapping(intervals, tuple(range(len(intervals))))


@register_solver("exact", optimizes="period", max_p=14,
                 description="exact min period (binary search + bitmask DP), exp. in p")
def _solve_exact(workload, platform, objective):
    return exact_min_period(workload, platform, latency_cap=_bound(objective))


@register_solver("exact-latency", optimizes="latency", max_p=14,
                 description="exact min latency s.t. period <= bound (bitmask DP), exp. in p")
def _solve_exact_latency(workload, platform, objective):
    if objective.bound is None:
        # Lemma 1: the unbounded optimum is the whole chain on the fastest
        # processor — skip the exponential DP.
        return single_processor_mapping(workload, platform.fastest())
    return exact_min_latency(workload, platform, period_cap=objective.bound)


@register_solver("brute-force", optimizes="both", max_p=6, auto=False,
                 predicate=lambda wl, pf: wl.n <= 10,
                 description="full enumeration ground truth (tiny instances only)")
def _solve_brute_force(workload, platform, objective):
    per_cap = _bound(objective) if objective.minimize == "latency" else math.inf
    lat_cap = _bound(objective) if objective.minimize == "period" else math.inf
    return _brute_force(workload, platform, period_cap=per_cap,
                        latency_cap=lat_cap, objective=objective.minimize)

# The reference's deal/replication extension registers seven grouped solvers
# from repro.core.deal and repro.core.replication; the port has not ported
# them yet.
