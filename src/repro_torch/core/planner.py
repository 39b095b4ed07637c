"""Planning API: PlanRequest -> PlanReport over the solver registry.

The paper's portfolio of bi-criteria algorithms (heuristics H1-H6, DP
baselines, exact solvers) is exposed through a single request/report
protocol:

    report = plan_request(PlanRequest(workload, platform, Objective("period")))
    report.plan          # chosen StagePlan, ready for the runtime
    report.candidates    # full provenance: every applicable solver's
                         # (period, latency, feasible, wall_time)
    report.pareto        # non-dominated (period, latency) points

Solvers come from :mod:`repro.core.solvers` and are filtered per request by
capability metadata (objective direction, size budgets, group support) plus
explicit include/exclude lists.  Candidate metrics are evaluated in one
vectorized batch (:func:`repro.core.metrics.evaluate_batch`).  Selection is a
pluggable policy (``@register_selection``); the default ``"lexicographic"``
policy reproduces the historical ``plan()`` behavior, which remains as a thin
facade.  ``plan_pareto`` sweeps bounded solvers over bound grids and reports
the achieved Pareto front with a knee-point default selection.

The port's own copy of ``repro.core.planner``.  Every entry point that runs
solvers takes ``device=None`` (CUDA, raising without a card) and runs them
inside a :func:`~repro_torch.core.heuristics.scoring_device` block, so the
heuristics score their splits there; selection, evaluation and the fronts
are numpy on the host, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np

from .exact import exact_min_latency, exact_min_period
from .heuristics import (FIXED_LATENCY_HEURISTICS, FIXED_PERIOD_HEURISTICS,
                         ScoringDeviceError, run_heuristic, scoring_device)
from .metrics import Mapping, evaluate, evaluate_batch
from .pareto import (default_latency_grid, default_period_grid, pareto_front)
from .platform import Platform
from .solvers import (Candidate, applicable, get_solver, meets_bound,
                      normalize_output, registered_solvers)
from .workload import Workload


@dataclasses.dataclass(frozen=True)
class Objective:
    """Bi-criteria objective: minimize ``minimize`` subject to the other
    criterion being <= ``bound`` (bound=None -> unconstrained)."""

    minimize: str                 # "latency" | "period"
    bound: Optional[float] = None

    def __post_init__(self):
        if self.minimize not in ("latency", "period"):
            raise ValueError(self.minimize)


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """A planned pipeline mapping, ready for the runtime."""

    mapping: Mapping
    period: float
    latency: float
    planner: str                  # which algorithm produced it
    # Runtime realization data:
    stage_sizes: tuple            # layers per stage, chain order
    max_stage_size: int           # padded stage depth for the stacked runtime
    padding_overhead: float       # wasted fraction of padded compute slots
    # Deal/replication extension: processor group per interval.  None for the
    # common single-processor-per-interval plans; when set, period/latency
    # above are the *grouped* metrics and alloc holds each group's leader.
    groups: Optional[tuple] = None

    @property
    def num_stages(self) -> int:
        return len(self.stage_sizes)


class InfeasiblePlan(RuntimeError):
    pass


def _realize(mapping: Mapping, per: float, lat: float, name: str,
             groups: Optional[tuple] = None) -> StagePlan:
    sizes = tuple(e - d + 1 for d, e in mapping.intervals)
    mx = max(sizes)
    total_slots = mx * len(sizes)
    pad = 1.0 - sum(sizes) / total_slots
    return StagePlan(mapping, per, lat, name, sizes, mx, pad, groups)


# ---------------------------------------------------------------------------
# Request / report
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """What to plan: the instance, one or more objectives, solver filters,
    and budgets.

    - ``objectives``: tuple of :class:`Objective` (a bare Objective is
      accepted).  The first is primary; every bound is enforced at selection.
    - ``include``: explicit solver-name allowlist (overrides the specs'
      ``auto`` flag); ``exclude`` removes names from whatever is selected.
    - ``exact_max_p``: size budget for exponential solvers (caps their
      ``max_p``).
    - ``time_budget``: wall-clock seconds; solvers past the deadline are
      recorded as skipped candidates instead of running.
    - ``allow_groups``: admit solvers that replicate intervals over processor
      groups (the deal extension).
    - ``selection``: policy name from :data:`SELECTION_POLICIES` or a callable
      ``(candidates, request) -> Optional[Candidate]``.
    """

    workload: Workload
    platform: Platform
    objectives: tuple
    include: Optional[tuple] = None
    exclude: tuple = ()
    exact_max_p: int = 12
    time_budget: Optional[float] = None
    allow_groups: bool = False
    selection: object = "lexicographic"

    def __post_init__(self):
        objs = self.objectives
        if isinstance(objs, Objective):
            objs = (objs,)
        objs = tuple(objs)
        if not objs:
            raise ValueError("PlanRequest needs at least one objective")
        object.__setattr__(self, "objectives", objs)
        if self.include is not None:
            object.__setattr__(self, "include", tuple(self.include))
            for nm in self.include:
                get_solver(nm)
        object.__setattr__(self, "exclude", tuple(self.exclude))
        for nm in self.exclude:
            get_solver(nm)
        if not callable(self.selection) and self.selection not in SELECTION_POLICIES:
            raise KeyError(f"unknown selection policy {self.selection!r}; "
                           f"registered: {sorted(SELECTION_POLICIES)}")

    @property
    def objective(self) -> Objective:
        """The primary objective."""
        return self.objectives[0]

    def solver_specs(self, objective: Objective) -> list:
        """Applicable solvers for ``objective``, in registration order."""
        out = []
        for spec in registered_solvers():
            if self.include is not None:
                if spec.name not in self.include:
                    continue
            elif not spec.auto:
                continue
            if spec.name in self.exclude:
                continue
            if not applicable(spec, self.workload, self.platform, objective,
                              exact_max_p=self.exact_max_p,
                              allow_groups=self.allow_groups):
                continue
            out.append(spec)
        return out


@dataclasses.dataclass(frozen=True)
class PlanReport:
    """The full outcome of a plan request: the chosen plan, the candidate
    provenance table, and the achieved Pareto front."""

    request: PlanRequest
    plan: Optional[StagePlan]      # None when nothing feasible was found
    chosen: Optional[Candidate]
    candidates: tuple              # tuple[Candidate, ...], run order
    pareto: tuple                  # non-dominated feasible (period, latency)
    wall_time: float

    @property
    def feasible(self) -> bool:
        return self.plan is not None

    def best(self, objective: Optional[Objective] = None) -> Optional[Candidate]:
        """Best candidate for ``objective`` (default: the primary one) under
        the lexicographic rule."""
        objective = objective or self.request.objective
        req = dataclasses.replace(self.request, objectives=(objective,))
        return select_lexicographic(list(self.candidates), req)

    def summary(self) -> str:
        """Human-readable provenance table."""
        lines = [f"{'solver':<18} {'objective':<22} {'period':>12} {'latency':>12} "
                 f"{'feasible':>8} {'wall_ms':>8}"]
        for c in self.candidates:
            obj = c.objective.minimize + (
                "" if c.objective.bound is None else f"|bound={c.objective.bound:.4g}")
            per = f"{c.period:.6g}" if math.isfinite(c.period) else "-"
            lat = f"{c.latency:.6g}" if math.isfinite(c.latency) else "-"
            mark = " <== chosen" if self.chosen is c else (
                f"  ({c.error})" if c.error else "")
            lines.append(f"{c.solver:<18} {obj:<22} {per:>12} {lat:>12} "
                         f"{str(c.feasible):>8} {c.wall_time*1e3:>8.2f}{mark}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Selection policies (pluggable)
# ---------------------------------------------------------------------------

SELECTION_POLICIES: "dict[str, Callable]" = {}


def register_selection(name: str) -> Callable:
    """Decorator: register a selection policy ``(candidates, request) ->
    Optional[Candidate]`` under ``name``."""
    def deco(fn: Callable) -> Callable:
        SELECTION_POLICIES[name] = fn
        return fn
    return deco


def _admissible(c: Candidate, request: PlanRequest) -> bool:
    return c.mapping is not None and all(
        meets_bound(o, c.period, c.latency) for o in request.objectives)


@register_selection("lexicographic")
def select_lexicographic(candidates, request) -> Optional[Candidate]:
    """Minimize the primary criterion, tie-break on the other, then on solver
    run order — the historical ``plan(mode="auto")`` rule.  Every objective's
    bound is enforced."""
    primary = request.objective
    best, best_key = None, None
    for c in candidates:
        if not _admissible(c, request):
            continue
        key = ((c.latency, c.period) if primary.minimize == "latency"
               else (c.period, c.latency))
        if best_key is None or key < best_key:
            best, best_key = c, key
    return best


@register_selection("min-period")
def select_min_period(candidates, request) -> Optional[Candidate]:
    """Minimize period; the request's original bounds stay enforced."""
    req = dataclasses.replace(
        request, objectives=(Objective("period"),) + tuple(request.objectives))
    return select_lexicographic(candidates, req)


@register_selection("min-latency")
def select_min_latency(candidates, request) -> Optional[Candidate]:
    """Minimize latency; the request's original bounds stay enforced."""
    req = dataclasses.replace(
        request, objectives=(Objective("latency"),) + tuple(request.objectives))
    return select_lexicographic(candidates, req)


@register_selection("knee")
def select_knee(candidates, request) -> Optional[Candidate]:
    """Balanced trade-off: the admissible candidate closest (L2, normalized
    per criterion over the admissible set) to the ideal point."""
    feas = [c for c in candidates if _admissible(c, request)]
    if not feas:
        return None
    pers = np.array([c.period for c in feas])
    lats = np.array([c.latency for c in feas])
    pr = max(pers.max() - pers.min(), 1e-30)
    lr = max(lats.max() - lats.min(), 1e-30)
    score = np.hypot((pers - pers.min()) / pr, (lats - lats.min()) / lr)
    return feas[int(np.argmin(score))]


# ---------------------------------------------------------------------------
# Portfolio execution
# ---------------------------------------------------------------------------

def _run_jobs(workload: Workload, platform: Platform, jobs: list,
              deadline: Optional[float]) -> list:
    """Run (spec, objective) jobs, timed, then evaluate all plain-mapping
    results in one vectorized batch.  Returns the Candidate list in job
    order; a job failure or deadline miss becomes an infeasible candidate
    with its ``error`` set.  Portfolio runs raise only when split scoring
    fails on the card (:class:`ScoringDeviceError`)."""
    rows = []
    for spec, obj in jobs:
        if deadline is not None and time.perf_counter() > deadline:
            rows.append((spec, obj, None, 0.0, "skipped: time budget exhausted"))
            continue
        t0 = time.perf_counter()
        try:
            sol = normalize_output(spec.fn(workload, platform, obj))
            err = None
        except ScoringDeviceError:
            raise                    # the card failed, not the solver
        except Exception as ex:  # noqa: BLE001 — one member must not kill the run
            sol, err = None, f"{type(ex).__name__}: {ex}"
        rows.append((spec, obj, sol, time.perf_counter() - t0, err))

    need = [i for i, (_, _, sol, _, _) in enumerate(rows)
            if sol is not None and (sol.period is None or sol.latency is None)]
    if need:
        mets = evaluate_batch(workload, platform, [rows[i][2].mapping for i in need])
        met_at = {i: j for j, i in enumerate(need)}

    cands = []
    for i, (spec, obj, sol, wall, err) in enumerate(rows):
        if sol is None:
            cands.append(Candidate(spec.name, obj, None, math.inf, math.inf,
                                   False, wall, error=err))
            continue
        if sol.period is not None and sol.latency is not None:
            per, lat = float(sol.period), float(sol.latency)
        else:
            per, lat = (float(v) for v in mets[met_at[i]])
        cands.append(Candidate(spec.name, obj, sol.mapping, per, lat,
                               meets_bound(obj, per, lat), wall, groups=sol.groups,
                               reliability=sol.reliability))
    return cands


def _finish(request: PlanRequest, cands: list, t0: float) -> PlanReport:
    feas_pts = [c.point for c in cands if c.feasible]
    front = tuple(pareto_front(feas_pts)) if feas_pts else ()
    policy = (request.selection if callable(request.selection)
              else SELECTION_POLICIES[request.selection])
    chosen = policy(cands, request)
    plan = (_realize(chosen.mapping, chosen.period, chosen.latency, chosen.solver,
                     groups=chosen.groups)
            if chosen is not None else None)
    return PlanReport(request, plan, chosen, tuple(cands), front,
                      time.perf_counter() - t0)


def plan_request(request: PlanRequest, device=None) -> PlanReport:
    """Run the applicable solver portfolio for ``request`` and report the
    chosen plan with full per-solver provenance.  Never raises on
    infeasibility — check ``report.feasible`` (the ``plan()`` facade raises
    :class:`InfeasiblePlan` for back-compat).  Split scoring runs on
    ``device`` (``None``: CUDA)."""
    with scoring_device(device):
        t0 = time.perf_counter()
        deadline = None if request.time_budget is None else t0 + request.time_budget
        jobs = [(spec, obj) for obj in request.objectives
                for spec in request.solver_specs(obj)]
        cands = _run_jobs(request.workload, request.platform, jobs, deadline)
        return _finish(request, cands, t0)


def plan_pareto(
    workload: Workload,
    platform: Platform,
    *,
    k: int = 20,
    include: Optional[tuple] = None,
    exclude: tuple = (),
    exact_max_p: int = 12,
    time_budget: Optional[float] = None,
    selection: object = "knee",
    device=None,
) -> PlanReport:
    """Pareto-first planning: sweep every applicable bounded solver over a
    ``k``-point bound grid (period grid for latency-minimizers, latency grid
    for period-minimizers), run unbounded solvers once per direction, and
    report the achieved (period, latency) front.  ``selection`` — a policy
    name or callable — picks the returned plan from the candidates (default:
    the knee of the trade-off).  Split scoring runs on ``device`` (``None``:
    CUDA)."""
    with scoring_device(device):
        return _plan_pareto(workload, platform, k, include, exclude, exact_max_p,
                            time_budget, selection)


def _plan_pareto(workload, platform, k, include, exclude, exact_max_p,
                 time_budget, selection) -> PlanReport:
    request = PlanRequest(
        workload, platform, (Objective("period"), Objective("latency")),
        include=include, exclude=exclude, exact_max_p=exact_max_p,
        time_budget=time_budget, selection=selection,
    )
    t0 = time.perf_counter()
    deadline = None if time_budget is None else t0 + time_budget
    pgrid = default_period_grid(workload, platform, k)
    lgrid = default_latency_grid(workload, platform, k)
    jobs = []
    seen = set()
    for obj in request.objectives:
        for spec in request.solver_specs(obj):
            if spec.needs_bound:
                grid = pgrid if obj.minimize == "latency" else lgrid
                jobs.extend((spec, Objective(obj.minimize, bound=float(bd)))
                            for bd in grid)
            elif spec.name not in seen:
                # direction-specific solvers appear for exactly one objective;
                # "both" solvers (e.g. single) would otherwise run twice.
                seen.add(spec.name)
                jobs.append((spec, obj))
    cands = _run_jobs(workload, platform, jobs, deadline)
    return _finish(request, cands, t0)


# ---------------------------------------------------------------------------
# Back-compat facades
# ---------------------------------------------------------------------------

# The historical plan(mode="auto") portfolio per objective direction.
AUTO_PORTFOLIO = {
    "latency": ("single", "H1", "H2", "H3", "H4"),
    "period": ("single", "H5", "H6", "dp-speed-ordered", "exact"),
}


def auto_request(workload: Workload, platform: Platform, objective: Objective,
                 exact_max_p: int = 12) -> PlanRequest:
    """The PlanRequest equivalent of the historical ``plan(mode="auto")``."""
    return PlanRequest(workload, platform, (objective,),
                       include=AUTO_PORTFOLIO[objective.minimize],
                       exact_max_p=exact_max_p)


def plan(
    workload: Workload,
    platform: Platform,
    objective: Objective,
    mode: str = "auto",
    exact_max_p: int = 12,
    device=None,
) -> StagePlan:
    """Compute a stage plan (thin facade over :func:`plan_request`).

    mode:
      - one of "H1".."H6": the corresponding paper heuristic (bound required);
      - "auto": portfolio — all applicable heuristics + DP baselines (+ exact
        when p is small), best feasible result wins;
      - "exact": exact solver (exponential in p; raises if p > exact_max_p).
        Routes period objectives to exact_min_period and latency objectives
        to exact_min_latency.

    Split scoring runs on ``device`` (``None``: CUDA, raising without a
    card, whatever the mode).
    """
    with scoring_device(device):
        return _plan(workload, platform, objective, mode, exact_max_p)


def _plan(workload, platform, objective, mode, exact_max_p) -> StagePlan:
    if mode in FIXED_PERIOD_HEURISTICS or mode in FIXED_LATENCY_HEURISTICS:
        if objective.bound is None:
            raise ValueError("paper heuristics need a bound")
        res = run_heuristic(mode, workload, platform, objective.bound)
        if not res.feasible or res.mapping is None:
            raise InfeasiblePlan(f"{mode} found no feasible mapping for {objective}")
        return _realize(res.mapping, res.period, res.latency, mode)

    if mode == "exact":
        if platform.p > exact_max_p:
            raise ValueError(f"exact solver limited to p <= {exact_max_p}")
        cap = objective.bound if objective.bound is not None else math.inf
        if objective.minimize == "period":
            mp, name = exact_min_period(workload, platform, latency_cap=cap), "exact"
        else:
            mp, name = exact_min_latency(workload, platform, period_cap=cap), "exact-latency"
        if mp is None:
            raise InfeasiblePlan("exact: infeasible")
        per, lat = evaluate(workload, platform, mp)
        return _realize(mp, per, lat, name)

    if mode != "auto":
        raise KeyError(mode)

    report = plan_request(auto_request(workload, platform, objective, exact_max_p))
    if report.plan is None:
        raise InfeasiblePlan(f"no planner produced a feasible mapping for {objective}")
    return dataclasses.replace(report.plan, planner=f"auto({report.chosen.solver})")


def replan_for_straggler(
    workload: Workload,
    platform: Platform,
    current: StagePlan,
    observed_stage_times: np.ndarray,
    slowdown_threshold: float = 1.3,
    device=None,
) -> tuple:
    """Straggler mitigation: compare observed per-stage step times against the
    plan's predicted cycle times; degrade the effective speed of any processor
    running slower than ``slowdown_threshold`` x predicted; re-plan.

    Returns (new_plan, degraded_platform).  This is exactly the paper's
    heterogeneous-processor scenario arising *online* on homogeneous hardware.
    The re-plan scores its splits on ``device`` (``None``: CUDA).
    """
    from .metrics import interval_cycle_times

    with scoring_device(device):
        predicted = interval_cycle_times(workload, platform, current.mapping)
        observed = np.asarray(observed_stage_times, dtype=float)
        if observed.shape != predicted.shape:
            raise ValueError("one observation per stage required")
        pf = platform
        for j, (obs, pred) in enumerate(zip(observed, predicted)):
            if pred > 0 and obs / pred > slowdown_threshold:
                pf = pf.degrade(current.mapping.alloc[j], obs / pred)
        new = plan(workload, pf, Objective("period", bound=None), mode="auto")
    return new, pf
