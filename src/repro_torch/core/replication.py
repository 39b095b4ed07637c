"""Tri-criteria planning: reliability via interval replication (arXiv 0711.1231).

The sequel to the source paper keeps the interval-mapping structure but lets
each interval run on a *set* of processors under the consensus model: every
replica processes every data set, so the interval's speed is its slowest
replica's and the interval fails only when ALL replicas fail.  This module
contributes:

  - :func:`replicate_greedy` — the greedy replica-assignment pass: repeatedly
    add the fastest unused processor to the reliability-critical interval
    (the one most likely to lose all replicas), as long as the period/latency
    bounds still hold.  A replica at least as fast as the group's slowest
    member costs NOTHING on period/latency — the greedy exploits exactly
    that, which is why it takes the fastest free processor first.
  - ``H1-rel`` .. ``H6-rel`` — replication-aware variants of the paper
    heuristics, registered via ``@register_solver`` with
    ``supports_groups=True`` so they stay out of the bi-criteria default
    portfolio (same mechanism as the deal extension) and join tri-criteria
    requests via ``allow_groups=True``.
  - :func:`plan_pareto_tri` — the tri-criteria analogue of ``plan_pareto``:
    sweep plain + replicated bounded solvers over bound grids, evaluate
    (period, latency, reliability) per candidate, and report the 3-D
    non-dominated front (:func:`repro_torch.core.pareto.pareto_front_tri`).
  - :func:`replicate_stage_plan` — replication pass over an existing
    StagePlan, used by the fleet service's ``reliability_floor`` knob.

Note the semantic contrast with :mod:`repro_torch.core.deal`: a deal group
round-robins tasks (aggregate rate, NO redundancy), a replica group repeats
them (slowest-replica speed, survives member failures).

The port's own copy of ``repro.core.replication``.  The greedy, the
reliability column and the tri-criteria selection are numpy on the host,
as in the reference; the heuristics under the ``-rel`` solvers score their
splits on the device of the enclosing
:func:`~repro_torch.core.heuristics.scoring_device` block, which
:func:`plan_pareto_tri` opens (``device=None``: CUDA, raising without a card).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np

from .heuristics import run_heuristic, scoring_device
from .metrics import Mapping, ReplicatedMapping, evaluate_batch, evaluate_tri
from .pareto import default_latency_grid, default_period_grid, pareto_front_tri
from .planner import (Objective, PlanReport, PlanRequest, StagePlan, _realize,
                      _run_jobs)
from .platform import Platform
from .solvers import Solution, register_solver
from .workload import Workload

_EPS = 1e-12


def replicate_greedy(
    workload: Workload,
    platform: Platform,
    base: Mapping,
    *,
    period_bound: Optional[float] = None,
    latency_bound: Optional[float] = None,
    target: Optional[float] = None,
) -> ReplicatedMapping:
    """Greedily replicate ``base``'s intervals over unused processors.

    Each step adds the FASTEST free processor to the reliability-critical
    interval — the one with the largest probability that all current
    replicas fail (Π f_u).  The step is rejected (and the greedy stops) when
    it would violate ``period_bound``/``latency_bound``; since every later
    free processor is no faster, no later candidate could do better.  Stops
    early once overall reliability reaches ``target`` (when given), when the
    free pool is exhausted, or when every interval is already perfectly
    reliable.  With ``platform.fail`` unset there is nothing to improve and
    the base mapping comes back as singleton replica sets.
    """
    if isinstance(base, ReplicatedMapping):
        intervals, groups = base.intervals, [list(g) for g in base.groups]
    else:
        intervals, groups = base.intervals, [[a] for a in base.alloc]
    w, delta, b, s = workload.w, workload.delta, platform.b, platform.s
    f = platform.failures
    used = {u for g in groups for u in g}
    free = [int(u) for u in platform.sorted_indices() if int(u) not in used]

    iv = np.asarray(intervals, dtype=np.int64)
    D, E = iv[:, 0], iv[:, 1]
    wsum = np.array([w[d - 1:e].sum() for d, e in iv])
    din = delta[D - 1] / b
    dout = delta[E] / b
    tail = delta[workload.n] / b
    smin = np.array([s[g].min() for g in groups])
    miss = np.array([np.prod(f[g]) for g in groups])

    if platform.fail is not None:
        while free:
            if not (miss > 0.0).any():
                break                      # every interval already certain
            if target is not None and float(np.prod(1.0 - miss)) >= target - _EPS:
                break
            j = int(np.argmax(miss))       # reliability-critical interval
            u = free[0]                    # fastest free processor
            new_smin = min(float(smin[j]), float(s[u]))
            sm = smin.copy()
            sm[j] = new_smin
            lat_terms = din + wsum / sm
            per = float((lat_terms + dout).max())
            lat = float(lat_terms.sum() + tail)
            if period_bound is not None and per > period_bound + _EPS:
                break
            if latency_bound is not None and lat > latency_bound + _EPS:
                break
            free.pop(0)
            groups[j].append(u)
            smin[j] = new_smin
            miss[j] *= float(f[u])
    return ReplicatedMapping(intervals=intervals,
                             groups=tuple(tuple(g) for g in groups))


def replicate_stage_plan(
    workload: Workload,
    platform: Platform,
    plan: StagePlan,
    *,
    target: Optional[float] = None,
    period_bound: Optional[float] = None,
    latency_bound: Optional[float] = None,
) -> StagePlan:
    """Replication pass over an existing plan (the fleet's reliability-floor
    repair): greedy replicas on the base mapping, metrics re-evaluated under
    the consensus model, planner name suffixed ``+rel``.  Returns ``plan``
    unchanged when the platform carries no failure probabilities or no
    replica was added."""
    rm = replicate_greedy(workload, platform, plan.mapping, target=target,
                          period_bound=period_bound, latency_bound=latency_bound)
    if all(len(g) == 1 for g in rm.groups):
        return plan
    per, lat, _rel = evaluate_tri(workload, platform, rm)
    out = _realize(rm.leader_mapping(), per, lat,
                   plan.planner if plan.planner.endswith("+rel")
                   else plan.planner + "+rel",
                   groups=rm.groups)
    return out


def _rel_solver(code: str, direction: str):
    def fn(workload, platform, objective):
        res = run_heuristic(code, workload, platform,
                            objective.bound if objective.bound is not None
                            else math.inf)
        if res.mapping is None:
            return None
        kw = ({"period_bound": objective.bound} if direction == "latency"
              else {"latency_bound": objective.bound})
        rm = replicate_greedy(workload, platform, res.mapping, **kw)
        per, lat, rel = evaluate_tri(workload, platform, rm)
        return Solution(mapping=rm.leader_mapping(), groups=rm.groups,
                        period=per, latency=lat, reliability=rel)
    fn.__name__ = f"_solve_{code.lower()}_rel"
    return fn


for _code in ("H1", "H2", "H3", "H4"):
    register_solver(
        f"{_code}-rel", optimizes="latency", needs_bound=True,
        supports_groups=True,
        description=f"{_code} + greedy interval replication: min latency "
                    "s.t. period <= bound, reliability-maximizing replicas",
    )(_rel_solver(_code, "latency"))

for _code in ("H5", "H6"):
    register_solver(
        f"{_code}-rel", optimizes="period", needs_bound=True,
        supports_groups=True,
        description=f"{_code} + greedy interval replication: min period "
                    "s.t. latency <= bound, reliability-maximizing replicas",
    )(_rel_solver(_code, "period"))


def _fill_reliability(workload: Workload, platform: Platform, cands: list) -> list:
    """Candidates from plain bi-criteria solvers carry reliability=None;
    compute it (singleton replica per interval) in one vectorized pass."""
    need = [i for i, c in enumerate(cands)
            if c.mapping is not None and c.reliability is None]
    if not need:
        return cands
    if platform.fail is None:
        rel = np.ones(len(need))
    else:
        rel = evaluate_batch(workload, platform,
                             [cands[i].mapping for i in need],
                             with_reliability=True)[:, 2]
    out = list(cands)
    for j, i in enumerate(need):
        out[i] = dataclasses.replace(out[i], reliability=float(rel[j]))
    return out


def _select_tri(reliability_floor: Optional[float]):
    """Tri-criteria selection: among admissible candidates at/above the
    reliability floor, the knee of the normalized (period, latency,
    unreliability) distance to the ideal point; when nothing reaches the
    floor, the most reliable candidate (tie-break knee) — graceful
    degradation instead of infeasibility."""
    def policy(candidates, request):
        feas = [c for c in candidates if c.mapping is not None and c.feasible]
        if not feas:
            return None
        atfloor = (feas if reliability_floor is None else
                   [c for c in feas if (c.reliability or 0.0) >= reliability_floor - _EPS])
        pool = atfloor or feas
        pers = np.array([c.period for c in pool])
        lats = np.array([c.latency for c in pool])
        unrel = np.array([1.0 - (c.reliability if c.reliability is not None else 1.0)
                          for c in pool])
        pr = max(pers.max() - pers.min(), 1e-30)
        lr = max(lats.max() - lats.min(), 1e-30)
        rr = max(unrel.max() - unrel.min(), 1e-30)
        score = np.sqrt(((pers - pers.min()) / pr) ** 2
                        + ((lats - lats.min()) / lr) ** 2
                        + ((unrel - unrel.min()) / rr) ** 2)
        if not atfloor:
            best_rel = unrel.min()
            mask = unrel <= best_rel + _EPS
            score = np.where(mask, score, np.inf)
        return pool[int(np.argmin(score))]
    return policy


def plan_pareto_tri(
    workload: Workload,
    platform: Platform,
    *,
    k: int = 20,
    reliability_floor: Optional[float] = None,
    include: Optional[tuple] = None,
    exclude: tuple = ("deal",),
    exact_max_p: int = 12,
    time_budget: Optional[float] = None,
    device=None,
) -> PlanReport:
    """Tri-criteria Pareto planning: ``plan_pareto`` extended with the
    replication-aware solvers and 3-D (period, latency, reliability)
    non-domination.

    Sweeps every applicable bounded solver — the plain heuristics AND their
    ``-rel`` variants (admitted via ``allow_groups=True``; the deal extension
    is excluded by default because its farm groups do not replicate work) —
    over the usual bound grids, evaluates all three criteria per candidate,
    and reports the 3-D front in ``report.pareto`` as (period, latency,
    reliability) triples.  The chosen plan is the knee of the normalized
    3-D trade-off among candidates meeting ``reliability_floor`` (falling
    back to the most reliable candidate when none does).  Split scoring runs
    on ``device`` (``None``: CUDA).
    """
    with scoring_device(device):
        return _plan_pareto_tri(workload, platform, k, reliability_floor, include,
                                exclude, exact_max_p, time_budget)


def _plan_pareto_tri(workload, platform, k, reliability_floor, include, exclude,
                     exact_max_p, time_budget) -> PlanReport:
    policy = _select_tri(reliability_floor)
    request = PlanRequest(
        workload, platform, (Objective("period"), Objective("latency")),
        include=include, exclude=exclude, exact_max_p=exact_max_p,
        time_budget=time_budget, allow_groups=True, selection=policy,
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
                seen.add(spec.name)
                jobs.append((spec, obj))
    cands = _run_jobs(workload, platform, jobs, deadline)
    cands = _fill_reliability(workload, platform, cands)
    pts = [(c.period, c.latency, c.reliability if c.reliability is not None else 1.0)
           for c in cands if c.feasible]
    front = tuple(pareto_front_tri(pts)) if pts else ()
    chosen = policy(cands, request)
    plan = (_realize(chosen.mapping, chosen.period, chosen.latency, chosen.solver,
                     groups=chosen.groups)
            if chosen is not None else None)
    return PlanReport(request, plan, chosen, tuple(cands), front,
                      time.perf_counter() - t0)
