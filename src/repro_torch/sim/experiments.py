"""The paper's simulation study (Section 5) on a torch device.

The port of the campaign part of ``repro.sim.experiments``: for each
scenario family, n and p, random application/platform pairs run the six
heuristics over a grid of bounds, producing

 - trade-off curves: averaged (period, latency) per bound index — the paper's
   Figures 2-7;
 - failure thresholds: the largest bound for which a heuristic finds no
   solution — the paper's Table 1.

Every family of a campaign point is stacked into ONE
:class:`~repro_torch.core.batched.ProblemBatch` and run through the lockstep
engine on the device: one trajectory pass per split arity for H1-H4, one
lockstep H4 bisection over every feasible (instance, bound) problem, and
H5/H6 over the (instance x bound) grid.  Instance generation, bound grids,
metric evaluation and the curve means stay numpy on the host (their
summation order is part of the result).  Outputs are bit-identical to
``repro.sim.experiments.run_campaign``.

Five engines produce identical outputs:

  - ``engine="batched"`` (default): the lockstep engine above;
  - ``engine="fused"``: the same campaign structure, but every lockstep loop
    runs on the device, one fixed-shape step per iteration replayed as a
    CUDA graph, with a host poll every few iterations
    (:mod:`repro_torch.core.fused`);
  - ``engine="sharded"``: the fused campaign with its stacked-instance rows
    split over several devices (:mod:`repro_torch.core.sharded`);
  - ``engine="scalar"``: the per-instance reference path (one Python loop per
    instance and bound through the scalar heuristics and the solver
    registry), whose split scoring runs on the same device;
  - ``engine="auto"``: ``fused`` on a card, and on the CPU the reference's
    ``n * p`` rule between ``fused`` and ``batched`` (:func:`auto_engine`).

:func:`failure_thresholds` computes the paper's Table 1, and
:func:`run_replicated` reruns a campaign over R disjoint seed banks with mean
+/- 95% confidence intervals (:func:`summarize_replicated`).

Each stage of a batched campaign runs under a
``torch.profiler.record_function`` span (``campaign.setup``,
``campaign.trajectories``, ``campaign.h4``, ``campaign.h5h6`` and, inside
it, ``campaign.evaluate``), which :mod:`repro_torch.sim.campaign_profile`
reads; with no profiler running a span costs a few microseconds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
from torch.profiler import record_function

from .. import resolve_device
from ..core.batched import (ProblemBatch, _check_backend, _fixed_latency_state,
                            batched_sp_bi_p, batched_trajectory_sets,
                            evaluate_state_rows)
from ..core.heuristics import scoring_device, sp_bi_p, split_trajectory
from ..core.metrics import optimal_latency, single_processor_mapping
from ..core.metrics import period as eval_period
from ..core.planner import Objective
from ..core.solvers import solve
from .generators import gen_instance_batch

N_STAGES_DEFAULT = (5, 10, 20, 40)
# the large-grid follow-up shapes
N_STAGES_LARGE = (80, 160)
N_PROCS_LARGE = (1000,)

ENGINES = ("batched", "fused", "sharded", "scalar", "auto")

# The reference's engine crossover on the CPU (repro/sim/experiments.py:73-87,
# measured on a 2-core CPU; no target here): the fused engine at or below
# this n * p, the batched engine above it.  Both give the same output.
_AUTO_FUSED_MAX_NP = 2_000


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")


def auto_engine(n: int, p: int, device=None) -> str:
    """The engine ``engine="auto"`` runs at an (n, p) campaign point on
    ``device`` (``None`` means CUDA): ``fused`` on a card (no host sync per
    iteration is the point of it); on the CPU the reference's rule, ``fused``
    at or below ``n * p = 2000``, ``batched`` above."""
    if resolve_device(device).type == "cuda":
        return "fused"
    return "fused" if n * p <= _AUTO_FUSED_MAX_NP else "batched"


def _resolve_engine(engine: str, n: int, p: int, device) -> str:
    _check_engine(engine)
    if engine == "auto":
        return auto_engine(n, p, device)
    return engine


def _campaign_backend(engine: str) -> str:
    """The lockstep runner's backend (``repro_torch.core.batched.BACKENDS``)
    of a campaign engine: the fused and sharded engines are backends of the
    same entry points; the batched engine is the lockstep loop."""
    backend = engine if engine in ("fused", "sharded") else "lockstep"
    _check_backend(backend)
    return backend


def _stacked_batch(batches, device) -> ProblemBatch:
    """One ProblemBatch of every instance of ``batches`` (InstanceBatches
    sharing (n, p)) on ``device``."""
    return ProblemBatch.from_arrays(
        np.concatenate([b.w for b in batches]),
        np.concatenate([b.delta for b in batches]),
        np.concatenate([b.s for b in batches]), batches[0].b,
        prefix=np.concatenate([b.prefix for b in batches]),
        order=np.concatenate([b.order for b in batches]), device=device)


def _curve(cols, n_pairs: int) -> tuple:
    """(mean period, mean latency, feasible fraction) per bound from each
    bound's list of feasible (period, latency) points."""
    mean_per = np.array([np.mean([a for a, _ in col]) if col else np.nan for col in cols])
    mean_lat = np.array([np.mean([b for _, b in col]) if col else np.nan for col in cols])
    frac = np.array([len(col) / n_pairs for col in cols])
    return mean_per, mean_lat, frac


def _result_from_trajectory(traj: list, p_fix: float) -> Optional[tuple]:
    """First trajectory state with period <= p_fix, or None (failure)."""
    for per, lat in traj:
        if per <= p_fix + 1e-12:
            return per, lat
    return None


@dataclasses.dataclass
class ExperimentResult:
    exp: str
    n: int
    p: int
    n_pairs: int
    bounds_rel: np.ndarray            # relative bound grid (fraction of single-proc period / L_opt mult)
    # curves[heuristic] = (mean_period, mean_latency, feasible_frac) arrays over the grid
    curves: dict
    thresholds: dict                  # heuristic -> (mean, max) failure threshold


def run_experiment(exp: str, n: int, p: int, n_pairs: int = 50,
                   n_bounds: int = 16, seed0: int = 1234, h4_iters: int = 10,
                   include_h4: bool = True, engine: str = "batched",
                   device=None) -> ExperimentResult:
    """One scenario family at one (n, p) point on ``device`` (``None`` means
    CUDA): ``run_campaign([exp], ...)`` with the batched, fused or sharded
    engine, or the per-instance reference path with ``engine="scalar"``."""
    engine = _resolve_engine(engine, n, p, device)
    if engine != "scalar":
        return run_campaign([exp], n, p, n_pairs=n_pairs, n_bounds=n_bounds,
                            seed0=seed0, h4_iters=h4_iters, include_h4=include_h4,
                            engine=engine, device=device)[exp]
    period_fracs = np.geomspace(0.04, 1.0, n_bounds)     # x single-processor period
    latency_mults = np.linspace(1.0, 3.0, n_bounds)      # x optimal latency
    codes_p = ["H1", "H2", "H3"] + (["H4"] if include_h4 else [])
    codes_l = ["H5", "H6"]
    acc = {c: [[] for _ in range(n_bounds)] for c in codes_p + codes_l}
    thresholds = {c: [] for c in codes_p + codes_l}
    with scoring_device(device):
        batch = gen_instance_batch(exp, n, p, [seed0 + k for k in range(n_pairs)])
        _run_scalar(batch, h4_iters, include_h4,
                    period_fracs, latency_mults, codes_l, acc, thresholds)

    curves = {c: _curve(cols, n_pairs) for c, cols in acc.items()}
    thr = {c: (float(np.mean(v)), float(np.max(v))) for c, v in thresholds.items()}
    return ExperimentResult(exp, n, p, n_pairs, period_fracs, curves, thr)


def _run_scalar(batch, h4_iters, include_h4,
                period_fracs, latency_mults, codes_l, acc, thresholds) -> None:
    """Per-instance reference path: one Python loop per (instance, bound),
    over the per-instance objects of an already-generated InstanceBatch.
    Split scoring runs on the enclosing ``scoring_device`` block's device."""
    for wl, pf in batch:
        hi = eval_period(wl, pf, single_processor_mapping(wl, pf.fastest()))
        l_opt = optimal_latency(wl, pf)
        pgrid = hi * period_fracs
        lgrid = l_opt * latency_mults

        trajs = {c: split_trajectory(c, wl, pf) for c in ["H1", "H2", "H3", "H4"]}
        for c in ["H1", "H2", "H3"]:
            thresholds[c].append(min(per for per, _ in trajs[c]))
            for bi, pb in enumerate(pgrid):
                r = _result_from_trajectory(trajs[c], pb)
                if r is not None:
                    acc[c][bi].append(r)
        if include_h4:
            # H4 feasibility is characterized by its inner splitter's trajectory;
            # the binary search then trades latency. Run the real H4 per bound.
            thresholds["H4"].append(min(per for per, _ in trajs["H4"]))
            for bi, pb in enumerate(pgrid):
                if _result_from_trajectory(trajs["H4"], pb) is None:
                    continue  # provably infeasible for H4 — skip the binary search
                r = sp_bi_p(wl, pf, pb, iters=h4_iters)
                if r.feasible:
                    acc["H4"][bi].append((r.period, r.latency))

        for c in codes_l:
            thresholds[c].append(l_opt)
            for bi, lb in enumerate(lgrid):
                cand = solve(c, wl, pf, Objective("period", bound=float(lb)))
                if cand.feasible:
                    acc[c][bi].append((cand.period, cand.latency))


def _campaign_core(pb, workloads, platforms, pgrids, lgrids, n_bounds,
                   h4_iters, include_h4, backend):
    """Lockstep evaluation of G stacked instances (any mix of experiment
    families sharing (n, p)) over per-instance bound grids.

    Returns ``(points, thr)``: ``points[code][g][bi]`` is the accumulated
    (period, latency) or None, ``thr[code][g]`` the failure threshold.
    """
    G = len(workloads)
    codes_p = ["H1", "H2", "H3"] + (["H4"] if include_h4 else [])
    points = {c: [[None] * n_bounds for _ in range(G)] for c in codes_p + ["H5", "H6"]}
    thr = {}

    with record_function("campaign.trajectories"):
        trajs = batched_trajectory_sets(codes_p, pb, backend=backend)
    for c in ["H1", "H2", "H3"]:
        thr[c] = [min(per for per, _ in trajs[c][g]) for g in range(G)]
        for g in range(G):
            for bi in range(n_bounds):
                points[c][g][bi] = _result_from_trajectory(trajs[c][g], pgrids[g][bi])
    if include_h4:
        thr["H4"] = [min(per for per, _ in trajs["H4"][g]) for g in range(G)]
        # One lockstep binary search over every (instance, bound) problem that
        # the trajectory proves feasible.
        todo = [(g, bi) for g in range(G) for bi in range(n_bounds)
                if _result_from_trajectory(trajs["H4"][g], pgrids[g][bi]) is not None]
        if todo:
            sub = pb.take([g for g, _ in todo])
            bounds = [pgrids[g][bi] for g, bi in todo]
            with record_function("campaign.h4"):
                res4 = batched_sp_bi_p(sub, bounds, iters=h4_iters,
                                       with_mappings=False,
                                       groups=[g for g, _ in todo], backend=backend)
            for (g, bi), r in zip(todo, res4):
                if r.feasible:
                    points["H4"][g][bi] = (r.period, r.latency)

    # H5/H6 over the (instance x bound) grid.  The running latency of the
    # splitting loop is monotone non-decreasing, hence every bound at or above
    # the *unconstrained* run's final latency reproduces that run — one
    # lockstep pass per instance covers the whole tail of its bound grid, and
    # only the binding bounds run individually.
    for c in ("H5", "H6"):
        with record_function("campaign.h5h6"):
            metr_inf, metr_con = _fixed_latency_grid(c, pb, workloads, platforms,
                                                     lgrids, n_bounds, backend)
        # candidate metrics come from the metrics layer on the mapping,
        # feasibility from the bound (the reference's solve() layer)
        for g in range(G):
            for bi in range(n_bounds):
                v = metr_con.get((g, bi), (metr_inf[g, 0], metr_inf[g, 1]))
                if v is None:
                    continue
                per, lat = float(v[0]), float(v[1])
                if (math.isfinite(per) and math.isfinite(lat)
                        and lat <= float(lgrids[g][bi]) + 1e-12):
                    points[c][g][bi] = (per, lat)
    return points, thr


def _fixed_latency_grid(c, pb, workloads, platforms, lgrids, n_bounds, backend):
    """H5 or H6 over the (instance x bound) grid: the unconstrained run's
    metrics per instance, and those of the binding bounds by (g, bi)."""
    G = len(workloads)
    st_inf, _ = _fixed_latency_state(c, pb, np.full(G, np.inf), backend)
    m_inf = st_inf.latency()
    with record_function("campaign.evaluate"):
        metr_inf = evaluate_state_rows(workloads, platforms, st_inf)
    # safety margin: the loop's cur_lat+dlat feasibility probe can exceed
    # the post-step state latency by a few ulps
    cut = m_inf + 1e-9 * np.maximum(1.0, np.abs(m_inf))
    con = [(g, bi) for g in range(G) for bi in range(n_bounds)
           if lgrids[g][bi] < cut[g]]
    metr_con = {}
    if con:
        sub = pb.take([g for g, _ in con])
        bnds = np.array([lgrids[g][bi] for g, bi in con])
        st_c, failed_c = _fixed_latency_state(c, sub, bnds, backend)
        with record_function("campaign.evaluate"):
            mc = evaluate_state_rows([workloads[g] for g, _ in con],
                                     [platforms[g] for g, _ in con],
                                     st_c, skip=failed_c)
        for row, gb in enumerate(con):
            metr_con[gb] = None if failed_c[row] else (mc[row, 0], mc[row, 1])
    return metr_inf, metr_con


def run_campaign(exps, n: int, p: int, n_pairs: int = 50, n_bounds: int = 16,
                 seed0: int = 1234, h4_iters: int = 10, include_h4: bool = True,
                 engine: str = "batched", device=None) -> dict:
    """Run SEVERAL experiment families sharing (n, p) as ONE stacked-instance
    campaign on ``device`` (``None`` means CUDA) and return
    {exp: ExperimentResult}.  ``engine`` picks the lockstep runner
    (batched, fused or sharded: one stacked campaign) or, with ``"scalar"``,
    one per-instance reference run per family."""
    dev = resolve_device(device)
    exps = list(exps)
    engine = _resolve_engine(engine, n, p, dev)
    if engine == "scalar":
        return {exp: run_experiment(exp, n, p, n_pairs=n_pairs, n_bounds=n_bounds,
                                    seed0=seed0, h4_iters=h4_iters,
                                    include_h4=include_h4, engine="scalar", device=dev)
                for exp in exps}
    period_fracs = np.geomspace(0.04, 1.0, n_bounds)     # x single-processor period
    latency_mults = np.linspace(1.0, 3.0, n_bounds)      # x optimal latency
    with record_function("campaign.setup"):
        seeds = [seed0 + k for k in range(n_pairs)]
        batches = [gen_instance_batch(exp, n, p, seeds) for exp in exps]
        workloads = [wl for b in batches for wl in b.workloads]
        platforms = [pf for b in batches for pf in b.platforms]
        pb = _stacked_batch(batches, dev)
        his = [eval_period(wl, pf, single_processor_mapping(wl, pf.fastest()))
               for wl, pf in zip(workloads, platforms)]
        lopts = [optimal_latency(wl, pf) for wl, pf in zip(workloads, platforms)]
        pgrids = [hi * period_fracs for hi in his]
        lgrids = [l_opt * latency_mults for l_opt in lopts]

    points, thr_vals = _campaign_core(pb, workloads, platforms, pgrids, lgrids,
                                      n_bounds, h4_iters, include_h4,
                                      _campaign_backend(engine))
    thr_vals = dict(thr_vals)
    for c in ("H5", "H6"):
        thr_vals[c] = lopts

    out = {}
    codes = ["H1", "H2", "H3"] + (["H4"] if include_h4 else []) + ["H5", "H6"]
    for ei, exp in enumerate(exps):
        lo = ei * n_pairs
        curves = {}
        for c in codes:
            cols = [[points[c][g][bi] for g in range(lo, lo + n_pairs)
                     if points[c][g][bi] is not None] for bi in range(n_bounds)]
            curves[c] = _curve(cols, n_pairs)
        thr = {c: (float(np.mean(thr_vals[c][lo:lo + n_pairs])),
                   float(np.max(thr_vals[c][lo:lo + n_pairs]))) for c in codes}
        out[exp] = ExperimentResult(exp, n, p, n_pairs, period_fracs, curves, thr)
    return out


def failure_thresholds(exps=("E1", "E2", "E3", "E4"), ns=N_STAGES_DEFAULT,
                       p: int = 10, n_pairs: int = 50, seed0: int = 1234,
                       engine: str = "batched", device=None) -> dict:
    """The paper's Table 1: per (experiment, heuristic, n), the failure
    threshold, averaged over instances, on ``device`` (``None`` means CUDA).
    Returns {exp: {code: {n: value}}}."""
    _check_engine(engine)
    dev = resolve_device(device)
    exps = list(exps)
    out: dict = {exp: {c: {} for c in ["H1", "H2", "H3", "H4", "H5", "H6"]}
                 for exp in exps}
    if engine != "scalar":
        # one stacked pass per n across ALL experiment families; "auto"
        # resolves per n (each n is its own campaign point)
        seeds = [seed0 + k for k in range(n_pairs)]
        for n in ns:
            batches = [gen_instance_batch(exp, n, p, seeds) for exp in exps]
            trajsets = batched_trajectory_sets(
                ["H1", "H2", "H3", "H4"], _stacked_batch(batches, dev),
                backend=_campaign_backend(_resolve_engine(engine, n, p, dev)))
            for c, trajs in trajsets.items():
                for ei, exp in enumerate(exps):
                    sl = trajs[ei * n_pairs:(ei + 1) * n_pairs]
                    out[exp][c][n] = float(np.mean([min(per for per, _ in t)
                                                    for t in sl]))
            for ei, exp in enumerate(exps):
                lopts = [optimal_latency(wl, pf) for wl, pf in batches[ei]]
                out[exp]["H5"][n] = float(np.mean(lopts))
                out[exp]["H6"][n] = float(np.mean(lopts))
        return out
    with scoring_device(dev):
        for exp in exps:
            for n in ns:
                vals = {c: [] for c in out[exp]}
                batch = gen_instance_batch(exp, n, p,
                                           [seed0 + k for k in range(n_pairs)])
                for wl, pf in batch:
                    for c in ["H1", "H2", "H3", "H4"]:
                        traj = split_trajectory(c, wl, pf)
                        vals[c].append(min(per for per, _ in traj))
                    l_opt = optimal_latency(wl, pf)
                    vals["H5"].append(l_opt)
                    vals["H6"].append(l_opt)
                for c, v in vals.items():
                    out[exp][c][n] = float(np.mean(v))
    return out


# ---------------------------------------------------------------------------
# Replication sweeps: the Section-5 study across many seed banks, with
# confidence intervals on the Figures 2-7 curves and Table 1 thresholds.
# ---------------------------------------------------------------------------

# normal-approximation 95% two-sided quantile
_Z95 = 1.959963984540054


@dataclasses.dataclass
class ReplicatedResult:
    """Aggregate of R independent campaign replications of one experiment.

    ``curves[code] = (mean_per, ci_per, mean_lat, ci_lat, mean_frac)`` over
    the bound grid, where the means average each replication's curve point
    (nan-skipping: a replication with no feasible instance at a bound does
    not contribute) and ``ci_*`` is the 95% half-width of the mean across
    replications.  ``thresholds[code] = (mean, ci)`` aggregates the
    per-replication mean failure thresholds.
    """

    exp: str
    n: int
    p: int
    n_pairs: int
    replications: int
    bounds_rel: np.ndarray
    curves: dict
    thresholds: dict


def _mean_ci(stack: np.ndarray) -> tuple:
    """(nan-mean, 95% CI half-width of the mean) along axis 0.  All-NaN
    columns (a bound infeasible in every replication) stay NaN."""
    import warnings

    cnt = np.sum(~np.isnan(stack), axis=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        mean = np.where(cnt > 0, np.nanmean(stack, axis=0), np.nan)
        sd = np.where(cnt > 1, np.nanstd(stack, axis=0, ddof=1), np.nan)
    ci = np.where(cnt > 1, _Z95 * sd / np.sqrt(np.maximum(cnt, 1)), np.nan)
    return mean, ci


def run_replicated(exps, n: int, p: int, n_pairs: int = 50,
                   replications: int = 10, n_bounds: int = 16,
                   seed0: int = 1234, h4_iters: int = 10,
                   include_h4: bool = True, engine: str = "batched",
                   device=None) -> tuple:
    """Run the campaign over ``replications`` disjoint seed banks (bank r
    uses seeds ``seed0 + r * n_pairs + k``; bank 0 is exactly the
    non-replicated campaign) on ``device`` (``None`` means CUDA) and
    aggregate mean +/- 95% CI per experiment.

    Returns ``(replicated, first)`` where ``replicated`` maps each exp to a
    :class:`ReplicatedResult` and ``first`` is bank 0's plain
    ``{exp: ExperimentResult}``.
    """
    dev = resolve_device(device)
    engine = _resolve_engine(engine, n, p, dev)
    if engine == "scalar":  # the reference path replicates per experiment
        camps = [{exp: run_experiment(exp, n, p, n_pairs=n_pairs,
                                      n_bounds=n_bounds,
                                      seed0=seed0 + r * n_pairs,
                                      h4_iters=h4_iters,
                                      include_h4=include_h4, engine="scalar",
                                      device=dev)
                  for exp in exps} for r in range(replications)]
    else:
        camps = [run_campaign(exps, n, p, n_pairs=n_pairs, n_bounds=n_bounds,
                              seed0=seed0 + r * n_pairs, h4_iters=h4_iters,
                              include_h4=include_h4, engine=engine, device=dev)
                 for r in range(replications)]
    out = {}
    for exp in exps:
        reps = [c[exp] for c in camps]
        codes = sorted(reps[0].curves)
        curves = {}
        thr = {}
        for c in codes:
            per = np.stack([r.curves[c][0] for r in reps])
            lat = np.stack([r.curves[c][1] for r in reps])
            frac = np.stack([r.curves[c][2] for r in reps])
            mean_per, ci_per = _mean_ci(per)
            mean_lat, ci_lat = _mean_ci(lat)
            curves[c] = (mean_per, ci_per, mean_lat, ci_lat, frac.mean(axis=0))
            tvals = np.array([r.thresholds[c][0] for r in reps])
            tm, tci = _mean_ci(tvals[:, None])
            thr[c] = (float(tm[0]), float(tci[0]))
        out[exp] = ReplicatedResult(exp, n, p, n_pairs, replications,
                                    reps[0].bounds_rel, curves, thr)
    return out, camps[0]


def summarize_replicated(res: ReplicatedResult) -> str:
    lines = [f"# {res.exp} n={res.n} p={res.p} pairs={res.n_pairs} "
             f"replications={res.replications}"]
    lines.append("heuristic,bound_idx,mean_period,period_ci95,"
                 "mean_latency,latency_ci95,feasible_frac")
    for c, (mp, cp, ml, cl, fr) in sorted(res.curves.items()):
        for i in range(len(mp)):
            lines.append(f"{c},{i},{mp[i]:.6g},{cp[i]:.6g},{ml[i]:.6g},"
                         f"{cl[i]:.6g},{fr[i]:.3f}")
    lines.append("heuristic,threshold_mean,threshold_ci95")
    for c, (m, ci) in sorted(res.thresholds.items()):
        lines.append(f"{c},{m:.6g},{ci:.6g}")
    return "\n".join(lines)


def summarize_experiment(res: ExperimentResult) -> str:
    lines = [f"# {res.exp} n={res.n} p={res.p} pairs={res.n_pairs}"]
    lines.append("heuristic,bound_idx,mean_period,mean_latency,feasible_frac")
    for c, (mp, ml, fr) in sorted(res.curves.items()):
        for i in range(len(mp)):
            lines.append(f"{c},{i},{mp[i]:.6g},{ml[i]:.6g},{fr[i]:.3f}")
    lines.append("heuristic,threshold_mean,threshold_max")
    for c, (m, mx) in sorted(res.thresholds.items()):
        lines.append(f"{c},{m:.6g},{mx:.6g}")
    return "\n".join(lines)
