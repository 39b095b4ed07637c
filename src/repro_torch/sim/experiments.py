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

Each stage of a campaign runs under a ``torch.profiler.record_function``
span (``campaign.setup``, ``campaign.trajectories``, ``campaign.h4``,
``campaign.h5h6`` and, inside it, ``campaign.evaluate``), which :mod:`repro_torch.sim.campaign_profile`
reads; with no profiler running a span costs a few microseconds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
from torch.profiler import record_function

from .. import resolve_device
from ..core.batched import (ProblemBatch, _fixed_latency_state, batched_sp_bi_p,
                            batched_trajectory_sets, evaluate_state_rows)
from ..core.metrics import optimal_latency, single_processor_mapping
from ..core.metrics import period as eval_period
from .generators import gen_instance_batch


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
                   include_h4: bool = True, device=None) -> ExperimentResult:
    """One scenario family at one (n, p) point: ``run_campaign([exp], ...)``."""
    return run_campaign([exp], n, p, n_pairs=n_pairs, n_bounds=n_bounds,
                        seed0=seed0, h4_iters=h4_iters, include_h4=include_h4,
                        device=device)[exp]


def _campaign_core(pb, workloads, platforms, pgrids, lgrids, n_bounds,
                   h4_iters, include_h4):
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
        trajs = batched_trajectory_sets(codes_p, pb)
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
                                       groups=[g for g, _ in todo])
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
                                                     lgrids, n_bounds)
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


def _fixed_latency_grid(c, pb, workloads, platforms, lgrids, n_bounds):
    """H5 or H6 over the (instance x bound) grid: the unconstrained run's
    metrics per instance, and those of the binding bounds by (g, bi)."""
    G = len(workloads)
    st_inf, _ = _fixed_latency_state(c, pb, np.full(G, np.inf))
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
        st_c, failed_c = _fixed_latency_state(c, sub, bnds)
        with record_function("campaign.evaluate"):
            mc = evaluate_state_rows([workloads[g] for g, _ in con],
                                     [platforms[g] for g, _ in con],
                                     st_c, skip=failed_c)
        for row, gb in enumerate(con):
            metr_con[gb] = None if failed_c[row] else (mc[row, 0], mc[row, 1])
    return metr_inf, metr_con


def run_campaign(exps, n: int, p: int, n_pairs: int = 50, n_bounds: int = 16,
                 seed0: int = 1234, h4_iters: int = 10, include_h4: bool = True,
                 device=None) -> dict:
    """Run SEVERAL experiment families sharing (n, p) as ONE stacked-instance
    campaign on ``device`` (``None`` means CUDA) and return
    {exp: ExperimentResult}."""
    dev = resolve_device(device)
    exps = list(exps)
    period_fracs = np.geomspace(0.04, 1.0, n_bounds)     # x single-processor period
    latency_mults = np.linspace(1.0, 3.0, n_bounds)      # x optimal latency
    with record_function("campaign.setup"):
        seeds = [seed0 + k for k in range(n_pairs)]
        batches = [gen_instance_batch(exp, n, p, seeds) for exp in exps]
        workloads = [wl for b in batches for wl in b.workloads]
        platforms = [pf for b in batches for pf in b.platforms]
        pb = ProblemBatch.from_arrays(
            np.concatenate([b.w for b in batches]),
            np.concatenate([b.delta for b in batches]),
            np.concatenate([b.s for b in batches]), batches[0].b,
            prefix=np.concatenate([b.prefix for b in batches]),
            order=np.concatenate([b.order for b in batches]), device=dev)
        his = [eval_period(wl, pf, single_processor_mapping(wl, pf.fastest()))
               for wl, pf in zip(workloads, platforms)]
        lopts = [optimal_latency(wl, pf) for wl, pf in zip(workloads, platforms)]
        pgrids = [hi * period_fracs for hi in his]
        lgrids = [l_opt * latency_mults for l_opt in lopts]

    points, thr_vals = _campaign_core(pb, workloads, platforms, pgrids, lgrids,
                                      n_bounds, h4_iters, include_h4)
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
            mean_per = np.array([np.mean([a for a, _ in col]) if col else np.nan
                                 for col in cols])
            mean_lat = np.array([np.mean([b for _, b in col]) if col else np.nan
                                 for col in cols])
            frac = np.array([len(col) / n_pairs for col in cols])
            curves[c] = (mean_per, mean_lat, frac)
        thr = {c: (float(np.mean(thr_vals[c][lo:lo + n_pairs])),
                   float(np.max(thr_vals[c][lo:lo + n_pairs]))) for c in codes}
        out[exp] = ExperimentResult(exp, n, p, n_pairs, period_fracs, curves, thr)
    return out


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
