"""Paper reproduction: the simulation study of Section 5, on a torch device.

The port's own copy of the CSV and claims writer of
``benchmarks/paper_sim.py`` (``run``, ``_check_claims``).  It writes to
``out_dir``:

  - curves_<exp>_n<k>_p<P>.csv      — the trade-off curves behind Figures 2-7
  - curves_<exp>_n<k>_p<P>_ci.csv   — mean +/- 95% CI across seed banks
                                      (only with --replications R > 1)
  - table1_thresholds.csv           — the failure-threshold table (Table 1)
  - table1_thresholds_ci.csv        — its replication CIs (with --replications)
  - claims.txt                      — machine-checked qualitative claims

byte-identical to the reference's files for the same grid.  Every (n, p)
point runs on ``device`` (``None`` means CUDA) as one
:func:`repro_torch.sim.experiments.run_campaign` through the batched engine,
the fused engine (the loop on the device, replayed as CUDA graphs) or the
sharded one (the same, rows split over every visible card), or, with
``--engine scalar``, the per-instance reference path; ``--engine auto``
picks per point (:func:`repro_torch.sim.experiments.auto_engine`).
``--large-grid`` adds the follow-up study's n in {80, 160}, p = 1000 points
(``--large-pairs`` pairs each).  Run it with

    PYTHONPATH=src python -m repro_torch.sim.paper_sim --out <dir> [--device cuda] \
        [--engine batched|fused|sharded|scalar|auto] [--replications R] \
        [--large-grid] [--large-pairs 6]
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np

from .. import resolve_device
from .experiments import (ENGINES, N_PROCS_LARGE, N_STAGES_LARGE, _check_engine,
                          _resolve_engine, run_campaign, run_experiment,
                          run_replicated, summarize_experiment,
                          summarize_replicated)
from .generators import FAMILY_SETS, PAPER_FAMILIES

HEURISTICS = ("H1", "H2", "H3", "H4", "H5", "H6")


def _run_point(exps, n, p, n_pairs, n_bounds, include_h4, engine, replications,
               device):
    """One (n, p) grid point through the selected engine (``"auto"``
    resolves per point); returns (single-bank {exp: ExperimentResult},
    {exp: ReplicatedResult} or None)."""
    engine = _resolve_engine(engine, n, p, device)
    if replications > 1:
        rep, first = run_replicated(exps, n, p, n_pairs=n_pairs,
                                    replications=replications,
                                    n_bounds=n_bounds, include_h4=include_h4,
                                    engine=engine, device=device)
        return first, rep
    if engine == "scalar":
        return {exp: run_experiment(exp, n, p, n_pairs=n_pairs,
                                    n_bounds=n_bounds, include_h4=include_h4,
                                    engine="scalar", device=device)
                for exp in exps}, None
    return run_campaign(exps, n, p, n_pairs=n_pairs, n_bounds=n_bounds,
                        include_h4=include_h4, engine=engine, device=device), None


def run(out_dir: pathlib.Path, full: bool = False, families: str = "paper",
        ns: tuple = None, ps: tuple = None, n_pairs: int = None,
        n_bounds: int = None, engine: str = "batched", replications: int = 1,
        large_grid: bool = False, large_pairs: int = 6, device=None) -> dict:
    """Run the study and write its CSVs.  ``families`` selects a family set
    from ``FAMILY_SETS`` (or pass an explicit tuple of family names);
    ``ns``/``ps``/``n_pairs``/``n_bounds`` override the grid."""
    dev = resolve_device(device)
    _check_engine(engine)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    exps = FAMILY_SETS[families] if isinstance(families, str) else tuple(families)
    n_pairs = n_pairs if n_pairs is not None else (50 if full else 15)
    ns = tuple(ns) if ns is not None else ((5, 10, 20, 40) if full else (5, 20))
    ps = tuple(ps) if ps is not None else (10, 100)
    nb = n_bounds if n_bounds is not None else (12 if full else 8)
    t0 = time.time()

    points = [(n, p, n_pairs, nb, full or (n <= 20)) for n in ns for p in ps]
    if large_grid:
        points += [(n, p, large_pairs, 8, True)
                   for n in N_STAGES_LARGE for p in N_PROCS_LARGE]

    results = {}
    rep_results = {}
    for n, p, pairs, n_bounds_pt, include_h4 in points:
        camp, rep = _run_point(exps, n, p, pairs, n_bounds_pt, include_h4,
                               engine, replications, dev)
        for exp in exps:
            results[(exp, n, p)] = camp[exp]
            (out_dir / f"curves_{exp}_n{n}_p{p}.csv").write_text(
                summarize_experiment(camp[exp]))
            if rep is not None:
                rep_results[(exp, n, p)] = rep[exp]
                (out_dir / f"curves_{exp}_n{n}_p{p}_ci.csv").write_text(
                    summarize_replicated(rep[exp]))

    # Table 1: failure thresholds at p=10, straight from the campaign results
    # (mean over the same instances the curves used).
    thr = None
    if 10 in ps:
        thr = {exp: {c: {n: results[(exp, n, 10)].thresholds[c][0] for n in ns}
                     for c in HEURISTICS} for exp in exps}
        lines = ["exp,heuristic," + ",".join(f"n{n}" for n in ns)]
        for exp in exps:
            for code in HEURISTICS:
                vals = ",".join(f"{thr[exp][code][n]:.2f}" for n in ns)
                lines.append(f"{exp},{code},{vals}")
        (out_dir / "table1_thresholds.csv").write_text("\n".join(lines))

        if replications > 1:
            lines = ["exp,heuristic,"
                     + ",".join(f"n{n}_mean,n{n}_ci95" for n in ns)]
            for exp in exps:
                for code in HEURISTICS:
                    cells = []
                    for n in ns:
                        m, ci = rep_results[(exp, n, 10)].thresholds[code]
                        cells.append(f"{m:.2f},{ci:.3f}")
                    lines.append(f"{exp},{code}," + ",".join(cells))
            (out_dir / "table1_thresholds_ci.csv").write_text("\n".join(lines))

    claims = _check_claims(exps, ns, ps, results, thr)
    (out_dir / "claims.txt").write_text("\n".join(claims))
    return {"claims": claims, "elapsed_s": round(time.time() - t0, 1),
            "points": len(results), "device": str(dev), "engine": engine,
            "replications": replications}


def _check_claims(exps, ns, ps, results, thr) -> list:
    """Machine-checked qualitative claims.  Structural claims (H5/H6
    threshold coincidence, p-scaling) apply to EVERY scenario family; the
    paper's comparative observations (H1-vs-H2 thresholds, the bi-criteria
    advantage) are claimed over its own E1-E4 families only."""
    claims = []

    def claim(name, ok):
        claims.append(f"[{'PASS' if ok else 'FAIL'}] {name}")
        return ok

    paper_exps = [e for e in exps if e in PAPER_FAMILIES]

    # 1. H5 and H6 have identical failure thresholds (both fail exactly when
    #    L_fix < optimal latency) — structural, any family.
    if thr is not None:
        ok1 = all(abs(thr[e]["H5"][n] - thr[e]["H6"][n]) < 1e-9
                  for e in exps for n in ns)
        claim("H5/H6 failure thresholds coincide (= optimal latency)", ok1)

    # 2. 'Sp mono P has the smallest failure thresholds' among fixed-period
    #    heuristics H1-H3.  2% tolerance absorbs finite-sample noise.
    if thr is not None and paper_exps:
        ok2 = all(thr[e]["H1"][n] <= thr[e]["H2"][n] * 1.02
                  for e in paper_exps for n in ns)
        claim("H1 (Sp mono P) threshold <= H2 (3-Explo mono) [2% tol]", ok2)

    # 3. p=100 dominates p=10: periods drop with more procs — any family.
    if 10 in ps and 100 in ps:
        ok3 = True
        for exp in exps:
            for n in ns:
                if (exp, n, 10) in results and (exp, n, 100) in results:
                    m10 = results[(exp, n, 10)].curves["H5"][0]
                    m100 = results[(exp, n, 100)].curves["H5"][0]
                    sel = ~(np.isnan(m10) | np.isnan(m100))
                    if sel.any() and not (m100[sel] <= m10[sel] + 1e-6).all():
                        ok3 = False
        claim("periods improve from p=10 to p=100 (Section 5.2.2)", ok3)

    # 4. Bi-criteria H6 improves vs mono H5 more at p=100 than p=10.
    if paper_exps and 10 in ps and 100 in ps:
        gains = {p: [] for p in ps}
        for exp in paper_exps:
            for n in ns:
                for p in ps:
                    if (exp, n, p) in results:
                        m5 = results[(exp, n, p)].curves["H5"][0]
                        m6 = results[(exp, n, p)].curves["H6"][0]
                        sel = ~(np.isnan(m5) | np.isnan(m6)) & (m5 > 0)
                        if sel.any():
                            gains[p].append(float(np.mean(1 - m6[sel] / m5[sel])))
        ok4 = (np.mean(gains.get(100, [0]))
               >= np.mean(gains.get(10, [0])) - 0.01)
        claim("bi-criteria advantage grows with processor count", ok4)

    return claims


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=pathlib.Path, required=True,
                    help="directory the CSVs and claims.txt are written to")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the host)")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--families", choices=tuple(FAMILY_SETS), default="paper")
    ap.add_argument("--engine", choices=ENGINES, default="batched",
                    help="the lockstep engine (batched), the loop on the device "
                         "(fused), the same over every visible card (sharded), "
                         "the per-instance reference path (scalar), or auto")
    ap.add_argument("--replications", type=int, default=1, metavar="R",
                    help="run each grid point over R disjoint seed banks and "
                         "emit mean +/- 95%% CI CSVs next to the point CSVs")
    ap.add_argument("--large-grid", action="store_true",
                    help="add the n in {80, 160}, p = 1000 follow-up points "
                         "(reduced pair count)")
    ap.add_argument("--large-pairs", type=int, default=6,
                    help="instance pairs per large-grid point (default 6)")
    args = ap.parse_args()
    out = run(args.out, full=args.full, families=args.families, engine=args.engine,
              replications=args.replications, large_grid=args.large_grid,
              large_pairs=args.large_pairs, device=args.device)
    for c in out["claims"]:
        print(c)
    extra = (f", {out['replications']} replications"
             if out["replications"] > 1 else "")
    print(f"paper_sim[{out['device']}, {out['engine']}, {args.families}]: "
          f"{out['points']} experiment points in {out['elapsed_s']}s{extra}")


if __name__ == "__main__":
    main()
