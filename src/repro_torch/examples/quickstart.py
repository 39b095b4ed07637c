"""Quickstart: the paper's bi-criteria pipeline mapping, end to end (the
port of the reference's ``examples/quickstart.py``).

1. Build a pipeline workload (here: qwen3-4b's 36 transformer blocks at the
   train_4k shape) and a heterogeneous platform (4 pods, one degraded).
2. Run the paper's heuristics, then the solver-registry portfolio through
   the PlanRequest -> PlanReport protocol (full per-solver provenance).
3. Inspect the period/latency Pareto front and the resulting stage plan.

Split scoring runs on ``--device`` (the card by default).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

from repro_torch.configs import get_config
from repro_torch.core import (NAMES, Objective, PlanRequest, make_platform, optimal_latency,
                              plan_pareto, plan_request, plan_with_deal, solve, solver_names)
from repro_torch.models.common import SHAPES
from repro_torch.models.registry import lm_workload
from repro_torch.sim import gen_instance


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = ap.parse_args(argv).device

    cfg = get_config("qwen3-4b")
    wl = lm_workload(cfg, SHAPES["train_4k"])
    print(f"workload: {wl.n} stages, {wl.total_work/1e12:.1f} TFLOP per step")
    print(f"registered solvers: {', '.join(solver_names())}")

    # 4 pods at 25.2 PF/s effective each; pod 2 is thermally degraded 1.6x
    pf = make_platform([25.2e15, 25.2e15, 25.2e15 / 1.6, 25.2e15], b=25e9)

    print("\n--- paper heuristics, fixed period = 1.5x ideal ---")
    ideal = wl.total_work / pf.s.sum()
    for code in ("H1", "H2", "H3", "H4"):
        c = solve(code, wl, pf, Objective("latency", bound=ideal * 1.5), device=dev)
        status = "ok " if c.feasible else "FAIL"
        print(f"{code} {NAMES[code]:14s} [{status}] period={c.period*1e3:7.2f}ms "
              f"latency={c.latency*1e3:7.2f}ms wall={c.wall_time*1e3:.1f}ms")

    print("\n--- fixed latency = 1.2x optimal ---")
    lopt = optimal_latency(wl, pf)
    for code in ("H5", "H6"):
        c = solve(code, wl, pf, Objective("period", bound=lopt * 1.2), device=dev)
        print(f"{code} {NAMES[code]:14s} period={c.period*1e3:7.2f}ms "
              f"latency={c.latency*1e3:7.2f}ms")

    print("\n--- PlanRequest -> PlanReport (min period, full provenance) ---")
    report = plan_request(PlanRequest(wl, pf, Objective("period")), device=dev)
    print(report.summary())
    p = report.plan
    print(f"\nplanner={p.planner} stages={p.stage_sizes} on pods {p.mapping.alloc}")
    print(f"period={p.period*1e3:.2f}ms latency={p.latency*1e3:.2f}ms "
          f"padding_overhead={p.padding_overhead:.1%}")
    print("note: the degraded pod receives the smallest interval")

    print("\n--- Pareto-first planning (knee selection) ---")
    pr = plan_pareto(wl, pf, k=8, device=dev)
    for per, lat in pr.pareto:
        mark = " <== knee" if (per, lat) == pr.chosen.point else ""
        print(f"  period={per*1e3:7.2f}ms latency={lat*1e3:7.2f}ms{mark}")

    print("\n--- deal-skeleton extension (the paper's Section-7 future work) ---")
    # A compute-dominated chain (the paper's E3 regime) with one huge stage:
    # interval splitting is stuck (a stage is atomic), dealing replicates it.
    wl3, pf3 = gen_instance("E3", n=8, p=10, seed=7)
    base3 = plan_request(PlanRequest(wl3, pf3, Objective("period")), device=dev).plan
    dealt = plan_with_deal(wl3, pf3, Objective("period"), device=dev)
    print(f"base:   m={base3.num_stages} stages, period={base3.period:.2f}")
    print(f"dealt:  groups={dealt.groups}")
    print(f"        period={dealt.period:.2f} "
          f"({(1 - dealt.period/base3.period):.1%} better)")


if __name__ == "__main__":
    main()
