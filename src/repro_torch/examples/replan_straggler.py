"""Straggler mitigation demo: the paper's heterogeneous-processor scenario
arising online (the port of the reference's ``examples/replan_straggler.py``).

A 4-pod pipeline plan is computed for qwen1.5-110b (80 layers).  Mid-training
one pod slows down 1.8x (thermal throttling).  The StragglerMonitor detects
it from observed stage times; the paper's planner re-balances the intervals
onto the now-heterogeneous platform, shrinking the straggler's interval.
Split scoring runs on ``--device`` (the card by default).

Run:  PYTHONPATH=src python -m repro_torch.examples.replan_straggler [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import Objective, PlanRequest, interval_cycle_times, make_platform, plan_request
from repro_torch.models.common import SHAPES
from repro_torch.models.registry import lm_workload
from repro_torch.pipeline.replan import StragglerMonitor, replan_stages


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = ap.parse_args(argv).device

    cfg = get_config("qwen1.5-110b")
    wl = lm_workload(cfg, SHAPES["train_4k"])
    pf = make_platform([25.2e15] * 4, b=25e9)

    report = plan_request(PlanRequest(wl, pf, Objective("period")), device=dev)
    p0 = report.plan
    pred = interval_cycle_times(wl, pf, p0.mapping)
    print(f"initial plan: stages={p0.stage_sizes} period={p0.period*1e3:.2f}ms "
          f"(chosen from {len(report.candidates)} candidates)")

    # pod serving stage 1 degrades 1.8x
    mon = StragglerMonitor(num_stages=p0.num_stages, alpha=0.5)
    for step in range(5):
        observed = pred.copy()
        observed[1] *= 1.8
        mon.observe(observed)
    print(f"observed stage times (ms): {np.round(mon.ewma*1e3, 2)}")

    new_plan, degraded = replan_stages(wl, pf, p0, mon, device=dev)
    assert new_plan is not None, "straggler must be detected"
    new_pred = interval_cycle_times(wl, degraded, new_plan.mapping)
    old_pred = interval_cycle_times(wl, degraded, p0.mapping)
    print(f"re-plan:      stages={new_plan.stage_sizes} on pods "
          f"{new_plan.mapping.alloc}")
    print(f"period with straggler: old={old_pred.max()*1e3:.2f}ms "
          f"-> new={new_pred.max()*1e3:.2f}ms "
          f"({(1 - new_pred.max()/old_pred.max()):.1%} better)")
    assert new_pred.max() <= old_pred.max() + 1e-9


if __name__ == "__main__":
    main()
