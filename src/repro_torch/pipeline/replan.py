"""Online re-planning: straggler mitigation and elastic scaling.

This is the paper's heterogeneous-processor scenario arising *online*:
observed per-stage step times turn a homogeneous pod platform into an
effectively heterogeneous one, and the paper's heuristics re-balance the
layer intervals.

The port's own copy of ``repro.pipeline.replan``.  The monitor and the
resized platform are numpy on the host; :func:`replan_stages` and
:func:`elastic_replan` run the planner portfolio inside a
:func:`~repro_torch.core.heuristics.scoring_device` block, so its heuristics
score their splits on ``device`` (``None``: CUDA, raising without a card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core import (InfeasiblePlan, Objective, Platform, StagePlan, Workload,
                    auto_request, interval_cycle_times, plan_request,
                    replan_for_straggler, scoring_device)


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA of per-stage step times; flags stages slower than predicted."""

    num_stages: int
    alpha: float = 0.2
    threshold: float = 1.3
    ewma: Optional[np.ndarray] = None

    def observe(self, stage_times) -> np.ndarray:
        t = np.asarray(stage_times, dtype=float)
        if self.ewma is None:
            self.ewma = t.copy()
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * t
        return self.ewma

    def stragglers(self, predicted) -> list:
        """Stage indices whose EWMA exceeds threshold x predicted cycle time."""
        if self.ewma is None:
            return []
        pred = np.asarray(predicted, dtype=float)
        return [int(j) for j in range(len(pred))
                if pred[j] > 0 and self.ewma[j] / pred[j] > self.threshold]


def replan_stages(workload: Workload, platform: Platform, current: StagePlan,
                  monitor: StragglerMonitor, device=None) -> tuple:
    """If stragglers are detected, degrade the platform and re-plan.
    Returns (new_plan_or_None, degraded_platform).  The re-plan scores its
    splits on ``device`` (``None``: CUDA)."""
    with scoring_device(device):
        predicted = interval_cycle_times(workload, platform, current.mapping)
        bad = monitor.stragglers(predicted)
        if not bad:
            return None, platform
        new_plan, degraded = replan_for_straggler(
            workload, platform, current, monitor.ewma,
            slowdown_threshold=monitor.threshold)
    return new_plan, degraded


def elastic_platform(old_platform: Platform, new_num_pods: int,
                     surviving=None) -> Platform:
    """The resized platform after a preemption / capacity change.

    Surviving pods keep their *observed* speeds (losing them would throw away
    exactly the heterogeneity the straggler monitor measured); only newly
    added pods get the median surviving speed as prior.  ``surviving`` names
    the pods that remain (default: the first ``min(p, new_num_pods)``).
    """
    if new_num_pods < 1:
        raise ValueError("need at least one pod")
    if surviving is None:
        surviving = np.arange(min(old_platform.p, new_num_pods))
    else:
        surviving = np.asarray(surviving, dtype=np.int64)[:new_num_pods]
    kept = old_platform.s[surviving]
    fill = np.full(new_num_pods - len(kept), float(np.median(kept)))
    if old_platform.fail is None:
        fail = None
    else:
        kept_f = old_platform.fail[surviving]
        fail = np.concatenate(
            [kept_f, np.full(new_num_pods - len(kept_f), float(np.median(kept_f)))])
    return Platform(np.concatenate([kept, fill]), old_platform.b,
                    name=f"elastic-{new_num_pods}", fail=fail)


def elastic_replan(workload: Workload, old_platform: Platform,
                   new_num_pods: int, device=None) -> StagePlan:
    """Elastic scaling: the pod count changed (preemption / capacity add);
    re-run the planner portfolio on the resized platform, preserving the
    surviving pods' observed speeds.  Split scoring runs on ``device``
    (``None``: CUDA)."""
    with scoring_device(device):
        pf = elastic_platform(old_platform, new_num_pods)
        report = plan_request(auto_request(workload, pf, Objective("period")))
    if report.plan is None:
        raise InfeasiblePlan(f"elastic replan found no feasible mapping "
                             f"for {new_num_pods} pods")
    return report.plan
