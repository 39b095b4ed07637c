"""Deal-skeleton extension (the paper's Section-7 'natural extension').

When a stage interval is both the period bottleneck and splitting is stuck
(single stage, or no improving cut), the paper suggests nesting a *deal*
(farm) skeleton: round-robin the tasks of that interval over a GROUP of
processors.  With a group U processing every |U|-th task, the interval's
cycle time becomes

    cycle_deal = delta_in/b + w_I / sum_{u in U} s_u + delta_out/b

under perfect dealing (each task goes to a processor proportionally often to
its speed; the aggregate rate is the sum of speeds), while its LATENCY
contribution uses the slowest group member (a task may land on it):

    lat_deal = delta_in/b + w_I / min_{u in U} s_u

``plan_with_deal`` runs the base planner, then greedily assigns remaining
unused processors as replicas of the current bottleneck interval while the
period improves.  In the TPU mapping this is data parallelism *within* a
stage group — which the runtime already executes (DP inside a pod) — so the
extension closes the loop between the paper's future work and what modern
pipelines actually do.

The port's own copy of ``repro.core.deal``.  The greedy stays numpy and
Python floats on the host, with the reference's chain-order latency sums;
the base plan's heuristics score their splits on the device of the
:func:`~repro_torch.core.heuristics.scoring_device` block that
:func:`plan_with_deal` opens (``device=None``: CUDA, raising without a card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .heuristics import scoring_device
from .metrics import Mapping
from .planner import Objective, StagePlan, auto_request, plan, plan_request
from .platform import Platform
from .solvers import Solution, register_solver
from .workload import Workload


@dataclasses.dataclass(frozen=True)
class DealPlan:
    """A stage plan where each interval may own a GROUP of processors."""

    base: StagePlan
    groups: tuple              # tuple[tuple[int, ...]] — processors per interval
    period: float
    latency: float

    @property
    def num_stages(self) -> int:
        return self.base.num_stages


def _deal_metrics(workload: Workload, platform: Platform, mapping: Mapping,
                  groups) -> tuple:
    """Per-candidate Python-loop reference for grouped-mapping metrics.

    Kept as the behavioral reference (and the "before" side of the
    deal-extension benchmark): the vectorized greedy below must reproduce it
    bit-for-bit, which it does because both accumulate group rates in
    append order and latency terms in chain order."""
    w, delta, b, s = workload.w, workload.delta, platform.b, platform.s
    per = 0.0
    lat = 0.0
    for (d, e), grp in zip(mapping.intervals, groups):
        wsum = w[d - 1: e].sum()
        rate = sum(s[u] for u in grp)
        cyc = delta[d - 1] / b + wsum / rate + delta[e] / b
        per = max(per, cyc)
        lat += delta[d - 1] / b + wsum / min(s[u] for u in grp)
    lat += delta[workload.n] / b
    return float(per), float(lat)


class _DealState:
    """Stacked per-interval state for the greedy deal loop (cf.
    ``metrics.evaluate_batch``): interval constants are computed ONCE as
    arrays, groups are summarized by their aggregate ``rate`` and slowest
    member ``smin``, and every candidate evaluation is elementwise numpy
    instead of a per-mapping Python loop over intervals."""

    def __init__(self, workload: Workload, platform: Platform, mapping: Mapping):
        w, delta, b = workload.w, workload.delta, platform.b
        iv = np.asarray(mapping.intervals, dtype=np.int64)
        D, E = iv[:, 0], iv[:, 1]
        # same reduction as the reference's w[d-1:e].sum(), cached per interval
        self.wsum = np.array([w[d - 1:e].sum() for d, e in iv])
        self.din = delta[D - 1] / b
        self.dout = delta[E] / b
        self.tail = delta[workload.n] / b
        alloc = np.asarray(mapping.alloc, dtype=np.int64)
        self.rate = platform.s[alloc].astype(float)   # append-order running sums
        self.smin = platform.s[alloc].astype(float)

    def metrics(self, rate: np.ndarray, smin: np.ndarray) -> tuple:
        """(period, latency) of one group summary — elementwise arrays, with
        the reference's chain-order latency accumulation."""
        cyc = self.din + self.wsum / rate + self.dout
        lat_terms = self.din + self.wsum / smin
        lat = 0.0
        for t in lat_terms:            # reference order: interval chain, then tail
            lat += float(t)
        return float(max(cyc.max(), 0.0)), float(lat + self.tail)

    def candidate_metrics(self, j: int, cand_speeds: np.ndarray) -> np.ndarray:
        """Stacked enumeration: (period, latency) for EVERY candidate
        processor joining bottleneck group ``j``, in one (F, m) numpy
        evaluation — the deal analogue of ``evaluate_batch`` replacing the
        per-candidate ``_deal_metrics`` Python loops.  Returns (F, 2)."""
        F = cand_speeds.size
        rate = np.broadcast_to(self.rate, (F, self.rate.size)).copy()
        smin = np.broadcast_to(self.smin, (F, self.smin.size)).copy()
        rate[:, j] = self.rate[j] + cand_speeds
        smin[:, j] = np.minimum(self.smin[j], cand_speeds)
        cyc = self.din[None] + self.wsum[None] / rate + self.dout[None]
        lat_terms = self.din[None] + self.wsum[None] / smin
        out = np.empty((F, 2))
        out[:, 0] = np.maximum(cyc.max(axis=1), 0.0)
        for f in range(F):             # chain-order accumulation per candidate
            lat = 0.0
            for t in lat_terms[f]:
                lat += float(t)
            out[f, 1] = lat + self.tail
        return out

    def accept(self, j: int, speed: float) -> None:
        self.rate[j] += speed
        self.smin[j] = min(self.smin[j], speed)


def plan_with_deal(workload: Workload, platform: Platform,
                   objective: Optional[Objective] = None,
                   mode: str = "auto", device=None) -> DealPlan:
    """Base interval plan + greedy deal-replication of the bottleneck stage.

    Back-compat facade: the base plan goes through the PlanRequest portfolio
    (explicit heuristic/exact modes fall back to the ``plan()`` facade).
    Candidate evaluation runs through the stacked-numpy :class:`_DealState`
    (one array expression per greedy step over all free candidates) instead
    of per-mapping Python loops; results are bit-identical to the
    ``_deal_metrics`` reference.  Split scoring runs on ``device``
    (``None``: the enclosing block's device, else CUDA)."""
    with scoring_device(device):
        return _plan_with_deal(workload, platform, objective or Objective("period"),
                               mode)


def _plan_with_deal(workload: Workload, platform: Platform, objective: Objective,
                    mode: str) -> DealPlan:
    if mode == "auto":
        from .planner import InfeasiblePlan

        report = plan_request(auto_request(workload, platform, objective))
        if report.plan is None:
            raise InfeasiblePlan(
                f"no planner produced a feasible mapping for {objective}")
        base = dataclasses.replace(report.plan,
                                   planner=f"auto({report.chosen.solver})")
    else:
        base = plan(workload, platform, objective, mode=mode)
    used = set(base.mapping.alloc)
    free = [int(u) for u in platform.sorted_indices() if int(u) not in used]
    groups = [[u] for u in base.mapping.alloc]

    st = _DealState(workload, platform, base.mapping)
    per, lat = st.metrics(st.rate, st.smin)
    while free:
        # bottleneck interval under the current group rates
        cyc = st.din + st.wsum / st.rate + st.dout
        j = int(np.argmax(cyc))
        # the greedy only ever enrolls the fastest free processor, so only
        # that one candidate is evaluated (stacked-numpy interval math); the
        # full-enumeration batch lives in candidate_metrics for sweep callers
        cands = st.candidate_metrics(j, platform.s[free[:1]])
        new_per, new_lat = float(cands[0, 0]), float(cands[0, 1])
        if new_per >= per - 1e-12:
            break                      # bottleneck is communication-bound
        if objective.minimize == "period" and objective.bound is not None \
                and new_lat > objective.bound + 1e-12:
            break
        cand = free.pop(0)
        groups[j].append(cand)
        st.accept(j, float(platform.s[cand]))
        per, lat = new_per, new_lat
    return DealPlan(base=base, groups=tuple(tuple(g) for g in groups),
                    period=per, latency=lat)


@register_solver("deal", optimizes="period", supports_groups=True,
                 description="interval plan + greedy deal-replication of the "
                             "bottleneck stage over unused processors")
def _solve_deal(workload, platform, objective):
    """Registry entry for the deal extension: only selected by requests with
    ``allow_groups=True`` (or an explicit include).  Scores on the device of
    the enclosing block."""
    dp = plan_with_deal(workload, platform, objective)
    return Solution(mapping=dp.base.mapping, groups=dp.groups,
                    period=dp.period, latency=dp.latency)
