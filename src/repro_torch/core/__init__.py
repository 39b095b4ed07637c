"""Core planner library of the port: Benoit/Rehn-Sonigo/Robert 2007,
bi-criteria pipeline mapping.

The planning surface is the solver registry (:mod:`repro_torch.core.solvers`)
plus the request/report protocol (:mod:`repro_torch.core.planner`):

    req = PlanRequest(workload, platform, Objective("period"))
    report = plan_request(req)        # -> PlanReport with provenance + Pareto
    front = plan_pareto(workload, platform)   # Pareto-first planning

plus the reliability sequel's tri-criteria planning
(:func:`~repro_torch.core.replication.plan_pareto_tri`) and the deal
extension (:func:`~repro_torch.core.deal.plan_with_deal`), whose grouped
solvers register after the ungrouped ones, as in the reference.

Every entry point that reaches split scoring takes ``device=None`` (CUDA).
The workload/platform/metrics host layer and the exact solvers are numpy
copies of the reference's.  The lockstep engine's batched entry points
(:mod:`repro_torch.core.batched`) are re-exported as the reference's are,
but resolved at first use (:func:`__getattr__`): ``batched`` imports
``repro_torch.kernels.split_score``, which imports this package's
heuristics, so importing it here would make ``import
repro_torch.kernels.split_score`` circular.
"""

from .workload import Workload, make_workload, uniform_workload
from .platform import (Platform, homogeneous_platform, make_platform,
                       sample_failures, tpu_pod_platform)
from .metrics import (Mapping, ReplicatedMapping, all_interval_partitions,
                      evaluate, evaluate_batch, evaluate_tri,
                      interval_cycle_times, intervals_from_cuts, latency,
                      optimal_latency, period, reliability,
                      single_processor_mapping)
from .heuristics import (FIXED_LATENCY_HEURISTICS, FIXED_PERIOD_HEURISTICS,
                         NAMES, HeuristicResult, ScoringDeviceError, explo3_bi,
                         explo3_mono, min_period_exhaustive, run_heuristic,
                         score_2way, score_3way, score_kernels, scoring_device,
                         sp_bi_l, sp_bi_p, sp_mono_l, sp_mono_p)
from .exact import (brute_force, dp_homogeneous_period, dp_speed_ordered,
                    exact_min_latency, exact_min_period, pareto_exact)
from .pareto import (pareto_front, pareto_front_tri, sweep_heuristic,
                     sweep_solver, tradeoff_curves)
from .solvers import (Candidate, Solution, SolverSpec, applicable, get_solver,
                      register_solver, registered_solvers, solve, solver_names)
from .planner import (AUTO_PORTFOLIO, SELECTION_POLICIES, InfeasiblePlan,
                      Objective, PlanReport, PlanRequest, StagePlan,
                      auto_request, plan, plan_pareto, plan_request,
                      register_selection, replan_for_straggler)
# deal before replication: registration order is the candidates' order
from .deal import DealPlan, plan_with_deal
from .replication import (plan_pareto_tri, replicate_greedy,
                          replicate_stage_plan)

__all__ = [
    "Workload", "make_workload", "uniform_workload",
    "Platform", "make_platform", "homogeneous_platform", "sample_failures",
    "tpu_pod_platform",
    "Mapping", "ReplicatedMapping", "period", "latency", "reliability",
    "evaluate", "evaluate_batch", "evaluate_tri",
    "interval_cycle_times", "optimal_latency", "single_processor_mapping",
    "intervals_from_cuts", "all_interval_partitions",
    "HeuristicResult", "run_heuristic", "NAMES",
    "FIXED_PERIOD_HEURISTICS", "FIXED_LATENCY_HEURISTICS",
    "min_period_exhaustive",
    "sp_mono_p", "explo3_mono", "explo3_bi", "sp_bi_p", "sp_mono_l", "sp_bi_l",
    "ProblemBatch", "batched_fixed_latency", "batched_min_period", "batched_sp_bi_p",
    "batched_trajectories", "stack_instances",
    "ScoringDeviceError", "score_2way", "score_3way", "score_kernels",
    "scoring_device",
    "brute_force", "exact_min_period", "exact_min_latency",
    "dp_homogeneous_period", "dp_speed_ordered", "pareto_exact",
    "pareto_front", "pareto_front_tri", "tradeoff_curves", "sweep_heuristic",
    "sweep_solver",
    "Candidate", "Solution", "SolverSpec", "applicable", "get_solver",
    "register_solver", "registered_solvers", "solve", "solver_names",
    "AUTO_PORTFOLIO", "InfeasiblePlan", "Objective", "PlanReport", "PlanRequest",
    "SELECTION_POLICIES", "StagePlan", "auto_request", "plan", "plan_pareto",
    "plan_request", "register_selection", "replan_for_straggler",
    "DealPlan", "plan_with_deal",
    "plan_pareto_tri", "replicate_greedy", "replicate_stage_plan",
]

_BATCHED = ("ProblemBatch", "batched_fixed_latency", "batched_min_period", "batched_sp_bi_p",
            "batched_trajectories", "stack_instances")


def __getattr__(name: str):
    """The batched entry points, imported at first use (module docstring)."""
    if name in _BATCHED:
        from . import batched

        return getattr(batched, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
