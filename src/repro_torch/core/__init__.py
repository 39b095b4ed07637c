"""Core planner library of the port: the workload/platform/metrics host
layer (own numpy copies), the split scoring, and the lockstep engine
(:mod:`repro_torch.core.batched`, imported on its own)."""

from .workload import Workload, make_workload, uniform_workload
from .platform import Platform, make_platform
from .metrics import (Mapping, evaluate, latency, optimal_latency, period,
                      single_processor_mapping)
from .heuristics import HeuristicResult, score_2way, score_3way, score_kernels

__all__ = ["Workload", "make_workload", "uniform_workload", "Platform",
           "make_platform", "Mapping", "evaluate", "latency",
           "optimal_latency", "period", "single_processor_mapping",
           "HeuristicResult", "score_2way", "score_3way", "score_kernels"]
