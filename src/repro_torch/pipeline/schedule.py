"""Pipeline schedules.

The runtime executes a synchronous GPipe-style schedule: with S stages and M
microbatches, tick t has stage s working on microbatch (t - s); total ticks
M + S - 1; bubble fraction (S-1)/(M+S-1).  The paper's period/latency map
directly: steady-state period = max stage cycle time (Eq. 1), fill latency =
sum of stage times along the chain (Eq. 2).

The port's own copy of ``repro.pipeline.schedule`` (plain Python).
"""

from __future__ import annotations


def gpipe_ticks(num_stages: int, num_microbatches: int) -> int:
    return num_microbatches + num_stages - 1


def stage_microbatch(tick: int, stage: int) -> int:
    """Microbatch index stage ``stage`` works on at ``tick`` (may be out of range)."""
    return tick - stage


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / gpipe_ticks(num_stages, num_microbatches)


def predicted_step_time(plan_period: float, plan_latency: float,
                        num_microbatches: int) -> float:
    """Paper metrics -> pipeline step time: fill (latency) + (M-1) periods."""
    return plan_latency + (num_microbatches - 1) * plan_period
