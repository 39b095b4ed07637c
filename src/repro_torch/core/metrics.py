"""Interval mappings and the paper's two metrics (Eq. 1 and Eq. 2).

A mapping is a partition of stages [1..n] into m <= p intervals
I_j = [d_j, e_j] (1-indexed, consecutive, covering) together with an
allocation of each interval to a *distinct* processor.

    T_period  = max_j ( delta[d_j-1]/b + sum(w[d_j..e_j])/s_alloc(j) + delta[e_j]/b )
    T_latency = sum_j ( delta[d_j-1]/b + sum(w[d_j..e_j])/s_alloc(j) ) + delta[n]/b

The port's own copy of the part of ``repro.core.metrics`` the campaign uses.
It stays numpy on the host on purpose: ``w[d-1:e].sum()`` is numpy's
pairwise summation, which no torch reduction reproduces bit for bit, and the
campaign's reported metrics are defined by it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .platform import Platform
from .workload import Workload


@dataclasses.dataclass(frozen=True)
class Mapping:
    """Interval mapping: intervals[j] = (d_j, e_j) 1-indexed, alloc[j] = processor id."""

    intervals: tuple  # tuple[tuple[int, int], ...]
    alloc: tuple      # tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "intervals", tuple((int(d), int(e)) for d, e in self.intervals))
        object.__setattr__(self, "alloc", tuple(int(a) for a in self.alloc))
        if len(self.intervals) != len(self.alloc):
            raise ValueError("one processor per interval")

    @property
    def m(self) -> int:
        return len(self.intervals)


def interval_cycle_times(workload: Workload, platform: Platform,
                         mapping: Mapping) -> np.ndarray:
    """Per-interval cycle time: in-comm + compute + out-comm (the max of these is the period)."""
    w, delta, b = workload.w, workload.delta, platform.b
    sp = platform.s[np.asarray(mapping.alloc, dtype=np.int64)]
    out = np.empty(mapping.m)
    for j, (d, e) in enumerate(mapping.intervals):
        out[j] = delta[d - 1] / b + w[d - 1 : e].sum() / sp[j] + delta[e] / b
    return out


def period(workload: Workload, platform: Platform, mapping: Mapping) -> float:
    """Eq. (1)."""
    return float(interval_cycle_times(workload, platform, mapping).max())


def latency(workload: Workload, platform: Platform, mapping: Mapping) -> float:
    """Eq. (2)."""
    w, delta, b = workload.w, workload.delta, platform.b
    sp = platform.s[np.asarray(mapping.alloc, dtype=np.int64)]
    tot = 0.0
    for j, (d, e) in enumerate(mapping.intervals):
        tot += delta[d - 1] / b + w[d - 1 : e].sum() / sp[j]
    return float(tot + delta[workload.n] / b)


def evaluate(workload: Workload, platform: Platform, mapping: Mapping) -> tuple:
    """(period, latency) for a mapping."""
    return (period(workload, platform, mapping), latency(workload, platform, mapping))


def single_processor_mapping(workload: Workload, proc: int) -> Mapping:
    return Mapping(intervals=((1, workload.n),), alloc=(proc,))


def optimal_latency(workload: Workload, platform: Platform) -> float:
    """Lemma 1: minimum latency = whole chain on the fastest processor."""
    m = single_processor_mapping(workload, platform.fastest())
    return latency(workload, platform, m)
