"""Interval mappings and the paper's two metrics (Eq. 1 and Eq. 2).

A mapping is a partition of stages [1..n] into m <= p intervals
I_j = [d_j, e_j] (1-indexed, consecutive, covering) together with an
allocation of each interval to a *distinct* processor.

    T_period  = max_j ( delta[d_j-1]/b + sum(w[d_j..e_j])/s_alloc(j) + delta[e_j]/b )
    T_latency = sum_j ( delta[d_j-1]/b + sum(w[d_j..e_j])/s_alloc(j) ) + delta[n]/b

The port's own copy of the part of ``repro.core.metrics`` the campaign and
the planner use (the replicated mappings of the reliability sequel are not
ported yet).  It stays numpy on the host on purpose: ``w[d-1:e].sum()`` is
numpy's pairwise summation, which no torch reduction reproduces bit for bit,
and the reported metrics are defined by it.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Sequence

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

    def validate(self, n: int, p: int) -> None:
        """Check the partition conditions of the paper (d_1=1, d_{j+1}=e_j+1, e_m=n)
        and that allocated processors are distinct and in range."""
        if self.m == 0:
            raise ValueError("empty mapping")
        if self.m > p:
            raise ValueError(f"more intervals ({self.m}) than processors ({p})")
        d0, _ = self.intervals[0]
        if d0 != 1:
            raise ValueError("first interval must start at stage 1")
        prev_e = 0
        for (d, e) in self.intervals:
            if d != prev_e + 1:
                raise ValueError(f"interval [{d},{e}] does not follow previous end {prev_e}")
            if e < d:
                raise ValueError(f"empty interval [{d},{e}]")
            prev_e = e
        if prev_e != n:
            raise ValueError(f"last interval ends at {prev_e}, expected n={n}")
        if len(set(self.alloc)) != len(self.alloc):
            raise ValueError("processors must be distinct")
        for a in self.alloc:
            if not (0 <= a < p):
                raise ValueError(f"processor {a} out of range")


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


def evaluate_batch(workload: Workload, platform: Platform,
                   mappings: Sequence[Mapping]) -> np.ndarray:
    """Vectorized ``evaluate`` over a batch of mappings.

    Returns an array of shape (len(mappings), 2): column 0 the period (Eq. 1),
    column 1 the latency (Eq. 2).  Mappings are stacked into (B, m) index
    arrays per interval count, with the reference's expressions in numpy.
    (The reference's reliability column comes with the replicated mappings,
    which are not ported yet.)
    """
    out = np.empty((len(mappings), 2))
    if not len(mappings):
        return out
    pre = workload.prefix_w()
    delta, b, s = workload.delta, platform.b, platform.s
    tail = delta[workload.n] / b
    by_m: dict = {}
    for i, mp in enumerate(mappings):
        by_m.setdefault(mp.m, []).append(i)
    for idxs in by_m.values():
        iv = np.array([mappings[i].intervals for i in idxs])   # (B, m, 2)
        D, E = iv[:, :, 0], iv[:, :, 1]
        al = np.array([mappings[i].alloc for i in idxs])       # (B, m)
        sp = s[al]
        lat_terms = delta[D - 1] / b + (pre[E] - pre[D - 1]) / sp
        cyc = lat_terms + delta[E] / b
        ix = np.asarray(idxs)
        out[ix, 0] = cyc.max(axis=1)
        out[ix, 1] = lat_terms.sum(axis=1) + tail
    return out


def intervals_from_cuts(n: int, cuts: Sequence[int]) -> tuple:
    """cuts = sorted interior cut points; cut c means a boundary between stage c and c+1.
    Returns the interval tuple for Mapping."""
    prev = 1
    out = []
    for c in cuts:
        out.append((prev, c))
        prev = c + 1
    out.append((prev, n))
    return tuple(out)


def all_interval_partitions(n: int, m: int) -> Iterable[tuple]:
    """Yield every partition of [1..n] into exactly m intervals (as interval tuples)."""
    for cuts in itertools.combinations(range(1, n), m - 1):
        yield intervals_from_cuts(n, cuts)
