"""Interval mappings and the paper's two metrics (Eq. 1 and Eq. 2).

A mapping is a partition of stages [1..n] into m <= p intervals
I_j = [d_j, e_j] (1-indexed, consecutive, covering) together with an
allocation of each interval to a *distinct* processor.

    T_period  = max_j ( delta[d_j-1]/b + sum(w[d_j..e_j])/s_alloc(j) + delta[e_j]/b )
    T_latency = sum_j ( delta[d_j-1]/b + sum(w[d_j..e_j])/s_alloc(j) ) + delta[n]/b

The reliability sequel (arXiv 0711.1231) adds a third criterion:
processors fail independently with probability ``Platform.fail[u]``, and an
interval replicated on a *set* of processors survives unless all replicas
fail.  :class:`ReplicatedMapping` models that allocation (disjoint replica
sets), with period/latency charged at the SLOWEST replica of each interval
(the consensus model: every replica processes every data set), and

    reliability = prod_j ( 1 - prod_{u in alloc_j} fail_u )

The port's own copy of ``repro.core.metrics``.  It stays numpy on the host on
purpose: ``w[d-1:e].sum()`` is numpy's pairwise summation, which no torch
reduction reproduces bit for bit, and the reported metrics are defined by it.
The two reliability formulas are the reference's too: a plain batch takes
``np.prod`` over its rows, a replicated one and the scalar
:func:`reliability` a Python-float loop; they round differently.
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


@dataclasses.dataclass(frozen=True)
class ReplicatedMapping:
    """Interval mapping where interval j runs replicated on the processor SET
    ``groups[j]`` (sets disjoint across intervals).  Consensus model of the
    sequel paper: every replica processes every data set, so the interval's
    compute speed is its slowest replica's, and the interval fails only if
    ALL replicas fail.  ``groups[j][0]`` is the interval's leader (the base
    mapping's processor in the greedy replication solvers)."""

    intervals: tuple  # tuple[tuple[int, int], ...], 1-indexed as in Mapping
    groups: tuple     # tuple[tuple[int, ...], ...] — replica set per interval

    def __post_init__(self):
        object.__setattr__(self, "intervals", tuple((int(d), int(e)) for d, e in self.intervals))
        object.__setattr__(self, "groups", tuple(tuple(int(u) for u in g) for g in self.groups))
        if len(self.intervals) != len(self.groups):
            raise ValueError("one replica set per interval")
        if any(len(g) == 0 for g in self.groups):
            raise ValueError("empty replica set")

    @property
    def m(self) -> int:
        return len(self.intervals)

    @property
    def alloc(self) -> tuple:
        """Leader processor per interval (first replica)."""
        return tuple(g[0] for g in self.groups)

    def leader_mapping(self) -> Mapping:
        """The plain (non-replicated) mapping of the group leaders."""
        return Mapping(intervals=self.intervals, alloc=self.alloc)

    def validate(self, n: int, p: int) -> None:
        """Partition conditions of Mapping.validate plus global disjointness
        of the replica sets."""
        self.leader_mapping().validate(n, p)
        flat = [u for g in self.groups for u in g]
        if len(set(flat)) != len(flat):
            raise ValueError("replica sets must be disjoint")
        for u in flat:
            if not (0 <= u < p):
                raise ValueError(f"processor {u} out of range")


def _interval_speeds(platform: Platform, mapping) -> np.ndarray:
    """Per-interval effective compute speed: the allocated processor's speed
    for a Mapping; the slowest replica's (consensus model) for a
    ReplicatedMapping.  A singleton replica set yields exactly the leader's
    speed, keeping the degenerate case bit-identical to the plain path."""
    if isinstance(mapping, ReplicatedMapping):
        s = platform.s
        return np.array([s[list(g)].min() for g in mapping.groups])
    return platform.s[np.asarray(mapping.alloc, dtype=np.int64)]


def interval_cycle_times(workload: Workload, platform: Platform, mapping) -> np.ndarray:
    """Per-interval cycle time: in-comm + compute + out-comm (the max of these is the period)."""
    w, delta, b = workload.w, workload.delta, platform.b
    sp = _interval_speeds(platform, mapping)
    out = np.empty(mapping.m)
    for j, (d, e) in enumerate(mapping.intervals):
        out[j] = delta[d - 1] / b + w[d - 1 : e].sum() / sp[j] + delta[e] / b
    return out


def period(workload: Workload, platform: Platform, mapping) -> float:
    """Eq. (1)."""
    return float(interval_cycle_times(workload, platform, mapping).max())


def latency(workload: Workload, platform: Platform, mapping) -> float:
    """Eq. (2)."""
    w, delta, b = workload.w, workload.delta, platform.b
    sp = _interval_speeds(platform, mapping)
    tot = 0.0
    for j, (d, e) in enumerate(mapping.intervals):
        tot += delta[d - 1] / b + w[d - 1 : e].sum() / sp[j]
    return float(tot + delta[workload.n] / b)


def reliability(workload: Workload, platform: Platform, mapping) -> float:
    """Sequel metric: R = prod_j (1 − prod_{u ∈ alloc_j} f_u).

    Accepts both Mapping (each interval a single processor) and
    ReplicatedMapping.  With ``platform.fail`` unset every processor is
    perfectly reliable and R == 1.0 exactly."""
    if platform.fail is None:
        return 1.0
    f = platform.fail
    groups = (mapping.groups if isinstance(mapping, ReplicatedMapping)
              else tuple((a,) for a in mapping.alloc))
    r = 1.0
    for g in groups:
        miss = 1.0
        for u in g:
            miss *= float(f[u])
        r *= 1.0 - miss
    return float(r)


def evaluate(workload: Workload, platform: Platform, mapping) -> tuple:
    """(period, latency) for a mapping."""
    return (period(workload, platform, mapping), latency(workload, platform, mapping))


def evaluate_tri(workload: Workload, platform: Platform, mapping) -> tuple:
    """(period, latency, reliability) for a Mapping or ReplicatedMapping."""
    return (period(workload, platform, mapping),
            latency(workload, platform, mapping),
            reliability(workload, platform, mapping))


def single_processor_mapping(workload: Workload, proc: int) -> Mapping:
    return Mapping(intervals=((1, workload.n),), alloc=(proc,))


def optimal_latency(workload: Workload, platform: Platform) -> float:
    """Lemma 1: minimum latency = whole chain on the fastest processor."""
    m = single_processor_mapping(workload, platform.fastest())
    return latency(workload, platform, m)


def evaluate_batch(workload: Workload, platform: Platform,
                   mappings: Sequence[Mapping], *,
                   with_reliability: bool = False) -> np.ndarray:
    """Vectorized ``evaluate`` over a batch of mappings.

    Returns an array of shape (len(mappings), 2): column 0 the period (Eq. 1),
    column 1 the latency (Eq. 2).  With ``with_reliability=True`` a third
    column carries the sequel's reliability metric.  Mappings are stacked
    into (B, m) index arrays per interval count, with the reference's
    expressions in numpy.  ReplicatedMapping entries are allowed (their
    compute speed is the group minimum, reliability the survival product).
    """
    out = np.empty((len(mappings), 3 if with_reliability else 2))
    if not len(mappings):
        return out
    pre = workload.prefix_w()
    delta, b, s = workload.delta, platform.b, platform.s
    fail = platform.fail
    tail = delta[workload.n] / b
    by_m: dict = {}
    for i, mp in enumerate(mappings):
        by_m.setdefault(mp.m, []).append(i)
    for idxs in by_m.values():
        iv = np.array([mappings[i].intervals for i in idxs])   # (B, m, 2)
        D, E = iv[:, :, 0], iv[:, :, 1]
        plain = all(not isinstance(mappings[i], ReplicatedMapping) for i in idxs)
        if plain:
            al = np.array([mappings[i].alloc for i in idxs])   # (B, m)
            sp = s[al]
        else:
            sp = np.array([[s[list(g)].min() for g in
                            (mappings[i].groups if isinstance(mappings[i], ReplicatedMapping)
                             else tuple((a,) for a in mappings[i].alloc))]
                           for i in idxs])
        lat_terms = delta[D - 1] / b + (pre[E] - pre[D - 1]) / sp
        cyc = lat_terms + delta[E] / b
        ix = np.asarray(idxs)
        out[ix, 0] = cyc.max(axis=1)
        out[ix, 1] = lat_terms.sum(axis=1) + tail
        if with_reliability:
            if fail is None:
                out[ix, 2] = 1.0
            elif plain:
                out[ix, 2] = np.prod(1.0 - fail[al], axis=1)
            else:
                out[ix, 2] = [reliability(workload, platform, mappings[i])
                              for i in idxs]
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
