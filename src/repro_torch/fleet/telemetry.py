"""Drift telemetry: event types, synthetic burst traces, deterministic replay.

A fleet is a set of pipeline instances, many of them replicas of the same
(workload, platform) template — the situation that makes dedup worthwhile.
Drift arrives as a stream of per-instance events:

  - :class:`StageTimings`   — raw per-stage step times (what a live serving
    loop reports; feeds the instance's ``StragglerMonitor``)
  - :class:`StageDrift`     — a stage slowed down by a discrete factor (what
    the synthetic generator emits; expanded to timings in-service)
  - :class:`PodCountChange` — preemption / autoscale resize to a target count
  - :class:`PodFailure`     — a pod died (the sequel paper's failure events)

The burst-trace generator models *correlated* infrastructure events: on a
burst tick every replica of a hit group receives the identical event, and
drift factors come from a small discrete set — so degraded platforms collide
bit-wise across replicas and the service's signature dedup has real work to
do.  Background noise hits single instances and breaks some of that sharing,
which is what keeps the dedup hit-rate an honest measurement.

Everything is driven by one ``numpy`` Generator seed: generating a trace twice
with the same seed yields equal traces, and replaying a trace through the
service is deterministic.  The port's copy: the same seeds give the same
instances (through the port's own ``gen_instance``) and the same events as
``repro.fleet.telemetry`` (tests/test_torch_fleet.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..sim.generators import gen_instance


# ---------------------------------------------------------------------------
# Event types
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageTimings:
    """Measured per-stage step times for one instance (seconds per stage of
    the *current plan*, chain order)."""

    instance: int
    times: tuple


@dataclasses.dataclass(frozen=True)
class StageDrift:
    """Stage ``stage`` of ``instance``'s *current plan* runs ``factor`` times
    slower than predicted.  An out-of-range stage is a stale event from a
    pre-replan plan shape; the service drops it (like stale StageTimings)
    rather than remapping it onto an arbitrary stage."""

    instance: int
    stage: int
    factor: float


@dataclasses.dataclass(frozen=True)
class PodCountChange:
    """Autoscale / preemption: resize ``instance`` to ``num_pods`` pods."""

    instance: int
    num_pods: int


@dataclasses.dataclass(frozen=True)
class PodFailure:
    """Pod ``pod`` (mod the instance's current pod count) of ``instance``
    failed and is removed from the platform."""

    instance: int
    pod: int


@dataclasses.dataclass(frozen=True)
class Trace:
    """A replayable event stream: ``ticks[t]`` is the tuple of events that
    arrive during tick ``t``."""

    ticks: tuple
    seed: Optional[int] = None

    @property
    def num_ticks(self) -> int:
        return len(self.ticks)

    @property
    def num_events(self) -> int:
        return sum(len(t) for t in self.ticks)


# ---------------------------------------------------------------------------
# Wire codec (the write-ahead journal's record payload)
# ---------------------------------------------------------------------------

_EVENT_TYPES = {cls.__name__: cls
                for cls in (StageTimings, StageDrift, PodCountChange,
                            PodFailure)}


def event_to_wire(ev) -> list:
    """``[type_name, field_dict]`` with only JSON scalars: the journal's
    payload format.  Floats survive JSON exactly (shortest-repr round-trip),
    so a replayed event is bit-identical to the applied one."""
    cls = type(ev).__name__
    if isinstance(ev, StageTimings):
        return [cls, {"instance": int(ev.instance),
                      "times": [float(t) for t in ev.times]}]
    if isinstance(ev, StageDrift):
        return [cls, {"instance": int(ev.instance), "stage": int(ev.stage),
                      "factor": float(ev.factor)}]
    if isinstance(ev, PodCountChange):
        return [cls, {"instance": int(ev.instance),
                      "num_pods": int(ev.num_pods)}]
    if isinstance(ev, PodFailure):
        return [cls, {"instance": int(ev.instance), "pod": int(ev.pod)}]
    raise TypeError(f"unknown fleet event {cls}")


def event_from_wire(obj):
    """Inverse of :func:`event_to_wire`."""
    try:
        name, fields = obj
        cls = _EVENT_TYPES[name]
    except (ValueError, TypeError, KeyError):
        raise ValueError(f"malformed wire event {obj!r}") from None
    if cls is StageTimings:
        return StageTimings(int(fields["instance"]),
                            tuple(float(t) for t in fields["times"]))
    return cls(**fields)


# ---------------------------------------------------------------------------
# Fleet + trace synthesis
# ---------------------------------------------------------------------------

def make_fleet(n_groups: int, replicas: int, n: int, p: int,
               seed: int = 0, exp: str = "E2") -> tuple:
    """A fleet of ``n_groups * replicas`` instances: each group is one random
    (workload, platform) template from the Section-5 generators, shared
    verbatim by its replicas.  Returns (pairs, groups) where ``pairs`` is the
    flat [(workload, platform), ...] list (instance id = position) and
    ``groups`` the list of per-group instance-id lists."""
    pairs, groups = [], []
    for g in range(n_groups):
        wl, pf = gen_instance(exp, n, p, seed=seed + g)
        ids = []
        for _ in range(replicas):
            ids.append(len(pairs))
            pairs.append((wl, pf))
        groups.append(ids)
    return pairs, groups


def gen_burst_trace(
    groups: Sequence[Sequence[int]],
    num_ticks: int,
    seed: int = 0,
    *,
    n_stages: int = 8,
    initial_pods: int = 4,
    burst_prob: float = 0.5,
    noise_per_tick: int = 1,
    drift_factors: Sequence[float] = (1.5, 2.0, 3.0),
) -> Trace:
    """Synthesize a correlated burst trace over the given instance groups.

    Per tick, with probability ``burst_prob`` a *burst* hits a random subset
    of groups; every replica of a hit group receives the identical event
    (drift 70% / resize 20% / failure 10%, parameters drawn from discrete
    sets).  Independently, ``noise_per_tick`` uncorrelated single-instance
    drift events fire each tick.  Same seed, same trace.
    """
    rng = np.random.default_rng(seed)
    all_ids = [i for g in groups for i in g]
    factors = np.asarray(drift_factors, dtype=float)
    ticks = []
    for _ in range(num_ticks):
        events = []
        if rng.random() < burst_prob:
            n_hit = 1 + int(rng.integers(max(1, len(groups) // 2)))
            hit = rng.choice(len(groups), size=min(n_hit, len(groups)),
                             replace=False)
            for gi in hit:
                kind = rng.random()
                if kind < 0.7:
                    stage = int(rng.integers(n_stages))
                    factor = float(factors[rng.integers(len(factors))])
                    events += [StageDrift(i, stage, factor) for i in groups[gi]]
                elif kind < 0.9:
                    target = int(rng.integers(max(1, initial_pods // 2),
                                              initial_pods + 2))
                    events += [PodCountChange(i, target) for i in groups[gi]]
                else:
                    pod = int(rng.integers(initial_pods))
                    events += [PodFailure(i, pod) for i in groups[gi]]
        for _ in range(noise_per_tick):
            iid = int(all_ids[rng.integers(len(all_ids))])
            stage = int(rng.integers(n_stages))
            factor = float(factors[rng.integers(len(factors))])
            events.append(StageDrift(iid, stage, factor))
        ticks.append(tuple(events))
    return Trace(ticks=tuple(ticks), seed=seed)
