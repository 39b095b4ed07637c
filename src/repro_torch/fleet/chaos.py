"""Fault injection for telemetry traces: storms, flapping, delivery faults.

The burst-trace generator (:mod:`repro_torch.fleet.telemetry`) models *planned*
drift.  This module composes the unplanned kind on top of any ``Trace``:

  - **pod-failure storms** — on a storm tick, several groups lose several
    pods at once, every replica of a hit group identically (correlated
    infrastructure failure: a rack, a power domain);
  - **flapping pods** — a group loses a pod and gets its capacity restored a
    few ticks later (``PodCountChange`` back to the nominal count), the
    oscillation that defeats naive keep-last-plan caching;
  - **delivery faults** — each event is independently dropped or duplicated,
    and a tick's event order may be shuffled, modeling an at-least-once
    telemetry bus with no ordering guarantee;
  - **controller crashes** — :func:`crash_restart_run` kills the controller
    mid-tick (after the write-ahead append, before any state mutates) at
    chosen ticks and restarts it from its journal, asserting the
    crash-safety contract end to end: the survivor finishes the trace with
    a ``fleet_digest()`` bit-identical to an uninterrupted run and zero
    invalid published ticks;
  - **worker/transport faults** — :class:`TransportChaos` (defined in
    :mod:`repro_torch.fleet.transport`, re-exported here) attacks the subprocess
    worker plane: dead-on-arrival spawns, SIGKILL mid-solve, in-band wedges,
    and drop/corrupt/truncate/delay on the reply wire.  Telemetry chaos asks
    "do bad *inputs* break the plan?"; transport chaos asks "do bad
    *executors* break the controller?".

Everything is driven by one seeded ``numpy`` Generator: ``inject_chaos`` is a
pure function of (trace, groups, spec, seed), so a chaos trace replays
bit-identically (asserted in tests/test_torch_fleet.py) and every run is
debuggable.  With :class:`ChaosSpec` probabilities at zero the input trace
comes back unchanged — chaos-disabled paths are byte-identical.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from .telemetry import PodCountChange, PodFailure, Trace
from .transport import TransportChaos  # noqa: F401  (re-exported)


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Fault-injection intensities.  All probabilities are per tick except
    ``drop_prob``/``dup_prob`` which are per event."""

    storm_prob: float = 0.15      # correlated multi-group pod-failure storm
    storm_groups: int = 4         # groups hit per storm
    storm_failures: int = 2       # pods killed per hit instance
    flap_prob: float = 0.15       # one group's pod flaps (fail now, restore later)
    flap_ticks: int = 3           # restore capacity this many ticks later
    drop_prob: float = 0.05       # event silently lost
    dup_prob: float = 0.05        # event delivered twice
    reorder_prob: float = 0.25    # tick's delivery order shuffled

    def __post_init__(self):
        for f in ("storm_prob", "flap_prob", "drop_prob", "dup_prob",
                  "reorder_prob"):
            v = getattr(self, f)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{f} must be a probability, got {v}")
        if self.flap_ticks < 1:
            raise ValueError("flap_ticks must be >= 1")


def inject_chaos(
    trace: Trace,
    groups: Sequence[Sequence[int]],
    spec: ChaosSpec = ChaosSpec(),
    *,
    seed: int = 0,
    initial_pods: int = 4,
) -> Trace:
    """Compose chaos onto ``trace`` and return the new (replayable) Trace.

    Per tick, in order: storm failures and flap failures are appended after
    the tick's planned events (flap restores land ``flap_ticks`` later as
    ``PodCountChange`` back to ``initial_pods``); then the delivery layer
    applies per-event drop/duplication and an optional within-tick shuffle —
    restores travel through the same lossy layer, so a dropped restore
    leaves the group degraded, exactly the pathology the service must absorb.
    """
    rng = np.random.default_rng(seed)
    ticks = [list(t) for t in trace.ticks]
    n_groups = len(groups)
    for t in range(len(ticks)):
        extra = []
        if n_groups and rng.random() < spec.storm_prob:
            hit = rng.choice(n_groups, size=min(spec.storm_groups, n_groups),
                             replace=False)
            for gi in hit:
                pods = rng.integers(0, max(1, initial_pods),
                                    size=spec.storm_failures)
                for pod in pods:
                    extra += [PodFailure(i, int(pod)) for i in groups[int(gi)]]
        if n_groups and rng.random() < spec.flap_prob:
            gi = int(rng.integers(n_groups))
            pod = int(rng.integers(max(1, initial_pods)))
            extra += [PodFailure(i, pod) for i in groups[gi]]
            restore = t + spec.flap_ticks
            if restore < len(ticks):
                ticks[restore].extend(
                    PodCountChange(i, initial_pods) for i in groups[gi])
        delivered = []
        for ev in ticks[t] + extra:
            if rng.random() < spec.drop_prob:
                continue
            delivered.append(ev)
            if rng.random() < spec.dup_prob:
                delivered.append(ev)
        if len(delivered) > 1 and rng.random() < spec.reorder_prob:
            order = rng.permutation(len(delivered))
            delivered = [delivered[int(k)] for k in order]
        ticks[t] = delivered
    return Trace(ticks=tuple(tuple(t) for t in ticks), seed=trace.seed)


class SimulatedCrash(RuntimeError):
    """The injected kill signal: raised from the controller's crash hook at
    the worst possible moment — the tick's events are on disk but no state
    has mutated (the write-ahead window a real ``kill -9`` would hit)."""


def crash_restart_run(instances, trace: Trace, journal_dir, *,
                      crash_ticks: Sequence[int] = (),
                      restore_supervisor=None, **service_kwargs):
    """Run ``trace`` over a journaled service, killing and restarting the
    controller at each tick in ``crash_ticks``.

    The crash fires via ``ReplanService.crash_hook`` right after the tick's
    write-ahead append; the replacement controller is built with
    :meth:`ReplanService.restore` from the same journal directory and
    resumes the trace where the corpse left off.  Events are neither lost
    nor double-applied: the crashed tick's events are already in the WAL, so
    replay applies them exactly once.

    Returns ``(service, restarts)`` — the surviving service (which has
    processed the full trace) and one dict per injected crash with the
    restart tick, the number of WAL ticks replayed, and the restore wall
    time.  ``service_kwargs`` are forwarded to the initial
    :class:`ReplanService`; ``restore_supervisor`` (optional) is forwarded
    to each ``restore`` call; each restored controller solves on the
    crashed one's device.
    """
    from .service import ReplanService

    remaining = sorted({int(t) for t in crash_ticks})
    svc = ReplanService(instances, journal=journal_dir, **service_kwargs)

    def arm(s):
        def hook(tick):
            if remaining and tick >= remaining[0]:
                remaining.pop(0)
                raise SimulatedCrash(f"injected crash at tick {tick}")
        s.crash_hook = hook

    arm(svc)
    restarts = []
    while True:
        try:
            svc.resume_trace(trace)
            return svc, restarts
        except SimulatedCrash:
            # The corpse's state is garbage by construction; everything the
            # survivor needs is on disk.
            svc.journal.close()
            t0 = time.perf_counter()
            svc = ReplanService.restore(journal_dir,
                                        supervisor=restore_supervisor,
                                        device=svc.device)
            arm(svc)
            restarts.append({"tick": svc.tick_count,
                             "replayed_ticks": svc.replayed_ticks,
                             "restore_wall": time.perf_counter() - t0})
