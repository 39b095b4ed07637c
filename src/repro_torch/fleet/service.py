"""The fleet controller loop: collect → dedup → warm-start → batch → publish.

Per tick the service applies every arriving drift event to its instance's
state (EWMA straggler monitor, platform degradation, elastic resize, pod
removal), collects the *dirty* instances — those whose effective platform
changed — and answers all of their replan requests together:

  1. each dirty instance's problem is canonicalized and signed
     (:mod:`repro_torch.fleet.signatures`); instances that are the same problem up
     to processor relabeling share one signature,
  2. signatures already in the cross-tick plan cache are warm-start hits:
     the previous solve is reused byte-for-byte (exact-bytes signatures mean
     a hit can never change a result, only skip work),
  3. the remaining distinct problems are grouped by (n, p, b) shape, stacked
     with :meth:`ProblemBatch.from_arrays` on the service's device, and
     solved in two lockstep runs per group via
     :func:`repro_torch.core.batched.batched_min_period` (the lockstep, fused
     or sharded engine, scoring splits with the CUDA kernels on the card) —
     thousands of requests become a handful of engine runs,
  4. every dirty instance receives its plan by remapping the canonical
     allocation through its own speed-sort permutation and is republished as
     a :class:`StagePlan`; its straggler monitor resets to the new stage
     count.

The published plans are bit-identical to running the scalar portfolio
``min_period_exhaustive(workload, platform)`` per instance (relabeling
theorem + the batched engine's equivalence contract), and ``fleet_digest()``
is ``==`` the reference's (``repro.fleet.service``) on the same fleet and
trace (asserted in tests/test_torch_fleet.py).

Device rule: ``device=None`` means CUDA (raising without a card).  A
split-score fault on the card — a kernel that does not build or launch, a
copy, memory — is a :class:`~repro_torch.core.ScoringDeviceError`: it is
raised out of :meth:`ReplanService.tick` (and the constructor), never
retried, never re-solved by the scalar fallback and never struck toward
quarantine, since each of those would hide a card that cannot score behind
stale plans.  Every other solve fault degrades as below.

Graceful degradation (the chaos-harness contract, tests/test_torch_fleet.py):

  - ``solve_deadline`` — a per-tick solve budget in seconds.  Groups past
    the budget are NOT solved this tick: their instances keep their last
    valid plan and are retried next tick.  Instances whose current plan is
    *invalid* (it addresses pods that no longer exist) are never deferred —
    their groups solve regardless of the budget, which is what guarantees
    zero ticks ending with an invalid published plan.
  - supervised workers — each solve group is dispatched to a worker actor
    (:mod:`repro_torch.fleet.supervision`): per-group timeout, exponential-backoff
    retries, heartbeat-based worker restarts.  A group the workers cannot
    solve is re-solved per member with the scalar reference portfolio
    (bit-identical by the equivalence contract), so one poisoned batch
    degrades throughput, not correctness.
  - poison quarantine — a canonical problem that fails the batched solve
    *and* the scalar fallback ``quarantine_after`` times is quarantined: its
    subscribers keep their last valid plan (counted per tick in
    ``FleetMetrics.quarantined_requests``) and the problem is never retried
    until drift changes its signature — a poison problem costs a metric, not
    a wedged tick loop.
  - ``reliability_floor`` — when platforms carry failure probabilities, any
    instance whose plan's reliability drops below the floor gets a greedy
    replication pass (:func:`repro_torch.core.replication.replicate_stage_plan`);
    time spent below the floor and recovery latency are counted in
    :class:`FleetMetrics`.

Durability (the crash-safety contract, tests/test_torch_fleet_recovery.py):
pass ``journal=`` (a directory or a
:class:`repro_torch.fleet.journal.Journal`) and the service write-ahead-logs every
tick's events *before* mutating state and snapshots its full state (the
instances with their effective platforms, plans, monitors, the plan cache in
LRU order, ``_pending``, ``_below_since``, quarantine state, and metrics —
RNG-free by construction) every ``Journal.snapshot_every`` ticks with
CRC-checked, atomic-rename writes.  :meth:`ReplanService.restore` rebuilds
the controller from the newest snapshot and replays the WAL tail through the
ordinary ``tick()`` path; determinism of replay makes the restored
``fleet_digest()`` bit-identical to an uninterrupted run.  The journal is
byte-compatible with the reference's, so :meth:`ReplanService.restore` also
reads a journal the reference wrote (its ``numpy``/``jax``/``pallas``
backends become ``lockstep`` on the restoring service's device).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import pathlib
import time
from typing import Callable, Optional, Sequence

import numpy as np

from .. import resolve_device
from ..core import (Mapping, Platform, ReplicatedMapping, ScoringDeviceError,
                    StagePlan, interval_cycle_times, min_period_exhaustive,
                    reliability, scoring_device)
from ..core.batched import BACKENDS, ProblemBatch, batched_min_period
from ..core.planner import _realize
from ..core.replication import replicate_stage_plan
from ..pipeline.replan import StragglerMonitor, elastic_platform
from .journal import (Journal, JournalError, decode_monitor, decode_plan,
                      decode_platform, decode_result, decode_workload,
                      encode_monitor, encode_plan, encode_platform,
                      encode_result, encode_workload)
from .metrics import FleetMetrics
from .signatures import canonicalize, remap_alloc, signature
from .supervision import Supervisor
from .telemetry import (PodCountChange, PodFailure, StageDrift, StageTimings,
                        Trace, event_from_wire)

#: Engines ``batched_min_period`` accepts; validated up front so a typo fails
#: at construction, not deep inside the first tick's solve.
KNOWN_BACKENDS = BACKENDS

#: The reference's backends, as a journal it wrote names them: each is the
#: lockstep engine here, on the restoring service's device.
_REFERENCE_BACKENDS = {"numpy": "lockstep", "jax": "lockstep",
                       "pallas": "lockstep"}

#: Default LRU bound on the cross-tick plan cache.  Far above the distinct
#: canonical problems of the standard traces (so the default-config hit-rate
#: is unchanged — asserted in tests), but a hard ceiling on controller
#: memory over unbounded uptime.
DEFAULT_PLAN_CACHE_CAP = 4096


@dataclasses.dataclass
class InstanceState:
    """One pipeline instance as the service sees it: the workload, the
    *effective* platform (with every observed degradation folded in), the
    current published plan, and the straggler monitor for that plan."""

    workload: object
    platform: Platform
    plan: Optional[StagePlan] = None
    monitor: Optional[StragglerMonitor] = None


class _PlanCache:
    """Bounded LRU over canonical digest → ``HeuristicResult``.

    Eviction can never change a result — signatures are exact bytes, so a
    re-solve after eviction is bit-identical to the evicted entry; the cap
    only trades memory for occasional re-solves (``evictions`` counts them,
    surfaced as ``FleetMetrics.cache_evictions``)."""

    def __init__(self, cap: Optional[int]):
        self.cap = cap
        self.evictions = 0
        self._d: collections.OrderedDict = collections.OrderedDict()

    def __contains__(self, digest) -> bool:
        return digest in self._d

    def __len__(self) -> int:
        return len(self._d)

    def lookup(self, digest):
        """Get-and-touch: a hit refreshes recency."""
        if digest not in self._d:
            return None
        self._d.move_to_end(digest)
        return self._d[digest]

    def put(self, digest, res) -> None:
        self._d[digest] = res
        self._d.move_to_end(digest)
        while self.cap is not None and len(self._d) > self.cap:
            self._d.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._d.clear()

    def items(self):
        """(digest, result) pairs oldest-first — serialized in this order so
        a restored cache carries the exact LRU recency order."""
        return self._d.items()


class ReplanService:
    """Telemetry-driven, dedup-batched replanning over a fleet of instances.

    ``instances`` is a sequence of (workload, platform) pairs; instance ids
    are positions.  ``backend`` is the engine of ``batched_min_period``
    ("lockstep", "fused" — each lockstep iteration a CUDA graph replay on the
    card — or "sharded"; all give the same floats) and ``device`` where the
    groups are stacked and solved and where the scalar fallback scores
    (``None``: CUDA).  ``warm_start=False`` drops the cross-tick plan cache
    at every tick (same-tick dedup always applies) — it exists to *prove*
    warm-starting never changes results, not to be used.

    ``solve_deadline`` (seconds per tick) and ``reliability_floor`` (minimum
    plan reliability, needs platforms with failure probabilities) enable the
    graceful-degradation behaviors documented in the module docstring; both
    default to off, keeping the clean path byte-identical.

    ``plan_cache_cap`` bounds the cross-tick plan cache (LRU; ``None`` means
    unbounded).  ``journal`` (a directory path or :class:`Journal`) enables
    the write-ahead log + snapshot durability layer.  ``supervisor``
    overrides the default in-process supervised worker pool (e.g. to use
    :class:`~repro_torch.fleet.supervision.ThreadWorker` actors with a solve
    timeout); ``quarantine_after`` is the strike count at which a poison
    problem is quarantined.
    """

    def __init__(self, instances: Sequence, backend: str = "lockstep",
                 device=None,
                 warm_start: bool = True,
                 solve_deadline: Optional[float] = None,
                 reliability_floor: Optional[float] = None,
                 plan_cache_cap: Optional[int] = DEFAULT_PLAN_CACHE_CAP,
                 journal=None,
                 supervisor: Optional[Supervisor] = None,
                 quarantine_after: int = 2):
        # Fail fast: every knob is validated here, with the error naming the
        # knob — not three frames deep inside the first group solve.
        if backend not in KNOWN_BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; known engines: "
                             f"{', '.join(KNOWN_BACKENDS)}")
        if solve_deadline is not None and solve_deadline < 0:
            raise ValueError(f"solve_deadline must be >= 0 seconds, got "
                             f"{solve_deadline}")
        if reliability_floor is not None and \
                not (0.0 <= reliability_floor <= 1.0):
            raise ValueError(f"reliability_floor must be in [0, 1], got "
                             f"{reliability_floor}")
        if plan_cache_cap is not None and plan_cache_cap < 1:
            raise ValueError(f"plan_cache_cap must be >= 1 or None, got "
                             f"{plan_cache_cap}")
        if quarantine_after < 1:
            raise ValueError(f"quarantine_after must be >= 1, got "
                             f"{quarantine_after}")
        self.backend = backend
        self.device = resolve_device(device)
        self.warm_start = warm_start
        self.solve_deadline = solve_deadline
        self.reliability_floor = reliability_floor
        self.plan_cache_cap = plan_cache_cap
        self.quarantine_after = int(quarantine_after)
        self.states = [InstanceState(wl, pf) for wl, pf in instances]
        self._init_runtime(journal=journal, supervisor=supervisor)
        # Initial fleet-wide planning runs through the same dedup+batch path
        # but is not a *re*plan: it stays out of the metrics.  (No plan
        # exists yet, so nothing is deferrable: a deadline cannot leave an
        # instance unplanned.)
        self._replan(range(len(self.states)))
        self._repair_reliability(dict.fromkeys(range(len(self.states))))
        self._sync_acct_baselines()
        if self.journal is not None:
            # Genesis snapshot: restore() is self-contained from the journal
            # directory alone, even before the first cadence snapshot.
            self._maybe_snapshot(force=True)

    def _init_runtime(self, journal=None,
                      supervisor: Optional[Supervisor] = None) -> None:
        """Runtime state shared by ``__init__`` and snapshot restore."""
        self.metrics = FleetMetrics()
        self.plan_cache = _PlanCache(self.plan_cache_cap)
        self.tick_count = 0
        self._pending: dict = {}     # deadline-deferred ids, retried next tick
        self._dropped = 0            # stale events discarded this tick
        self._below_since: dict = {} # iid -> tick it dipped below the floor
        self.quarantine_strikes: dict = {}   # digest -> failed-round count
        self.quarantined: set = set()        # digests pinned to last valid plan
        self.journal = (Journal(journal) if isinstance(journal,
                                                       (str, pathlib.Path))
                        else journal)
        self.supervisor = supervisor if supervisor is not None else \
            Supervisor(self._solve_group, max_attempts=2)
        self.crash_hook: Optional[Callable] = None  # fault injection point
        self.replayed_ticks = 0      # WAL records re-applied by restore()
        self._replaying = False
        self._last_tick_stats = (0, 0, 0, [], 0, 0, 0)
        self._sync_acct_baselines()

    def _sync_acct_baselines(self) -> None:
        """Supervisor/cache counters are cumulative on their objects; the
        per-tick metrics record deltas against these baselines."""
        self._seen_retries = self.supervisor.stats.retries
        self._seen_restarts = self.supervisor.stats.restarts
        self._seen_timeouts = self.supervisor.stats.timeouts
        self._seen_evictions = self.plan_cache.evictions

    def _solve_group(self, pb: ProblemBatch) -> list:
        # Late-bound module global so test fault injection (monkeypatching
        # ``service.batched_min_period``) reaches the workers too.
        return batched_min_period(pb, self.backend)

    # -- event application ----------------------------------------------------

    def _observe(self, st: InstanceState, observed: np.ndarray) -> bool:
        """Feed one timing observation; degrade the platform if the EWMA
        flags stragglers (the ``replan_for_straggler`` recipe).  Returns
        whether the platform changed."""
        if not _plan_valid(st) or len(observed) != st.plan.num_stages:
            self._dropped += 1
            return False   # stale report from a pre-replan plan shape
        st.monitor.observe(observed)
        predicted = interval_cycle_times(st.workload, st.platform,
                                         st.plan.mapping)
        bad = st.monitor.stragglers(predicted)
        if not bad:
            return False
        pf = st.platform
        for j in bad:
            pf = pf.degrade(st.plan.mapping.alloc[j],
                            float(st.monitor.ewma[j] / predicted[j]))
        st.platform = pf
        return True

    def _apply(self, ev) -> bool:
        """Apply one event; returns True when the instance needs a replan."""
        st = self.states[ev.instance]
        if isinstance(ev, StageTimings):
            return self._observe(st, np.asarray(ev.times, dtype=float))
        if isinstance(ev, StageDrift):
            if not _plan_valid(st):
                return False   # platform already changed this tick
            if not (0 <= ev.stage < st.plan.num_stages):
                # stale event addressed at a pre-replan plan shape: drop it,
                # like stale StageTimings — remapping it (the old
                # ``stage % num_stages``) would slow an arbitrary stage
                self._dropped += 1
                return False
            predicted = interval_cycle_times(st.workload, st.platform,
                                             st.plan.mapping)
            observed = predicted.copy()
            observed[ev.stage] *= ev.factor
            return self._observe(st, observed)
        if isinstance(ev, PodCountChange):
            target = max(1, int(ev.num_pods))
            if target == st.platform.p:
                return False
            st.platform = elastic_platform(st.platform, target)
            return True
        if isinstance(ev, PodFailure):
            if st.platform.p <= 1:
                return False   # last pod: nothing to fail over to
            pod = int(ev.pod) % st.platform.p
            # Platform.without appends "-failed" at most once (names stay
            # bounded over long traces) and drops the pod's failure
            # probability alongside its speed.
            st.platform = st.platform.without(pod)
            return True
        raise TypeError(f"unknown fleet event {type(ev).__name__}")

    # -- solve + publish ------------------------------------------------------

    def _strike(self, digest: str) -> None:
        """One failed batched+scalar round for this canonical problem; at
        ``quarantine_after`` strikes the problem is quarantined."""
        n = self.quarantine_strikes.get(digest, 0) + 1
        self.quarantine_strikes[digest] = n
        self._tick_strikes += 1
        if n >= self.quarantine_after and digest not in self.quarantined:
            self.quarantined.add(digest)
            self._tick_quarantined += 1

    def _replan(self, ids) -> dict:
        """Dedup, batch-solve, and publish new plans for the given instance
        ids.  Returns {iid: StagePlan}; sets ``self._last_tick_stats``.

        With a ``solve_deadline``, canonical problems are solved group by
        group until the budget runs out; later groups are deferred — their
        subscribers keep their last valid plan and are retried next tick —
        EXCEPT problems with a subscriber whose plan is invalid or missing,
        which always solve (keep-last-VALID-plan, never keep-broken-plan).
        Group solves go through the supervised worker pool; a group the
        workers give up on falls back to per-member scalar solves of the
        same canonical problems (bit-identical results), and a member whose
        scalar solve *also* raises is struck toward quarantine."""
        ids = list(ids)
        t0 = time.perf_counter()
        deadline = (None if self.solve_deadline is None
                    else t0 + self.solve_deadline)
        self._tick_strikes = 0
        self._tick_quarantined = 0
        sig_of = {i: signature(self.states[i].workload,
                               self.states[i].platform) for i in ids}
        warm_hits = sum(sig_of[i].digest in self.plan_cache for i in ids)
        need: dict = {}
        for i in ids:
            sig = sig_of[i]
            if (sig.digest not in self.plan_cache
                    and sig.digest not in need
                    and sig.digest not in self.quarantined):
                need[sig.digest] = (sig, self.states[i])
        must = {sig_of[i].digest for i in ids
                if self.states[i].plan is None
                or not _plan_valid(self.states[i])}
        by_shape: dict = {}
        for digest, (sig, st) in need.items():
            by_shape.setdefault(sig.shape, []).append((digest, st))
        fallback_solves = 0
        solved = 0
        # Tick-local results: publishing reads from here first, so LRU
        # eviction pressure can only cost cross-tick re-solves — it can never
        # evict a result between its solve and its publish in the same tick.
        fresh: dict = {}
        for (n, p, b), entries in by_shape.items():
            if deadline is not None and time.perf_counter() > deadline:
                entries = [e for e in entries if e[0] in must]
            if not entries:
                continue
            pb = ProblemBatch.from_arrays(
                np.stack([st.workload.w for _, st in entries]),
                np.stack([st.workload.delta for _, st in entries]),
                np.stack([st.platform.s[st.platform.sorted_indices()]
                          for _, st in entries]),
                b, device=self.device)
            try:
                results = list(self.supervisor.solve(pb))
            except ScoringDeviceError:
                raise   # the card cannot score: no fallback may hide it
            except Exception:  # noqa: BLE001 — degrade, don't die mid-tick
                for digest, st in entries:
                    try:
                        with scoring_device(self.device):
                            res = min_period_exhaustive(
                                st.workload, canonicalize(st.platform)[0])
                    except ScoringDeviceError:
                        raise
                    except Exception:  # noqa: BLE001 — poison problem
                        self._strike(digest)
                        continue
                    fresh[digest] = res
                    self.plan_cache.put(digest, res)
                    fallback_solves += 1
                    solved += 1
                continue
            for (digest, _), res in zip(entries, results):
                fresh[digest] = res
                self.plan_cache.put(digest, res)
            solved += len(entries)
        published, churns, deferred = {}, [], []
        quarantined_requests = 0
        for i in ids:
            st = self.states[i]
            res = self.plan_cache.lookup(sig_of[i].digest)
            if res is None:
                res = fresh.get(sig_of[i].digest)
            if res is None:
                if sig_of[i].digest in self.quarantined:
                    # Pinned to the last valid plan; NOT retried — the
                    # problem re-enters the solve path only when drift
                    # changes its signature.
                    quarantined_requests += 1
                else:
                    deferred.append(i)   # keep last valid plan, retry next tick
                continue
            _, perm = canonicalize(st.platform)
            mapping = Mapping(res.mapping.intervals,
                              remap_alloc(res.mapping.alloc, perm))
            plan = _realize(mapping, res.period, res.latency, res.name)
            if st.plan is not None:
                churns.append(_plan_churn(st.plan, plan, st.workload.n))
            st.plan = plan
            st.monitor = StragglerMonitor(plan.num_stages)
            published[i] = plan
        self._pending.update(dict.fromkeys(deferred))
        self._last_tick_stats = (len(ids), solved, warm_hits, churns,
                                 len(deferred), fallback_solves,
                                 quarantined_requests)
        return published

    def _plan_reliability(self, st: InstanceState) -> float:
        """Reliability of the instance's published plan (consensus model when
        the plan carries replication groups)."""
        if st.plan.groups is not None:
            rm = ReplicatedMapping(st.plan.mapping.intervals, st.plan.groups)
            return reliability(st.workload, st.platform, rm)
        return reliability(st.workload, st.platform, st.plan.mapping)

    def _repair_reliability(self, published: dict) -> tuple:
        """Reliability-floor pass: re-replicate any instance whose plan sits
        below the floor, republishing into ``published`` when the plan
        actually changed.  Returns (instance-ticks below the floor, list of
        recovery latencies closed this tick)."""
        floor = self.reliability_floor
        if floor is None:
            return 0, []
        below, recoveries = 0, []
        for i, st in enumerate(self.states):
            if st.platform.fail is None or not _plan_valid(st):
                continue
            rel = self._plan_reliability(st)
            if rel < floor - _FLOOR_EPS:
                new = replicate_stage_plan(st.workload, st.platform, st.plan,
                                           target=floor)
                if (new is not st.plan
                        and (new.groups != st.plan.groups
                             or new.mapping != st.plan.mapping)):
                    st.plan = new
                    st.monitor = StragglerMonitor(new.num_stages)
                    published[i] = new
                rel = self._plan_reliability(st)
            if rel < floor - _FLOOR_EPS:
                below += 1
                self._below_since.setdefault(i, self.tick_count)
            elif i in self._below_since:
                recoveries.append(self.tick_count - self._below_since.pop(i))
        return below, recoveries

    def tick(self, events: Sequence) -> dict:
        """Process one tick's events; returns the republished plans."""
        events = tuple(events)
        if self.journal is not None and not self._replaying:
            # Write-ahead: the tick's events hit stable storage before any
            # state mutates, so a controller killed anywhere inside this
            # method replays the tick from disk on restore.
            self.journal.append(self.tick_count, events)
            if self.crash_hook is not None:
                self.crash_hook(self.tick_count)
        t0 = time.perf_counter()
        if not self.warm_start:
            self.plan_cache.clear()
        self._dropped = 0
        # Deadline-deferred instances retry before this tick's events touch
        # anything; new dirtiness merges in behind them.
        dirty: dict = dict.fromkeys(self._pending)
        self._pending = {}
        for ev in events:
            if self._apply(ev):
                dirty[ev.instance] = None
        published = self._replan(dirty.keys())
        below, recoveries = self._repair_reliability(published)
        (requests, solves, warm_hits, churns, deferred,
         fallback_solves, quarantined_requests) = self._last_tick_stats
        invalid = sum(not _plan_valid(st) for st in self.states)
        retries = self.supervisor.stats.retries - self._seen_retries
        restarts = self.supervisor.stats.restarts - self._seen_restarts
        timeouts = self.supervisor.stats.timeouts - self._seen_timeouts
        evictions = self.plan_cache.evictions - self._seen_evictions
        self.metrics.record_tick(requests=requests, solves=solves,
                                 warm_hits=warm_hits, events=len(events),
                                 wall=time.perf_counter() - t0, churns=churns,
                                 deferred=deferred,
                                 fallback_solves=fallback_solves,
                                 dropped_events=self._dropped,
                                 below_floor=below, recoveries=recoveries,
                                 invalid_published=invalid,
                                 quarantined_requests=quarantined_requests,
                                 quarantine_strikes=self._tick_strikes,
                                 quarantined_problems=self._tick_quarantined,
                                 solve_retries=retries,
                                 worker_restarts=restarts,
                                 worker_timeouts=timeouts,
                                 cache_evictions=evictions)
        self._sync_acct_baselines()
        self.tick_count += 1
        self._maybe_snapshot()
        return published

    def run_trace(self, trace: Trace) -> FleetMetrics:
        """Replay a telemetry trace tick by tick.  Deterministic: the same
        trace over the same fleet yields the same plans and counters."""
        for events in trace.ticks:
            self.tick(events)
        return self.metrics

    def resume_trace(self, trace: Trace) -> FleetMetrics:
        """Continue a (restored) service through the tail of ``trace``: the
        ticks it has not yet processed, ``trace.ticks[self.tick_count:]``.
        Valid when this service has been driven by exactly this trace from
        tick 0 — the crash/restart replay contract."""
        for events in trace.ticks[self.tick_count:]:
            self.tick(events)
        return self.metrics

    # -- durability -----------------------------------------------------------

    def _maybe_snapshot(self, force: bool = False) -> None:
        if self.journal is None:
            return
        if force or self.tick_count % self.journal.snapshot_every == 0:
            self.journal.write_snapshot(self.tick_count, self._state_dict())

    def _state_dict(self) -> dict:
        """Full service state as JSON scalars — everything a future tick's
        behavior depends on (the service is RNG-free, so this is exhaustive).
        Exact float round-trip makes restore bit-identical."""
        return {
            "config": {
                "backend": self.backend,
                "warm_start": self.warm_start,
                "solve_deadline": self.solve_deadline,
                "reliability_floor": self.reliability_floor,
                "plan_cache_cap": self.plan_cache_cap,
                "quarantine_after": self.quarantine_after,
                "snapshot_every": (None if self.journal is None
                                   else self.journal.snapshot_every),
            },
            "tick_count": self.tick_count,
            "instances": [{"workload": encode_workload(st.workload),
                           "platform": encode_platform(st.platform),
                           "plan": encode_plan(st.plan),
                           "monitor": encode_monitor(st.monitor)}
                          for st in self.states],
            "plan_cache": [[digest, encode_result(res)]
                           for digest, res in self.plan_cache.items()],
            "cache_evictions": self.plan_cache.evictions,
            "pending": list(self._pending),
            "below_since": [[int(i), int(t)]
                            for i, t in self._below_since.items()],
            "quarantine_strikes": [[d, int(n)] for d, n
                                   in self.quarantine_strikes.items()],
            "quarantined": sorted(self.quarantined),
            "metrics": dataclasses.asdict(self.metrics),
        }

    @classmethod
    def _from_state(cls, state: dict, journal: Optional[Journal],
                    supervisor: Optional[Supervisor],
                    device=None) -> "ReplanService":
        cfg = state["config"]
        svc = object.__new__(cls)
        svc.backend = _REFERENCE_BACKENDS.get(cfg["backend"], cfg["backend"])
        if svc.backend not in KNOWN_BACKENDS:
            raise JournalError(f"journal names unknown backend {cfg['backend']!r}")
        svc.device = resolve_device(device)
        svc.warm_start = cfg["warm_start"]
        svc.solve_deadline = cfg["solve_deadline"]
        svc.reliability_floor = cfg["reliability_floor"]
        svc.plan_cache_cap = cfg["plan_cache_cap"]
        svc.quarantine_after = cfg["quarantine_after"]
        svc.states = [InstanceState(decode_workload(d["workload"]),
                                    decode_platform(d["platform"]),
                                    decode_plan(d["plan"]),
                                    decode_monitor(d["monitor"]))
                      for d in state["instances"]]
        svc._init_runtime(journal=journal, supervisor=supervisor)
        for digest, res in state["plan_cache"]:
            svc.plan_cache.put(digest, decode_result(res))
        svc.plan_cache.evictions = int(state["cache_evictions"])
        svc.tick_count = int(state["tick_count"])
        svc._pending = dict.fromkeys(int(i) for i in state["pending"])
        svc._below_since = {int(i): int(t) for i, t in state["below_since"]}
        svc.quarantine_strikes = {d: int(n)
                                  for d, n in state["quarantine_strikes"]}
        svc.quarantined = set(state["quarantined"])
        svc.metrics = FleetMetrics(**state["metrics"])
        svc._sync_acct_baselines()
        return svc

    @classmethod
    def restore(cls, journal_or_dir, *, supervisor: Optional[Supervisor] = None,
                strict: bool = False, device=None) -> "ReplanService":
        """Rebuild a crashed controller from its journal directory.

        Loads the newest CRC-valid snapshot, then re-applies the WAL tail
        through the ordinary ``tick()`` path (suppressing re-journaling).
        The restored service's ``fleet_digest()`` is bit-identical to an
        uninterrupted run over the same ticks, it keeps journaling into the
        same directory, and ``resume_trace`` continues exactly where the
        crashed controller left off.  ``strict=True`` turns a torn WAL tail
        (normal after a crash mid-append) into a :class:`JournalError`
        instead of recovering to the last good record.  The restored service
        solves on ``device`` (``None``: CUDA); a journal the reference wrote
        restores too.
        """
        journal = (journal_or_dir if isinstance(journal_or_dir, Journal)
                   else Journal(journal_or_dir))
        snap = journal.latest_snapshot()
        if snap is None:
            raise JournalError(f"no valid snapshot in {journal.dir} — "
                               "cannot restore")
        snap_tick, state = snap
        every = state["config"].get("snapshot_every")
        if every:
            journal.snapshot_every = int(every)
        svc = cls._from_state(state, journal, supervisor, device)
        records, _ = journal.read_wal(strict=strict)
        expect = svc.tick_count
        svc._replaying = True
        try:
            for rec in records:
                if rec["tick"] < expect:
                    continue   # pre-snapshot record not yet compacted away
                if rec["tick"] != expect:
                    raise JournalError(
                        f"WAL gap: expected tick {expect}, found record for "
                        f"tick {rec['tick']}")
                svc.tick([event_from_wire(e) for e in rec["events"]])
                expect += 1
        finally:
            svc._replaying = False
        svc.replayed_ticks = expect - snap_tick
        return svc

    # -- introspection --------------------------------------------------------

    @property
    def plans(self) -> list:
        return [st.plan for st in self.states]

    def fleet_digest(self) -> str:
        """Hash of every instance's current plan — determinism fingerprint."""
        h = hashlib.blake2b(digest_size=16)
        for st in self.states:
            h.update(repr((st.plan.mapping.intervals, st.plan.mapping.alloc,
                           st.plan.period, st.plan.latency,
                           st.plan.groups)).encode())
        return h.hexdigest()


_FLOOR_EPS = 1e-12   # matches the greedy replicator's target tolerance


def _plan_valid(st: InstanceState) -> bool:
    """Whether the published plan still addresses the current platform — a
    same-tick pod removal/resize invalidates the plan's allocation until the
    end-of-tick replan; timing reports against it are meaningless."""
    if st.plan is None:
        return False
    if max(st.plan.mapping.alloc) >= st.platform.p:
        return False
    if st.plan.groups is not None:
        return max(u for g in st.plan.groups for u in g) < st.platform.p
    return True


def _plan_churn(old: StagePlan, new: StagePlan, n: int) -> float:
    """Fraction of the n layers whose pod assignment changed."""
    old_alloc = np.repeat(np.asarray(old.mapping.alloc), old.stage_sizes)
    new_alloc = np.repeat(np.asarray(new.mapping.alloc), new.stage_sizes)
    return float(np.mean(old_alloc != new_alloc))
