"""Fleet service metrics (the port's copy of ``repro.fleet.metrics``).

The service calls :meth:`FleetMetrics.record_tick` once per controller tick
with that tick's request count, solve count, warm-start hits, wall time, and
per-instance plan churn.  Aggregates:

  - ``replans_per_sec``  — published replans / total solve wall time
  - ``p50 / p99 latency`` — per-request replan latency; every request in a
    tick shares the tick's collect-to-publish wall time (requests are only
    answered at the tick boundary, so that *is* each request's latency)
  - ``dedup_hit_rate``   — fraction of requests that did NOT need their own
    solve (same-tick signature sharing + cross-tick warm-start hits)
  - ``plan_churn``       — mean fraction of layers whose pod assignment
    changed across a replan (placement stability)

``bench_rows`` formats these as ``fleet_replan_*`` rows in the reference's
benchmark row schema ((name, us_per_call, derived, extra-dict)).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class FleetMetrics:
    """Aggregated counters over a service run (one trace replay)."""

    ticks: int = 0
    requests: int = 0       # replan requests = dirty instances across ticks
    solves: int = 0         # canonical problems actually solved (batched rows)
    warm_hits: int = 0      # cross-tick plan-cache hits
    events: int = 0
    solve_wall: float = 0.0  # seconds spent collect-to-publish
    latencies: list = dataclasses.field(default_factory=list)
    churns: list = dataclasses.field(default_factory=list)
    # Robustness counters (the chaos-harness surface; all zero on the clean
    # path, so clean-run numbers are unchanged by them):
    degraded_ticks: int = 0      # ticks where a deadline deferral or solver
                                 # fallback fired (service ran but degraded)
    deferred: int = 0            # replan requests pushed to a later tick
    fallback_solves: int = 0     # scalar solves after a batched group raised
    dropped_events: int = 0      # stale/out-of-range events discarded
    below_floor_ticks: int = 0   # instance-ticks spent below the reliability floor
    recovery_ticks: list = dataclasses.field(default_factory=list)
    #                            ^ ticks from dipping below the floor to recovery
    invalid_published: int = 0   # instance-ticks ending with an invalid plan
    #                            (must stay 0: the keep-last-valid guarantee)
    # Durability / supervision counters (zero on the clean path):
    quarantined_requests: int = 0  # requests answered by a quarantined
    #                              problem's last valid plan (not retried)
    quarantine_strikes: int = 0    # batched+scalar double-failure rounds
    quarantined_problems: int = 0  # canonical problems quarantined
    solve_retries: int = 0         # supervisor retry attempts (with backoff)
    worker_restarts: int = 0       # workers replaced (timeout / stale heartbeat)
    worker_timeouts: int = 0       # hung solves reaped/abandoned on deadline
    cache_evictions: int = 0       # plan-cache LRU evictions (cap pressure)

    def record_tick(self, *, requests: int, solves: int, warm_hits: int,
                    events: int, wall: float, churns,
                    deferred: int = 0, fallback_solves: int = 0,
                    dropped_events: int = 0, below_floor: int = 0,
                    recoveries=(), invalid_published: int = 0,
                    quarantined_requests: int = 0, quarantine_strikes: int = 0,
                    quarantined_problems: int = 0, solve_retries: int = 0,
                    worker_restarts: int = 0, worker_timeouts: int = 0,
                    cache_evictions: int = 0) -> None:
        self.ticks += 1
        self.requests += requests
        self.solves += solves
        self.warm_hits += warm_hits
        self.events += events
        self.solve_wall += wall
        self.latencies.extend([wall] * requests)
        self.churns.extend(float(c) for c in churns)
        if deferred or fallback_solves or quarantined_requests:
            self.degraded_ticks += 1
        self.deferred += deferred
        self.fallback_solves += fallback_solves
        self.dropped_events += dropped_events
        self.below_floor_ticks += below_floor
        self.recovery_ticks.extend(int(r) for r in recoveries)
        self.invalid_published += invalid_published
        self.quarantined_requests += quarantined_requests
        self.quarantine_strikes += quarantine_strikes
        self.quarantined_problems += quarantined_problems
        self.solve_retries += solve_retries
        self.worker_restarts += worker_restarts
        self.worker_timeouts += worker_timeouts
        self.cache_evictions += cache_evictions

    # -- aggregates -----------------------------------------------------------
    def dedup_hit_rate(self) -> float:
        if not self.requests:
            return 0.0
        return 1.0 - self.solves / self.requests

    def replans_per_sec(self) -> float:
        if self.solve_wall <= 0:
            return 0.0
        return self.requests / self.solve_wall

    def latency_percentile(self, q: float) -> float:
        """Percentile over the per-request latency samples.  An EMPTY sample
        set returns NaN, not 0.0 — a 0 would read as "instant replans"; NaN is
        unambiguous and :meth:`bench_rows` turns it into an explicit 0-sample
        row.  A singleton sample is fine (every
        percentile is that sample)."""
        if not self.latencies:
            return float("nan")
        return float(np.percentile(np.asarray(self.latencies, dtype=float), q))

    def mean_churn(self) -> float:
        if not self.churns:
            return 0.0
        return float(np.mean(self.churns))

    def max_recovery_ticks(self) -> int:
        return max(self.recovery_ticks) if self.recovery_ticks else 0

    def summary(self) -> dict:
        return {
            "ticks": self.ticks,
            "events": self.events,
            "requests": self.requests,
            "solves": self.solves,
            "warm_hits": self.warm_hits,
            "dedup_hit_rate": self.dedup_hit_rate(),
            "replans_per_sec": self.replans_per_sec(),
            "latency_samples": len(self.latencies),
            "p50_latency_us": self.latency_percentile(50) * 1e6,
            "p99_latency_us": self.latency_percentile(99) * 1e6,
            "mean_churn": self.mean_churn(),
        }

    def robustness_summary(self) -> dict:
        return {
            "degraded_ticks": self.degraded_ticks,
            "deferred": self.deferred,
            "fallback_solves": self.fallback_solves,
            "dropped_events": self.dropped_events,
            "below_floor_ticks": self.below_floor_ticks,
            "recoveries": len(self.recovery_ticks),
            "max_recovery_ticks": self.max_recovery_ticks(),
            "mean_recovery_ticks": (float(np.mean(self.recovery_ticks))
                                    if self.recovery_ticks else 0.0),
            "invalid_published": self.invalid_published,
            "quarantined_requests": self.quarantined_requests,
            "quarantine_strikes": self.quarantine_strikes,
            "quarantined_problems": self.quarantined_problems,
            "solve_retries": self.solve_retries,
            "worker_restarts": self.worker_restarts,
            "worker_timeouts": self.worker_timeouts,
            "cache_evictions": self.cache_evictions,
        }

    def bench_rows(self, suffix: str = "", extra: Optional[dict] = None) -> list:
        """Benchmark rows (name, us_per_call, derived, extra).

        A run that recorded ZERO per-request latency samples (e.g. a --quick
        trace whose every tick deduped away) emits an explicit 0-sample
        latency row with ``None`` percentiles instead of fake zeros or JSON
        NaNs, so an empty measurement can never pass as a fast one."""
        s = self.summary()
        tag = f"_{suffix}" if suffix else ""
        shared = dict(s)
        if extra:
            shared.update(extra)
        n_lat = s["latency_samples"]
        finite = lambda x: float(x) if np.isfinite(x) else None
        p50, p99 = finite(s["p50_latency_us"]), finite(s["p99_latency_us"])
        shared["p50_latency_us"] = p50
        shared["p99_latency_us"] = p99
        lat_derived = (f"p50={p50:.0f}us p99={p99:.0f}us "
                       f"({n_lat} samples)" if n_lat
                       else "NO SAMPLES — latency unmeasured")
        return [
            (f"fleet_replan_throughput{tag}",
             1e6 / s["replans_per_sec"] if s["replans_per_sec"] else None,
             f"{s['replans_per_sec']:.0f} replans/s over {s['requests']} "
             f"requests in {s['ticks']} ticks",
             shared),
            (f"fleet_replan_latency{tag}", p50, lat_derived,
             {"p50_latency_us": p50,
              "p99_latency_us": p99,
              "latency_samples": n_lat}),
            (f"fleet_replan_dedup{tag}", None,
             f"hit-rate {s['dedup_hit_rate']:.3f} "
             f"({s['requests']} requests -> {s['solves']} solves, "
             f"{s['warm_hits']} warm hits)",
             {"dedup_hit_rate": s["dedup_hit_rate"],
              "requests": s["requests"], "solves": s["solves"],
              "warm_hits": s["warm_hits"]}),
            (f"fleet_replan_churn{tag}", None,
             f"mean fraction of layers remapped per replan: "
             f"{s['mean_churn']:.3f}",
             {"mean_churn": s["mean_churn"]}),
        ]

    def chaos_rows(self, suffix: str = "", extra: Optional[dict] = None) -> list:
        """``fleet_chaos_*`` rows: graceful-degradation counters under fault
        injection (``invalid_published`` must stay 0: never publish a plan
        addressing dead pods; ``max_recovery_ticks`` bounds the return above
        the reliability floor)."""
        r = self.robustness_summary()
        tag = f"_{suffix}" if suffix else ""
        shared = dict(r)
        shared["ticks"] = self.ticks
        if extra:
            shared.update(extra)
        return [
            (f"fleet_chaos_robustness{tag}", None,
             f"{r['degraded_ticks']} degraded ticks, {r['deferred']} deferred, "
             f"{r['fallback_solves']} fallback solves, "
             f"{r['dropped_events']} dropped events, "
             f"{r['invalid_published']} invalid published",
             shared),
            (f"fleet_chaos_recovery{tag}", None,
             f"{r['recoveries']} floor recoveries, max {r['max_recovery_ticks']} "
             f"ticks, mean {r['mean_recovery_ticks']:.2f}; "
             f"{r['below_floor_ticks']} instance-ticks below floor",
             {"below_floor_ticks": r["below_floor_ticks"],
              "recoveries": r["recoveries"],
              "max_recovery_ticks": r["max_recovery_ticks"],
              "mean_recovery_ticks": r["mean_recovery_ticks"],
              "invalid_published": r["invalid_published"]}),
        ]
