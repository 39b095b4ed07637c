"""Fleet replanning service of the port: planning-as-a-service over the
paper's heuristics, on a torch device.

The port of ``repro.fleet``.  Online, observed drift (stragglers,
preemptions, autoscale events) turns a homogeneous platform into a
different-speed one, where the paper's fast heuristics are the only option.
A fleet runs thousands of pipeline instances at once: this subsystem ingests
a drift-event stream, dedups identical-up-to-relabeling replan requests
through canonical instance signatures, and solves the distinct problems in
groups through :func:`repro_torch.core.batched.batched_min_period` (the
lockstep, fused or sharded engine, whose split scoring runs the hand-written
CUDA kernels on the card), so a tick's worth of replans costs a few engine
runs instead of thousands of scalar solves.

Device rule: :class:`ReplanService`, :func:`subprocess_supervisor` and
``python -m repro_torch.fleet.worker_main`` take a device (``None``: CUDA,
raising without a card).  A split-score fault on the card
(:class:`~repro_torch.core.ScoringDeviceError`) is raised out of the service
and the supervisor, never turned into a scalar fallback, a retry or a
quarantine; any other solve fault degrades as in the reference.  Published
plans and ``fleet_digest()`` are ``==`` the reference's on the same seeds.

Modules (the reference's names):

  - :mod:`repro_torch.fleet.telemetry`  — drift event types, synthetic
    burst-trace generator, deterministic trace replay
  - :mod:`repro_torch.fleet.signatures` — canonical (n, speed-order,
    span-bucket) instance signatures + the relabeling theorem that makes
    dedup exact
  - :mod:`repro_torch.fleet.service`    — the controller loop: collect,
    dedup, warm-start, batch-solve, publish
  - :mod:`repro_torch.fleet.metrics`    — replans/sec, p50/p99 replan
    latency, dedup hit-rate, plan churn, graceful-degradation counters
  - :mod:`repro_torch.fleet.chaos`      — fault injection over telemetry
    traces: correlated pod-failure storms, flapping pods, event
    drop/dup/reorder, and controller kill/restart-from-journal
  - :mod:`repro_torch.fleet.journal`    — write-ahead event log +
    CRC-checked atomic snapshots, byte-compatible with the reference's
  - :mod:`repro_torch.fleet.supervision` — the controller/worker split:
    supervised solve workers with heartbeats, timeouts, backoff retries, and
    restarts
  - :mod:`repro_torch.fleet.transport`  — CRC-framed stdio wire protocol for
    process-isolated workers, plus :class:`TransportChaos` wire-fault
    injection
  - :mod:`repro_torch.fleet.worker_main` — the ``python -m
    repro_torch.fleet.worker_main`` subprocess entrypoint driven by
    :class:`SubprocessWorker`
"""

from .telemetry import (PodCountChange, PodFailure, StageDrift, StageTimings,
                        Trace, event_from_wire, event_to_wire,
                        gen_burst_trace, make_fleet)
from .signatures import (Signature, canonicalize, remap_alloc, signature,
                         span_bucket)
from .journal import Journal, JournalError
from .transport import (FrameError, FrameReader, TransportChaos, encode_frame)
from .supervision import (InlineWorker, SubprocessWorker, Supervisor,
                          ThreadWorker, WorkerCrash, WorkerFailed,
                          WorkerSolveError, WorkerTimeout,
                          subprocess_supervisor)
from .service import InstanceState, ReplanService
from .metrics import FleetMetrics
from .chaos import ChaosSpec, SimulatedCrash, crash_restart_run, inject_chaos

__all__ = [
    "StageTimings", "StageDrift", "PodCountChange", "PodFailure",
    "Trace", "gen_burst_trace", "make_fleet",
    "event_to_wire", "event_from_wire",
    "Signature", "signature", "canonicalize", "remap_alloc", "span_bucket",
    "Journal", "JournalError",
    "Supervisor", "InlineWorker", "ThreadWorker", "SubprocessWorker",
    "subprocess_supervisor",
    "WorkerFailed", "WorkerTimeout", "WorkerCrash", "WorkerSolveError",
    "FrameError", "FrameReader", "TransportChaos", "encode_frame",
    "ReplanService", "InstanceState",
    "FleetMetrics",
    "ChaosSpec", "inject_chaos", "SimulatedCrash", "crash_restart_run",
]
