"""Supervised solve workers: the fleet controller/worker split.

The controller (:class:`~repro_torch.fleet.service.ReplanService`) no longer calls
the batched engine inline; each deduped solve group is dispatched to a
**worker actor** through a :class:`Supervisor`.  A worker owns its execution
context, exposes a heartbeat, and can be killed and replaced without touching
controller state.  Three transports implement the same ``solve/alive/close``
actor API:

  - :class:`InlineWorker` — synchronous in-process execution, the default.
    No threads, no timeouts, bit-identical to calling the engine directly.
  - :class:`ThreadWorker` — runs each solve on a dedicated worker thread so
    the supervisor can enforce a per-group ``timeout``.  Preemption is
    *advisory*: a thread cannot be killed, so a timed-out solve is abandoned
    (counted in ``leaked``/``SupervisorStats.leaked_threads``) and keeps
    burning CPU until it returns on its own.
  - :class:`SubprocessWorker` — the real process boundary.  Solves run in a
    ``python -m repro_torch.fleet.worker_main`` child speaking the CRC-framed wire
    protocol of :mod:`repro_torch.fleet.transport` over stdio; results are
    bit-identical to inline execution (exact-float codecs).  On timeout the
    supervisor **reaps** the child — SIGTERM, a grace period, then SIGKILL —
    so preemption is real: a wedged or leaking solve dies with its process
    and the abandoned-thread leak class disappears.  Heartbeat frames let
    ``alive()`` distinguish a slow worker from a dead one, and any wire
    corruption (CRC/magic/length) marks the stream poisoned so the worker is
    replaced, never trusted past the first bad byte.

The supervisor dispatches round-robin over its pool, retries a failed group
with **exponential backoff** (``backoff_base`` doubling up to
``backoff_max``), and **restarts** workers that time out, die, poison their
stream, or whose heartbeat has gone stale.  After ``max_attempts`` failures
it raises :class:`WorkerFailed` — at which point the service falls back to
per-member scalar solves, and problems that fail *that* too are quarantined
(see ``ReplanService``).  On the clean path none of this machinery fires, so
published plans remain bit-identical to a direct engine call (asserted in
tests/test_torch_fleet.py and tests/test_torch_fleet_recovery.py).

The one exception to supervision: a split-score fault on the card
(:class:`~repro_torch.core.ScoringDeviceError`, raised by the engine or
reported by a subprocess worker's error frame) is not retried.  It is raised
at once out of :meth:`Supervisor.solve`: retrying, or re-solving on the host,
would hide a device that does not work.
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
import pathlib
import subprocess
import sys
import time
from select import select
from typing import Callable, Optional

from .. import resolve_device
from ..core.heuristics import ScoringDeviceError
from .transport import (FrameError, FrameReader, decode_results, encode_frame,
                        encode_solve)

#: The src/ directory that holds the ``repro_torch`` package — prepended to
#: the child's PYTHONPATH so ``-m repro_torch.fleet.worker_main`` resolves no
#: matter where the controller was launched from.
_SRC_DIR = pathlib.Path(__file__).resolve().parents[2]


class WorkerFailed(RuntimeError):
    """A solve group failed on every attempt; the last cause is chained."""


class WorkerTimeout(RuntimeError):
    """A worker exceeded the per-group solve timeout (hung or wedged)."""


class WorkerCrash(RuntimeError):
    """The worker process died or its wire stream is poisoned (EOF, broken
    pipe, or a frame that failed its CRC/magic/length check)."""


class WorkerSolveError(RuntimeError):
    """The worker is alive and well but the solve itself raised; carries the
    remote exception type and message.  (A remote
    :class:`~repro_torch.core.ScoringDeviceError` is raised as itself.)"""


class InlineWorker:
    """Synchronous in-process worker — deterministic, zero overhead.

    ``timeout`` cannot preempt a synchronous call; constructing a
    :class:`Supervisor` with a timeout over inline workers raises
    ``ValueError`` so a misconfigured service cannot believe it has
    preemption it lacks.  Use :class:`ThreadWorker` (advisory) or
    :class:`SubprocessWorker` (real, kill-based) when a hung solve must not
    wedge the controller.
    """

    #: A synchronous call cannot be preempted — Supervisor(timeout=...)
    #: refuses this worker class up front.
    supports_timeout = False

    def __init__(self, solve_fn: Callable, worker_id: int = 0):
        self.solve_fn = solve_fn
        self.worker_id = worker_id
        self.solves = 0
        self.heartbeat = time.monotonic()

    def solve(self, batch, timeout: Optional[float] = None):
        self.heartbeat = time.monotonic()
        out = self.solve_fn(batch)
        self.heartbeat = time.monotonic()
        self.solves += 1
        return out

    def alive(self, heartbeat_timeout: Optional[float]) -> bool:
        # A synchronous worker cannot be secretly wedged: if control returned
        # to the supervisor, the worker is idle.
        return True

    def close(self) -> None:
        pass


class ThreadWorker:
    """Worker actor on its own thread: per-group timeout + heartbeat.

    ``solve`` submits to the worker's single-thread executor and bounds the
    wait.  On timeout the controller raises :class:`WorkerTimeout` and the
    supervisor replaces the worker — but a thread cannot be killed, so the
    abandoned solve keeps running until it returns on its own; each such
    abandonment is counted in ``leaked`` (rolled up into
    ``SupervisorStats.leaked_threads`` at restart).  ``close()`` shuts the
    executor down with ``cancel_futures=True`` so *queued* work is cancelled
    rather than silently run by an abandoned executor; only the
    already-running solve can leak.  :class:`SubprocessWorker` is the
    transport without this caveat.
    """

    supports_timeout = True

    def __init__(self, solve_fn: Callable, worker_id: int = 0):
        self.solve_fn = solve_fn
        self.worker_id = worker_id
        self.solves = 0
        self.leaked = 0   # timed-out solves still running on the dead executor
        self.heartbeat = time.monotonic()
        self._ex = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"fleet-worker-{worker_id}")

    def _run(self, batch):
        out = self.solve_fn(batch)
        self.heartbeat = time.monotonic()
        self.solves += 1
        return out

    def solve(self, batch, timeout: Optional[float] = None):
        self.heartbeat = time.monotonic()
        fut = self._ex.submit(self._run, batch)
        try:
            return fut.result(timeout)
        except concurrent.futures.TimeoutError:
            if not fut.cancel():
                # Already running: the thread is abandoned, not preempted.
                self.leaked += 1
            raise WorkerTimeout(
                f"worker {self.worker_id} exceeded {timeout}s solve "
                "timeout") from None

    def alive(self, heartbeat_timeout: Optional[float]) -> bool:
        if heartbeat_timeout is None:
            return True
        return time.monotonic() - self.heartbeat <= heartbeat_timeout

    def close(self) -> None:
        # cancel_futures: queued (not-yet-started) solves are cancelled
        # instead of being silently run to completion by an executor nothing
        # is listening to anymore.
        self._ex.shutdown(wait=False, cancel_futures=True)


class SubprocessWorker:
    """Worker actor in its own OS process: kill-based preemption.

    Spawns ``python -m repro_torch.fleet.worker_main --backend <backend>
    --device <device>`` and drives it over the CRC-framed stdio protocol.
    ``solve_fn`` is accepted for actor-API compatibility but unused — the
    child runs ``batched_min_period`` itself on ``device`` (``None``: CUDA,
    raising here without a card), and the exact-float wire codecs make its
    results bit-identical to the inline path.  An error frame of kind
    ``ScoringDeviceError`` is raised as
    :class:`~repro_torch.core.ScoringDeviceError`.

    Timeout semantics: when a reply misses the deadline the child is
    *reaped* — SIGTERM, ``term_grace`` seconds to comply, then SIGKILL — and
    :class:`WorkerTimeout` is raised.  Unlike :class:`ThreadWorker`, nothing
    leaks: the wedged solve's memory, threads, and file descriptors die with
    the process.  ``sigkills`` counts escalations that actually needed the
    hard kill.

    ``chaos`` (a :class:`repro_torch.fleet.transport.TransportChaos`) injects
    wire-level faults — dead-on-arrival spawns, SIGKILL mid-solve,
    drop/corrupt/truncate/delay on the reply path, in-band wedges — at this
    transport boundary, so the supervisor's recovery machinery is exercised
    against the same fault classes a real remote host exhibits.
    """

    supports_timeout = True

    def __init__(self, solve_fn: Optional[Callable] = None, worker_id: int = 0,
                 *, backend: str = "lockstep", device=None, chaos=None,
                 term_grace: float = 1.0, heartbeat_interval: float = 0.5,
                 ignore_sigterm: bool = False,
                 wedge_every: int = 0, wedge_seconds: float = 0.0,
                 python: str = sys.executable):
        self.worker_id = worker_id
        self.backend = backend
        self.device = resolve_device(device)
        self.chaos = chaos
        self.term_grace = float(term_grace)
        self.solves = 0
        self.sigkills = 0        # reaps that escalated past SIGTERM
        self.heartbeat = time.monotonic()
        self._reader = FrameReader()
        self._broken: Optional[str] = None
        self._req = 0
        cmd = [python, "-m", "repro_torch.fleet.worker_main",
               "--backend", backend,
               "--device", str(self.device),
               "--heartbeat-interval", str(heartbeat_interval)]
        if ignore_sigterm:
            cmd.append("--ignore-sigterm")
        if wedge_every:
            cmd += ["--wedge-every", str(wedge_every),
                    "--wedge-seconds", str(wedge_seconds)]
        env = dict(os.environ)
        env["PYTHONPATH"] = str(_SRC_DIR) + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                      stdout=subprocess.PIPE, env=env)
        if self.chaos is not None and self.chaos.spawn_dead_on_arrival():
            # Dead on arrival: the child never gets to its first heartbeat.
            self._proc.kill()

    @property
    def pid(self) -> int:
        return self._proc.pid

    # -- wire helpers ---------------------------------------------------------

    def _mark_broken(self, why: str) -> None:
        self._broken = why

    def _send(self, payload) -> None:
        try:
            self._proc.stdin.write(encode_frame(payload))
            self._proc.stdin.flush()
        except (BrokenPipeError, OSError, ValueError):
            self._mark_broken("request pipe broken")
            raise WorkerCrash(f"worker {self.worker_id} (pid {self.pid}): "
                              "request pipe broken — process died") from None

    def _recv_chunk(self, deadline: Optional[float]) -> bool:
        """Read one chunk from the child's stdout into the frame reader
        (through the chaos layer if armed).  Returns False on timeout;
        raises :class:`WorkerCrash` on EOF."""
        fd = self._proc.stdout.fileno()
        wait = (None if deadline is None
                else max(0.0, deadline - time.monotonic()))
        ready, _, _ = select([fd], [], [], wait)
        if not ready:
            return False
        chunk = os.read(fd, 1 << 16)
        if not chunk:
            self._mark_broken("reply pipe EOF")
            raise WorkerCrash(f"worker {self.worker_id} (pid {self.pid}): "
                              "reply pipe EOF — process died mid-solve")
        if self.chaos is not None:
            chunk = self.chaos.mangle_chunk(chunk)
            if chunk is None:
                return True   # dropped on the wire; keep waiting
        self._reader.feed(chunk)
        return True

    def _next_payload(self, deadline: Optional[float]):
        """Next frame payload, or ``None`` on deadline expiry.  Heartbeats
        refresh ``self.heartbeat`` in passing."""
        while True:
            try:
                payload = self._reader.next_frame()
            except FrameError as e:
                self._mark_broken(f"poisoned stream: {e}")
                raise WorkerCrash(
                    f"worker {self.worker_id} (pid {self.pid}): {e}"
                ) from None
            if payload is not None:
                if payload[0] in ("heartbeat", "hello"):
                    self.heartbeat = time.monotonic()
                    continue
                return payload
            if deadline is not None and time.monotonic() >= deadline:
                return None
            if not self._recv_chunk(deadline):
                return None

    # -- actor API ------------------------------------------------------------

    def solve(self, batch, timeout: Optional[float] = None):
        if self._broken or self._proc.poll() is not None:
            self._mark_broken(self._broken or "process exited")
            raise WorkerCrash(f"worker {self.worker_id} (pid {self.pid}) is "
                              f"dead before dispatch ({self._broken})")
        self._req += 1
        rid = self._req
        if self.chaos is not None and self.chaos.wedge_solve():
            # In-band hang injection: the child sleeps before it ever sees
            # the solve frame — indistinguishable from a wedged solve.
            self._send(["wedge", {"seconds": self.chaos.wedge_seconds}])
        self._send(encode_solve(rid, batch))
        if self.chaos is not None and self.chaos.kill_mid_solve():
            # The request is on the wire; the worker dies holding it.
            self._proc.kill()
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            payload = self._next_payload(deadline)
            if payload is None:
                self.reap()
                raise WorkerTimeout(
                    f"worker {self.worker_id} (pid {self.pid}) exceeded "
                    f"{timeout}s solve timeout; process reaped")
            kind, body = payload
            if kind == "result":
                if int(body["id"]) != rid:
                    continue   # stale reply from an earlier, abandoned request
                self.solves += 1
                self.heartbeat = time.monotonic()
                return decode_results(body)
            if kind == "error":
                if int(body["id"]) != rid:
                    continue
                if body.get("kind") == "ScoringDeviceError":
                    raise ScoringDeviceError(
                        f"worker {self.worker_id}: {body.get('message', '')}")
                raise WorkerSolveError(
                    f"worker {self.worker_id}: solve raised "
                    f"{body.get('kind', 'Exception')}: "
                    f"{body.get('message', '')}")
            # Unknown-but-valid frame kinds are ignored (forward compat).

    def alive(self, heartbeat_timeout: Optional[float]) -> bool:
        if self._broken is not None or self._proc.poll() is not None:
            return False
        # Drain any queued heartbeat frames (non-blocking) so idle liveness
        # reflects the newest beat, not the last solve.
        try:
            while True:
                fd = self._proc.stdout.fileno()
                ready, _, _ = select([fd], [], [], 0)
                if not ready:
                    break
                if not self._recv_chunk(time.monotonic()):
                    break
                while True:
                    payload = self._reader.next_frame()
                    if payload is None:
                        break
                    if payload[0] in ("heartbeat", "hello"):
                        self.heartbeat = time.monotonic()
        except WorkerCrash:
            return False
        if self._broken is not None:
            return False
        if heartbeat_timeout is None:
            return True
        return time.monotonic() - self.heartbeat <= heartbeat_timeout

    def reap(self) -> None:
        """SIGTERM → ``term_grace`` seconds → SIGKILL.  The escalation is the
        preemption guarantee: a worker too wedged to honor SIGTERM (or
        ignoring it outright) is killed by the kernel, not negotiated with."""
        self._mark_broken("reaped")
        if self._proc.poll() is not None:
            return
        self._proc.terminate()
        try:
            self._proc.wait(timeout=self.term_grace)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self.sigkills += 1
            self._proc.wait()

    def close(self) -> None:
        if self._proc.poll() is None and self._broken is None:
            try:   # polite first: a clean 'bye' lets the child exit 0
                self._proc.stdin.write(encode_frame(["bye", {}]))
                self._proc.stdin.flush()
                self._proc.stdin.close()
                self._proc.wait(timeout=self.term_grace)
            except (BrokenPipeError, OSError, ValueError,
                    subprocess.TimeoutExpired):
                pass
        self.reap()
        for pipe in (self._proc.stdin, self._proc.stdout):
            try:
                if pipe is not None:
                    pipe.close()
            except (OSError, ValueError):
                pass


class SupervisorStats:
    """Lifetime counters the service folds into :class:`FleetMetrics`.

    ``timeouts`` (reaped/abandoned hung solves) is counted separately from
    ``failures`` (solves that raised) — a hung engine and a raising engine
    are different pathologies and the metrics must not conflate them.
    ``leaked_threads`` counts ThreadWorker solves that were abandoned
    mid-flight (the leak class SubprocessWorker eliminates); ``sigkills``
    counts subprocess reaps that had to escalate past SIGTERM."""

    def __init__(self):
        self.dispatches = 0
        self.failures = 0
        self.timeouts = 0
        self.retries = 0
        self.restarts = 0
        self.leaked_threads = 0
        self.sigkills = 0

    def as_dict(self) -> dict:
        return {"dispatches": self.dispatches, "failures": self.failures,
                "timeouts": self.timeouts, "retries": self.retries,
                "restarts": self.restarts,
                "leaked_threads": self.leaked_threads,
                "sigkills": self.sigkills}


def _worker_class(worker_cls):
    """Unwrap ``functools.partial`` layers to the underlying worker class."""
    while isinstance(worker_cls, functools.partial):
        worker_cls = worker_cls.func
    return worker_cls


class Supervisor:
    """Dispatch solve groups to a supervised worker pool.

    ``solve_fn`` is the actual group solver (the service binds it to
    ``batched_min_period`` on its backend); pass ``None`` when the pool runs
    :class:`SubprocessWorker` actors, which execute the solve in their own
    process.  ``worker_cls`` picks the actor flavor — a class or a
    ``functools.partial`` carrying transport options (all workers run the
    same pure function, so pool width only affects liveness, never results).
    A failed dispatch is retried up to ``max_attempts`` total attempts with
    exponential backoff; timed-out, crashed, or heartbeat-stale workers are
    closed and replaced (counted in ``stats.restarts``).  A
    :class:`~repro_torch.core.ScoringDeviceError` is counted as a failure and
    raised at once, never retried.  ``sleep`` is
    injectable so tests can assert the backoff schedule without waiting it
    out.

    ``timeout`` demands a worker transport that can actually preempt:
    constructing with a worker class whose ``supports_timeout`` is false
    (:class:`InlineWorker`) raises ``ValueError`` — deadline protection that
    silently does nothing is worse than none.
    """

    def __init__(self, solve_fn: Optional[Callable], *, workers: int = 1,
                 worker_cls=InlineWorker, max_attempts: int = 2,
                 timeout: Optional[float] = None,
                 backoff_base: float = 0.01, backoff_max: float = 1.0,
                 heartbeat_timeout: Optional[float] = None,
                 sleep: Callable = time.sleep):
        if workers < 1:
            raise ValueError(f"need at least one worker, got {workers}")
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if timeout is not None and \
                not getattr(_worker_class(worker_cls), "supports_timeout",
                            True):
            raise ValueError(
                f"timeout={timeout} has no effect with "
                f"{_worker_class(worker_cls).__name__}: a synchronous worker "
                "cannot be preempted, so the deadline protection would be "
                "fictional.  Use ThreadWorker (advisory) or SubprocessWorker "
                "(kill-based), or drop the timeout.")
        self.solve_fn = solve_fn
        self.worker_cls = worker_cls
        self.max_attempts = int(max_attempts)
        self.timeout = timeout
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.heartbeat_timeout = heartbeat_timeout
        self.sleep = sleep
        self.stats = SupervisorStats()
        self._next_id = 0
        self.pool = [self._spawn() for _ in range(workers)]
        self._rr = 0

    def _spawn(self):
        w = self.worker_cls(self.solve_fn, worker_id=self._next_id)
        self._next_id += 1
        return w

    def _restart(self, idx: int) -> None:
        old = self.pool[idx]
        self.stats.leaked_threads += getattr(old, "leaked", 0)
        self.stats.sigkills += getattr(old, "sigkills", 0)
        old.close()
        self.pool[idx] = self._spawn()
        self.stats.restarts += 1

    def solve(self, batch):
        """Solve one group, supervising the worker.  Returns the worker's
        result list; raises :class:`WorkerFailed` after ``max_attempts``
        failed attempts (the service then degrades to scalar fallback)."""
        delay = self.backoff_base
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            idx = self._rr % len(self.pool)
            self._rr += 1
            worker = self.pool[idx]
            if not worker.alive(self.heartbeat_timeout):
                self._restart(idx)
                worker = self.pool[idx]
            self.stats.dispatches += 1
            try:
                return worker.solve(batch, timeout=self.timeout)
            except ScoringDeviceError:
                # the card cannot score: a retry would only hide it
                self.stats.failures += 1
                raise
            except Exception as e:  # noqa: BLE001 — supervise, don't die
                if isinstance(e, WorkerTimeout):
                    self.stats.timeouts += 1
                else:
                    self.stats.failures += 1
                last = e
                if isinstance(e, WorkerTimeout) or \
                        not worker.alive(self.heartbeat_timeout):
                    self._restart(idx)
                if attempt + 1 < self.max_attempts:
                    self.stats.retries += 1
                    if delay > 0:
                        self.sleep(delay)
                    delay = min(delay * 2 if delay > 0 else delay,
                                self.backoff_max)
        raise WorkerFailed(
            f"solve group failed after {self.max_attempts} attempts") from last

    def close(self) -> None:
        for w in self.pool:
            self.stats.leaked_threads += getattr(w, "leaked", 0)
            self.stats.sigkills += getattr(w, "sigkills", 0)
            w.close()


def subprocess_supervisor(*, backend: str = "lockstep", device=None,
                          workers: int = 1,
                          timeout: Optional[float] = 30.0,
                          chaos=None, term_grace: float = 1.0,
                          heartbeat_interval: float = 0.5,
                          ignore_sigterm: bool = False,
                          wedge_every: int = 0, wedge_seconds: float = 0.0,
                          **supervisor_kw) -> Supervisor:
    """A :class:`Supervisor` over process-isolated workers, pre-wired.

    ``backend`` names the workers' engine (every engine gives the same
    floats) and ``device`` their device (``None``: CUDA, raising as the
    first worker is made without a card; a worker never runs on the CPU
    unasked).  The
    remaining keywords configure the transport (``chaos``, ``term_grace``,
    ``ignore_sigterm``, wedge test hooks) or pass through to
    :class:`Supervisor` (``max_attempts``, ``backoff_base``, ...).
    """
    worker_cls = functools.partial(
        SubprocessWorker, backend=backend, device=device, chaos=chaos,
        term_grace=term_grace,
        heartbeat_interval=heartbeat_interval, ignore_sigterm=ignore_sigterm,
        wedge_every=wedge_every, wedge_seconds=wedge_seconds)
    return Supervisor(None, workers=workers, worker_cls=worker_cls,
                      timeout=timeout, **supervisor_kw)
