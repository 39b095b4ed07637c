"""Subprocess solve-worker entrypoint: ``python -m repro_torch.fleet.worker_main``.

The process-isolated half of the controller/worker split
(:mod:`repro_torch.fleet.supervision`).  The worker owns its whole execution
context — interpreter, engine state, CUDA context, memory — so a wedged,
leaking, or segfaulting solve takes down *this* process, never the
controller; the supervisor reaps it with SIGTERM→SIGKILL and spawns a
replacement.

``--device`` (default: CUDA) is where the worker builds its batches and
solves them.  A worker without a card exits with an error before its
``hello`` frame: it never runs on the CPU unless asked (``--device cpu``).
A solve that raises is reported in an ``error`` frame under its exception's
class name; a split-score fault on the card arrives as
``ScoringDeviceError``, which the controller raises as itself.

Protocol (:mod:`repro_torch.fleet.transport`): length-prefixed CRC-framed records
over stdin/stdout.  stdout carries *only* frames — anything else (diagnostics,
engine warnings) must go to stderr or it would desynchronize the stream.
The main loop is strictly serial: read a frame, act, reply; a daemon thread
emits ``heartbeat`` frames every ``--heartbeat-interval`` seconds so the
controller can tell "alive but slow" from "gone" (heartbeats prove the
*process* lives, not that a solve progresses — reaping a wedged solve is the
controller-side timeout's job).

Flags used by the chaos harness and tests:

  ``--ignore-sigterm``  installs SIG_IGN for SIGTERM, modeling a worker too
                        wedged to honor graceful shutdown — only SIGKILL
                        reaps it, which is exactly what the supervisor's
                        escalation path must prove it does.
  ``--wedge-every K``   every K-th solve sleeps ``--wedge-seconds`` before
                        replying (a deterministic hung solve, no chaos rng).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time

from .. import resolve_device
from .transport import (FrameError, FrameReader, decode_solve, encode_frame,
                        encode_results)

_READ_CHUNK = 1 << 16


def _write_all(fd: int, data: bytes) -> None:
    view = memoryview(data)
    while view:
        n = os.write(fd, view)
        view = view[n:]


class _Sender:
    """Serialized frame writes: the heartbeat thread and the main loop share
    stdout, and a frame larger than PIPE_BUF would interleave without the
    lock."""

    def __init__(self, fd: int):
        self.fd = fd
        self._lock = threading.Lock()

    def send(self, payload) -> None:
        data = encode_frame(payload)
        with self._lock:
            _write_all(self.fd, data)


def _heartbeat_loop(sender: _Sender, interval: float, stop: threading.Event,
                    state: dict) -> None:
    while not stop.wait(interval):
        try:
            sender.send(["heartbeat", {"pid": os.getpid(),
                                       "solves": state["solves"]}])
        except OSError:
            return   # controller is gone; the main loop will see EOF too


def serve(in_fd: int, out_fd: int, *, backend: str = "lockstep", device=None,
          heartbeat_interval: float = 0.5, wedge_every: int = 0,
          wedge_seconds: float = 0.0) -> int:
    """Frame-serve until EOF or a ``bye`` frame, solving on ``device``
    (``None``: CUDA, raising without a card before any frame is sent).
    Returns the exit code."""
    from ..core.batched import batched_min_period

    dev = resolve_device(device)

    sender = _Sender(out_fd)
    state = {"solves": 0}
    stop = threading.Event()
    beat = threading.Thread(target=_heartbeat_loop,
                            args=(sender, heartbeat_interval, stop, state),
                            name="fleet-worker-heartbeat", daemon=True)
    beat.start()
    sender.send(["hello", {"pid": os.getpid(), "backend": backend}])
    reader = FrameReader()
    try:
        while True:
            try:
                payload = reader.next_frame()
            except FrameError as e:
                # The controller's request stream is corrupt: there is no
                # request id to attach an error to, and no way to resync.
                print(f"worker {os.getpid()}: poisoned request stream: {e}",
                      file=sys.stderr)
                return 2
            if payload is None:
                chunk = os.read(in_fd, _READ_CHUNK)
                if not chunk:
                    return 0   # controller closed the pipe: clean shutdown
                reader.feed(chunk)
                continue
            kind, body = payload
            if kind == "bye":
                return 0
            if kind == "wedge":
                # In-band injected hang: sleep as if the next solve wedged.
                time.sleep(float(body.get("seconds", 0.0)))
                continue
            if kind == "solve":
                rid = int(body["id"])
                if wedge_every and (state["solves"] + 1) % wedge_every == 0:
                    time.sleep(wedge_seconds)
                try:
                    results = batched_min_period(decode_solve(body, dev), backend)
                except Exception as e:  # noqa: BLE001 — report, stay alive
                    sender.send(["error", {"id": rid,
                                           "kind": type(e).__name__,
                                           "message": str(e)}])
                    continue
                state["solves"] += 1
                sender.send(encode_results(rid, results))
                continue
            print(f"worker {os.getpid()}: ignoring unknown frame kind "
                  f"{kind!r}", file=sys.stderr)
    finally:
        stop.set()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.fleet.worker_main")
    ap.add_argument("--backend", default="lockstep",
                    help="engine of batched_min_period: lockstep, fused or sharded")
    ap.add_argument("--device", default=None,
                    help="device the solves run on (default: cuda; without a "
                         "card the worker exits with an error)")
    ap.add_argument("--heartbeat-interval", type=float, default=0.5)
    ap.add_argument("--ignore-sigterm", action="store_true",
                    help="model a worker too wedged for graceful shutdown "
                         "(only SIGKILL reaps it)")
    ap.add_argument("--wedge-every", type=int, default=0,
                    help="every K-th solve sleeps --wedge-seconds (0 = off)")
    ap.add_argument("--wedge-seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)   # no card: raise before any frame
    if args.ignore_sigterm:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
    return serve(sys.stdin.fileno(), sys.stdout.fileno(),
                 backend=args.backend, device=device,
                 heartbeat_interval=args.heartbeat_interval,
                 wedge_every=args.wedge_every,
                 wedge_seconds=args.wedge_seconds)


if __name__ == "__main__":
    sys.exit(main())
