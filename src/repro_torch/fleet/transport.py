"""Wire protocol for process-isolated fleet workers: CRC-framed stdio pipes.

The controller and a :mod:`repro_torch.fleet.worker_main` subprocess speak a
length-prefixed, CRC-checked frame stream over the child's stdin/stdout:

    frame := magic b"RW" | payload length (u32 LE) | crc32(payload) (u32 LE)
             | payload (canonical JSON, sorted keys, no whitespace)

A frame's payload is ``[kind, body]`` — the same shape as the journal's
event wire records.  The kinds:

  controller -> worker
    ``["solve", {"id", "w", "delta", "s", "b"}]``  — one stacked solve group
    ``["wedge", {"seconds"}]``                     — chaos: sleep before the
                                                     next frame (a wedged
                                                     solve, injected in-band)
    ``["bye", {}]``                                — clean shutdown

  worker -> controller
    ``["hello", {"pid", "backend"}]``              — post-import readiness
    ``["heartbeat", {"pid", "solves"}]``           — periodic liveness beat
    ``["result", {"id", "results"}]``              — the solved group
    ``["error", {"id", "kind", "message"}]``       — the solve raised (the
                                                     worker itself is fine)

Bit-identity is the load-bearing property: solve groups ship as exact-float
JSON (``.tolist()`` + shortest-repr round-trip, the same codec contract as
:mod:`repro_torch.fleet.journal`) and are rebuilt with
:meth:`repro_torch.core.batched.ProblemBatch.from_arrays` on the worker's
device, which re-derives ``prefix``/``order`` exactly as the controller would
have; results travel through the journal's
:func:`~repro_torch.fleet.journal.encode_result` /
:func:`~repro_torch.fleet.journal.decode_result`.  So a subprocess solve
returns byte-for-byte what an
:class:`~repro_torch.fleet.supervision.InlineWorker` would have produced, and
``fleet_digest()`` cannot tell the transports apart (asserted in
tests/test_torch_fleet_recovery.py).  The frames are byte-identical to the
reference's (``repro.fleet.transport``).

Corruption anywhere in a frame — magic, length, CRC field, payload — is
*detected*, never silently absorbed: the reader raises :class:`FrameError`
and the supervisor declares the worker's stream poisoned, kills the process,
and replaces it.  A dropped or truncated frame stalls the reply and is reaped
by the controller's solve timeout.  :class:`TransportChaos` injects exactly
these faults at the transport boundary so the recovery paths are exercised,
counted, and gated rather than theoretical.
"""

from __future__ import annotations

import json
import struct
import time
import zlib
from typing import Optional

import numpy as np

from .journal import decode_result, encode_result  # noqa: F401  (re-exported)

MAGIC = b"RW"
_HEADER = struct.Struct("<2sII")   # magic, payload length, crc32(payload)
HEADER_BYTES = _HEADER.size

#: Hard ceiling on a single frame's payload.  Far above any real solve group
#: (the standard trace's groups are a few KB) but small enough that a
#: corrupted length field fails fast instead of waiting on gigabytes that
#: will never arrive.
MAX_FRAME_BYTES = 64 << 20


class FrameError(RuntimeError):
    """A frame failed its magic/length/CRC/parse check — the stream is
    desynchronized or corrupt and cannot be trusted past this point."""


def encode_frame(payload) -> bytes:
    """One wire frame: header (magic, length, CRC) + canonical JSON payload."""
    data = json.dumps(payload, separators=(",", ":"), sort_keys=True).encode()
    if len(data) > MAX_FRAME_BYTES:
        raise FrameError(f"payload of {len(data)} bytes exceeds the "
                         f"{MAX_FRAME_BYTES}-byte frame ceiling")
    return _HEADER.pack(MAGIC, len(data), zlib.crc32(data)) + data


class FrameReader:
    """Incremental frame parser over an arbitrary byte-chunk stream.

    ``feed()`` bytes as they arrive (pipes deliver whatever chunk sizes they
    like), then drain complete frames with ``next_frame()`` — ``None`` means
    the buffered prefix is still incomplete.  Any integrity failure raises
    :class:`FrameError`; there is deliberately NO resynchronization — a
    poisoned stream means a poisoned worker, and the supervisor's job is to
    replace it, not to guess where the next frame starts.
    """

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> None:
        self._buf += data

    @property
    def buffered(self) -> int:
        return len(self._buf)

    def next_frame(self):
        if len(self._buf) < HEADER_BYTES:
            return None
        magic, length, want = _HEADER.unpack_from(self._buf)
        if magic != MAGIC:
            raise FrameError(f"bad frame magic {bytes(magic)!r} — stream "
                             "desynchronized")
        if length > MAX_FRAME_BYTES:
            raise FrameError(f"frame length {length} exceeds the "
                             f"{MAX_FRAME_BYTES}-byte ceiling (corrupt "
                             "length field)")
        if len(self._buf) < HEADER_BYTES + length:
            return None
        data = bytes(self._buf[HEADER_BYTES:HEADER_BYTES + length])
        del self._buf[:HEADER_BYTES + length]
        got = zlib.crc32(data)
        if got != want:
            raise FrameError(f"frame CRC mismatch: header says {want:08x}, "
                             f"payload hashes to {got:08x}")
        try:
            payload = json.loads(data.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise FrameError(f"unparseable frame payload: {e}") from None
        if not (isinstance(payload, list) and len(payload) == 2
                and isinstance(payload[0], str)):
            raise FrameError(f"frame payload is not [kind, body]: "
                             f"{payload!r}")
        return payload


# ---------------------------------------------------------------------------
# Solve-group / result codecs (exact floats, like the journal's)
# ---------------------------------------------------------------------------

def encode_solve(request_id: int, batch) -> list:
    """``["solve", ...]`` payload for one stacked solve group.  Ships the raw
    (w, delta, s, b) arrays; ``prefix``/``order`` are re-derived on the
    worker side by ``ProblemBatch.from_arrays`` — bit-identically, because
    derivation is deterministic and the floats round-trip JSON exactly."""
    return ["solve", {"id": int(request_id),
                      "w": np.asarray(batch.w).tolist(),
                      "delta": np.asarray(batch.delta).tolist(),
                      "s": np.asarray(batch.s).tolist(),
                      "b": float(batch.b)}]


def decode_solve(body: dict, device=None):
    """Rebuild the :class:`~repro_torch.core.batched.ProblemBatch` on the
    worker, on ``device`` (``None``: CUDA)."""
    from ..core.batched import ProblemBatch

    return ProblemBatch.from_arrays(body["w"], body["delta"], body["s"],
                                    body["b"], device=device)


def encode_results(request_id: int, results) -> list:
    """``["result", ...]`` payload: the journal's exact-float result codec,
    one entry per batch row."""
    return ["result", {"id": int(request_id),
                       "results": [encode_result(r) for r in results]}]


def decode_results(body: dict) -> list:
    return [decode_result(d) for d in body["results"]]


# ---------------------------------------------------------------------------
# Wire-level fault injection
# ---------------------------------------------------------------------------

class TransportChaos:
    """Seeded fault injection at the subprocess transport boundary.

    The storm/flap/delivery chaos of :mod:`repro_torch.fleet.chaos` attacks the
    *telemetry* plane; this attacks the *worker* plane — the fault classes a
    real remote host exhibits:

      - ``doa_prob``       (per spawn)    worker dead on arrival (killed
                                          before its first heartbeat)
      - ``kill_prob``      (per dispatch) SIGKILL mid-solve, after the
                                          request is on the wire
      - ``wedge_prob``     (per dispatch) in-band ``wedge`` frame: the worker
                                          sleeps ``wedge_seconds`` — a hung
                                          solve the timeout must reap
      - ``drop_prob``      (per chunk)    inbound reply bytes silently lost
      - ``corrupt_prob``   (per chunk)    one inbound byte flipped (CRC or
                                          magic check trips)
      - ``truncate_prob``  (per chunk)    inbound chunk cut short (stalls or
                                          desyncs the stream)
      - ``delay_prob``     (per chunk)    inbound delivery delayed
                                          ``delay_seconds``

    Drop/truncate leave the controller waiting on a reply that never
    completes, so those faults are only recoverable with a solve ``timeout``
    configured — which is the point: the harness proves the timeout path.

    ``max_faults`` caps the total number of injections (deterministic tests,
    bounded restarts); ``counts`` records what actually fired, the ceiling
    on restarts — every worker restart must be attributable to an injected
    fault.
    """

    _PROBS = ("doa_prob", "kill_prob", "wedge_prob", "drop_prob",
              "corrupt_prob", "truncate_prob", "delay_prob")

    def __init__(self, *, doa_prob: float = 0.0, kill_prob: float = 0.0,
                 wedge_prob: float = 0.0, wedge_seconds: float = 30.0,
                 drop_prob: float = 0.0, corrupt_prob: float = 0.0,
                 truncate_prob: float = 0.0, delay_prob: float = 0.0,
                 delay_seconds: float = 0.02,
                 max_faults: Optional[int] = None, seed: int = 0):
        for name, v in [("doa_prob", doa_prob), ("kill_prob", kill_prob),
                        ("wedge_prob", wedge_prob), ("drop_prob", drop_prob),
                        ("corrupt_prob", corrupt_prob),
                        ("truncate_prob", truncate_prob),
                        ("delay_prob", delay_prob)]:
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{name} must be a probability, got {v}")
        if wedge_seconds < 0 or delay_seconds < 0:
            raise ValueError("wedge_seconds/delay_seconds must be >= 0")
        if max_faults is not None and max_faults < 0:
            raise ValueError(f"max_faults must be >= 0, got {max_faults}")
        self.doa_prob = doa_prob
        self.kill_prob = kill_prob
        self.wedge_prob = wedge_prob
        self.wedge_seconds = wedge_seconds
        self.drop_prob = drop_prob
        self.corrupt_prob = corrupt_prob
        self.truncate_prob = truncate_prob
        self.delay_prob = delay_prob
        self.delay_seconds = delay_seconds
        self.max_faults = max_faults
        self.rng = np.random.default_rng(seed)
        self.counts: dict = {}

    def total_faults(self) -> int:
        return sum(self.counts.values())

    def _fire(self, kind: str, prob: float) -> bool:
        if prob <= 0.0:
            return False
        if (self.max_faults is not None
                and self.total_faults() >= self.max_faults):
            return False
        if self.rng.random() >= prob:
            return False
        self.counts[kind] = self.counts.get(kind, 0) + 1
        return True

    # -- decision points (called by SubprocessWorker) -------------------------

    def spawn_dead_on_arrival(self) -> bool:
        return self._fire("doa", self.doa_prob)

    def kill_mid_solve(self) -> bool:
        return self._fire("kill", self.kill_prob)

    def wedge_solve(self) -> bool:
        return self._fire("wedge", self.wedge_prob)

    def mangle_chunk(self, chunk: bytes) -> Optional[bytes]:
        """Pass one inbound chunk through the lossy wire.  Returns the
        (possibly mangled) chunk, or ``None`` when it was dropped; a delay
        fault sleeps before delivering.  With all probabilities zero the
        chunk comes back untouched — chaos-disabled transport is
        byte-identical."""
        if not chunk:
            return chunk
        if self._fire("drop", self.drop_prob):
            return None
        if len(chunk) > 1 and self._fire("truncate", self.truncate_prob):
            return chunk[: int(self.rng.integers(1, len(chunk)))]
        if self._fire("corrupt", self.corrupt_prob):
            i = int(self.rng.integers(len(chunk)))
            mangled = bytearray(chunk)
            mangled[i] ^= 0xFF
            return bytes(mangled)
        if self._fire("delay", self.delay_prob):
            time.sleep(self.delay_seconds)
        return chunk
