"""Write-ahead journal + snapshots: the fleet controller's durability layer.

The :class:`~repro_torch.fleet.service.ReplanService` is deterministic and RNG-free:
its entire future behavior is a function of (current state, future events).
That makes crash safety a replay problem —

  - every tick's incoming events are appended to a **write-ahead log**
    *before* any state mutates (one CRC-checked record per tick), and
  - a full **snapshot** of service state is written every ``snapshot_every``
    ticks with an atomic temp-file + rename commit
    (:func:`repro_torch.checkpoint.atomic_write_bytes`, the port's copy of the
    reference's checkpoint commit primitive).

Recovery (:meth:`ReplanService.restore`) loads the newest CRC-valid snapshot
and re-applies the WAL tail through the ordinary ``tick()`` path; because
replay is the service's determinism contract, the restored controller's
``fleet_digest()`` is **bit-identical** to an uninterrupted run (asserted in
tests/test_torch_fleet_recovery.py over every crash point of a seeded chaos
trace).

The port's files are byte-compatible with ``repro.fleet.journal``'s: the
same records, the same snapshot state.  So the port's
:meth:`ReplanService.restore` reads a journal the reference wrote.

Record format — one record per line, human-greppable, torn-write safe::

    <crc32 of payload, 8 lowercase hex chars> <payload JSON, no newlines>\n

A WAL record's payload is ``{"tick": t, "events": [[type, fields], ...]}``
(:func:`repro_torch.fleet.telemetry.event_to_wire`); a snapshot file holds exactly
one record whose payload is ``{"tick": t, "state": {...}}``.  Floats survive
JSON exactly (shortest-repr round-trip), so nothing here introduces
tolerance.  A torn or corrupt record is *detected* (CRC or parse failure):
readers recover to the longest good prefix by default, or raise
:class:`JournalError` in strict mode.  On snapshot, older snapshots beyond
``keep_snapshots`` are pruned and the WAL is compacted down to the records
the *oldest retained* snapshot has not absorbed — so recovery can fall back
past a corrupt newest snapshot and still replay forward.
"""

from __future__ import annotations

import json
import os
import pathlib
import zlib
from typing import Optional, Tuple

from ..checkpoint.checkpointer import atomic_write_bytes
from .telemetry import event_to_wire  # noqa: F401  (re-exported for callers)

WAL_NAME = "wal.log"
SNAPSHOT_GLOB = "snapshot_*.json"
FORMAT_VERSION = 1


class JournalError(RuntimeError):
    """A journal record failed its CRC/parse check, or the WAL has a gap."""


def encode_record(payload) -> bytes:
    """One journal line: crc32 of the canonical JSON payload, then the JSON."""
    data = json.dumps(payload, separators=(",", ":"), sort_keys=True).encode()
    return b"%08x " % zlib.crc32(data) + data + b"\n"


def decode_record(line: bytes):
    """Inverse of :func:`encode_record`; raises :class:`JournalError` on a
    torn, truncated, or corrupt record."""
    line = line.rstrip(b"\n")
    if len(line) < 10 or line[8:9] != b" ":
        raise JournalError(f"malformed journal record ({len(line)} bytes)")
    crc_hex, data = line[:8], line[9:]
    try:
        want = int(crc_hex, 16)
    except ValueError:
        raise JournalError(f"bad CRC field {crc_hex!r}") from None
    got = zlib.crc32(data)
    if got != want:
        raise JournalError(f"CRC mismatch: record says {want:08x}, "
                           f"payload hashes to {got:08x}")
    try:
        return json.loads(data.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise JournalError(f"unparseable journal payload: {e}") from None


class Journal:
    """One service's durability directory: ``wal.log`` plus
    ``snapshot_<tick>.json`` files.

    ``snapshot_every`` is the snapshot cadence knob (service ticks between
    full-state snapshots; it bounds the WAL replay length after a crash),
    ``keep_snapshots`` the retention depth, and ``fsync`` whether appends and
    snapshot commits are forced to stable storage (leave on anywhere a crash
    matters; tests turn it off for speed).
    """

    def __init__(self, directory, *, snapshot_every: int = 8,
                 keep_snapshots: int = 2, fsync: bool = True):
        if snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, got {snapshot_every}")
        if keep_snapshots < 1:
            raise ValueError(f"keep_snapshots must be >= 1, got {keep_snapshots}")
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.snapshot_every = int(snapshot_every)
        self.keep_snapshots = int(keep_snapshots)
        self.fsync = bool(fsync)
        self._fh = None

    @property
    def wal_path(self) -> pathlib.Path:
        return self.dir / WAL_NAME

    # -- write side -----------------------------------------------------------

    def append(self, tick: int, events) -> None:
        """WAL-append one tick's events.  Called by the service *before* any
        state mutates; the record is flushed (and fsynced) before return, so
        a controller killed mid-tick can replay the tick from disk."""
        payload = {"tick": int(tick),
                   "events": [event_to_wire(e) for e in events]}
        data = encode_record(payload)
        if self._fh is None:
            self._fh = open(self.wal_path, "ab")
        self._fh.write(data)
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())

    def write_snapshot(self, tick: int, state: dict) -> None:
        """Atomically commit a full-state snapshot taken *after* processing
        ticks ``< tick``, then prune old snapshots and compact the WAL down
        to the records the snapshot has not absorbed."""
        payload = {"format": FORMAT_VERSION, "tick": int(tick), "state": state}
        atomic_write_bytes(self.dir / f"snapshot_{int(tick):08d}.json",
                           encode_record(payload), fsync=self.fsync)
        for _, path in self._snapshot_paths()[:-self.keep_snapshots]:
            path.unlink(missing_ok=True)
        # Compact against the OLDEST retained snapshot, not the newest: if
        # the newest turns out torn/corrupt, restore can fall back to an
        # older snapshot and still find its WAL tail on disk.
        retained = self._snapshot_paths()
        self._compact(retained[0][0] if retained else int(tick))

    def _compact(self, tick: int) -> None:
        """Drop WAL records already absorbed by the snapshot at ``tick``."""
        records, _ = self.read_wal()
        keep = [r for r in records if r["tick"] >= tick]
        self.close()
        atomic_write_bytes(self.wal_path,
                           b"".join(encode_record(r) for r in keep),
                           fsync=self.fsync)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- read side ------------------------------------------------------------

    def read_wal(self, strict: bool = False) -> Tuple[list, Optional[str]]:
        """All decodable WAL records, in append order.

        Returns ``(records, error)`` where ``error`` is ``None`` for a clean
        log or a description of the first bad record (a torn tail from a
        crash mid-append, or corruption).  Reading always recovers to the
        longest good prefix; ``strict=True`` raises :class:`JournalError`
        instead of tolerating the bad record.
        """
        if not self.wal_path.exists():
            return [], None
        records: list = []
        for idx, line in enumerate(self.wal_path.read_bytes().split(b"\n")):
            if not line:
                continue
            try:
                records.append(decode_record(line))
            except JournalError as e:
                if strict:
                    raise JournalError(
                        f"{self.wal_path} record {idx}: {e}") from None
                return records, f"record {idx}: {e}"
        return records, None

    def _snapshot_paths(self) -> list:
        out = []
        for p in sorted(self.dir.glob(SNAPSHOT_GLOB)):
            try:
                out.append((int(p.stem.split("_")[1]), p))
            except (IndexError, ValueError):
                continue
        return out

    def latest_snapshot(self) -> Optional[tuple]:
        """Newest CRC-valid snapshot as ``(tick, state)``; snapshots that
        fail their check (torn by a crash, hand-corrupted) are skipped in
        favor of the next older one."""
        for _, path in reversed(self._snapshot_paths()):
            try:
                payload = decode_record(path.read_bytes())
            except JournalError:
                continue
            if payload.get("format") != FORMAT_VERSION:
                continue
            return int(payload["tick"]), payload["state"]
        return None


# ---------------------------------------------------------------------------
# State codec: exact JSON round-trip for every object in a snapshot
# ---------------------------------------------------------------------------
# All floats go through Python's shortest-repr JSON path (exact for float64,
# including the values numpy's .tolist() hands back), ints stay ints, and
# tuples are restored as tuples — so a decoded plan reprs (and therefore
# fleet_digest()s) identically to the original.

def encode_workload(wl) -> dict:
    return {"w": wl.w.tolist(), "delta": wl.delta.tolist(), "name": wl.name}


def decode_workload(d):
    from ..core import Workload
    import numpy as np

    return Workload(np.asarray(d["w"], float), np.asarray(d["delta"], float),
                    name=d["name"])


def encode_platform(pf) -> dict:
    return {"s": pf.s.tolist(), "b": float(pf.b), "name": pf.name,
            "fail": None if pf.fail is None else pf.fail.tolist()}


def decode_platform(d):
    from ..core import Platform
    import numpy as np

    return Platform(np.asarray(d["s"], float), d["b"], name=d["name"],
                    fail=None if d["fail"] is None
                    else np.asarray(d["fail"], float))


def encode_mapping(m) -> dict:
    return {"intervals": [list(iv) for iv in m.intervals],
            "alloc": list(m.alloc)}


def decode_mapping(d):
    from ..core import Mapping

    return Mapping(tuple((int(a), int(b)) for a, b in d["intervals"]),
                   tuple(int(a) for a in d["alloc"]))


def encode_plan(plan) -> Optional[dict]:
    if plan is None:
        return None
    return {"mapping": encode_mapping(plan.mapping),
            "period": plan.period, "latency": plan.latency,
            "planner": plan.planner,
            "stage_sizes": list(plan.stage_sizes),
            "max_stage_size": plan.max_stage_size,
            "padding_overhead": plan.padding_overhead,
            "groups": None if plan.groups is None
            else [list(g) for g in plan.groups]}


def decode_plan(d):
    from ..core import StagePlan

    if d is None:
        return None
    return StagePlan(decode_mapping(d["mapping"]), d["period"], d["latency"],
                     d["planner"], tuple(int(s) for s in d["stage_sizes"]),
                     int(d["max_stage_size"]), d["padding_overhead"],
                     None if d["groups"] is None
                     else tuple(tuple(int(u) for u in g)
                                for g in d["groups"]))


def encode_result(res) -> dict:
    return {"mapping": None if res.mapping is None
            else encode_mapping(res.mapping),
            "period": res.period, "latency": res.latency,
            "feasible": res.feasible, "splits": res.splits, "name": res.name}


def decode_result(d):
    from ..core.heuristics import HeuristicResult

    return HeuristicResult(
        None if d["mapping"] is None else decode_mapping(d["mapping"]),
        d["period"], d["latency"], d["feasible"], int(d["splits"]), d["name"])


def encode_monitor(mon) -> Optional[dict]:
    if mon is None:
        return None
    return {"num_stages": mon.num_stages, "alpha": mon.alpha,
            "threshold": mon.threshold,
            "ewma": None if mon.ewma is None else mon.ewma.tolist()}


def decode_monitor(d):
    from ..pipeline.replan import StragglerMonitor
    import numpy as np

    if d is None:
        return None
    mon = StragglerMonitor(int(d["num_stages"]), alpha=d["alpha"],
                           threshold=d["threshold"])
    if d["ewma"] is not None:
        mon.ewma = np.asarray(d["ewma"], float)
    return mon
