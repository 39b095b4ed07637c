"""Crash-safe file writes: the port's copy of the commit primitive of
``repro.checkpoint.checkpointer`` (``atomic_write_bytes``,
``atomic_write_json``), byte for byte the same files.  The fleet journal's
snapshots and WAL compaction commit through it."""

from __future__ import annotations

import json
import os
import pathlib


def atomic_write_bytes(path, data: bytes, fsync: bool = True) -> None:
    """Crash-safe file write: write to a same-directory temp file, fsync it,
    then atomically rename over the destination — a reader never observes a
    torn file, only the old bytes or the new bytes."""
    path = pathlib.Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        fh.write(data)
        if fsync:
            fh.flush()
            os.fsync(fh.fileno())
    os.replace(tmp, path)


def atomic_write_json(path, obj, fsync: bool = True) -> None:
    """``atomic_write_bytes`` for a JSON-serializable object."""
    atomic_write_bytes(path, json.dumps(obj).encode(), fsync=fsync)
