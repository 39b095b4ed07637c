"""Checkpoint primitives of the port.  Today only the crash-safe file
writes under the fleet journal (:mod:`repro_torch.fleet.journal`); the
training checkpoints of ``repro.checkpoint`` are not ported yet."""

from .checkpointer import atomic_write_bytes, atomic_write_json

__all__ = ["atomic_write_bytes", "atomic_write_json"]
