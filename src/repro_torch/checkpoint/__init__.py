"""Checkpointing of the port (the reference's ``repro.checkpoint``): the
training checkpoints, in the reference's on-disk format, and the crash-safe
file writes under them and under the fleet journal
(:mod:`repro_torch.fleet.journal`)."""

from .checkpointer import (CheckpointManager, Checkpointer, atomic_write_bytes,
                           atomic_write_json)

__all__ = ["CheckpointManager", "Checkpointer", "atomic_write_bytes", "atomic_write_json"]
