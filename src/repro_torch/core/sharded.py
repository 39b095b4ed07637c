"""Multi-device sharded campaign engine: the fused loop with its rows split
over several devices.

The port of ``repro.core.sharded``.  A campaign over stacked instances is
embarrassingly parallel across rows, so this module runs the fused engine's
step (:mod:`repro_torch.core.fused`) on every device of a list at once, each
over its own block of rows:

  - Rows are split over ``torch.cuda.device_count()`` cards by default, or
    over the devices of an enclosing :func:`use_devices` block (the CPU
    tests pass several CPU devices; a list may name one card twice, which
    runs the split, the padding and the merge on one card).  Each device
    slot has its own programs, static buffers and graphs.
  - There is no cross-device traffic inside the loop: rows never interact.
    Each shard picks its own bucket at its own polls and stops on its own;
    every shard's iterations are enqueued before the host waits on the
    first poll, so the cards run side by side.
  - The batch is padded to a device multiple with INERT rows: padding rows
    carry row 0's instance data but start inactive, so they are live in no
    iteration, accept nothing, and are never written back.  A shard of
    padding rows only runs no iteration.  Per-device rows per chunk follow
    the fused engine's rule (:func:`repro_torch.core.fused.rows_per_chunk`
    of the shard's share of the batch), and the global chunk is that times
    the device count.

Equivalence contract: ``==`` ``backend="fused"`` (and so the reference's
numpy engine) on any device list: each row's floats come from the same step
on its own data; the split only changes where a row is computed.

Use via ``backend="sharded"`` on any :mod:`repro_torch.core.batched` entry
point, or ``engine="sharded"`` in :mod:`repro_torch.sim.experiments`.
Counters: :func:`trace_count` (bucket graphs captured by sharded runs),
:func:`dispatch_count` (step replays, summed over shards) and
:func:`sync_count` (host polls); bucket captures also count into
``fused.bucket_trace_count``, as in the reference.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from . import fused

__all__ = ["sharded_available", "device_count", "default_devices", "use_devices",
           "run_sharded", "run_sharded_bisection", "trace_count", "reset_trace_count",
           "dispatch_count", "reset_dispatch_count", "sync_count", "reset_sync_count"]

_COUNTS = fused._Counts()
_DEVICES: contextvars.ContextVar = contextvars.ContextVar("repro_torch_shard_devices",
                                                         default=None)


def trace_count() -> int:
    """Bucket graphs captured by sharded runs since the last reset."""
    return _COUNTS.traces


def reset_trace_count() -> None:
    _COUNTS.traces = 0


def dispatch_count() -> int:
    """Step replays of sharded runs, summed over shards, since the last reset."""
    return _COUNTS.dispatches


def reset_dispatch_count() -> None:
    _COUNTS.dispatches = 0


def sync_count() -> int:
    """Host polls of sharded runs since the last reset."""
    return _COUNTS.syncs


def reset_sync_count() -> None:
    _COUNTS.syncs = 0


def sharded_available(device=None) -> bool:
    """Whether the sharded engine can run on ``device`` (``None`` means CUDA)."""
    return fused.fused_available(device)


def default_devices(device=None) -> list:
    """The devices rows are split over for a batch on ``device`` (``None``
    means CUDA, which raises without a card): those of an enclosing
    :func:`use_devices` block, else every visible card for a CUDA batch and
    the one CPU for a CPU batch."""
    devs = _DEVICES.get()
    if devs is not None:
        return list(devs)
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def device_count(device=None) -> int:
    """Devices a batch on ``device`` is split over (:func:`default_devices`)."""
    return len(default_devices(device))


@contextlib.contextmanager
def use_devices(devices):
    """Split the rows of every sharded run in the block over ``devices`` (a
    list of torch devices or names; one may repeat)."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("use_devices needs at least one device")
    token = _DEVICES.set(devs)
    try:
        yield devs
    finally:
        _DEVICES.reset(token)


def run_sharded(state, k: int, bi_mode: np.ndarray, stop: np.ndarray,
                lat_limit: np.ndarray, record: Optional[Callable] = None) -> None:
    """Run the fused loop over ``state`` (a ``batched._BatchState``) with its
    rows split over :func:`default_devices`.  Drop-in replacement for
    :func:`fused.run_fused` — same write-back, same record replay, the same
    floats on any device list."""
    fused.run_loop(state, k, bi_mode, stop, lat_limit, record,
                   default_devices(state.pb.device), _COUNTS)


def run_sharded_bisection(pb, p_fix: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                          iters: int) -> dict:
    """The fused H4 binary search with its rows split over
    :func:`default_devices` — :func:`fused.run_fused_bisection`'s outputs,
    bit for bit."""
    return fused.run_bisection(pb, p_fix, lo, hi, iters,
                               default_devices(pb.device), _COUNTS)
