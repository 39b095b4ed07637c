"""Deterministic data pipeline: synthetic LM streams and a prefetching
loader (the port of the reference's ``data/pipeline.py``).

The dataset is a deterministic function of (seed, step), numpy only, so a
restart from a checkpoint reproduces the exact token stream without
persisting cursor state beyond the step counter, and its batches are the
reference's for any (seed, step).  A background prefetch thread keeps
``prefetch`` batches ahead of the consumer, already on the device.  The
reference's ``make_batch_sharding`` is ported beside the batch spec, in
:mod:`repro_torch.models.sharding`; the loader does not split batches over
a mesh yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from .. import resolve_device

__all__ = ["ShardedLoader", "SyntheticLMDataset"]


class SyntheticLMDataset:
    """Deterministic synthetic token stream with a learnable structure
    (repeated n-gram motifs) so a ~100M model visibly learns."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, motif_len: int = 16, n_motifs: int = 64):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        rng = np.random.default_rng(seed)
        self.motifs = rng.integers(0, vocab_size, (n_motifs, motif_len))

    def batch(self, step: int) -> dict:
        """Batch for ``step`` — pure function of (seed, step)."""
        rng = np.random.default_rng((self.seed, step))
        B, S = self.global_batch, self.seq_len
        n, m = self.motifs.shape
        reps = S // m + 2
        idx = rng.integers(0, n, (B, reps))
        stream = self.motifs[idx].reshape(B, reps * m)[:, : S + 1]
        noise = rng.random((B, S + 1)) < 0.05
        stream = np.where(noise, rng.integers(0, self.vocab_size, (B, S + 1)), stream)
        return {
            "tokens": stream[:, :-1].astype(np.int32),
            "labels": stream[:, 1:].astype(np.int32),
        }


class ShardedLoader:
    """Prefetching loader that moves each batch to ``device`` (``None``
    means cuda) on its own thread; yields (step, batch of tensors)."""

    def __init__(self, dataset: SyntheticLMDataset, device=None,
                 start_step: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.device = resolve_device(device)
        self.step = start_step
        self.prefetch = prefetch
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _produce(self):
        step = self.step
        while not self._stop.is_set():
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.dataset.batch(step).items()}
            self._q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator:
        self._q = queue.Queue(maxsize=self.prefetch)
        self._stop.clear()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()
        try:
            while True:
                step, batch = self._q.get()
                self.step = step + 1
                yield step, batch
        finally:
            self._stop.set()

    def close(self):
        """Stop the prefetch thread: drain the queue (a producer blocked on a
        full one then wakes, sees the stop and ends) and join it."""
        self._stop.set()
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(10.0)
