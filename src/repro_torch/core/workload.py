"""Pipeline workload description — the application side of the paper's model.

The port's own copy of ``repro.core.workload`` (numpy, on the host):
``prefix_w`` keeps numpy's sequential ``cumsum`` so prefix sums are
bit-identical to the reference.

A pipeline of ``n`` stages S_1..S_n.  Stage S_k reads ``delta[k-1]`` bytes,
performs ``w[k]`` flops, writes ``delta[k]`` bytes (paper Section 2, Figure 1).
``delta`` therefore has ``n + 1`` entries: delta[0] is the input from the
outside world, delta[n] the final output.

``from_arch`` derives a workload from a model architecture config: layers are
stages, ``w_k`` is the per-layer analytic FLOP count, ``delta_k`` the
inter-layer activation bytes for the given input shape.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Workload:
    """The (w, delta) description of an n-stage pipeline."""

    w: np.ndarray        # shape (n,), flops per stage, w[i] is stage i+1 of the paper
    delta: np.ndarray    # shape (n+1,), bytes between stages (delta[0]=input, delta[n]=output)
    name: str = "workload"

    def __post_init__(self):
        w = np.asarray(self.w, dtype=np.float64)
        delta = np.asarray(self.delta, dtype=np.float64)
        object.__setattr__(self, "w", w)
        object.__setattr__(self, "delta", delta)
        if w.ndim != 1 or delta.ndim != 1:
            raise ValueError("w and delta must be 1-D")
        if len(delta) != len(w) + 1:
            raise ValueError(f"need len(delta) == n+1, got n={len(w)}, len(delta)={len(delta)}")
        if (w < 0).any() or (delta < 0).any():
            raise ValueError("w and delta must be non-negative")

    @property
    def n(self) -> int:
        return int(len(self.w))

    @property
    def total_work(self) -> float:
        return float(self.w.sum())

    def prefix_w(self) -> np.ndarray:
        """prefix_w()[i] = sum of w_1..w_i  (prefix_w()[0] == 0)."""
        return np.concatenate([[0.0], np.cumsum(self.w)])

    def interval_work(self, d: int, e: int) -> float:
        """Sum of w over stages d..e inclusive (1-indexed, paper convention)."""
        if not (1 <= d <= e <= self.n):
            raise ValueError(f"bad interval [{d},{e}] for n={self.n}")
        return float(self.w[d - 1 : e].sum())


def make_workload(w: Sequence[float], delta: Sequence[float], name: str = "workload") -> Workload:
    return Workload(np.asarray(w, dtype=np.float64), np.asarray(delta, dtype=np.float64), name)


def uniform_workload(n: int, w: float = 1.0, delta: float = 0.0) -> Workload:
    return Workload(np.full(n, w), np.full(n + 1, delta), name=f"uniform-{n}")
