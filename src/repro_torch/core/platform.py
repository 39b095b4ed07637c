"""Target platform description — Communication-Homogeneous platforms.

Different-speed processors ``s_u`` interconnected by links of identical
bandwidth ``b`` (paper Section 2).  The port's own copy of what the campaign
path and the planner use from ``repro.core.platform``: the :class:`Platform`
record (with the reliability sequel's optional per-processor failure vector
``fail``, which the R1-R4 scenario families draw, read through
:attr:`Platform.failures` and replaced by :meth:`Platform.with_failures`),
its speed ordering, the straggler and failure events
:meth:`Platform.degrade` / :meth:`Platform.without`, the constructors
:func:`make_platform` / :func:`homogeneous_platform`, and the seeded failure
sampler :func:`sample_failures` (the reference's draws in the reference's
order).  Numpy on the host: platforms are tiny and their ordering and draws
feed the seed contract.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


def _suffix_once(name: str, suffix: str) -> str:
    """Append ``suffix`` unless the name already carries it (events that fire
    repeatedly must not grow the name without bound)."""
    return name if name.endswith(suffix) else name + suffix


@dataclasses.dataclass(frozen=True)
class Platform:
    """p processors with speeds ``s``, homogeneous link bandwidth ``b``, and
    optional per-processor failure probabilities ``fail`` (None = reliable)."""

    s: np.ndarray          # shape (p,), processor speeds (flops / time-unit)
    b: float               # link bandwidth (bytes / time-unit), identical links
    name: str = "platform"
    fail: Optional[np.ndarray] = None   # shape (p,), failure prob in [0, 1)

    def __post_init__(self):
        s = np.asarray(self.s, dtype=np.float64)
        object.__setattr__(self, "s", s)
        if s.ndim != 1 or len(s) == 0:
            raise ValueError("s must be a non-empty 1-D array")
        if (s <= 0).any():
            raise ValueError("processor speeds must be positive")
        if self.b <= 0:
            raise ValueError("bandwidth must be positive")
        if self.fail is not None:
            f = np.asarray(self.fail, dtype=np.float64)
            object.__setattr__(self, "fail", f)
            if f.shape != s.shape:
                raise ValueError(f"fail must have shape {s.shape}, got {f.shape}")
            if ((f < 0) | (f >= 1)).any():
                raise ValueError("failure probabilities must be in [0, 1)")

    @property
    def p(self) -> int:
        return int(len(self.s))

    @property
    def failures(self) -> np.ndarray:
        """Per-processor failure probabilities; zeros when ``fail`` is None
        (the bi-criteria model's perfectly reliable processors)."""
        if self.fail is None:
            return np.zeros(self.p)
        return self.fail

    def sorted_indices(self) -> np.ndarray:
        """Processor indices by non-increasing speed (ties broken by index,
        matching the paper's 'sort processors by non-increasing speed')."""
        return np.lexsort((np.arange(self.p), -self.s))

    def fastest(self) -> int:
        return int(self.sorted_indices()[0])

    def degrade(self, proc: int, factor: float) -> "Platform":
        """Return a platform where processor ``proc`` runs ``factor`` times slower.
        Used for straggler modeling."""
        if not (0 < factor):
            raise ValueError("factor must be positive")
        s = self.s.copy()
        s[proc] = s[proc] / factor
        return Platform(s, self.b, name=_suffix_once(self.name, "-degraded"),
                        fail=self.fail)

    def without(self, proc: int) -> "Platform":
        """The platform after processor ``proc`` died: speeds and failure
        probabilities both lose that row."""
        if self.p <= 1:
            raise ValueError("cannot remove the last processor")
        return Platform(np.delete(self.s, proc), self.b,
                        name=_suffix_once(self.name, "-failed"),
                        fail=(None if self.fail is None
                              else np.delete(self.fail, proc)))

    def with_failures(self, fail) -> "Platform":
        """The same platform with per-processor failure probabilities
        attached (or stripped, with ``fail=None``)."""
        return Platform(self.s, self.b, name=self.name,
                        fail=None if fail is None else np.asarray(fail, float))


def make_platform(s: Sequence[float], b: float, name: str = "platform",
                  fail=None) -> Platform:
    return Platform(np.asarray(s, dtype=np.float64), float(b), name,
                    fail=None if fail is None else np.asarray(fail, float))


def homogeneous_platform(p: int, s: float = 1.0, b: float = 10.0) -> Platform:
    return Platform(np.full(p, s), b, name=f"homog-{p}")


def sample_failures(p: int, *, kind: str = "uniform", lo: float = 1e-3,
                    hi: float = 2e-2, seed: Optional[int] = None,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Seeded per-processor failure-probability sampler (sequel model).

      - ``"uniform"``  — i.i.d. uniform in [lo, hi];
      - ``"bimodal"``  — mostly near ``lo`` with a flaky minority near ``hi``
        (20% of processors), the realistic mixed-fleet shape;
      - ``"loguniform"`` — log-uniform in [lo, hi], spanning orders of
        magnitude of hardware quality.

    Pass either ``seed`` (new Generator) or an existing ``rng`` (draws
    consume its stream — the scenario-family contract)."""
    if rng is None:
        rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(lo, hi, p)
    if kind == "bimodal":
        flaky = rng.random(p) < 0.2
        base = rng.uniform(lo, 2 * lo, p)
        bad = rng.uniform(0.5 * hi, hi, p)
        return np.where(flaky, bad, base)
    if kind == "loguniform":
        return np.exp(rng.uniform(np.log(lo), np.log(hi), p))
    raise ValueError(f"unknown failure sampler kind {kind!r}")
