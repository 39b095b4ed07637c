"""Target platform description — Communication-Homogeneous platforms.

Different-speed processors ``s_u`` interconnected by links of identical
bandwidth ``b`` (paper Section 2).  The port's own copy of what the campaign
path uses from ``repro.core.platform``: the :class:`Platform` record (with the
reliability sequel's optional per-processor failure vector ``fail``, which the
R1-R4 scenario families draw), its speed ordering, the straggler and
failure events :meth:`Platform.degrade` / :meth:`Platform.without`, and the
constructors :func:`make_platform` / :func:`homogeneous_platform`.  Numpy on
the host: platforms are tiny and their ordering feeds the seed contract.
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


def make_platform(s: Sequence[float], b: float, name: str = "platform",
                  fail=None) -> Platform:
    return Platform(np.asarray(s, dtype=np.float64), float(b), name,
                    fail=None if fail is None else np.asarray(fail, float))


def homogeneous_platform(p: int, s: float = 1.0, b: float = 10.0) -> Platform:
    return Platform(np.full(p, s), b, name=f"homog-{p}")
