"""Canonical instance signatures: exact dedup of relabeled replan problems.

Two replan requests are *the same problem* when their workloads are equal and
their platforms are equal up to a renaming of processor indices.  The paper's
heuristics touch the platform only through ``Platform.sorted_indices()`` (the
stable non-increasing-speed order) and the speed values themselves, so the
solve depends on the *sorted speed sequence*, not on which physical pod
carries which speed:

  Relabeling theorem.  Let ``perm = platform.sorted_indices()`` and let the
  canonical platform carry speeds ``s[perm]``.  Every split decision, period
  and latency the heuristics produce on the canonical platform is bit-for-bit
  the one they produce on the original, with processor ``c`` of the canonical
  solve standing for processor ``perm[c]`` of the original.  (On the
  canonical platform ``sorted_indices()`` is the identity — speeds are
  non-increasing and equal speeds sit in increasing index order — so both
  runs enroll the same speed sequence and score identical candidates.)

Hence: solve the canonical problem once, fan the result back out through each
subscriber's ``perm`` via :func:`remap_alloc`.  The signature is a blake2b
digest of the canonical problem bytes — exact equality of (n, p, b, w, delta,
sorted s), no tolerance — so a cache hit can never change a result, only
skip work.  ``span_bucket`` exposes the fused engine's power-of-two grid
bucket for the instance (grouping solves by bucket keeps batched grids
dense); tests assert the dedup path is bit-identical to solo scalar replans.

The port's copy hashes the same bytes in the same order, with the port's
``Platform.sorted_indices`` (the same stable sort), so its digest strings
are the reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct

import numpy as np

from ..core import Platform, Workload


def span_bucket(n: int) -> int:
    """The fused engine's grid bucket: smallest power of two >= n (stage
    count == the widest interval a split can ever score)."""
    if n < 1:
        raise ValueError("need n >= 1")
    return 1 << (int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class Signature:
    """Identity of a canonical replan problem.

    ``digest`` decides equality; (n, p, b) ride along because only
    same-shaped problems can be stacked into one ``ProblemBatch``, and
    ``bucket`` is the fused-grid span bucket for the instance.
    """

    digest: str
    n: int
    p: int
    b: float

    @property
    def bucket(self) -> int:
        return span_bucket(self.n)

    @property
    def shape(self) -> tuple:
        return (self.n, self.p, self.b)


def signature(workload: Workload, platform: Platform) -> Signature:
    """Canonical signature of a replan problem: hash of the exact bytes of
    (n, p, b, w, delta, speed-sorted s) — plus the speed-sorted failure
    probabilities when the platform carries them (reliability-floor replans
    depend on them; platforms without a failure model hash exactly the
    bi-criteria bytes)."""
    order = platform.sorted_indices()
    h = hashlib.blake2b(digest_size=16)
    h.update(struct.pack("<qqd", workload.n, platform.p, float(platform.b)))
    h.update(np.ascontiguousarray(workload.w).tobytes())
    h.update(np.ascontiguousarray(workload.delta).tobytes())
    h.update(np.ascontiguousarray(platform.s[order]).tobytes())
    if platform.fail is not None:
        h.update(b"fail")
        h.update(np.ascontiguousarray(platform.fail[order]).tobytes())
    return Signature(h.hexdigest(), workload.n, platform.p, float(platform.b))


def canonicalize(platform: Platform) -> tuple:
    """(canonical platform, perm): speeds sorted non-increasing, stable.
    ``perm[c]`` is the original index of canonical processor ``c``.  Failure
    probabilities (when present) follow their processors through the
    permutation."""
    perm = platform.sorted_indices()
    canon = Platform(platform.s[perm], platform.b, name=f"{platform.name}-canon",
                     fail=None if platform.fail is None else platform.fail[perm])
    return canon, perm


def remap_alloc(alloc, perm) -> tuple:
    """Translate a canonical-space processor allocation back to the original
    instance's indices (see the relabeling theorem above)."""
    return tuple(int(perm[a]) for a in alloc)
