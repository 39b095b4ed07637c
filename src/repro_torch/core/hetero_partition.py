"""Hetero-1D-Partition (the paper's Definition 1) and the NMWTS reduction.

HETERO-1D-PARTITION: partition n elements a_1..a_n into p intervals and find a
permutation sigma such that max_k sum(I_k)/s_sigma(k) <= K.

This module provides:
 - the problem as a (Workload, Platform) pair with zero communication,
 - the Theorem-1 reduction from Numerical Matching With Target Sums, used by
   the tests to machine-check both directions of the proof construction,
 - a direct checker.

The port's own copy of ``repro.core.hetero_partition``: host numpy, no
device (the reduction builds instances; the exact solver checks them).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .metrics import Mapping, period
from .platform import Platform
from .workload import Workload


@dataclasses.dataclass(frozen=True)
class Hetero1DInstance:
    a: np.ndarray  # element weights
    s: np.ndarray  # prescribed values (processor speeds)
    K: float       # bound

    def as_mapping_problem(self) -> tuple:
        """Theorem 2's conversion: stages w_i = a_i, all delta = 0, b = 1."""
        wl = Workload(np.asarray(self.a, float), np.zeros(len(self.a) + 1), name="hetero1d")
        pf = Platform(np.asarray(self.s, float), 1.0, name="hetero1d")
        return wl, pf

    def check(self, intervals: Sequence, sigma: Sequence[int]) -> bool:
        """Does (intervals, sigma) witness the bound K?  intervals are 1-indexed
        [d,e] pairs covering [1..n]; sigma[k] = processor for interval k."""
        wl, pf = self.as_mapping_problem()
        mp = Mapping(tuple(intervals), tuple(sigma))
        mp.validate(wl.n, pf.p)
        if len(mp.intervals) != pf.p:
            return False  # Definition 1 uses exactly p intervals
        return period(wl, pf, mp) <= self.K + 1e-9


@dataclasses.dataclass(frozen=True)
class NMWTSInstance:
    """Numerical Matching With Target Sums: do permutations sigma1, sigma2 exist
    with x_i + y_sigma1(i) = z_sigma2(i) for all i?"""

    x: np.ndarray
    y: np.ndarray
    z: np.ndarray

    @property
    def m(self) -> int:
        return len(self.x)

    def solve_small(self) -> Optional[tuple]:
        """Brute-force solver for tests (m <= 7). Returns (sigma1, sigma2) or None."""
        import itertools

        m = self.m
        if self.x.sum() + self.y.sum() != self.z.sum():
            return None
        zs = list(self.z)
        for s1 in itertools.permutations(range(m)):
            targets = [self.x[i] + self.y[s1[i]] for i in range(m)]
            # match targets to z values (multiset equality -> greedy by sorting)
            avail = sorted(range(m), key=lambda j: zs[j])
            order = sorted(range(m), key=lambda i: targets[i])
            s2 = [0] * m
            good = True
            for i, j in zip(order, avail):
                if targets[i] != zs[j]:
                    good = False
                    break
                s2[i] = j
            if good:
                return tuple(s1), tuple(s2)
        return None


def reduce_nmwts(inst: NMWTSInstance) -> Hetero1DInstance:
    """The Theorem-1 construction: 3m numbers -> (M+3)m tasks, 3m speeds, K=1."""
    x, y, z = inst.x, inst.y, inst.z
    m = inst.m
    M = int(max(x.max(), y.max(), z.max()))
    B, C, D = 2 * M, 5 * M, 7 * M
    tasks = []
    for i in range(m):
        tasks.append(B + int(x[i]))       # A_i
        tasks.extend([1] * M)             # M unit tasks
        tasks.append(C)
        tasks.append(D)
    speeds = (
        [B + int(z[i]) for i in range(m)]
        + [C + M - int(y[i]) for i in range(m)]
        + [D] * m
    )
    return Hetero1DInstance(np.asarray(tasks, float), np.asarray(speeds, float), K=1.0)


def witness_from_nmwts_solution(
    inst: NMWTSInstance, sigma1: Sequence[int], sigma2: Sequence[int]
) -> tuple:
    """Build the interval mapping used in the 'only if' direction of the proof:
    for each i, A_i plus y_sigma1(i) units -> P_sigma2(i); the remaining
    M - y_sigma1(i) units plus C -> P_{m+sigma1(i)}; D -> P_{2m+i}."""
    m = inst.m
    M = int(max(inst.x.max(), inst.y.max(), inst.z.max()))
    N = M + 3
    intervals = []
    procs = []
    for i in range(m):
        base = i * N  # 0-indexed start of block i
        yv = int(inst.y[sigma1[i]])
        intervals.append((base + 1, base + 1 + yv))            # A_i + yv units
        procs.append(sigma2[i])
        intervals.append((base + 2 + yv, base + N - 1))        # rest units + C
        procs.append(m + sigma1[i])
        intervals.append((base + N, base + N))                 # D
        procs.append(2 * m + i)
    return tuple(intervals), tuple(procs)


def extract_nmwts_solution(inst: NMWTSInstance, hinst: Hetero1DInstance,
                           intervals: Sequence, procs: Sequence[int]) -> Optional[tuple]:
    """The 'if' direction of the proof: given a K=1 witness for the reduced
    instance, recover (sigma1, sigma2).  Returns None if the witness does not
    have the structure forced by the proof (it always should)."""
    m = inst.m
    M = int(max(inst.x.max(), inst.y.max(), inst.z.max()))
    N = M + 3
    sigma1 = [-1] * m
    sigma2 = [-1] * m
    for (d, e), u in zip(intervals, procs):
        # Which block does this interval start in, and what does it contain?
        blk = (d - 1) // N
        start_in_blk = (d - 1) % N
        if start_in_blk == 0:
            # starts with A_blk: must be on some P_sigma2, h units follow
            if u >= m:
                return None
            h = e - d  # number of unit tasks
            sigma2[blk] = u
            # y_sigma1 for this block equals h (proof: y_{sigma1(i)} = h_i)
        elif (e - 1) % N == N - 2:
            # ends with C: processor must be some P_{m+j}
            if not (m <= u < 2 * m):
                return None
            sigma1[blk] = u - m
        elif start_in_blk == N - 1 and d == e:
            if not (2 * m <= u < 3 * m):
                return None
        else:
            return None
    if -1 in sigma1 or -1 in sigma2:
        return None
    return tuple(sigma1), tuple(sigma2)
