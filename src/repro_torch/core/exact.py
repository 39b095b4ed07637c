"""Exact and strong-baseline solvers for the mapping problem.

The port's own copy of ``repro.core.exact``: numpy and Python on the host,
line for line, since a summation or enumeration order defines each result.

The period-minimization problem is NP-hard (paper Theorem 2), so exact solvers
are exponential in ``p`` — they exist to measure heuristic optimality gaps on
small/medium instances and to power property tests.

 - ``brute_force``          : full enumeration, tiny instances (n<=10, p<=6).
 - ``exact_min_period``     : binary search on K + interval/bitmask DP; exact,
                              practical to p ~ 14, any n (O(2^p n^2) feasibility).
 - ``dp_homogeneous_period``: exact O(n^2 p) DP when all speeds are equal
                              (the classic chains-to-chains with comm terms).
 - ``dp_speed_ordered``     : beyond-paper baseline — exact *under the
                              constraint* that faster processors take earlier
                              intervals; polynomial O(n^2 p^2).
 - ``pareto_exact``         : exact bi-criteria Pareto front, tiny instances.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import numpy as np

from .metrics import Mapping, all_interval_partitions, latency
from .platform import Platform
from .workload import Workload


def _cycle_table(workload: Workload, platform: Platform) -> np.ndarray:
    """cyc[d-1, e-1, u] = cycle time of interval [d,e] on processor u."""
    n, p = workload.n, platform.p
    pre = workload.prefix_w()
    cyc = np.full((n, n, p), np.inf)
    for d in range(1, n + 1):
        for e in range(d, n + 1):
            wsum = pre[e] - pre[d - 1]
            comm = workload.delta[d - 1] / platform.b + workload.delta[e] / platform.b
            cyc[d - 1, e - 1, :] = comm + wsum / platform.s
    return cyc


def _latency_table(workload: Workload, platform: Platform,
                   cyc: np.ndarray) -> np.ndarray:
    """lat[d-1, e-1, u] = interval [d,e]'s Eq. (2) term on processor u
    (input comm + compute; the final-output term is added by callers).
    Derived from the cycle table: the cycle just adds the output comm."""
    return cyc - (workload.delta[1:] / platform.b)[None, :, None]


def _enumerated_metrics(workload: Workload, platform: Platform, m: int,
                        cyc_t: np.ndarray, lat_t: np.ndarray) -> tuple:
    """Stack every (partition into m intervals, distinct-processor assignment)
    and evaluate them all at once: returns (parts (C,m,2), procs (P,m),
    per (C,P), lat (C,P)).  Row-major (partition-major) order matches the
    nested loops of the scalar enumeration, so stable argmins agree."""
    n, p = workload.n, platform.p
    parts = np.array(list(all_interval_partitions(n, m)), dtype=np.intp)
    procs = np.array(list(itertools.permutations(range(p), m)), dtype=np.intp)
    if parts.ndim == 2:            # m == 1: (C, 2) -> (C, 1, 2)
        parts = parts[:, None, :]
    D = parts[:, None, :, 0] - 1
    E = parts[:, None, :, 1] - 1
    U = procs[None, :, :]
    per = cyc_t[D, E, U].max(axis=-1)
    lat = lat_t[D, E, U].sum(axis=-1) + workload.delta[n] / platform.b
    return parts, procs, per, lat


# ---------------------------------------------------------------------------
# Brute force (tiny)
# ---------------------------------------------------------------------------

def brute_force(
    workload: Workload,
    platform: Platform,
    *,
    period_cap: float = math.inf,
    latency_cap: float = math.inf,
    objective: str = "period",
) -> Optional[Mapping]:
    """Enumerate all (partition, distinct-processor assignment); return the best
    mapping under the caps, minimizing ``objective`` ('period' or 'latency'),
    breaking ties on the other criterion.  None if infeasible.

    The enumeration is evaluated in stacked numpy batches (one per interval
    count) rather than per-mapping Python loops; tie-breaking order is
    identical to the scalar enumeration."""
    n, p = workload.n, platform.p
    cyc_t = _cycle_table(workload, platform)
    lat_t = _latency_table(workload, platform, cyc_t)
    best: Optional[Mapping] = None
    best_key = (math.inf, math.inf)
    for m in range(1, min(n, p) + 1):
        parts, procs, per, lat = _enumerated_metrics(workload, platform, m, cyc_t, lat_t)
        ok = (per <= period_cap + 1e-12) & (lat <= latency_cap + 1e-12)
        if not ok.any():
            continue
        a, c = (per, lat) if objective == "period" else (lat, per)
        a = np.where(ok, a, np.inf).ravel()
        c = np.where(ok, c, np.inf).ravel()
        first = np.lexsort((c, a))[0]
        key = (float(a[first]), float(c[first]))
        if key < best_key:
            ci, pi = divmod(int(first), procs.shape[0])
            best = Mapping(tuple(map(tuple, parts[ci])), tuple(int(u) for u in procs[pi]))
            best_key = key
    return best


def pareto_exact(workload: Workload, platform: Platform) -> list:
    """All Pareto-optimal (period, latency) points over every mapping (tiny
    instances).  Candidate evaluation is fully vectorized over the stacked
    enumeration."""
    n, p = workload.n, platform.p
    cyc_t = _cycle_table(workload, platform)
    lat_t = _latency_table(workload, platform, cyc_t)
    pts = []
    for m in range(1, min(n, p) + 1):
        _, _, per, lat = _enumerated_metrics(workload, platform, m, cyc_t, lat_t)
        pts.append(np.stack([per.ravel(), lat.ravel()], axis=1))
    from .pareto import pareto_front

    return pareto_front(np.concatenate(pts))


# ---------------------------------------------------------------------------
# Exact min-period via threshold search + bitmask feasibility
# ---------------------------------------------------------------------------

def _feasible(cyc: np.ndarray, n: int, p: int, K: float) -> Optional[list]:
    """Is there a partition + distinct assignment with every cycle <= K?
    DP over (stages consumed, frozenset of used processors) — memoized on
    (e, mask).  Returns the item list [(d,e,u)] or None.

    ok[d-1, e-1, u] = cyc[d,e,u] <= K.  f(e, mask): stages 1..e assignable
    using exactly the processors in mask.
    """
    ok = cyc <= K + 1e-12
    # f[e] = set of masks achievable covering stages 1..e. Use dict e -> set(masks).
    from functools import lru_cache

    procs = range(p)

    @lru_cache(maxsize=None)
    def f(e: int, mask: int) -> Optional[tuple]:
        if e == 0:
            return () if mask == 0 else None
        for u in procs:
            if not (mask >> u) & 1:
                continue
            sub = mask & ~(1 << u)
            for d in range(1, e + 1):
                if ok[d - 1, e - 1, u] and (res := f(d - 1, sub)) is not None:
                    return res + ((d, e, u),)
        return None

    for m in range(1, min(n, p) + 1):
        for combo in itertools.combinations(procs, m):
            mask = sum(1 << u for u in combo)
            if (res := f(n, mask)) is not None:
                return list(res)
    return None


def exact_min_period(
    workload: Workload, platform: Platform, latency_cap: float = math.inf
) -> Optional[Mapping]:
    """Exact minimum-period mapping via binary search over the O(n^2 p) candidate
    cycle values + bitmask feasibility DP.  With ``latency_cap`` the feasibility
    check additionally verifies the latency (making it exact for the bi-criteria
    problem at a given latency bound, at extra cost)."""
    n, p = workload.n, platform.p
    cyc = _cycle_table(workload, platform)
    cands = np.unique(cyc[np.isfinite(cyc)])
    # keep only values achievable as some interval cycle
    mask_valid = np.zeros_like(cyc, dtype=bool)
    for d in range(1, n + 1):
        mask_valid[d - 1, d - 1 :, :] = True
    cands = np.unique(cyc[mask_valid])

    def try_K(K: float) -> Optional[Mapping]:
        items = _feasible(cyc, n, p, K)
        if items is None:
            return None
        mp = Mapping(tuple((d, e) for d, e, _ in items), tuple(u for _, _, u in items))
        if latency(workload, platform, mp) > latency_cap + 1e-12:
            return _feasible_with_latency(cyc, workload, platform, K, latency_cap)
        return mp

    lo, hi = 0, len(cands) - 1
    if try_K(cands[hi]) is None:
        return None
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        mp = try_K(float(cands[mid]))
        if mp is not None:
            best = mp
            hi = mid - 1
        else:
            lo = mid + 1
    return best


def _feasible_with_latency(
    cyc: np.ndarray, workload: Workload, platform: Platform, K: float, latency_cap: float
) -> Optional[Mapping]:
    """Feasibility under both cycle<=K and total latency <= cap: DP minimizing
    latency over (e, mask).  Exponential in p; used only when a latency cap is set."""
    n, p = workload.n, platform.p
    ok = cyc <= K + 1e-12
    pre = workload.prefix_w()
    b = platform.b
    from functools import lru_cache

    @lru_cache(maxsize=None)
    def g(e: int, mask: int):
        """min latency contribution for stages 1..e using processor set = mask."""
        if e == 0:
            return (0.0, ()) if mask == 0 else (math.inf, None)
        best = (math.inf, None)
        for u in range(p):
            if not (mask >> u) & 1:
                continue
            sub = mask & ~(1 << u)
            for d in range(1, e + 1):
                if not ok[d - 1, e - 1, u]:
                    continue
                prev_cost, prev_items = g(d - 1, sub)
                if prev_items is None:
                    continue
                cost = prev_cost + workload.delta[d - 1] / b + (pre[e] - pre[d - 1]) / platform.s[u]
                if cost < best[0]:
                    best = (cost, prev_items + ((d, e, u),))
        return best

    tail = workload.delta[n] / b
    overall = (math.inf, None)
    for m in range(1, min(n, p) + 1):
        for combo in itertools.combinations(range(p), m):
            mask = sum(1 << u for u in combo)
            cost, items = g(n, mask)
            if items is not None and cost + tail <= latency_cap + 1e-12 and cost < overall[0]:
                overall = (cost, items)
    if overall[1] is None:
        return None
    items = overall[1]
    return Mapping(tuple((d, e) for d, e, _ in items), tuple(u for _, _, u in items))


def exact_min_latency(
    workload: Workload, platform: Platform, period_cap: float = math.inf
) -> Optional[Mapping]:
    """Exact minimum-latency mapping subject to ``period <= period_cap``.

    DP over (stages consumed, processor mask) minimizing the Eq. (2) sum with
    every interval cycle <= the cap — the same machinery as the latency-capped
    feasibility check of :func:`exact_min_period`, with the roles of the two
    criteria swapped.  Exponential in p; None when the cap is infeasible.
    Without a cap this reduces to Lemma 1 (whole chain on the fastest
    processor)."""
    cyc = _cycle_table(workload, platform)
    return _feasible_with_latency(cyc, workload, platform, float(period_cap), math.inf)


# ---------------------------------------------------------------------------
# Polynomial DPs
# ---------------------------------------------------------------------------

def dp_homogeneous_period(workload: Workload, p: int, s: float, b: float) -> tuple:
    """Exact min period for identical processors (chains-to-chains with comms).
    Returns (period, intervals).  O(n^2 p)."""
    n = workload.n
    pre = workload.prefix_w()

    def cyc(d, e):
        return workload.delta[d - 1] / b + (pre[e] - pre[d - 1]) / s + workload.delta[e] / b

    INF = math.inf
    # f[k][e] = min over partitions of 1..e into k intervals of max cycle
    f = [[INF] * (n + 1) for _ in range(p + 1)]
    cut = [[-1] * (n + 1) for _ in range(p + 1)]
    f[0][0] = 0.0
    for k in range(1, p + 1):
        for e in range(1, n + 1):
            for d in range(1, e + 1):
                v = max(f[k - 1][d - 1], cyc(d, e))
                if v < f[k][e]:
                    f[k][e] = v
                    cut[k][e] = d
    best_k = min(range(1, p + 1), key=lambda k: f[k][n])
    # backtrack
    intervals = []
    e, k = n, best_k
    while e > 0:
        d = cut[k][e]
        intervals.append((d, e))
        e, k = d - 1, k - 1
    intervals.reverse()
    return f[best_k][n], tuple(intervals)


def dp_speed_ordered(workload: Workload, platform: Platform,
                     latency_cap: float = math.inf) -> Optional[Mapping]:
    """Beyond-paper polynomial baseline: exact min-period mapping *under the
    constraint* that processors are assigned to intervals in non-increasing
    speed order (fastest gets the first interval).  O(n^2 p^2) DP over
    (stage e, index into the speed-sorted list).  Ignores the latency cap
    unless set (then applied as a post-check)."""
    n = workload.n
    order = platform.sorted_indices()
    p = len(order)
    pre = workload.prefix_w()
    b = platform.b

    def cyc(d, e, oi):
        u = order[oi]
        return workload.delta[d - 1] / b + (pre[e] - pre[d - 1]) / platform.s[u] + workload.delta[e] / b

    INF = math.inf
    # f[oi][e]: min max-cycle covering stages 1..e where the *last* interval uses
    # speed-order index oi (processors with smaller index may be skipped).
    f = np.full((p, n + 1), INF)
    back = {}
    for oi in range(p):
        for e in range(1, n + 1):
            for d in range(1, e + 1):
                c = cyc(d, e, oi)
                if d == 1:
                    prev = 0.0
                    key = None
                else:
                    prev = INF
                    key = None
                    for oj in range(oi):
                        if f[oj][d - 1] < prev:
                            prev = f[oj][d - 1]
                            key = oj
                    if key is None:
                        continue
                v = max(prev, c)
                if v < f[oi][e]:
                    f[oi][e] = v
                    back[(oi, e)] = (d, key)
    end = min(range(p), key=lambda oi: f[oi][n])
    if not math.isfinite(f[end][n]):
        return None
    items = []
    oi, e = end, n
    while e > 0:
        d, prev_oi = back[(oi, e)]
        items.append((d, e, int(order[oi])))
        e = d - 1
        if prev_oi is None:
            break
        oi = prev_oi
    items.reverse()
    mp = Mapping(tuple((d, e) for d, e, _ in items), tuple(u for _, _, u in items))
    if latency(workload, platform, mp) > latency_cap + 1e-12:
        return None
    return mp
