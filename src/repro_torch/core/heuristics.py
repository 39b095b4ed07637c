"""The paper's six polynomial bi-criteria heuristics (Section 4) and their
split scoring.

All heuristics sort processors by non-increasing speed and start from the
optimal-latency solution: every stage on the fastest processor.  They then
repeatedly *split* the interval of the used processor with the largest cycle
time, enrolling the next fastest unused processor(s).

Fixed-period family (minimize latency under ``period <= P_fix``):
  - ``sp_mono_p``  (H1)  greedy split, mono-criterion choice
  - ``explo3_mono`` (H2) 3-way split, mono-criterion choice
  - ``explo3_bi``  (H3)  3-way split, bi-criteria (min max dLat/dPer) choice
  - ``sp_bi_p``    (H4)  binary search on authorized latency + bi-criteria split

Fixed-latency family (minimize period under ``latency <= L_fix``):
  - ``sp_mono_l``  (H5)  greedy split, mono-criterion choice
  - ``sp_bi_l``    (H6)  bi-criteria choice

The port's own copy of ``repro.core.heuristics``.  The splitting state, the
candidate choice (masks, ``np.lexsort``, the 3-way per-permutation key) and
the generator paths stay numpy on the host, as in the reference.  Each split
of the vectorized fast paths builds its inputs in numpy exactly as the
reference does (prefix sums, ``1.0 / s[j]``, and for 3-way splits ``dI`` /
``W`` / ``dO`` with their divisions by ``b``), copies them to the scoring
device in one transfer, scores every candidate there through
``score_kernels("cuda")`` (the hand-written kernels on the card, their plain
PyTorch versions on the CPU), and copies the scores back in one transfer.
Each lane's arithmetic is then the kernel's, which equals numpy's.

Device: every entry point that reaches split scoring takes ``device=None``.
``None`` means the device of an enclosing :func:`scoring_device` block, and
CUDA outside one (raising without a card).  The planner's entry points open
such a block, so a solver registered with the three-argument signature
``fn(workload, platform, objective)`` scores on the request's device.  A
block on the card loads the split-scoring kernels when it opens, and any
failure of scoring on the card is raised as :class:`ScoringDeviceError`,
which the solver and portfolio runs let through: a request for the card
scores there or raises.

Also here, for the lockstep engine (:mod:`repro_torch.core.batched`): the
plain PyTorch split-scoring functions :func:`score_2way` / :func:`score_3way`
with the reference's guarded expressions, element for element, in float64
(``heuristics.py:225-256, 308-322``), and :func:`score_kernels`.

Exactness: every ``*`` and ``+`` is its own torch op (no ``addcmul``, ``lerp``
or ``addmm``), so each is rounded once, as in numpy.  ``b`` is turned into a
float64 tensor on the data's device before dividing by it: a CUDA division by
a Python scalar is computed as a multiplication by its reciprocal, which is
not the IEEE quotient numpy computes.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import math
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from .metrics import Mapping
from .platform import Platform
from .workload import Workload

_EPS = 1e-12

_PERMS3 = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]


@dataclasses.dataclass
class HeuristicResult:
    """Outcome of one heuristic run."""

    mapping: Optional[Mapping]
    period: float
    latency: float
    feasible: bool          # constraint satisfied?
    splits: int             # number of accepted splits
    name: str

    @classmethod
    def failure(cls, name: str) -> "HeuristicResult":
        return cls(None, math.inf, math.inf, False, 0, name)


# ---------------------------------------------------------------------------
# The scoring device
# ---------------------------------------------------------------------------

_SCORING_DEVICE = contextvars.ContextVar("repro_torch_scoring_device", default=None)


def _resolve(device=None) -> torch.device:
    """``device``, else the enclosing :func:`scoring_device` block's, else CUDA."""
    return resolve_device(_SCORING_DEVICE.get() if device is None else device)


class ScoringDeviceError(RuntimeError):
    """Split scoring failed on a device other than the CPU: a kernel that did
    not build or launch, a copy, memory.  Not a solver fault: :func:`solve`
    and the planner's portfolio runs raise it rather than turn it into an
    infeasible candidate."""


def _device_fault(dev: torch.device, ex: Exception) -> ScoringDeviceError:
    return ScoringDeviceError(f"split scoring on {dev} failed: {type(ex).__name__}: {ex}")


@contextlib.contextmanager
def scoring_device(device=None):
    """Score the block's splits on ``device`` (``None``: the enclosing block's
    device, else CUDA).  On the card the split-scoring kernels are loaded
    (built first if needed) here, so a build failure raises before any solver
    runs.  Yields the resolved device."""
    dev = _resolve(device)
    if dev.type == "cuda":
        from ..kernels import build

        try:
            build.load("split_score")
        except Exception as ex:
            raise _device_fault(dev, ex) from ex
    token = _SCORING_DEVICE.set(dev)
    try:
        yield dev
    finally:
        _SCORING_DEVICE.reset(token)


# ---------------------------------------------------------------------------
# Mutable interval mapping state (host)
# ---------------------------------------------------------------------------

class _State:
    """Mutable interval mapping state shared by all heuristics."""

    force_reference = False  # class-wide switch: use generator candidate paths

    def __init__(self, workload: Workload, platform: Platform, device: torch.device):
        self.wl = workload
        self.pf = platform
        self.device = device                     # where the fast paths score splits
        self.order = platform.sorted_indices()   # processors, fastest first
        self.next_idx = 1                        # next unused processor in `order`
        fastest = int(self.order[0])
        # items: list of [d, e, proc], 1-indexed inclusive intervals, chain order.
        self.items: list = [[1, workload.n, fastest]]
        self._prefix = workload.prefix_w()
        # Incrementally-maintained metrics: one cycle time and one latency term
        # per item, plus the running latency sum, kept in sync by ``replace``.
        t0 = self.latency_term(1, workload.n, fastest)
        self._cycles: list = [self.cycle(1, workload.n, fastest)]
        self._lat_terms: list = [t0]
        self._lat_sum = t0
        self._tail = workload.delta[workload.n] / platform.b

    # -- elementary quantities ------------------------------------------------
    def interval_w(self, d: int, e: int) -> float:
        return self._prefix[e] - self._prefix[d - 1]

    def cycle(self, d: int, e: int, proc: int) -> float:
        wl, pf = self.wl, self.pf
        return wl.delta[d - 1] / pf.b + self.interval_w(d, e) / pf.s[proc] + wl.delta[e] / pf.b

    def cycles(self) -> np.ndarray:
        return np.asarray(self._cycles)

    def period(self) -> float:
        return float(max(self._cycles))

    def latency(self) -> float:
        return float(self._lat_sum + self._tail)

    def latency_term(self, d: int, e: int, proc: int) -> float:
        """This interval's contribution to Eq. (2) (input comm + compute)."""
        return self.wl.delta[d - 1] / self.pf.b + self.interval_w(d, e) / self.pf.s[proc]

    def worst_index(self) -> int:
        return self._cycles.index(max(self._cycles))

    def peek_procs(self, k: int) -> Optional[list]:
        """The next k fastest unused processors, or None if fewer remain."""
        if self.next_idx + k > len(self.order):
            return None
        return [int(self.order[self.next_idx + i]) for i in range(k)]

    def consume_procs(self, k: int) -> None:
        self.next_idx += k

    def replace(self, idx: int, parts: list) -> None:
        self.items[idx : idx + 1] = [list(p) for p in parts]
        new_terms = [self.latency_term(d, e, u) for d, e, u in parts]
        new_cycles = [self.cycle(d, e, u) for d, e, u in parts]
        add = 0.0
        for t in new_terms:
            add += t
        self._lat_sum = self._lat_sum - self._lat_terms[idx] + add
        self._lat_terms[idx : idx + 1] = new_terms
        self._cycles[idx : idx + 1] = new_cycles

    def mapping(self) -> Mapping:
        return Mapping(
            intervals=tuple((d, e) for d, e, _ in self.items),
            alloc=tuple(u for _, _, u in self.items),
        )

    def result(self, name: str, feasible: bool, splits: int) -> HeuristicResult:
        return HeuristicResult(self.mapping(), self.period(), self.latency(), feasible, splits, name)


# ---------------------------------------------------------------------------
# Candidate enumeration and choice (host; the generator paths of
# ``reference_mode`` and the 2-stage 3-way fallback)
# ---------------------------------------------------------------------------

def _two_way_candidates(st: _State, idx: int, jp: int):
    """All 2-way splits of item idx using new processor jp.

    Yields (parts, new_cycles, d_latency): parts = [(d,c,pa),(c+1,e,pb)] for
    every cut c and both placements, new_cycles their cycle times, d_latency
    the global latency delta of applying the split.
    """
    d, e, j = st.items[idx]
    base_lat_term = st.latency_term(d, e, j)
    for c in range(d, e):
        for pa, pb in ((j, jp), (jp, j)):
            parts = [(d, c, pa), (c + 1, e, pb)]
            cyc = [st.cycle(*p) for p in parts]
            dlat = sum(st.latency_term(*p) for p in parts) - base_lat_term
            yield parts, cyc, dlat


def _three_way_candidates(st, idx: int, jp: int, jpp: int):
    """All 3-way splits of item idx over processors {j, jp, jpp} (all 6 perms).

    Falls back to 2-way splits over the same processor choices when the
    interval has only 2 stages (a 3-way split needs >= 3 stages).
    """
    d, e, j = st.items[idx]
    base_lat_term = st.latency_term(d, e, j)
    if e - d + 1 >= 3:
        for c1 in range(d, e - 1):
            for c2 in range(c1 + 1, e):
                spans = [(d, c1), (c1 + 1, c2), (c2 + 1, e)]
                for perm in itertools.permutations((j, jp, jpp)):
                    parts = [(s0, s1, u) for (s0, s1), u in zip(spans, perm)]
                    cyc = [st.cycle(*p) for p in parts]
                    dlat = sum(st.latency_term(*p) for p in parts) - base_lat_term
                    yield parts, cyc, dlat
    elif e - d + 1 == 2:
        spans = [(d, d), (d + 1, e)]
        for pa, pb in itertools.permutations((j, jp, jpp), 2):
            parts = [(spans[0][0], spans[0][1], pa), (spans[1][0], spans[1][1], pb)]
            cyc = [st.cycle(*p) for p in parts]
            dlat = sum(st.latency_term(*p) for p in parts) - base_lat_term
            yield parts, cyc, dlat


def _pick_mono(candidates, old_cycle: float, lat_limit: float, cur_lat: float):
    """Mono-criterion choice: min over candidates of max(new cycles), only among
    strictly improving candidates (max new cycle < old cycle) whose resulting
    latency respects lat_limit.  Ties broken by latency delta, then shape."""
    best = None
    best_key = None
    for parts, cyc, dlat in candidates:
        mx = max(cyc)
        if mx >= old_cycle - _EPS:
            continue
        if cur_lat + dlat > lat_limit + _EPS:
            continue
        key = (mx, dlat, parts[0][1])
        if best_key is None or key < best_key:
            best, best_key = (parts, cyc, dlat), key
    return best


def _pick_bi(candidates, old_cycle: float, lat_limit: float, cur_lat: float):
    """Bi-criteria choice: min over candidates of max_i dLatency/dPeriod(i)
    (paper's ratio), among improving candidates respecting lat_limit."""
    best = None
    best_key = None
    for parts, cyc, dlat in candidates:
        mx = max(cyc)
        if mx >= old_cycle - _EPS:
            continue
        if cur_lat + dlat > lat_limit + _EPS:
            continue
        # dPeriod(i) = old worst cycle - new cycle of processor i; all > 0 here.
        ratio = max(dlat / max(old_cycle - c, _EPS) for c in cyc)
        key = (ratio, mx, parts[0][1])
        if best_key is None or key < best_key:
            best, best_key = (parts, cyc, dlat), key
    return best


# ---------------------------------------------------------------------------
# Plain PyTorch split scoring: the reference for the CUDA kernels
# ---------------------------------------------------------------------------

def score_2way(pre_d1, pre_C, pre_e, delta_d1, delta_C, delta_e, b,
               inv_j, inv_p, zero=0.0):
    """Cycle times and latency delta of every 2-way split of interval [d, e].

    Lanes ``pre_C``/``delta_C`` are (A, K) (the cut points), the interval-end
    columns (A, 1).  Returns ``(cyc1, cyc2, dlat)``, each (A, 2K), with the
    two placement orders concatenated along the last axis: first all cuts
    with the original processor ``j`` on the first part, then all cuts with
    ``j`` and the new processor ``jp`` swapped.  ``zero`` is the reference's
    FMA guard: every product feeding an add is written ``(a * b + zero)``.
    """
    b = torch.as_tensor(b, dtype=torch.float64, device=pre_C.device)
    W1 = pre_C - pre_d1
    W2 = pre_e - pre_C
    dIn = delta_d1 / b
    dMid = delta_C / b
    dOut = delta_e / b
    d_inv = inv_p - inv_j
    # order A: first part on j, second on jp; order B: swapped.
    cyc1 = torch.cat([dIn + (W1 * inv_j + zero) + dMid,
                      dIn + (W1 * inv_p + zero) + dMid], dim=-1)
    cyc2 = torch.cat([dMid + (W2 * inv_p + zero) + dOut,
                      dMid + (W2 * inv_j + zero) + dOut], dim=-1)
    dlat = torch.cat([dMid + (W2 * d_inv + zero),
                      dMid + (W1 * d_inv + zero)], dim=-1)
    return cyc1, cyc2, dlat


def score_3way(dI, W, dO, invp, base_term, zero=0.0):
    """Cycle times, latency delta and max cycle of 3-way splits.  ``dI``/
    ``W``/``dO`` carry the three parts on axis -2 and the (c1, c2) cut pairs
    on axis -1, ``invp`` the permuted inverse speeds, ``base_term`` the
    replaced interval's latency term.  Returns ``(cyc, dlat, mx)``; the part
    sum is left-associated, ``(c0 + c1) + c2``, as numpy sums 3 elements."""
    comp = dI + (W * invp + zero)
    cyc = comp + dO
    dlat = (comp[..., 0, :] + comp[..., 1, :] + comp[..., 2, :]) - base_term
    mx = cyc.amax(dim=-2)
    return cyc, dlat, mx


def score_kernels(impl: str = "cuda"):
    """``(score2, score3)`` with the ``score_2way`` / ``score_3way`` calling
    convention for the named implementation:

      - ``"torch"`` — the plain PyTorch functions above, on any device;
      - ``"cuda"``  — the wrappers of the hand-written kernels
        (:mod:`repro_torch.kernels.split_score`).  They take an extra per-row
        ``need`` (live-lane bound) and zero the lanes at or past it; a CUDA
        tensor launches the kernel, a CPU tensor runs the plain function.
    """
    if impl == "torch":
        return score_2way, score_3way
    if impl == "cuda":
        from ..kernels.split_score import score_2way_cuda, score_3way_cuda

        return score_2way_cuda, score_3way_cuda
    raise ValueError(f"unknown kernel implementation {impl!r}; use 'torch' or 'cuda'")


# ---------------------------------------------------------------------------
# Vectorized fast paths: inputs in numpy, scores on the state's device, the
# choice in numpy — bit-identical to the generator paths of reference_mode
# ---------------------------------------------------------------------------

def _device_scores(dev: torch.device, host: np.ndarray, score: Callable) -> np.ndarray:
    """Copy ``host`` to ``dev`` in one transfer (none on the CPU), score it
    with ``score(buf)`` and copy the flattened outputs back in one.  Any
    failure off the CPU is raised as :class:`ScoringDeviceError`."""
    try:
        buf = torch.from_numpy(host).to(dev)
        return torch.cat([t.reshape(-1) for t in score(buf)]).cpu().numpy()
    except Exception as ex:
        if dev.type == "cpu":
            raise
        raise _device_fault(dev, ex) from ex


def _best_split_2way_fast(st: _State, idx: int, jp: int, mode: str,
                          old_cycle: float, lat_limit: float, cur_lat: float):
    d, e, j = st.items[idx]
    if e == d:
        return None
    pre, delta, b, s = st._prefix, st.wl.delta, st.pf.b, st.pf.s
    C = np.arange(d, e)                       # cut points
    K = len(C)
    # columns (pre[d-1], pre[e], delta[d-1], delta[e], 1/s[j], 1/s[jp]), then
    # the cut lanes pre[C] and delta[C]: one buffer, one copy
    host = np.concatenate([[pre[d - 1], pre[e], delta[d - 1], delta[e],
                            1.0 / s[j], 1.0 / s[jp]], pre[C], delta[C]])
    score2, _ = score_kernels("cuda")

    def score(buf):
        col = [buf[i:i + 1].view(1, 1) for i in range(6)]
        return score2(col[0], buf[6:6 + K].view(1, K), col[1], col[2],
                      buf[6 + K:].view(1, K), col[3], b, col[4], col[5])

    scores = _device_scores(st.device, host, score)
    cyc1, cyc2, dlat = scores[:2 * K], scores[2 * K:4 * K], scores[4 * K:]
    cuts = np.concatenate([C, C])
    order = np.concatenate([np.zeros(len(C)), np.ones(len(C))])
    mx = np.maximum(cyc1, cyc2)
    okay = (mx < old_cycle - _EPS) & (cur_lat + dlat <= lat_limit + _EPS)
    if not okay.any():
        return None
    idxs = np.nonzero(okay)[0]
    if mode == "mono":
        keys = (mx[idxs], dlat[idxs], cuts[idxs], order[idxs])
    else:
        den1 = np.maximum(old_cycle - cyc1[idxs], _EPS)
        den2 = np.maximum(old_cycle - cyc2[idxs], _EPS)
        ratio = np.maximum(dlat[idxs] / den1, dlat[idxs] / den2)
        keys = (ratio, mx[idxs], cuts[idxs], order[idxs])
    best = idxs[np.lexsort(keys[::-1])[0]]
    c = int(cuts[best])
    if order[best] == 0:
        parts = [(d, c, j), (c + 1, e, jp)]
    else:
        parts = [(d, c, jp), (c + 1, e, j)]
    return parts, [float(cyc1[best]), float(cyc2[best])], float(dlat[best])


def _best_split_3way_fast(st: _State, idx: int, jp: int, jpp: int, mode: str,
                          old_cycle: float, lat_limit: float, cur_lat: float):
    d, e, j = st.items[idx]
    if e - d + 1 < 3:
        # fall back to the generator for the 2-stage case (cheap)
        cands = _three_way_candidates(st, idx, jp, jpp)
        pick = _pick_mono if mode == "mono" else _pick_bi
        return pick(cands, old_cycle, lat_limit, cur_lat)
    pre, delta, b, s = st._prefix, st.wl.delta, st.pf.b, st.pf.s
    procs = np.array([j, jp, jpp])
    inv = 1.0 / s[procs]
    c1, c2 = np.meshgrid(np.arange(d, e - 1), np.arange(d + 1, e), indexing="ij")
    valid = c2 > c1
    c1, c2 = c1[valid], c2[valid]
    K = len(c1)
    W = np.stack([pre[c1] - pre[d - 1], pre[c2] - pre[c1], pre[e] - pre[c2]])   # (3, K)
    dI = np.stack([np.full_like(c1, delta[d - 1], dtype=float), delta[c1], delta[c2]]) / b
    dO = np.stack([delta[c1], delta[c2], np.full_like(c1, delta[e], dtype=float)]) / b
    base_term = delta[d - 1] / b + (pre[e] - pre[d - 1]) / s[j]
    # the six permutations in one call: invp (1, 6, 3, 1)
    invp = np.stack([inv[list(perm)] for perm in _PERMS3])
    host = np.concatenate([dI.ravel(), W.ravel(), dO.ravel(), invp.ravel(), [base_term]])
    _, score3 = score_kernels("cuda")

    def score(buf):
        return score3(buf[:3 * K].view(1, 1, 3, K), buf[3 * K:6 * K].view(1, 1, 3, K),
                      buf[6 * K:9 * K].view(1, 1, 3, K),
                      buf[9 * K:9 * K + 18].view(1, 6, 3, 1), buf[9 * K + 18:].view(1, 1, 1))

    scores = _device_scores(st.device, host, score)   # cyc, dlat, mx
    cyc_all = scores[:18 * K].reshape(6, 3, K)
    dlat_all = scores[18 * K:24 * K].reshape(6, K)
    mx_all = scores[24 * K:].reshape(6, K)
    best_choice, best_key = None, None
    for pi, perm in enumerate(_PERMS3):
        cyc, dlat, mx = cyc_all[pi], dlat_all[pi], mx_all[pi]
        okay = (mx < old_cycle - _EPS) & (cur_lat + dlat <= lat_limit + _EPS)
        if not okay.any():
            continue
        ix = np.nonzero(okay)[0]
        if mode == "mono":
            keys = (mx[ix], dlat[ix], c1[ix].astype(float), c2[ix].astype(float))
        else:
            ratio = (dlat[ix] / np.maximum(old_cycle - cyc[:, ix], _EPS)).max(axis=0)
            keys = (ratio, mx[ix], c1[ix].astype(float), c2[ix].astype(float))
        o = ix[np.lexsort(keys[::-1])[0]]
        key = tuple(float(k[np.lexsort(keys[::-1])[0]]) for k in keys) + (pi,)
        if best_key is None or key < best_key:
            u = [procs[q] for q in perm]
            spans = [(d, int(c1[o])), (int(c1[o]) + 1, int(c2[o])), (int(c2[o]) + 1, e)]
            parts = [(s0, s1, int(uu)) for (s0, s1), uu in zip(spans, u)]
            cycv = [float(v) for v in cyc[:, o]]
            best_choice, best_key = (parts, cycv, float(dlat[o])), key
    return best_choice


# ---------------------------------------------------------------------------
# Generic splitting loop
# ---------------------------------------------------------------------------

def _splitting_loop(
    st: _State,
    *,
    n_new_procs: int,
    gen_candidates: Callable,
    pick: Callable,
    stop_when_period_leq: float = -math.inf,
    lat_limit: float = math.inf,
    on_split: Optional[Callable] = None,
) -> int:
    """Run the paper's splitting loop on state ``st``.

    Repeatedly: if the current period already satisfies ``stop_when_period_leq``
    stop; otherwise split the worst interval using the next ``n_new_procs``
    fastest unused processors, choosing the candidate with ``pick``.  Stops
    when stuck (no improving candidate / no processors / single-stage worst
    interval).  Returns the number of accepted splits.

    ``pick``/``gen_candidates`` identify the strategy; the loop dispatches to
    the vectorized fast paths (identical results, see tests) unless
    ``st.force_reference`` is set.  ``on_split(st)``, when given, is invoked
    after every accepted split (trajectory recording).
    """
    mode = "mono" if pick is _pick_mono else "bi"
    fast = not getattr(st, "force_reference", False)
    splits = 0
    while True:
        if st.period() <= stop_when_period_leq + _EPS:
            break
        idx = st.worst_index()
        d, e, j = st.items[idx]
        if e == d:  # single stage: cannot split
            break
        new_procs = st.peek_procs(n_new_procs)
        if new_procs is None:
            break
        old_cycle = st.cycle(d, e, j)
        cur_lat = st.latency()
        if fast and n_new_procs == 1:
            choice = _best_split_2way_fast(st, idx, new_procs[0], mode, old_cycle, lat_limit, cur_lat)
        elif fast and n_new_procs == 2:
            choice = _best_split_3way_fast(st, idx, new_procs[0], new_procs[1], mode,
                                           old_cycle, lat_limit, cur_lat)
        else:
            choice = pick(gen_candidates(st, idx, *new_procs), old_cycle, lat_limit, cur_lat)
        if choice is None:
            break
        parts, _, _ = choice
        st.replace(idx, parts)
        # Only consume the processors actually enrolled (a 3-way fallback on a
        # 2-stage interval may use just one of the pair).
        used = {u for _, _, u in parts} - {j}
        st.consume_procs(n_new_procs if len(used) == n_new_procs else len(used))
        splits += 1
        if on_split is not None:
            on_split(st)
    return splits


# ---------------------------------------------------------------------------
# Fixed-period heuristics (minimize latency s.t. period <= P_fix)
# ---------------------------------------------------------------------------

def sp_mono_p(workload: Workload, platform: Platform, p_fix: float,
              device=None) -> HeuristicResult:
    """H1 'Sp mono P': greedy mono-criterion splitting until period <= p_fix."""
    st = _State(workload, platform, _resolve(device))
    splits = _splitting_loop(
        st, n_new_procs=1, gen_candidates=_two_way_candidates, pick=_pick_mono,
        stop_when_period_leq=p_fix,
    )
    return st.result("Sp mono P", st.period() <= p_fix + _EPS, splits)


def explo3_mono(workload: Workload, platform: Platform, p_fix: float,
                device=None) -> HeuristicResult:
    """H2 '3-Explo mono': 3-way exploration, mono-criterion choice."""
    st = _State(workload, platform, _resolve(device))
    splits = _splitting_loop(
        st, n_new_procs=2, gen_candidates=_three_way_candidates, pick=_pick_mono,
        stop_when_period_leq=p_fix,
    )
    return st.result("3-Explo mono", st.period() <= p_fix + _EPS, splits)


def explo3_bi(workload: Workload, platform: Platform, p_fix: float,
              device=None) -> HeuristicResult:
    """H3 '3-Explo bi': 3-way exploration, bi-criteria (dLat/dPer) choice."""
    st = _State(workload, platform, _resolve(device))
    splits = _splitting_loop(
        st, n_new_procs=2, gen_candidates=_three_way_candidates, pick=_pick_bi,
        stop_when_period_leq=p_fix,
    )
    return st.result("3-Explo bi", st.period() <= p_fix + _EPS, splits)


def _bi_split_under_latency(workload: Workload, platform: Platform, p_fix: float,
                            lat_limit: float, device: torch.device) -> HeuristicResult:
    st = _State(workload, platform, device)
    splits = _splitting_loop(
        st, n_new_procs=1, gen_candidates=_two_way_candidates, pick=_pick_bi,
        stop_when_period_leq=p_fix, lat_limit=lat_limit,
    )
    feasible = st.period() <= p_fix + _EPS and st.latency() <= lat_limit + _EPS
    return st.result("Sp bi P(inner)", feasible, splits)


def sp_bi_p(workload: Workload, platform: Platform, p_fix: float,
            iters: int = 40, device=None) -> HeuristicResult:
    """H4 'Sp bi P': binary search over the authorized latency increase; at each
    probe, bi-criteria splitting constrained to the authorized latency; keep the
    smallest authorized latency that still yields ``period <= p_fix``."""
    dev = _resolve(device)
    lat_opt = _State(workload, platform, dev).latency()
    # Upper bound: every stage its own interval on the slowest processor.
    s_min = float(platform.s.min())
    lat_ub = float(
        workload.delta[:-1].sum() / platform.b
        + workload.total_work / s_min
        + workload.delta[-1] / platform.b
    )
    lo, hi = lat_opt, max(lat_ub, lat_opt)
    best: Optional[HeuristicResult] = None
    # Ensure feasibility at the upper end first.
    probe = _bi_split_under_latency(workload, platform, p_fix, hi, dev)
    if probe.feasible:
        best = probe
    else:
        return HeuristicResult(probe.mapping, probe.period, probe.latency, False, probe.splits, "Sp bi P")
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        probe = _bi_split_under_latency(workload, platform, p_fix, mid, dev)
        if probe.feasible:
            hi = mid
            if probe.latency < best.latency - _EPS or (
                abs(probe.latency - best.latency) <= _EPS and probe.period < best.period
            ):
                best = probe
        else:
            lo = mid
    return HeuristicResult(best.mapping, best.period, best.latency, True, best.splits, "Sp bi P")


# ---------------------------------------------------------------------------
# Fixed-latency heuristics (minimize period s.t. latency <= L_fix)
# ---------------------------------------------------------------------------

def sp_mono_l(workload: Workload, platform: Platform, l_fix: float,
              device=None) -> HeuristicResult:
    """H5 'Sp mono L': greedy mono-criterion splitting while latency <= l_fix."""
    st = _State(workload, platform, _resolve(device))
    if st.latency() > l_fix + _EPS:
        return HeuristicResult.failure("Sp mono L")
    splits = _splitting_loop(
        st, n_new_procs=1, gen_candidates=_two_way_candidates, pick=_pick_mono,
        lat_limit=l_fix,
    )
    return st.result("Sp mono L", True, splits)


def sp_bi_l(workload: Workload, platform: Platform, l_fix: float,
            device=None) -> HeuristicResult:
    """H6 'Sp bi L': bi-criteria splitting while latency <= l_fix."""
    st = _State(workload, platform, _resolve(device))
    if st.latency() > l_fix + _EPS:
        return HeuristicResult.failure("Sp bi L")
    splits = _splitting_loop(
        st, n_new_procs=1, gen_candidates=_two_way_candidates, pick=_pick_bi,
        lat_limit=l_fix,
    )
    return st.result("Sp bi L", True, splits)


def min_period_exhaustive(workload: Workload, platform: Platform,
                          device=None) -> HeuristicResult:
    """Unbounded min-period portfolio: every splitting strategy run to
    exhaustion, best result wins.

    With no latency constraint the paper's six heuristics collapse to four
    distinct exhaustion runs: H1 and H5 are the same 2-way/mono loop once the
    period stop-bound is unreachable and the latency limit is infinite, H6
    and H4's inner splitter (at unbounded authorized latency) are the 2-way/bi
    loop, and H2/H3 are the 3-way runs.  The winner is the lexicographically
    best (period, latency), ties broken by strategy order below — the scalar
    form of :func:`repro_torch.core.batched.batched_min_period`."""
    dev = _resolve(device)
    runs = (
        sp_mono_l(workload, platform, math.inf, device=dev),      # 2-way mono (H1/H5)
        sp_bi_l(workload, platform, math.inf, device=dev),        # 2-way bi   (H4/H6)
        explo3_mono(workload, platform, -math.inf, device=dev),   # 3-way mono (H2)
        explo3_bi(workload, platform, -math.inf, device=dev),     # 3-way bi   (H3)
    )
    best = min(range(len(runs)),
               key=lambda i: (runs[i].period, runs[i].latency, i))
    r = runs[best]
    # exhaustion runs carry the stop-bound's feasibility flag; the unbounded
    # objective is always satisfied
    return HeuristicResult(r.mapping, r.period, r.latency, True, r.splits, r.name)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

FIXED_PERIOD_HEURISTICS = {
    "H1": sp_mono_p,
    "H2": explo3_mono,
    "H3": explo3_bi,
    "H4": sp_bi_p,
}

FIXED_LATENCY_HEURISTICS = {
    "H5": sp_mono_l,
    "H6": sp_bi_l,
}

NAMES = {
    "H1": "Sp mono P",
    "H2": "3-Explo mono",
    "H3": "3-Explo bi",
    "H4": "Sp bi P",
    "H5": "Sp mono L",
    "H6": "Sp bi L",
}


def split_trajectory(code: str, workload: Workload, platform: Platform,
                     device=None) -> list:
    """Run a fixed-period heuristic to exhaustion (bound -inf) and return the
    (period, latency) trajectory: the state after 0, 1, 2, ... accepted splits.

    Because the split choices of H1/H2/H3 do not depend on the period bound
    (only the stopping point does), the result of the heuristic for ANY bound
    P_fix is the first trajectory state with period <= P_fix.  For H4 the
    trajectory of its inner bi-criteria splitter (whose top-of-binary-search
    probe is latency-unconstrained) characterizes feasibility the same way.
    """
    st = _State(workload, platform, _resolve(device))
    traj = [(st.period(), st.latency())]
    if code == "H1":
        gen, pick, k = _two_way_candidates, _pick_mono, 1
    elif code == "H2":
        gen, pick, k = _three_way_candidates, _pick_mono, 2
    elif code == "H3":
        gen, pick, k = _three_way_candidates, _pick_bi, 2
    elif code == "H4":
        gen, pick, k = _two_way_candidates, _pick_bi, 1
    else:
        raise KeyError(f"trajectories are for fixed-period heuristics, not {code}")
    _splitting_loop(
        st, n_new_procs=k, gen_candidates=gen, pick=pick,
        on_split=lambda s: traj.append((s.period(), s.latency())),
    )
    return traj


@contextlib.contextmanager
def reference_mode():
    """Force the readable generator-based candidate paths (for tests that
    check the vectorized fast paths are behavior-identical)."""
    old = _State.force_reference
    _State.force_reference = True
    try:
        yield
    finally:
        _State.force_reference = old


def run_heuristic(code: str, workload: Workload, platform: Platform, bound: float,
                  device=None) -> HeuristicResult:
    if code in FIXED_PERIOD_HEURISTICS:
        return FIXED_PERIOD_HEURISTICS[code](workload, platform, bound, device=device)
    if code in FIXED_LATENCY_HEURISTICS:
        return FIXED_LATENCY_HEURISTICS[code](workload, platform, bound, device=device)
    raise KeyError(f"unknown heuristic {code!r}")
