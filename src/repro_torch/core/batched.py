"""Lockstep campaign engine on a torch device: the paper's heuristics over
stacked instances.

The port of ``repro.core.batched`` (numpy/JAX).  B homogeneously-shaped
problems run in *lockstep* with structure-of-arrays state; each iteration
evaluates a whole batch of worst-interval selections, split scorings and
state updates, with per-problem masks tracking convergence.

Where things live:

  - on the device: the SoA state (``arr``, ``packed``, ``m``, ``next_idx``,
    ``lat_sum``, ``active``, ``splits``), the gathers of per-interval
    quantities, the split scoring (the hand-written CUDA kernels of
    :mod:`repro_torch.kernels.split_score`, through ``score_kernels("cuda")``)
    and the lexicographic candidate selection;
  - on the host, on purpose: the loop's control decisions (which rows are
    still splitting, the lane count, the span partition of
    :func:`_split_by_span` with its ``np.median``), the 2-stage 3-way
    fallback (scalar candidate generator over host rows, rare and tiny),
    ``np.lexsort`` in :func:`batched_min_period`, the H4 bisection
    bookkeeping and its ``view(np.int64)`` probe-dedup keys, and every
    numpy summation whose order defines a result (prefix sums, search
    bounds, :func:`evaluate_state_rows`).

Each lockstep iteration syncs with the host a few times: to compact the rows
still splitting, to read the lane count (or, for 3-way splits, the spans),
and to read back what a recorder needs.

Equivalence contract: every float this engine produces is bit-identical to
``repro.core.batched`` with ``backend="numpy"``.  The elementwise expressions
are the reference's, one torch op per numpy op, in float64, with ``b`` a
device tensor (never a Python scalar divisor, which CUDA turns into a
multiplication by the reciprocal); max/min/argmax reductions are
order-exact; nothing is summed by a torch reduction.

Device faults: on a batch off the CPU, every public entry point loads the
split-score library first and raises any failure of its run (a kernel that
does not build or launch, a copy, a graph capture or replay, memory) as
:class:`~repro_torch.core.heuristics.ScoringDeviceError`, as the planner's
entry points do; nothing falls back to the host.  The engine's host logic is
the same on every device and is held ``==`` the reference on the CPU, so what
fails only off the CPU is the device.

Entry points take a :class:`ProblemBatch`, which carries the device
(``ProblemBatch.from_arrays(..., device=None)`` means CUDA;
:func:`stack_instances` stacks (workload, platform) pairs), and a
``backend``: ``"lockstep"`` (default) is the loop of this module;
``"fused"`` runs the whole loop on the device, one fixed-shape step per
iteration replayed as a CUDA graph (:mod:`repro_torch.core.fused`), and
``"sharded"`` the same loop with its rows split over several devices
(:mod:`repro_torch.core.sharded`).  All three give the same floats.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..kernels import build
from ..kernels.split_score import pair_need
from .heuristics import (_EPS, _PERMS3, HeuristicResult, ScoringDeviceError,
                         _device_fault, _pick_bi, _pick_mono,
                         _three_way_candidates, score_kernels)
from .metrics import Mapping

__all__ = [
    "ProblemBatch", "stack_instances", "batched_trajectories",
    "batched_trajectory_sets", "batched_fixed_latency", "batched_min_period", "batched_sp_bi_p",
    "evaluate_state_rows", "h4_search_bounds", "BACKENDS",
]

BACKENDS = ("lockstep", "fused", "sharded")

F64 = torch.float64
I64 = torch.int64

_SCORE2, _SCORE3 = score_kernels("cuda")

# Device-memory budget of one 3-way scoring call.  The (rows, 6 perms,
# 3 parts, K pairs) working set of ``_choose_3way`` (gathers, kernel inputs
# and outputs, ratio and selection keys) peaks near _BYTES_PER_LANE bytes per
# (row, pair lane); rows are chunked so one call stays within the budget.
# Results are per row, so chunking cannot change them.
_CHUNK_BYTES = 2 << 30
_BYTES_PER_LANE = 1024


# ---------------------------------------------------------------------------
# Problem stacking
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProblemBatch:
    """B equally-shaped problems, one row per problem.

    Host copies (numpy): ``w`` (B, n), ``delta`` (B, n+1), ``s`` (B, p),
    ``prefix`` (B, n+1) stage-work prefix sums, ``order`` (B, p) speed-sorted
    processor indices; they feed the scalar fallback, the metric evaluation
    and the search bounds.  Device tensors: ``packed`` = [delta | prefix | s]
    per row (float64, so the hot paths fetch several per-interval quantities
    in one gather), ``order_t`` (int64) and ``b_t`` (0-dim float64).
    """

    w: np.ndarray
    delta: np.ndarray
    s: np.ndarray
    b: float
    prefix: np.ndarray
    order: np.ndarray
    device: torch.device
    packed: torch.Tensor
    order_t: torch.Tensor
    b_t: torch.Tensor

    @property
    def B(self) -> int:
        return self.w.shape[0]

    @property
    def n(self) -> int:
        return self.w.shape[1]

    @property
    def p(self) -> int:
        return self.s.shape[1]

    @classmethod
    def from_arrays(cls, w, delta, s, b: float, prefix=None, order=None,
                    device=None) -> "ProblemBatch":
        """Build a batch from the reference's ``ProblemBatch`` fields as numpy
        arrays.  ``prefix`` and ``order`` default to the reference's
        derivation (numpy's sequential ``cumsum`` and a stable speed sort), so
        results stay bit-identical to a reference batch of the same arrays.
        ``device=None`` means CUDA (see :func:`repro_torch.resolve_device`)."""
        dev = resolve_device(device)
        w = np.asarray(w, dtype=np.float64)
        delta = np.asarray(delta, dtype=np.float64)
        s = np.asarray(s, dtype=np.float64)
        if w.ndim != 2 or s.ndim != 2 or s.shape[0] != w.shape[0]:
            raise ValueError(f"need 2-D stacked rows, got w{w.shape} s{s.shape}")
        B, n = w.shape
        if delta.shape != (B, n + 1):
            raise ValueError(f"need delta shape (B, n+1), got {delta.shape}")
        if prefix is None:
            prefix = np.concatenate([np.zeros((B, 1)), np.cumsum(w, axis=1)], axis=1)
        if order is None:
            order = np.lexsort((np.broadcast_to(np.arange(s.shape[1]), s.shape), -s),
                               axis=-1)
        prefix = np.asarray(prefix, dtype=np.float64)
        order = np.asarray(order, dtype=np.int64)
        if prefix.shape != (B, n + 1) or order.shape != s.shape:
            raise ValueError(f"need prefix (B, n+1) and order (B, p), got "
                             f"{prefix.shape} and {order.shape}")
        with _device_faults(dev, load=False):
            packed = torch.from_numpy(np.concatenate([delta, prefix, s], axis=1)).to(dev)
            order_t = torch.from_numpy(np.ascontiguousarray(order)).to(dev)
            b_t = torch.tensor(float(b), dtype=F64, device=dev)
        return cls(w=w, delta=delta, s=s, b=float(b), prefix=prefix, order=order,
                   device=dev, packed=packed, order_t=order_t, b_t=b_t)

    def take(self, rows) -> "ProblemBatch":
        """Sub-batch of the given rows (with repetition allowed — used to tile
        instances across a bound grid)."""
        rows = np.asarray(rows, dtype=np.int64)
        idx = torch.from_numpy(rows).to(self.device)
        return ProblemBatch(self.w[rows], self.delta[rows], self.s[rows], self.b,
                            self.prefix[rows], self.order[rows], self.device,
                            self.packed[idx], self.order_t[idx], self.b_t)


def stack_instances(pairs: Sequence, device=None) -> ProblemBatch:
    """Stack (Workload, Platform) pairs of identical shape into a
    :class:`ProblemBatch` on ``device`` (``None``: CUDA) — the reference's
    ``stack_instances``: ``prefix`` from each workload's ``prefix_w()``,
    ``order`` from each platform's ``sorted_indices()``."""
    if not len(pairs):
        raise ValueError("empty batch")
    n = pairs[0][0].n
    p = pairs[0][1].p
    b = float(pairs[0][1].b)
    for wl, pf in pairs:
        if wl.n != n or pf.p != p or float(pf.b) != b:
            raise ValueError("all instances in a batch must share n, p, and b")
    return ProblemBatch.from_arrays(
        np.stack([wl.w for wl, _ in pairs]), np.stack([wl.delta for wl, _ in pairs]),
        np.stack([pf.s for _, pf in pairs]), b,
        prefix=np.stack([wl.prefix_w() for wl, _ in pairs]),
        order=np.stack([pf.sorted_indices() for _, pf in pairs]), device=device)


@contextlib.contextmanager
def _device_faults(dev: torch.device, load: bool = True):
    """Off the CPU: load the split-score library first (``load``) and raise
    any failure of the block as :class:`ScoringDeviceError`."""
    if dev.type == "cpu":
        yield
        return
    try:
        if load:
            build.load("split_score")
        yield
    except ScoringDeviceError:
        raise
    except Exception as ex:
        raise _device_fault(dev, ex) from ex


# ---------------------------------------------------------------------------
# Lockstep splitting state
# ---------------------------------------------------------------------------

class _BatchState:
    """SoA splitting state of B problems, on the batch's device.

    Items (1-indexed intervals + processor) live in chain order in a padded
    (B, n, 5) float64 tensor ``arr`` together with each item's cycle time and
    latency term (padding: zeros with cycle -inf); ``m`` counts valid items
    per row.  d/e/proc are small integers, exactly represented in float64.
    """

    # arr field layout: 0=d, 1=e, 2=proc, 3=cycle, 4=latency term
    F_D, F_E, F_U, F_CYC, F_TERM = range(5)

    def __init__(self, pb: ProblemBatch, active=None):
        B, n, dev = pb.B, pb.n, pb.device
        self.pb = pb
        self.off_pre = n + 1
        self.off_s = 2 * (n + 1)
        P = pb.packed
        fastest = pb.order_t[:, 0]
        rows = torch.arange(B, device=dev)
        term0 = (P[:, 0] / pb.b_t
                 + (P[:, self.off_pre + n] - P[:, self.off_pre]) / P[rows, self.off_s + fastest])
        self.tail = P[:, n] / pb.b_t
        self.arr = torch.zeros((B, n, 5), dtype=F64, device=dev)
        self.arr[:, :, self.F_CYC] = -math.inf
        self.arr[:, 0, self.F_D] = 1
        self.arr[:, 0, self.F_E] = n
        self.arr[:, 0, self.F_U] = fastest.to(F64)
        self.arr[:, 0, self.F_CYC] = term0 + self.tail
        self.arr[:, 0, self.F_TERM] = term0
        self.m = torch.ones(B, dtype=I64, device=dev)
        self.next_idx = torch.ones(B, dtype=I64, device=dev)
        self.lat_sum = term0.clone()
        self.active = (torch.ones(B, dtype=torch.bool, device=dev) if active is None
                       else torch.tensor(np.asarray(active, dtype=bool), device=dev))
        self.splits = torch.zeros(B, dtype=I64, device=dev)

    def period(self) -> np.ndarray:
        return _host(self.arr[:, :, self.F_CYC].amax(dim=1))

    def latency(self) -> np.ndarray:
        return _host(self.lat_sum + self.tail)

    def items(self, rows=None) -> np.ndarray:
        """(R, n, 3) int (d, e, proc) items of the given rows (all rows by
        default), on the host."""
        arr = self.arr if rows is None else self.arr[_dev_index(rows, self.pb.device)]
        return _host(arr[:, :, :3].to(I64))

    def host(self) -> tuple:
        """(period, latency, items, m, splits) of every row, on the host."""
        return (self.period(), self.latency(), self.items(),
                _host(self.m), _host(self.splits))


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy that shares no memory with the (possibly CPU) tensor."""
    return t.cpu().numpy().copy()


def _dev_index(rows, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(rows, dtype=np.int64)).to(device)


def _mapping_from_rows(items_row, m: int) -> Mapping:
    return Mapping(intervals=tuple((int(items_row[t, 0]), int(items_row[t, 1]))
                                   for t in range(m)),
                   alloc=tuple(int(items_row[t, 2]) for t in range(m)))


# ---------------------------------------------------------------------------
# Batched candidate selection
# ---------------------------------------------------------------------------

def _lex_argmin(keys, mask: torch.Tensor):
    """Per-row index of the lexicographically smallest key tuple among masked
    candidates — the scalar paths' ``lexsort(keys[::-1])[0]``.  Returns
    (choice_index (A,), has_any (A,)).  The reference stops filtering once
    every row is decided; the keys here are finite (speeds and bandwidth are
    positive), so a decided row's one candidate survives every later key and
    filtering on through all keys gives the same choice without a host sync."""
    has = mask.any(dim=1)
    m = mask.clone()
    for key in keys:
        key = key.expand(m.shape)
        kmin = torch.where(m, key, math.inf).amin(dim=1)
        m &= key == kmin[:, None]
    # torch.argmax takes no bool on CUDA; it returns the first maximal index
    return torch.argmax(m.to(torch.uint8), dim=1), has


def _split_by_span(spans: np.ndarray) -> Optional[np.ndarray]:
    """When one row's interval is much wider than the median, lane-compacted
    scoring wastes (max_span - span) lanes on every other row.  Returns a
    boolean 'small rows' partition mask (process the two groups separately),
    or None when partitioning isn't worth the extra call.  Host numpy: the
    median picks a code path, and ``np.median`` is the reference's."""
    if spans.size < 16:
        return None
    med = int(np.median(spans))
    if int(spans.max()) < 2 * med:
        return None
    small = spans <= med
    if not small.any() or small.all():
        return None
    return small


def _choose_2way(state, rows, d, e, j, jp, bi_mode, old_cycle, cur_lat, lat_lim,
                 any_bi: bool):
    """Best 2-way split per row, or none.  Cut lanes are compacted to the
    rows' maximum interval span (cut c = d + offset); invalid lanes are
    masked (the kernel zeroes them), and key values use the absolute cut
    position so selection is identical to the scalar path."""
    pb = state.pb
    n, dev = pb.n, pb.device
    P = pb.packed
    K = int((e - d).max())                       # host sync: the lane count
    c_abs = d[:, None] + torch.arange(K, device=dev)[None, :]
    valid = c_abs < e[:, None]
    c_idx = c_abs.clamp(max=n - 1)               # in-range gather for masked lanes
    rowc = rows[:, None]
    # interval-end quantities via ONE packed gather, one contiguous row each
    gidx = torch.stack([state.off_pre + (d - 1), state.off_pre + e, d - 1, e,
                        state.off_s + j, state.off_s + jp], dim=1)
    g = P[rowc, gidx].T.contiguous()             # (6, A)
    pre_C = P[rowc, state.off_pre + c_idx]
    del_C = P[rowc, c_idx]
    cyc1, cyc2, dlat = _SCORE2(
        g[0][:, None], pre_C, g[1][:, None], g[2][:, None], del_C, g[3][:, None],
        pb.b, (1.0 / g[4])[:, None], (1.0 / g[5])[:, None], need=e - d)
    mx = torch.maximum(cyc1, cyc2)
    okay = mx < (old_cycle - _EPS)[:, None]
    okay &= cur_lat[:, None] + dlat <= (lat_lim + _EPS)[:, None]
    okay &= torch.cat([valid, valid], dim=1)
    # (cut, placement-order) tie-break as ONE exactly-represented integer key
    cutorder = torch.cat([c_abs * 2, c_abs * 2 + 1], dim=1).to(F64)
    if not any_bi:
        keys = [mx, dlat, cutorder]
    else:
        # per-row key columns: each row sees exactly its own mode's key tuple
        den1 = (old_cycle[:, None] - cyc1).clamp_min(_EPS)
        den2 = (old_cycle[:, None] - cyc2).clamp_min(_EPS)
        ratio = torch.maximum(dlat / den1, dlat / den2)
        bc = bi_mode[:, None]
        keys = [torch.where(bc, ratio, mx), torch.where(bc, mx, dlat), cutorder]
    q, has = _lex_argmin(keys, okay)
    c = d + q % K
    swapped = q >= K
    return has, c, torch.where(swapped, jp, j), torch.where(swapped, j, jp)


@functools.lru_cache(maxsize=None)
def _offset_pair_grid(span: int, device: torch.device):
    """All cut-offset pairs 0 <= o1 < o2 <= span-2 as flat (K,) int64 tensors
    in r1-major order (cut c_i = d + o_i for an interval of ``span`` stages
    starting at d)."""
    i, jj = np.triu_indices(span - 1, k=1)
    return torch.from_numpy(i).to(device), torch.from_numpy(jj).to(device)


@functools.lru_cache(maxsize=None)
def _perm_table(device: torch.device) -> torch.Tensor:
    return torch.tensor(_PERMS3, dtype=I64, device=device)      # (6, 3)


def _merge_choices(si, li, outs_small, outs_large, A: int):
    merged = []
    for a, b in zip(outs_small, outs_large):
        m = torch.empty((A,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        m[si] = a
        m[li] = b
        merged.append(m)
    return tuple(merged)


def _choose_3way(state, rows, d, e, j, jp, jpp, bi_mode, old_cycle, cur_lat,
                 lat_lim, any_bi: bool, spans: np.ndarray):
    """Best 3-way split per row (all >= 3-stage worst intervals): per-perm
    scoring in one kernel call, global lexmin over (keys..., perm index).
    Cut-pair lanes are compacted to the rows' maximum span, span-skewed
    batches are partitioned (the pair grid grows quadratically in the span),
    and rows are chunked to the device-memory budget.  ``spans`` is the
    host copy of ``e - d + 1``."""
    dev = state.pb.device
    A = rows.numel()
    args = (rows, d, e, j, jp, jpp, bi_mode, old_cycle, cur_lat, lat_lim)
    small = _split_by_span(spans)
    if small is not None:
        si = _dev_index(np.nonzero(small)[0], dev)
        li = _dev_index(np.nonzero(~small)[0], dev)
        return _merge_choices(
            si, li,
            _choose_3way(state, *(t[si] for t in args), any_bi, spans[small]),
            _choose_3way(state, *(t[li] for t in args), any_bi, spans[~small]), A)
    span_max = int(spans.max())
    K_est = (span_max - 1) * (span_max - 2) // 2
    step = max(1, _CHUNK_BYTES // (_BYTES_PER_LANE * max(K_est, 1)))
    if A > step:
        outs = [_choose_3way(state, *(t[i:i + step] for t in args), any_bi,
                             spans[i:i + step])
                for i in range(0, A, step)]
        return tuple(torch.cat([o[f] for o in outs]) for f in range(4))
    pb = state.pb
    n = pb.n
    P = pb.packed
    perm = _perm_table(dev)
    o1g, o2g = _offset_pair_grid(span_max, dev)
    K = o1g.numel()
    c1 = d[:, None] + o1g[None, :]
    c2 = d[:, None] + o2g[None, :]
    valid = c2 <= (e - 1)[:, None]
    c1i = c1.clamp(max=n - 1)
    c2i = c2.clamp(max=n - 1)
    rowc = rows[:, None]
    gidx = torch.stack([state.off_pre + (d - 1), state.off_pre + e, d - 1, e,
                        state.off_s + j, state.off_s + jp, state.off_s + jpp], dim=1)
    g = P[rowc, gidx]                                                  # (A, 7)
    pre_c1 = P[rowc, state.off_pre + c1i]
    pre_c2 = P[rowc, state.off_pre + c2i]
    delta_c1 = P[rowc, c1i]
    delta_c2 = P[rowc, c2i]
    del c1i, c2i
    pre_d1, pre_e = g[:, 0:1], g[:, 1:2]
    W = torch.stack([pre_c1 - pre_d1, pre_c2 - pre_c1, pre_e - pre_c2], dim=1)   # (A, 3, K)
    dI = torch.stack([g[:, 2:3].expand(A, K), delta_c1, delta_c2], dim=1) / pb.b_t
    dO = torch.stack([delta_c1, delta_c2, g[:, 3:4].expand(A, K)], dim=1) / pb.b_t
    del pre_c1, pre_c2, delta_c1, delta_c2
    procs = torch.stack([j, jp, jpp], dim=1)                                    # (A, 3)
    inv = 1.0 / g[:, 4:7]
    base_term = (g[:, 2] / pb.b_t + (g[:, 1] - g[:, 0]) / g[:, 4])[:, None, None]
    # all 6 permutations in one kernel call: perm axis 1, parts axis 2; the
    # per-row last-valid-lane bound of the r1-major pair layout lets the
    # kernel skip (and zero) out-of-band lanes
    invp = inv[:, perm][:, :, :, None]                                          # (A, 6, 3, 1)
    cyc, dlat, mx = _SCORE3(dI[:, None], W[:, None], dO[:, None], invp,
                            base_term, need=pair_need(e - d + 1, span_max))
    del dI, W, dO
    ratio_all = None
    if any_bi:
        ratio_all = (dlat[:, :, None, :]
                     / (old_cycle[:, None, None, None] - cyc).clamp_min(_EPS)).amax(dim=2)
    del cyc
    mx_f = mx.reshape(A, 6 * K)
    dlat_f = dlat.reshape(A, 6 * K)
    okay = mx_f < (old_cycle - _EPS)[:, None]
    okay &= cur_lat[:, None] + dlat_f <= (lat_lim + _EPS)[:, None]
    okay &= valid[:, None, :].expand(A, 6, K).reshape(A, 6 * K)
    # (c1, c2, perm index) tie-break as ONE exactly-represented integer key,
    # matching the scalar path's per-perm (.., c1, c2) lexsort + cross-perm
    # (keys..., pi) comparison.
    ccp = ((c1 * (n + 1) + c2)[:, None, :] * 6
           + torch.arange(6, device=dev)[None, :, None]).to(F64).reshape(A, 6 * K)
    if not any_bi:
        keys = [mx_f, dlat_f, ccp]
    else:
        bc = bi_mode[:, None]
        ratio_f = ratio_all.reshape(A, 6 * K)
        keys = [torch.where(bc, ratio_f, mx_f), torch.where(bc, mx_f, dlat_f), ccp]
    q, has = _lex_argmin(keys, okay)
    pi = torch.div(q, K, rounding_mode="floor")
    kk = q % K
    u_parts = torch.gather(procs, 1, perm[pi])                                  # (A, 3)
    return has, d + o1g[kk], d + o2g[kk], u_parts


class _RowView:
    """Minimal scalar-state shim over one host batch row, so the 2-stage 3-way
    fallback reuses ``_three_way_candidates``/``_pick_*`` verbatim."""

    __slots__ = ("pre", "delta", "s", "b", "items")

    def __init__(self, pre, delta, s, b, d, e, j):
        self.pre, self.delta, self.s, self.b = pre, delta, s, b
        self.items = [[d, e, j]]

    def cycle(self, d, e, u):
        return self.delta[d - 1] / self.b + (self.pre[e] - self.pre[d - 1]) / self.s[u] + self.delta[e] / self.b

    def latency_term(self, d, e, u):
        return self.delta[d - 1] / self.b + (self.pre[e] - self.pre[d - 1]) / self.s[u]


def _fallback_2stage(pb: ProblemBatch, k: int, rows, d, e, j, jp, jpp, bi_mode,
                     old_cycle, lat_lim, cur_lat):
    """The 2-stage worst intervals of a 3-way step, on the host: the scalar
    fast path falls back to the readable generator; do exactly that, row by
    row (rare and tiny).  Inputs are host arrays; returns host arrays
    (has, pd, pe, pu, nparts, consumed)."""
    R = rows.size
    has = np.zeros(R, dtype=bool)
    pd = np.ones((R, 3), dtype=np.int64)
    pe = np.ones((R, 3), dtype=np.int64)
    pu = np.zeros((R, 3), dtype=np.int64)
    nparts = np.full(R, 2, dtype=np.int64)
    consumed = np.ones(R, dtype=np.int64)
    for t in range(R):
        i = int(rows[t])
        view = _RowView(pb.prefix[i], pb.delta[i], pb.s[i], pb.b,
                        int(d[t]), int(e[t]), int(j[t]))
        pick = _pick_bi if bi_mode[t] else _pick_mono
        choice = pick(_three_way_candidates(view, 0, int(jp[t]), int(jpp[t])),
                      float(old_cycle[t]), float(lat_lim[t]), float(cur_lat[t]))
        if choice is None:
            continue
        parts, _, _ = choice
        has[t] = True
        for q, (pd_, pe_, pu_) in enumerate(parts):
            pd[t, q], pe[t, q], pu[t, q] = pd_, pe_, pu_
        pd[t, 2], pe[t, 2], pu[t, 2] = pd[t, 1], pe[t, 1], pu[t, 1]
        nparts[t] = len(parts)
        used = {pu_ for _, _, pu_ in parts} - {int(j[t])}
        consumed[t] = k if len(used) == k else len(used)
    return has, pd, pe, pu, nparts, consumed


# ---------------------------------------------------------------------------
# Lockstep loop
# ---------------------------------------------------------------------------

def _apply_splits(state: _BatchState, rows, idx, pd, pe, pu, nparts, consumed):
    """Replace item ``idx`` of each row with its 2 or 3 parts: shift the item
    arrays, scatter the parts, and update cycle/term/lat_sum incrementally
    with the same division-based expressions as the scalar ``replace``.
    (Lane 2 of a 2-part row holds in-range filler, never scattered.)"""
    pb = state.pb
    n, dev = pb.n, pb.device
    P = pb.packed
    R = rows.numel()
    arR = torch.arange(R, device=dev)
    gidx = torch.stack([pd - 1, state.off_pre + pe, state.off_pre + (pd - 1),
                        state.off_s + pu, pe], dim=2)                       # (R, 3, 5)
    g = P[rows[:, None, None], gidx]
    t_parts = g[..., 0] / pb.b_t + (g[..., 1] - g[..., 2]) / g[..., 3]
    c_parts = t_parts + g[..., 4] / pb.b_t
    old_term = state.arr[rows, idx, state.F_TERM]
    add = t_parts[:, 0] + t_parts[:, 1]
    three = nparts == 3
    add = torch.where(three, add + t_parts[:, 2], add)
    new_lat = (state.lat_sum[rows] - old_term) + add
    # shift every item column: columns past the items are identical padding
    # (zeros, cycle -inf), so shifting padding into padding changes nothing
    sh = (nparts - 1)[:, None]
    col = torch.arange(n, device=dev)[None, :]
    idxc = idx[:, None]
    src = torch.where(col <= idxc, col, torch.where(col <= idxc + sh, idxc, col - sh))
    parts = torch.stack([pd.to(F64), pe.to(F64), pu.to(F64), c_parts, t_parts], dim=2)
    sub = state.arr[rows[:, None], src]                                     # (R, n, 5)
    sub[arR, idx] = parts[:, 0]
    sub[arR, idx + 1] = parts[:, 1]
    tgt = (idx + 2).clamp(max=n - 1)
    sub[arR, tgt] = torch.where(three[:, None], parts[:, 2], sub[arR, tgt])
    state.arr[rows] = sub
    state.m[rows] = state.m[rows] + (nparts - 1)
    state.next_idx[rows] = state.next_idx[rows] + consumed
    state.splits[rows] = state.splits[rows] + 1
    state.lat_sum[rows] = new_lat


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of {BACKENDS}")


def _run_loop(state: _BatchState, k: int, bi_mode, stop, lat_limit,
              record: Optional[Callable] = None, backend: str = "lockstep") -> None:
    """The paper's splitting loop in lockstep: per row, stop-bound check,
    worst interval, candidate choice, update; rows are deactivated as they
    converge.  ``bi_mode`` (host bool (B,)) selects each row's choice rule
    (False = mono-criterion, True = bi-criteria), so heuristics sharing a
    split arity run together in one pass.  ``stop`` and ``lat_limit`` are
    host float (B,).  ``record(rows, periods, latencies)`` (host arrays) is
    invoked after each lockstep apply with the rows that accepted a split.

    ``backend="fused"`` hands the whole loop to the device-resident engine
    (:mod:`repro_torch.core.fused`), ``backend="sharded"`` to the same loop
    with its rows split over devices (:mod:`repro_torch.core.sharded`)."""
    _check_backend(backend)
    if backend == "fused":
        from . import fused

        fused.run_fused(state, k, bi_mode, stop, lat_limit, record)
        return
    if backend == "sharded":
        from . import sharded

        sharded.run_sharded(state, k, bi_mode, stop, lat_limit, record)
        return
    pb = state.pb
    dev = pb.device
    bi_h = np.asarray(bi_mode, dtype=bool)
    any_bi = bool(bi_h.any())
    bi_t = torch.from_numpy(bi_h.copy()).to(dev)
    stop_t = torch.from_numpy(np.asarray(stop, dtype=np.float64).copy()).to(dev)
    lim_t = torch.from_numpy(np.asarray(lat_limit, dtype=np.float64).copy()).to(dev)
    arr = state.arr
    rows = torch.nonzero(state.active).flatten()
    while rows.numel():
        # 1.-3. natural stop (period bound met), worst interval splittable,
        # processors left; rows failing any of them are done
        cyc_sub = arr[rows, :, state.F_CYC]
        widx = torch.argmax(cyc_sub, dim=1)
        worst = arr[rows, widx, :3].to(I64)                 # (R, 3): d, e, proc
        d, e, j = worst[:, 0], worst[:, 1], worst[:, 2]
        ok = ((cyc_sub.amax(dim=1) > stop_t[rows] + _EPS) & (e > d)
              & (state.next_idx[rows] + k <= pb.p))
        state.active[rows] = ok
        sel = torch.nonzero(ok).flatten()                   # host sync
        if sel.numel() == 0:
            break
        if sel.numel() < rows.numel():
            rows, widx, d, e, j = rows[sel], widx[sel], d[sel], e[sel], j[sel]
            cyc_sub = cyc_sub[sel]
        R = rows.numel()
        old_cycle = cyc_sub.gather(1, widx[:, None])[:, 0]
        cur_lat = state.lat_sum[rows] + state.tail[rows]
        lat_lim = lim_t[rows]
        bim = bi_t[rows]
        nxt = state.next_idx[rows]
        jp = pb.order_t[rows, nxt]
        if k == 1:
            has, c, pa, pb2 = _choose_2way(state, rows, d, e, j, jp, bim,
                                           old_cycle, cur_lat, lat_lim, any_bi)
            pd = torch.stack([d, c + 1, c + 1], dim=1)       # lane 2: in-range filler
            pe = torch.stack([c, e, e], dim=1)
            pu = torch.stack([pa, pb2, pb2], dim=1)
            nparts = torch.full((R,), 2, dtype=I64, device=dev)
            consumed = torch.ones(R, dtype=I64, device=dev)
        else:
            jpp = pb.order_t[rows, nxt + 1]
            spans = (e - d + 1).cpu().numpy()               # host sync
            big = spans >= 3
            has = torch.zeros(R, dtype=torch.bool, device=dev)
            pd = torch.ones((R, 3), dtype=I64, device=dev)
            pe = torch.ones((R, 3), dtype=I64, device=dev)
            pu = torch.zeros((R, 3), dtype=I64, device=dev)
            nparts = torch.full((R,), 3, dtype=I64, device=dev)
            consumed = torch.full((R,), 2, dtype=I64, device=dev)
            if big.any():
                bi = _dev_index(np.nonzero(big)[0], dev)
                hb, c1, c2, u_parts = _choose_3way(
                    state, rows[bi], d[bi], e[bi], j[bi], jp[bi], jpp[bi], bim[bi],
                    old_cycle[bi], cur_lat[bi], lat_lim[bi], any_bi, spans[big])
                has[bi] = hb
                pd[bi] = torch.stack([d[bi], c1 + 1, c2 + 1], dim=1)
                pe[bi] = torch.stack([c1, c2, e[bi]], dim=1)
                pu[bi] = u_parts
            if not big.all():
                si = _dev_index(np.nonzero(~big)[0], dev)
                host = [t[si].cpu().numpy() for t in
                        (rows, d, e, j, jp, jpp, bim, old_cycle, lat_lim, cur_lat)]
                outs = _fallback_2stage(pb, k, *host)
                for dst, val in zip((has, pd, pe, pu, nparts, consumed), outs):
                    dst[si] = torch.from_numpy(val).to(dev)
        # 4. rows with no improving candidate are done
        keep = torch.nonzero(has).flatten()                 # host sync
        if keep.numel() < R:
            state.active[rows] = has
            if keep.numel() == 0:
                break
            rows, widx = rows[keep], widx[keep]
            pd, pe, pu = pd[keep], pe[keep], pu[keep]
            nparts, consumed = nparts[keep], consumed[keep]
        # 5. apply accepted splits
        _apply_splits(state, rows, widx, pd, pe, pu, nparts, consumed)
        if record is not None:
            rec = torch.stack([arr[rows, :, state.F_CYC].amax(dim=1),
                               state.lat_sum[rows] + state.tail[rows]]).cpu().numpy()
            record(rows.cpu().numpy(), rec[0], rec[1])


# ---------------------------------------------------------------------------
# Public engine API
# ---------------------------------------------------------------------------

_TRAJ_CONFIG = {"H1": ("mono", 1), "H2": ("mono", 2), "H3": ("bi", 2), "H4": ("bi", 1)}


def batched_trajectories(code: str, pb: ProblemBatch, backend: str = "lockstep") -> list:
    """Per-problem (period, latency) exhaustion trajectories of one
    fixed-period heuristic (the state after 0, 1, 2, ... accepted splits; the
    result for any period bound is the first state meeting it).  Returns a
    list of B trajectories."""
    if code not in _TRAJ_CONFIG:
        raise KeyError(f"trajectories are for fixed-period heuristics, not {code}")
    return batched_trajectory_sets([code], pb, backend)[code]


def batched_trajectory_sets(codes, pb: ProblemBatch, backend: str = "lockstep") -> dict:
    """Trajectories for several heuristic codes in as few lockstep runs as
    possible: codes sharing a split arity (H1+H4 2-way, H2+H3 3-way) run
    TOGETHER as extra batch rows distinguished only by their per-row choice
    mode.  Returns {code: [trajectory per problem]}."""
    out = {}
    by_k: dict = {}
    for code in codes:
        mode, k = _TRAJ_CONFIG[code]
        by_k.setdefault(k, []).append((code, mode))
    _check_backend(backend)
    B = pb.B
    with _device_faults(pb.device):
        for k, group in by_k.items():
            tiled = pb if len(group) == 1 else pb.take(np.tile(np.arange(B), len(group)))
            bi_mode = np.concatenate([np.full(B, mode == "bi") for _, mode in group])
            st = _BatchState(tiled)
            trajs = [[(float(p), float(l))] for p, l in zip(st.period(), st.latency())]

            def rec(rows, pers, lats):
                for i, p, l in zip(rows, pers, lats):
                    trajs[i].append((float(p), float(l)))

            _run_loop(st, k, bi_mode, np.full(tiled.B, -np.inf),
                      np.full(tiled.B, np.inf), record=rec, backend=backend)
            for gi, (code, _) in enumerate(group):
                out[code] = trajs[gi * B:(gi + 1) * B]
    return out


_FIXED_LAT = {"H5": ("mono", "Sp mono L"), "H6": ("bi", "Sp bi L")}


def _fixed_latency_state(code: str, pb: ProblemBatch, bounds: np.ndarray,
                         backend: str = "lockstep"):
    """Run the H5/H6 splitting loop; returns (state, initially_failed host mask)."""
    bi_mode = np.full(pb.B, _FIXED_LAT[code][0] == "bi")
    st = _BatchState(pb)
    failed = st.latency() > bounds + _EPS
    st.active[torch.from_numpy(failed).to(pb.device)] = False
    _run_loop(st, 1, bi_mode, np.full(pb.B, -np.inf), bounds, backend=backend)
    return st, failed


def batched_fixed_latency(code: str, pb: ProblemBatch, bounds,
                          backend: str = "lockstep") -> list:
    """H5/H6 (min period s.t. latency <= bound) for B problems at once, each
    with its own bound.  Returns per-problem HeuristicResults identical to
    the reference's ``sp_mono_l``/``sp_bi_l``."""
    bounds = np.asarray(bounds, dtype=float)
    name = _FIXED_LAT[code][1]
    _check_backend(backend)
    with _device_faults(pb.device):
        st, failed = _fixed_latency_state(code, pb, bounds, backend)
        per, lat, items, m, splits = st.host()
    return [HeuristicResult.failure(name) if failed[i]
            else HeuristicResult(_mapping_from_rows(items[i], int(m[i])),
                                 float(per[i]), float(lat[i]), True,
                                 int(splits[i]), name)
            for i in range(pb.B)]


# Strategy order mirrors the reference's min_period_exhaustive: (name, arity, bi)
_MIN_PERIOD_STRATEGIES = (
    ("Sp mono L", 1, False),
    ("Sp bi L", 1, True),
    ("3-Explo mono", 2, False),
    ("3-Explo bi", 2, True),
)


def batched_min_period(pb: ProblemBatch, backend: str = "lockstep") -> list:
    """Unbounded min-period portfolio for B problems at once (the fleet
    replanning service's solve primitive).  Two lockstep runs cover all four
    exhaustion strategies: each run tiles the batch x2 with per-row choice
    mode (mono rows then bi rows), one run per split arity.  The per-problem
    winner is the lexicographically smallest (period, latency, strategy
    order), picked on the host with ``np.lexsort`` like the reference."""
    _check_backend(backend)
    B = pb.B
    rows2 = np.tile(np.arange(B), 2)
    bi_mode = np.concatenate([np.zeros(B, dtype=bool), np.ones(B, dtype=bool)])
    runs = []
    with _device_faults(pb.device):
        for k in (1, 2):
            st = _BatchState(pb.take(rows2))
            _run_loop(st, k, bi_mode, np.full(2 * B, -np.inf), np.full(2 * B, np.inf),
                      backend=backend)
            runs.append(st.host())
    (per1, lat1, it1, m1, sp1), (per2, lat2, it2, m2, sp2) = runs
    per = np.stack([per1[:B], per1[B:], per2[:B], per2[B:]])   # (4, B)
    lat = np.stack([lat1[:B], lat1[B:], lat2[:B], lat2[B:]])
    strat = np.broadcast_to(np.arange(4)[:, None], per.shape)
    win = np.lexsort((strat, lat, per), axis=0)[0]
    out = []
    for i in range(B):
        wi = int(win[i])
        items, m, splits = (it1, m1, sp1) if wi < 2 else (it2, m2, sp2)
        row = i + (wi % 2) * B
        out.append(HeuristicResult(_mapping_from_rows(items[row], int(m[row])),
                                   float(per[wi, i]), float(lat[wi, i]), True,
                                   int(splits[row]),
                                   _MIN_PERIOD_STRATEGIES[wi][0]))
    return out


def evaluate_state_rows(workloads, platforms, state: _BatchState,
                        skip=None) -> np.ndarray:
    """(period, latency) of each row's final mapping through the *metrics*
    layer, on the host — bit-identical to ``metrics.evaluate(wl, pf,
    mapping)`` per row (same per-interval expressions, including numpy's
    ``w[d-1:e].sum()``), reusing the previous row's result when it holds the
    same instance and final mapping.  Rows with ``skip`` set are left as NaN.
    Returns (B, 2)."""
    B = state.pb.B
    items_all = state.items()
    m_all = _host(state.m)
    out = np.full((B, 2), np.nan)
    prev = -1
    for i in range(B):
        if skip is not None and skip[i]:
            continue
        m = int(m_all[i])
        if (prev >= 0 and workloads[i] is workloads[prev]
                and platforms[i] is platforms[prev]
                and int(m_all[prev]) == m
                and np.array_equal(items_all[i, :m], items_all[prev, :m])):
            out[i] = out[prev]
            prev = i
            continue
        items = items_all[i, :m]
        wl, pf = workloads[i], platforms[i]
        w, delta, b, s = wl.w, wl.delta, pf.b, pf.s
        per = -math.inf
        tot = 0.0
        for t in range(m):
            d, e, a = items[t]
            lat_term = delta[d - 1] / b + w[d - 1:e].sum() / s[a]
            cyc = lat_term + delta[e] / b
            if cyc > per:
                per = cyc
            tot += lat_term
        out[i, 0] = per
        out[i, 1] = tot + delta[wl.n] / b
        prev = i
    return out


def h4_search_bounds(pb: ProblemBatch, groups=None) -> tuple:
    """Initial (lo, hi) authorized-latency bounds of the H4 binary search:
    lo = the optimal latency (all-on-fastest), hi = every stage its own
    interval on the slowest processor.  The sums are numpy on the host copies
    (their order defines the bound); rows sharing a ``groups`` key compute
    the bound once."""
    B = pb.B
    lat_opt = _BatchState(pb).latency()
    if groups is None:
        groups = np.arange(B)
    groups = np.asarray(groups)
    lat_ub = np.empty(B)
    seen: dict = {}
    for i in range(B):
        gkey = int(groups[i])
        if gkey in seen:
            lat_ub[i] = lat_ub[seen[gkey]]
            continue
        seen[gkey] = i
        s_min = float(pb.s[i].min())
        lat_ub[i] = float(pb.delta[i, :-1].sum() / pb.b
                          + pb.w[i].sum() / s_min
                          + pb.delta[i, -1] / pb.b)
    return lat_opt, np.maximum(lat_ub, lat_opt)


def batched_sp_bi_p(pb: ProblemBatch, bounds, iters: int = 40,
                    with_mappings: bool = True, groups=None,
                    backend: str = "lockstep") -> list:
    """H4 'Sp bi P' for B problems at once: ONE binary search whose every
    bisection step probes all still-searching problems in lockstep.
    ``with_mappings=False`` skips Mapping materialization (metrics-only
    campaigns) and deduplicates probe runs across rows sharing a ``groups``
    key (see ``_sp_bi_p_grouped``).  The bisection bookkeeping is numpy on
    the host; each probe is a lockstep run on the device.  With
    ``backend="fused"`` or ``"sharded"`` the whole search runs on the device
    (``_sp_bi_p_fused``), with or without mappings: probes cost no host
    round trip there, so ``groups`` is not used; results are the same."""
    _check_backend(backend)
    p_fix = np.asarray(bounds, dtype=float)
    if groups is None:
        groups = np.arange(pb.B)
    groups = np.asarray(groups)
    lo, hi = h4_search_bounds(pb, groups)
    with _device_faults(pb.device):
        if backend != "lockstep" and min(pb.n - 1, pb.p - 1) > 0:
            return _sp_bi_p_fused(pb, p_fix, iters, lo, hi, with_mappings, backend)
        if not with_mappings:
            return _sp_bi_p_grouped(pb, p_fix, groups, iters, lo, hi, backend)
        return _sp_bi_p_rowwise(pb, p_fix, iters, lo, hi, backend)


def _sp_bi_p_fused(pb, p_fix, iters, lo, hi, with_mappings, backend):
    """H4 with the binary search on the device
    (:func:`repro_torch.core.fused.run_fused_bisection`, or its row-split
    twin :func:`repro_torch.core.sharded.run_sharded_bisection`): outputs
    identical to the host-driven probe loops."""
    if backend == "sharded":
        from . import sharded

        r = sharded.run_sharded_bisection(pb, p_fix, lo, hi, iters)
    else:
        from . import fused

        r = fused.run_fused_bisection(pb, p_fix, lo, hi, iters)
    out = []
    for i in range(pb.B):
        if not r["feas0"][i]:
            mp = (_mapping_from_rows(r["items0"][i], int(r["m0"][i]))
                  if with_mappings else None)
            out.append(HeuristicResult(mp, float(r["per0"][i]), float(r["lat0"][i]),
                                       False, int(r["sp0"][i]), "Sp bi P"))
        else:
            mp = (_mapping_from_rows(r["items"][i], int(r["m"][i]))
                  if with_mappings else None)
            out.append(HeuristicResult(mp, float(r["per"][i]), float(r["lat"][i]),
                                       True, int(r["sp"][i]), "Sp bi P"))
    return out


def _sp_bi_p_rowwise(pb, p_fix, iters, lo, hi, backend="lockstep"):
    """One lockstep probe row per problem: keeps full state for mappings."""
    B = pb.B
    all_bi = np.ones(B, dtype=bool)

    def probe(limits, act):
        st = _BatchState(pb, active=act)
        _run_loop(st, 1, all_bi, p_fix, limits, backend=backend)
        per, lat = st.period(), st.latency()
        feas = (per <= p_fix + _EPS) & (lat <= limits + _EPS)
        return st, per, lat, feas

    # Ensure feasibility at the upper end first.
    st0, per0, lat0, feas0 = probe(hi, np.ones(B, dtype=bool))
    best_items = st0.items()
    best_m, best_splits = _host(st0.m), _host(st0.splits)
    fail_maps = [None if feas0[i] else _mapping_from_rows(best_items[i], int(best_m[i]))
                 for i in range(B)]
    fail_per, fail_lat, fail_splits = per0.copy(), lat0.copy(), best_splits.copy()
    best_per, best_lat = per0.copy(), lat0.copy()
    alive = feas0.copy()
    for _ in range(iters):
        if not alive.any():
            break
        mid = 0.5 * (lo + hi)
        st, per, lat, feas = probe(mid, alive)
        good = alive & feas
        hi = np.where(good, mid, hi)
        lo = np.where(alive & ~feas, mid, lo)
        better = good & ((lat < best_lat - _EPS) |
                         ((np.abs(lat - best_lat) <= _EPS) & (per < best_per)))
        if better.any():
            bx = np.nonzero(better)[0]
            best_items[bx] = st.items(bx)
            best_m[bx] = _host(st.m)[bx]
            best_splits[bx] = _host(st.splits)[bx]
            best_per[better] = per[better]
            best_lat[better] = lat[better]
    out = []
    for i in range(B):
        if not feas0[i]:
            out.append(HeuristicResult(fail_maps[i], float(fail_per[i]),
                                       float(fail_lat[i]), False,
                                       int(fail_splits[i]), "Sp bi P"))
        else:
            out.append(HeuristicResult(_mapping_from_rows(best_items[i], int(best_m[i])),
                                       float(best_per[i]), float(best_lat[i]),
                                       True, int(best_splits[i]), "Sp bi P"))
    return out


def _sp_bi_p_grouped(pb, p_fix, groups, iters, lo, hi, backend="lockstep"):
    """Metrics-only H4 with probe-run deduplication.

    A probe's split *choices* never depend on its period stop-bound — only
    the stopping point does.  So per bisection step, ONE latency-limited
    exhaustion run per unique (instance, latency-limit) pair is recorded as a
    (period, latency)-per-split trajectory, and every period bound sharing
    that pair reads its probe result off the shared trajectory: the first
    state with ``period <= bound + eps`` (or the final state).  The dedup keys
    are the limits' exact bit patterns (``view(np.int64)``), on the host.
    """
    B = pb.B

    def probe(limits, act):
        alive_rows = np.nonzero(act)[0]
        key_arr = np.empty((alive_rows.size, 2), dtype=np.int64)
        key_arr[:, 0] = groups[alive_rows]
        key_arr[:, 1] = limits[alive_rows].view(np.int64)
        uniq, inv = np.unique(key_arr, axis=0, return_inverse=True)
        inv = inv.ravel()
        R = len(uniq)
        exemplar = np.empty(R, dtype=np.int64)
        exemplar[inv[::-1]] = alive_rows[::-1]      # first occurrence wins
        st = _BatchState(pb.take(exemplar))
        init_per, init_lat = st.period(), st.latency()
        recs = []
        _run_loop(st, 1, np.ones(R, dtype=bool), np.full(R, -np.inf),
                  limits[exemplar],
                  record=lambda rows, pers, lats: recs.append((rows, pers, lats)),
                  backend=backend)
        # assemble per-run trajectories; step index == split count because an
        # active row accepts a split at every lockstep iteration
        T = len(recs) + 1
        per_tr = np.full((R, T), np.inf)            # +inf padding: never a stop
        lat_tr = np.zeros((R, T))
        lengths = np.ones(R, dtype=np.int64)
        per_tr[:, 0] = init_per
        lat_tr[:, 0] = init_lat
        for s, (rws, pers, lats) in enumerate(recs, start=1):
            per_tr[rws, s] = pers
            lat_tr[rws, s] = lats
            lengths[rws] = s + 1
        bnd = p_fix[alive_rows] + _EPS
        hit = per_tr[inv] <= bnd[:, None]
        has_hit = hit.any(axis=1)
        t_idx = np.where(has_hit, np.argmax(hit, axis=1), lengths[inv] - 1)
        per = np.empty(B)
        lat = np.empty(B)
        sp = np.zeros(B, dtype=np.int64)
        feas = np.zeros(B, dtype=bool)
        per[alive_rows] = per_tr[inv, t_idx]
        lat[alive_rows] = lat_tr[inv, t_idx]
        sp[alive_rows] = t_idx
        feas[alive_rows] = ((per[alive_rows] <= p_fix[alive_rows] + _EPS)
                            & (lat[alive_rows] <= limits[alive_rows] + _EPS))
        return per, lat, sp, feas

    per0, lat0, sp0, feas0 = probe(hi, np.ones(B, dtype=bool))
    best_per, best_lat, best_sp = per0.copy(), lat0.copy(), sp0.copy()
    alive = feas0.copy()
    for _ in range(iters):
        if not alive.any():
            break
        mid = 0.5 * (lo + hi)
        per, lat, sp, feas = probe(mid, alive)
        good = alive & feas
        hi = np.where(good, mid, hi)
        lo = np.where(alive & ~feas, mid, lo)
        better = good & ((lat < best_lat - _EPS) |
                         ((np.abs(lat - best_lat) <= _EPS) & (per < best_per)))
        best_per[better] = per[better]
        best_lat[better] = lat[better]
        best_sp[better] = sp[better]
    return [HeuristicResult(None, float(per0[i]), float(lat0[i]), False,
                            int(sp0[i]), "Sp bi P") if not feas0[i]
            else HeuristicResult(None, float(best_per[i]), float(best_lat[i]),
                                 True, int(best_sp[i]), "Sp bi P")
            for i in range(B)]
