"""Fused device-resident campaign engine: the whole lockstep splitting loop on
the device, replayed as CUDA graphs.

The port of ``repro.core.fused``.  The lockstep engine
(:mod:`repro_torch.core.batched`) compacts its rows, reads lane counts and
runs the 2-stage 3-way fallback on the host, so every iteration syncs with
the host several times.  Here one lockstep *iteration* is a fixed-shape step
over a chunk of S rows that never leaves the device: stop checks, the
worst-interval argmax, masked candidate scoring through the split-score
kernels, the exact lexicographic tie-breaks (the 2-stage fallback as six
static lanes on the device), the structure-of-arrays update and the
per-iteration records ``(T, S)``.

Design (the reference's, fixed shape; what differs on the card):

  - Candidate grids are SPAN-BUCKETED (:func:`bucket_sizes`): a step scores
    the smallest geometric bucket of cut lanes (2-way) or span (3-way) that
    covers every live row.  Cut lanes are interval-relative with validity
    masks and clamped gathers; tie-break keys use absolute positions, so any
    covering bucket gives the same floats.
  - The reference picks the bucket on the device every iteration
    (``lax.switch``).  A CUDA graph has no switch, so the HOST picks it at
    each poll: every ``POLL_EVERY`` iterations one small device-to-host copy
    brings back whether any row is still active (a row that stops is
    inactive for good) and the largest span of any interval of any active
    row.  Every later interval is a sub-interval of one that exists at the
    poll and rows only leave, so this bound only shrinks and the bucket it
    picks covers every row live in any step until the next poll.  Iterations
    after convergence are inert (a row that is not live accepts nothing);
    a chunk runs at most ``T = min(n-1, p-1)`` iterations.
  - On a card each bucket's step is captured once as a CUDA graph per
    (n, p, k, S, bucket) and replayed on static buffers (inputs, state,
    records); all captures of one (n, k) on one card share a memory pool
    (their replays never overlap).  Before the first capture the split-score
    library is loaded and one eager step runs on a side stream with no row
    active.  On the CPU the same step runs eagerly with the plain scoring;
    that is the tests' path.  On a card nothing falls back: a capture, a
    replay or a kernel build that fails raises.
  - Batches are padded to the chunk size with inert rows (row 0's data,
    starting inactive, never written back).  On the CPU S is the reference's
    :func:`chunk_rows`; on a card the batch rounded up to a power of two,
    at most what fits the lockstep engine's 2 GiB working-set budget at the
    top bucket (:func:`device_chunk_rows`).  Chunking cannot change results.
  - The H4 bisection (:func:`run_fused_bisection`) runs its whole search for
    a chunk on the device: a probe at ``hi``, then ``iters`` probes, with
    ``lo``, ``hi`` and the best probe kept on the device.

Counters, under the reference's names: :func:`trace_count` (bucket graphs
captured by fused runs; on the CPU, buckets first stepped),
:func:`bucket_trace_count` (the same, fused and sharded runs together),
:func:`dispatch_count` (graph replays; eager steps on the CPU) and
:func:`sync_count` (host polls).  A replay bypasses the Python launch
counters of the split-score wrappers, so each replay adds its graph's
kernels to them.

Equivalence contract: every float is ``==`` the reference's numpy engine.
The expressions are the reference's fused ones, one torch op per jnp op, in
float64, ``b`` a 0-dim float64 device tensor (never a Python scalar divisor);
argmax/max/min are order-exact and nothing is summed by a torch reduction.

Use via ``backend="fused"`` on any :mod:`repro_torch.core.batched` entry
point, or ``engine="fused"`` in :mod:`repro_torch.sim.experiments`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels import build
from ..kernels.split_score import pair_need, score_2way_cuda, score_3way_cuda
from .heuristics import _EPS

__all__ = ["fused_available", "run_fused", "run_fused_bisection",
           "trace_count", "reset_trace_count",
           "dispatch_count", "reset_dispatch_count",
           "bucket_trace_count", "reset_bucket_trace_count",
           "sync_count", "reset_sync_count",
           "bucket_sizes", "bucket_index", "trace_budget", "chunk_rows",
           "device_chunk_rows", "rows_per_chunk", "captures", "release_programs"]

F64 = torch.float64
I64 = torch.int64

# lane budget per call: rows_per_chunk * candidate_lanes is held under this
# (the reference's CPU sizing; a card sizes by bytes, device_chunk_rows)
_LANE_BUDGET = 4_000_000
_MAX_CHUNK = 128
# the lockstep engine's device-memory budget of one step, and its per-lane
# estimate (batched.py); a 3-way lane is one cut pair (x 6 perms x 3 parts)
_CHUNK_BYTES = 2 << 30
_BYTES_PER_LANE = 1024
# iterations between two host polls
POLL_EVERY = 8

_PERMS3 = np.array([(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
                    (2, 1, 0)])
# the scalar 2-stage fallback's candidate order: permutations((j,jp,jpp), 2)
_FB_A = np.array([0, 0, 1, 1, 2, 2])
_FB_B = np.array([1, 2, 0, 2, 0, 1])


@dataclasses.dataclass
class _Counts:
    traces: int = 0
    dispatches: int = 0
    syncs: int = 0


_COUNTS = _Counts()
# bucket graphs captured, by the fused and the sharded engine alike
_BUCKET_TRACES = [0]


def fused_available(device=None) -> bool:
    """Whether the fused engine can run on ``device`` (``None`` means CUDA):
    always on the CPU (eager steps), on CUDA when a card is present."""
    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cpu" or (dev.type == "cuda" and torch.cuda.is_available())


def trace_count() -> int:
    """Bucket graphs captured by fused runs (on the CPU, buckets first
    stepped) since the last :func:`reset_trace_count`."""
    return _COUNTS.traces


def reset_trace_count() -> None:
    _COUNTS.traces = 0


def bucket_trace_count() -> int:
    """Bucket graphs captured since :func:`reset_bucket_trace_count` (on the
    CPU, buckets first stepped): at most :func:`trace_budget` per chunk size."""
    return _BUCKET_TRACES[0]


def reset_bucket_trace_count() -> None:
    _BUCKET_TRACES[0] = 0


def dispatch_count() -> int:
    """Step dispatches (graph replays; eager steps on the CPU) since the last
    :func:`reset_dispatch_count`."""
    return _COUNTS.dispatches


def reset_dispatch_count() -> None:
    _COUNTS.dispatches = 0


def sync_count() -> int:
    """Host polls (one device-to-host copy each) since the last reset."""
    return _COUNTS.syncs


def reset_sync_count() -> None:
    _COUNTS.syncs = 0


@functools.lru_cache(maxsize=None)
def bucket_sizes(n: int, k: int) -> tuple:
    """Geometric (power-of-two) candidate-grid buckets for stage count ``n``.

    For arity ``k == 1`` the sizes count candidate CUTS of the worst interval
    (``1 <= e - d <= n - 1``); for ``k == 2`` they count its SPAN
    (``3 <= e - d + 1 <= n`` — 2-stage intervals score through the static
    fallback lanes instead, shared across buckets).  Sizes double from a
    small floor and the top bucket is clamped to the exact maximum, so there
    are at most ``ceil(log2(n)) + 1`` buckets.
    """
    if k == 1:
        lo, hi = 2, n - 1
    else:
        if n < 3:
            return ()
        lo, hi = 4, n
    if hi <= 0:
        return ()
    sizes = []
    s = lo
    while s < hi:
        sizes.append(s)
        s *= 2
    sizes.append(hi)
    return tuple(sizes)


def bucket_index(need: int, sizes) -> int:
    """Index of the smallest bucket in ``sizes`` covering ``need`` lanes: the
    host's choice at each poll, from the polled bound."""
    sizes = np.asarray(sizes)
    return int(np.sum(np.asarray(need) > sizes[:-1]))


def trace_budget(n: int) -> int:
    """Upper bound on bucket captures for one campaign at stage count ``n``
    and one chunk size: the reference's count (one bucket set per k=1
    program, the lockstep loop AND the bisection, plus one per k=2 program).
    The port's bisection replays the lockstep loop's k=1 graphs, so it
    captures at most ``len(bucket_sizes(n, 1)) + len(bucket_sizes(n, 2))``."""
    return 2 * len(bucket_sizes(n, 1)) + len(bucket_sizes(n, 2))


def chunk_rows(n: int, k: int) -> int:
    """The reference's fixed rows-per-call for shape (n, arity k), sized
    against the TOP span bucket; the chunk size on the CPU."""
    if k == 1:
        lanes = max(2 * (n - 1), 1)
    else:
        lanes = 18 * ((n - 1) * (n - 2) // 2) + 6
    return int(max(1, min(_MAX_CHUNK, _LANE_BUDGET // max(lanes, 1))))


def device_chunk_rows(n: int, k: int, B: int) -> int:
    """Rows per chunk on a card for a batch of ``B`` rows: B rounded up to a
    power of two (so the calls of a campaign share few chunk sizes, each
    with its own graphs), at most what fits ``_CHUNK_BYTES`` at
    ``_BYTES_PER_LANE`` per cut (2-way) or cut pair (3-way) of the top
    bucket."""
    lanes = max(n - 1, 1) if k == 1 else max((n - 1) * (n - 2) // 2, 1)
    cap = max(1, _CHUNK_BYTES // (_BYTES_PER_LANE * lanes))
    return int(min(cap, 1 << max(0, int(B) - 1).bit_length()))


def rows_per_chunk(n: int, k: int, B: int, device) -> int:
    """The chunk size on ``device``: :func:`chunk_rows` on the CPU,
    :func:`device_chunk_rows` on a card."""
    if torch.device(device).type == "cpu":
        return chunk_rows(n, k)
    return device_chunk_rows(n, k, B)


def _lex_argmin_traced(keys, mask):
    """Fixed-shape mirror of ``batched._lex_argmin``: per-row first index of
    the lexicographically smallest key tuple among masked lanes (no early
    exit — extra key passes only re-filter ties, so the winner is
    identical).  Returns (choice (A,), has_any (A,))."""
    has = mask.any(dim=1)
    m = mask
    for key in keys:
        kmin = torch.where(m, key, math.inf).amin(dim=1)
        m = m & (key == kmin[:, None])
    # torch.argmax takes no bool on CUDA; it returns the first maximal index
    return torch.argmax(m.to(torch.uint8), dim=1), has


def _take1(a, idx):
    return a.gather(1, idx[:, None])[:, 0]


# ---------------------------------------------------------------------------
# The step program of one shape on one device slot
# ---------------------------------------------------------------------------

class _Program:
    """Static buffers and per-bucket steps of shape (n, p, k) over S rows on
    one device: inputs (``delta``, ``prefix``, ``s``, ``order``, ``bi``,
    ``stop``, ``lim``, ``b``), the SoA state (``arr`` (S, n, 5) in the
    ``_BatchState`` field layout, ``m``, ``nx``, ``lat``, ``sp``,
    ``active``), the iteration counter ``t`` and the records ``(T, S)``."""

    def __init__(self, n: int, p: int, k: int, S: int, device, pool):
        dev = torch.device(device)
        self.n, self.p, self.k, self.S = n, p, k, S
        self.T = T = min(n - 1, p - 1)
        self.device = dev
        self.cuda = dev.type == "cuda"
        self.sizes = bucket_sizes(n, k)
        self.buckets = self.sizes if self.sizes else (None,)
        self.pool = pool

        def z(*shape, dtype=F64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.delta, self.prefix = z(S, n + 1), z(S, n + 1)
        self.s = torch.ones((S, p), dtype=F64, device=dev)
        self.order = z(S, p, dtype=I64)
        self.bi = z(S, dtype=torch.bool)
        self.stop, self.lim = z(S), z(S)
        self.b = torch.ones((), dtype=F64, device=dev)
        self.arr = z(S, n, 5)
        self.m, self.nx, self.sp = z(S, dtype=I64), z(S, dtype=I64), z(S, dtype=I64)
        self.lat = z(S)
        self.active = z(S, dtype=torch.bool)
        self.t = z(1, dtype=I64)
        self.per_rec, self.lat_rec = z(max(T, 1), S), z(max(T, 1), S)
        self.acc_rec = z(max(T, 1), S, dtype=torch.bool)
        # constants, made before any capture
        self.col = torch.arange(n, device=dev)[None, :]
        self.one = torch.ones(S, dtype=I64, device=dev)
        self.two = torch.full((S,), 2, dtype=I64, device=dev)
        self.three = torch.full((S,), 3, dtype=I64, device=dev)
        self.perms = torch.from_numpy(_PERMS3).to(dev)
        self.fb_a = torch.from_numpy(_FB_A).to(dev)
        self.fb_b = torch.from_numpy(_FB_B).to(dev)
        self.fb_key = torch.arange(6, dtype=F64, device=dev)[None, :].expand(S, 6).contiguous()
        self.six = torch.arange(6, device=dev)[None, :, None]
        self.lanes = {}
        for L in self.sizes:
            if k == 1:
                self.lanes[L] = torch.arange(L, device=dev)
            else:
                r1, r2 = np.triu_indices(L - 1, k=1)
                self.lanes[L] = (torch.from_numpy(r1).to(dev), torch.from_numpy(r2).to(dev))
        self.graphs: dict = {}
        self.kernels: dict = {}      # bucket -> (2-way, 3-way) kernels per replay
        self.stepped: set = set()    # buckets first stepped (CPU)
        self.t_host = 0
        self.bucket = self.buckets[-1]
        self.running = False
        if self.cuda:
            self.poll_host = torch.zeros(2, dtype=F64, pin_memory=True)
            self.poll_event = torch.cuda.Event()
            self._warm_up()
        else:
            self.poll_host = torch.zeros(2, dtype=F64)

    # -- set-up ---------------------------------------------------------------

    def _warm_up(self) -> None:
        """Load the split-score library (``build.load`` may run nvcc, which
        must not happen during a capture) and run one eager step on a side
        stream with no row active (state untouched; records reset per chunk)."""
        build.load("split_score")
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.active.zero_()
                self.t.zero_()
                self._step(self.buckets[-1])
                self.t.zero_()
            torch.cuda.current_stream().wait_stream(side)

    def load(self, pb, sel, state, act, bi, stop, lim) -> None:
        """Copy the rows ``sel`` (host int64 (S,), padding rows repeat row 0)
        of ``pb`` and of ``state`` (its tensors on ``pb.device``) into the
        static buffers; ``act`` (host bool (S,)) starts the padding rows
        inactive; ``bi``/``stop``/``lim`` are host (S,) arrays."""
        n = self.n
        idx = torch.from_numpy(sel).to(pb.device)
        P = pb.packed[idx]
        self.delta.copy_(P[:, :n + 1])
        self.prefix.copy_(P[:, n + 1:2 * n + 2])
        self.s.copy_(P[:, 2 * n + 2:])
        self.order.copy_(pb.order_t[idx])
        self.b.copy_(pb.b_t)
        self.bi.copy_(torch.from_numpy(np.ascontiguousarray(bi)))
        self.stop.copy_(torch.from_numpy(np.ascontiguousarray(stop, dtype=np.float64)))
        self.lim.copy_(torch.from_numpy(np.ascontiguousarray(lim, dtype=np.float64)))
        if state is not None:
            self.arr.copy_(state.arr[idx])
            self.m.copy_(state.m[idx])
            self.nx.copy_(state.next_idx[idx])
            self.lat.copy_(state.lat_sum[idx])
            self.sp.copy_(state.splits[idx])
        self.active.copy_(torch.from_numpy(np.ascontiguousarray(act, dtype=bool)))
        self.t.zero_()

    def init_state(self) -> None:
        """The optimal-latency starting state (all stages on the fastest
        processor) — the expressions of ``batched._BatchState.__init__``."""
        n = self.n
        fastest = self.order[:, 0]
        tail = self.delta[:, n] / self.b
        term0 = (self.delta[:, 0] / self.b
                 + (self.prefix[:, n] - self.prefix[:, 0]) / _take1(self.s, fastest))
        self.arr.zero_()
        self.arr[:, :, 3] = -math.inf
        self.arr[:, 0, 0] = 1.0
        self.arr[:, 0, 1] = float(n)
        self.arr[:, 0, 2] = fastest.to(F64)
        self.arr[:, 0, 3] = term0 + tail
        self.arr[:, 0, 4] = term0
        self.m.fill_(1)
        self.nx.fill_(1)
        self.lat.copy_(term0)
        self.sp.zero_()
        self.t.zero_()

    # -- the step -------------------------------------------------------------

    def _step(self, L) -> None:
        """One lockstep iteration over all S rows with candidate bucket ``L``,
        in place on the static buffers.  Fixed shapes only: masks and
        ``torch.where``, no host sync, so it can be captured."""
        n, p, k, S = self.n, self.p, self.k, self.S
        delta, prefix, s, b = self.delta, self.prefix, self.s, self.b
        arr = self.arr
        tail = delta[:, n] / b
        cyc = arr[:, :, 3]
        live = self.active & (cyc.amax(dim=1) > self.stop + _EPS)
        widx = torch.argmax(cyc, dim=1)
        item = arr.gather(1, widx[:, None, None].expand(S, 1, 5))[:, 0]
        d = item[:, 0].to(I64).clamp(1, n)
        e = item[:, 1].to(I64).clamp(1, n)
        j = item[:, 2].to(I64).clamp(0, p - 1)
        live = live & (item[:, 1] > item[:, 0]) & (self.nx + k <= p)
        old_cycle = item[:, 3]
        old_term = item[:, 4]
        cur_lat = self.lat + tail
        jp = _take1(self.order, self.nx.clamp(0, p - 1))
        rows = dict(d=d, e=e, j=j, jp=jp, live=live, old_cycle=old_cycle,
                    cur_lat=cur_lat, pre_d1=_take1(prefix, d - 1),
                    pre_e=_take1(prefix, e), del_d1=_take1(delta, d - 1),
                    del_e=_take1(delta, e))
        has, pd, pe, pu, nparts, consumed = self._choose(L, rows)
        accept = live & has

        # apply splits (same division-based expressions as _apply_splits)
        pdc = pd.clamp(1, n)
        pec = pe.clamp(1, n)
        puc = pu.clamp(0, p - 1)
        del_pd1 = delta.gather(1, pdc - 1)
        pre_pe = prefix.gather(1, pec)
        pre_pd1 = prefix.gather(1, pdc - 1)
        s_pu = s.gather(1, puc)
        del_pe = delta.gather(1, pec)
        t_parts = del_pd1 / b + (pre_pe - pre_pd1) / s_pu
        c_parts = t_parts + del_pe / b
        add = t_parts[:, 0] + t_parts[:, 1]
        three = nparts == 3
        add = torch.where(three, add + t_parts[:, 2], add)
        new_lat = (self.lat - old_term) + add
        col = self.col
        sh = (nparts - 1)[:, None]
        idxc = widx[:, None]
        src = torch.where(col <= idxc, col, torch.where(col <= idxc + sh, idxc, col - sh))
        new_arr = arr.gather(1, src[:, :, None].expand(S, n, 5))
        parts5 = torch.stack([pdc.to(F64), pec.to(F64), puc.to(F64), c_parts, t_parts],
                             dim=2)                                       # (S, 3, 5)
        new_arr = torch.where((col == idxc)[:, :, None], parts5[:, 0][:, None, :], new_arr)
        new_arr = torch.where((col == idxc + 1)[:, :, None], parts5[:, 1][:, None, :], new_arr)
        new_arr = torch.where(((col == idxc + 2) & three[:, None])[:, :, None],
                              parts5[:, 2][:, None, :], new_arr)
        self.arr.copy_(torch.where(accept[:, None, None], new_arr, arr))
        self.m.add_(torch.where(accept, nparts - 1, 0))
        self.nx.add_(torch.where(accept, consumed, 0))
        self.lat.copy_(torch.where(accept, new_lat, self.lat))
        self.sp.add_(accept.to(I64))
        self.active.copy_(accept)
        self.per_rec.index_copy_(0, self.t, self.arr[:, :, 3].amax(dim=1)[None])
        self.lat_rec.index_copy_(0, self.t, (self.lat + tail)[None])
        self.acc_rec.index_copy_(0, self.t, accept[None])
        self.t.add_(1)

    def _choose(self, L, r):
        """The bucket-dependent part of a step: the best split of each live
        row over bucket ``L``; returns (has, pd, pe, pu, nparts, consumed)."""
        if self.k == 1:
            return self._choose_2way(L, r)
        return self._choose_3way(L, r)

    def _choose_2way(self, L, r):
        """Interval-relative cut lanes ``c = d + offset`` over the L-cut
        bucket (the lockstep engine's compaction), absolute-position
        tie-break keys."""
        n, S = self.n, self.S
        d, e, j, jp, live = r["d"], r["e"], r["j"], r["jp"], r["live"]
        old_cycle = r["old_cycle"]
        c = d[:, None] + self.lanes[L][None, :]
        valid = c < e[:, None]
        ci = c.clamp(max=n - 1)                 # in-range gather, masked lanes
        pre_C = self.prefix.gather(1, ci)
        del_C = self.delta.gather(1, ci)
        inv_j = 1.0 / _take1(self.s, j)
        inv_p = 1.0 / _take1(self.s, jp)
        cyc1, cyc2, dlat = score_2way_cuda(
            r["pre_d1"][:, None], pre_C, r["pre_e"][:, None], r["del_d1"][:, None],
            del_C, r["del_e"][:, None], self.b, inv_j[:, None], inv_p[:, None],
            need=torch.where(live, e - d, 0))
        mx = torch.maximum(cyc1, cyc2)
        okay = mx < (old_cycle - _EPS)[:, None]
        okay &= r["cur_lat"][:, None] + dlat <= (self.lim + _EPS)[:, None]
        okay &= torch.cat([valid, valid], dim=1)
        okay &= live[:, None]
        ratio = torch.maximum(dlat / (old_cycle[:, None] - cyc1).clamp_min(_EPS),
                              dlat / (old_cycle[:, None] - cyc2).clamp_min(_EPS))
        cf = c.to(F64)
        cutorder = torch.cat([cf * 2.0, cf * 2.0 + 1.0], dim=1)
        bc = self.bi[:, None]
        keys = [torch.where(bc, ratio, mx), torch.where(bc, mx, dlat), cutorder]
        q, has = _lex_argmin_traced(keys, okay)
        cw = d + q % L
        swapped = q >= L
        pa = torch.where(swapped, jp, j)
        pb2 = torch.where(swapped, j, jp)
        pd = torch.stack([d, cw + 1, cw + 1], dim=1)
        pe = torch.stack([cw, e, e], dim=1)
        pu = torch.stack([pa, pb2, pb2], dim=1)
        return has, pd, pe, pu, self.two, self.one

    def _choose_3way(self, L, r):
        """All relative cut pairs ``0 <= r1 < r2 <= L-2`` (``c_i = d + r_i``)
        x 6 permutations over the L-span bucket, joined with the six static
        2-stage fallback lanes (the scalar generator's enumeration order) in
        one exact lex argmin.  ``L=None`` (n < 3) keeps the fallback lanes."""
        n, p, S = self.n, self.p, self.S
        delta, prefix, s, b = self.delta, self.prefix, self.s, self.b
        d, e, j, jp, live = r["d"], r["e"], r["j"], r["jp"], r["live"]
        old_cycle, cur_lat = r["old_cycle"], r["cur_lat"]
        pre_d1, pre_e, del_d1, del_e = r["pre_d1"], r["pre_e"], r["del_d1"], r["del_e"]
        jpp = _take1(self.order, (self.nx + 1).clamp(0, p - 1))
        sj = _take1(s, j)
        s3 = torch.stack([sj, _take1(s, jp), _take1(s, jpp)], dim=1)
        invp = (1.0 / s3)[:, self.perms][:, :, :, None]                   # (S, 6, 3, 1)
        base_term = del_d1 / b + (pre_e - pre_d1) / sj
        procs3 = torch.stack([j, jp, jpp], dim=1)                         # (S, 3)
        span2 = (e - d + 1) == 2
        lim_eps = (self.lim + _EPS)[:, None]
        old_eps = (old_cycle - _EPS)[:, None]

        # 2-stage fallback lanes (division-based like the scalar generator)
        dd = d.clamp(max=n)
        pre_dd = _take1(prefix, dd)
        del_dd = _take1(delta, dd)
        W1 = (pre_dd - pre_d1)[:, None]
        W2 = (pre_e - pre_dd)[:, None]
        spa = s3[:, self.fb_a]
        spb = s3[:, self.fb_b]
        t1 = del_d1[:, None] / b + W1 / spa
        cyc1_fb = t1 + del_dd[:, None] / b
        t2 = del_dd[:, None] / b + W2 / spb
        cyc2_fb = t2 + del_e[:, None] / b
        dlat_fb = (t1 + t2) - base_term[:, None]
        mx_fb = torch.maximum(cyc1_fb, cyc2_fb)
        okay_fb = mx_fb < old_eps
        okay_fb &= cur_lat[:, None] + dlat_fb <= lim_eps
        okay_fb &= (live & span2)[:, None]
        ratio_fb = torch.maximum(
            dlat_fb / (old_cycle[:, None] - cyc1_fb).clamp_min(_EPS),
            dlat_fb / (old_cycle[:, None] - cyc2_fb).clamp_min(_EPS))
        bc = self.bi[:, None]
        key1_fb = torch.where(bc, ratio_fb, mx_fb)
        key2_fb = torch.where(bc, mx_fb, dlat_fb)

        if L is None:
            q, has = _lex_argmin_traced([key1_fb, key2_fb, self.fb_key], okay_fb)
            K = 0
            fb = torch.ones_like(has)
            pd_g = pe_g = u_grid = None
        else:
            r1, r2 = self.lanes[L]
            K = r1.numel()
            c1 = d[:, None] + r1[None, :]
            c2 = d[:, None] + r2[None, :]
            valid = c2 <= (e - 1)[:, None]
            c1i = c1.clamp(max=n - 1)
            c2i = c2.clamp(max=n - 1)
            pre_c1 = prefix.gather(1, c1i)
            pre_c2 = prefix.gather(1, c2i)
            del_c1 = delta.gather(1, c1i)
            del_c2 = delta.gather(1, c2i)
            W = torch.stack([pre_c1 - pre_d1[:, None], pre_c2 - pre_c1,
                             pre_e[:, None] - pre_c2], dim=1)              # (S, 3, K)
            dI = torch.stack([del_d1[:, None].expand(S, K), del_c1, del_c2], dim=1) / b
            dO = torch.stack([del_c1, del_c2, del_e[:, None].expand(S, K)], dim=1) / b
            big = live & ~span2
            cyc, dlat, mx = score_3way_cuda(
                dI[:, None], W[:, None], dO[:, None], invp, base_term[:, None, None],
                need=torch.where(big, pair_need(e - d + 1, L), 0))
            ratio = (dlat[:, :, None, :]
                     / (old_cycle[:, None, None, None] - cyc).clamp_min(_EPS)).amax(dim=2)
            mx_f = mx.reshape(S, 6 * K)
            dlat_f = dlat.reshape(S, 6 * K)
            ratio_f = ratio.reshape(S, 6 * K)
            okay3 = mx_f < old_eps
            okay3 &= cur_lat[:, None] + dlat_f <= lim_eps
            okay3 &= valid[:, None, :].expand(S, 6, K).reshape(S, 6 * K)
            okay3 &= big[:, None]
            # (c1, c2, perm) tie-break as ONE exactly-represented integer key
            ccp = ((c1 * (n + 1) + c2)[:, None, :] * 6 + self.six).to(F64).reshape(S, 6 * K)
            key1 = torch.cat([torch.where(bc, ratio_f, mx_f), key1_fb], dim=1)
            key2 = torch.cat([torch.where(bc, mx_f, dlat_f), key2_fb], dim=1)
            key3 = torch.cat([ccp, self.fb_key], dim=1)
            okay = torch.cat([okay3, okay_fb], dim=1)
            q, has = _lex_argmin_traced([key1, key2, key3], okay)
            fb = q >= 6 * K
            # grid winner
            pi = torch.div(q, K, rounding_mode="floor").clamp(max=5)
            kk = q % K
            c1b = d + r1[kk]
            c2b = d + r2[kk]
            u_grid = procs3.gather(1, self.perms[pi])
            pd_g = torch.stack([d, c1b + 1, c2b + 1], dim=1)
            pe_g = torch.stack([c1b, c2b, e], dim=1)
        # fallback winner
        qf = torch.where(fb, q - 6 * K, 0)
        ia = self.fb_a[qf]
        ib = self.fb_b[qf]
        pu0 = _take1(procs3, ia)
        pu1 = _take1(procs3, ib)
        pd_f = torch.stack([d, d + 1, d + 1], dim=1)
        pe_f = torch.stack([d, e, e], dim=1)
        pu_f = torch.stack([pu0, pu1, pu1], dim=1)
        cons_f = torch.where((ia != 0) & (ib != 0), self.two, self.one)
        if L is None:
            return has, pd_f, pe_f, pu_f, self.two, cons_f
        fbc = fb[:, None]
        pd = torch.where(fbc, pd_f, pd_g)
        pe = torch.where(fbc, pe_f, pe_g)
        pu = torch.where(fbc, pu_f, u_grid)
        nparts = torch.where(fb, self.two, self.three)
        consumed = torch.where(fb, cons_f, self.two)
        return has, pd, pe, pu, nparts, consumed

    # -- driving --------------------------------------------------------------

    def step(self, L, counts: _Counts) -> None:
        """One iteration over bucket ``L``: a graph replay on a card
        (captured at first use), the eager step on the CPU."""
        counts.dispatches += 1
        if not self.cuda:
            if L not in self.stepped:
                self.stepped.add(L)
                _BUCKET_TRACES[0] += 1
                counts.traces += 1
            self._step(L)
            return
        with torch.cuda.device(self.device):
            graph = self.graphs.get(L)
            if graph is None:
                before = (score_2way_cuda.captured, score_3way_cuda.captured)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self.pool):
                    self._step(L)
                self.kernels[L] = (score_2way_cuda.captured - before[0],
                                   score_3way_cuda.captured - before[1])
                self.graphs[L] = graph
                _BUCKET_TRACES[0] += 1
                counts.traces += 1
            graph.replay()
        n2, n3 = self.kernels[L]
        score_2way_cuda.launches += n2
        score_3way_cuda.launches += n3

    def request_poll(self) -> None:
        """Enqueue the poll: (any row active, largest cut count (2-way) or
        span (3-way) of any interval of any active row), one small copy to
        the host."""
        span = self.arr[:, :, 1] - self.arr[:, :, 0] + (self.k - 1)
        bound = torch.where(self.active[:, None], span, 0.0).amax()
        val = torch.stack([self.active.any().to(F64), bound])
        if self.cuda:
            with torch.cuda.device(self.device):
                self.poll_host.copy_(val, non_blocking=True)
                self.poll_event.record()
        else:
            self.poll_host.copy_(val)

    def read_poll(self, counts: _Counts) -> None:
        """Wait for the poll and pick the next bucket; stop the chunk when no
        row is active or T iterations ran."""
        if self.cuda:
            self.poll_event.synchronize()
        counts.syncs += 1
        any_active, bound = self.poll_host.tolist()
        self.running = bool(any_active) and self.t_host < self.T
        if self.running and self.sizes:
            self.bucket = self.sizes[bucket_index(int(bound), self.sizes)]


def _drive(progs, counts: _Counts) -> None:
    """Run the loaded programs (one per shard) to convergence: each polls
    once, then replays ``POLL_EVERY`` iterations (at most T in all) over its
    polled bucket and polls again.  Every shard is enqueued before the first
    wait, and each picks its own bucket and stops on its own."""
    for pr in progs:
        pr.t_host = 0
        pr.request_poll()
    for pr in progs:
        pr.read_poll(counts)
    while any(pr.running for pr in progs):
        live = [pr for pr in progs if pr.running]
        for pr in live:
            steps = min(POLL_EVERY, pr.T - pr.t_host)
            for _ in range(steps):
                pr.step(pr.bucket, counts)
            pr.t_host += steps
            pr.request_poll()
        for pr in live:
            pr.read_poll(counts)


# ---------------------------------------------------------------------------
# Programs and their memory pools
# ---------------------------------------------------------------------------

_PROGRAMS: dict = {}
_POOLS: dict = {}


def _program(n: int, p: int, k: int, S: int, device, slot: int) -> _Program:
    """The program of shape (n, p, k, S) for device slot ``slot`` (two slots
    may name one card: each has its own buffers and graphs)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (n, p, k, S, str(dev), slot)
    prog = _PROGRAMS.get(key)
    if prog is None:
        pool = None
        if dev.type == "cuda":
            pkey = (n, k, str(dev))
            if pkey not in _POOLS:
                with torch.cuda.device(dev):
                    _POOLS[pkey] = torch.cuda.graph_pool_handle()
            pool = _POOLS[pkey]
        prog = _PROGRAMS[key] = _Program(n, p, k, S, dev, pool)
    return prog


def release_programs() -> None:
    """Drop every cached program, its graphs and static buffers."""
    _PROGRAMS.clear()
    _POOLS.clear()


def captures(n: int) -> dict:
    """Bucket graphs held for stage count ``n``, per (chunk size, device,
    slot), both arities together: each at most :func:`trace_budget`."""
    out: dict = {}
    for (pn, _p, _k, S, dev, slot), prog in _PROGRAMS.items():
        if pn == n:
            key = (S, dev, slot)
            out[key] = out.get(key, 0) + len(prog.graphs)
    return out


def _shards(B: int, S: int, D: int):
    """Per global chunk of ``S * D`` rows, per shard: (first row, rows, sel)
    with ``sel`` the host row indices padded to S with row 0."""
    for lo in range(0, B, S * D):
        chunk = []
        for i in range(D):
            r0 = min(lo + i * S, B)
            r1 = min(r0 + S, B)
            sel = np.concatenate([np.arange(r0, r1), np.zeros(S - (r1 - r0), dtype=np.int64)])
            chunk.append((r0, r1 - r0, sel))
        yield chunk


def run_loop(state, k: int, bi_mode, stop, lat_limit, record: Optional[Callable],
             devices, counts: _Counts) -> None:
    """The fused loop over ``state`` (a ``batched._BatchState``), its rows
    split over ``devices`` (one shard each): write-back of the final state
    and replay of the per-iteration ``record`` callbacks in global lockstep
    order.  The body of :func:`run_fused` and of the sharded engine."""
    pb = state.pb
    B, n, p = pb.B, pb.n, pb.p
    T = min(n - 1, p - 1)
    if T <= 0 or not bool(state.active.any()):
        state.active.fill_(False)
        return
    D = len(devices)
    S = rows_per_chunk(n, k, -(-B // D), devices[0])
    bi_mode = np.asarray(bi_mode, dtype=bool)
    stop = np.asarray(stop, dtype=np.float64)
    lat_limit = np.asarray(lat_limit, dtype=np.float64)
    active = state.active.cpu().numpy()
    chunks = []  # (rows, per_rec, lat_rec, acc_rec, t_used)
    for shards in _shards(B, S, D):
        progs = []
        for slot, (r0, r, sel) in enumerate(shards):
            act = np.zeros(S, dtype=bool)
            act[:r] = active[r0:r0 + r]
            if not act.any():
                continue      # all rows inactive or padding: no iteration runs
            pr = _program(n, p, k, S, devices[slot], slot)
            pr.load(pb, sel, state, act, bi_mode[sel], stop[sel], lat_limit[sel])
            progs.append((pr, r0, r))
        _drive([pr for pr, _, _ in progs], counts)
        for pr, r0, r in progs:
            state.arr[r0:r0 + r] = pr.arr[:r].to(pb.device)
            state.m[r0:r0 + r] = pr.m[:r].to(pb.device)
            state.next_idx[r0:r0 + r] = pr.nx[:r].to(pb.device)
            state.lat_sum[r0:r0 + r] = pr.lat[:r].to(pb.device)
            state.splits[r0:r0 + r] = pr.sp[:r].to(pb.device)
            if record is not None and pr.t_host:
                t = pr.t_host
                # copies: the buffers are the next chunk's (and .cpu() of a
                # CPU tensor is the tensor itself)
                chunks.append((np.arange(r0, r0 + r),
                               *(rec[:t, :r].cpu().numpy().copy()
                                 for rec in (pr.per_rec, pr.lat_rec, pr.acc_rec)), t))
    state.active.fill_(False)
    if record is None:
        return
    # Replay records in global lockstep order: a row's s-th accepted split
    # always lands at iteration s regardless of which rows share its chunk,
    # so merging chunk records per iteration reproduces the lockstep engine's
    # record sequence exactly.
    t_max = max((t for *_, t in chunks), default=0)
    for t in range(t_max):
        rsel, pers, lats = [], [], []
        for rows, per_rec, lat_rec, acc_rec, t_used in chunks:
            if t >= t_used:
                continue
            a = acc_rec[t]
            if a.any():
                rsel.append(rows[a])
                pers.append(per_rec[t][a])
                lats.append(lat_rec[t][a])
        if rsel:
            record(np.concatenate(rsel), np.concatenate(pers), np.concatenate(lats))


def run_fused(state, k: int, bi_mode: np.ndarray, stop: np.ndarray,
              lat_limit: np.ndarray, record: Optional[Callable] = None) -> None:
    """Run the fused loop over ``state`` (a ``batched._BatchState``) on its
    device, writing the final state back and replaying per-iteration
    ``record`` callbacks — a drop-in replacement for the lockstep
    ``_run_loop`` body with a host poll every ``POLL_EVERY`` iterations."""
    run_loop(state, k, bi_mode, stop, lat_limit, record, [state.pb.device], _COUNTS)


def run_bisection(pb, p_fix, lo, hi, iters: int, devices, counts: _Counts) -> dict:
    """The fused H4 binary search over ``pb``, rows split over ``devices``:
    per chunk, a probe at ``hi`` and then ``iters`` probes, every update on
    the device and bit-identical to the host-driven search: ``mid = 0.5 *
    (lo + hi)``, feasibility ``(period <= p_fix + eps) & (latency <= mid +
    eps)``, and the (latency, then period) best-probe tie-break of
    ``batched._sp_bi_p_rowwise``.  Returns per-row numpy arrays
    ``items0/m0/sp0/per0/lat0/feas0`` (the probe at ``hi``: the failure
    outputs) and ``items/m/sp/per/lat`` (the best feasible probe)."""
    B, n, p = pb.B, pb.n, pb.p
    T = min(n - 1, p - 1)
    if T <= 0:
        raise ValueError("unsplittable shape: caller should use the host path")
    D = len(devices)
    S = rows_per_chunk(n, 1, -(-B // D), devices[0])
    p_fix = np.asarray(p_fix, dtype=np.float64)
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    names = ("items0", "m0", "sp0", "per0", "lat0", "feas0",
             "items", "m", "sp", "per", "lat")
    out = {
        "items0": np.zeros((B, n, 3)), "m0": np.zeros(B, dtype=np.int64),
        "sp0": np.zeros(B, dtype=np.int64), "per0": np.zeros(B),
        "lat0": np.zeros(B), "feas0": np.zeros(B, dtype=bool),
        "items": np.zeros((B, n, 3)), "m": np.zeros(B, dtype=np.int64),
        "sp": np.zeros(B, dtype=np.int64), "per": np.zeros(B),
        "lat": np.zeros(B),
    }
    all_bi = np.ones(S, dtype=bool)
    for shards in _shards(B, S, D):
        runs = []
        for slot, (r0, r, sel) in enumerate(shards):
            if r == 0:
                continue
            pr = _program(n, p, 1, S, devices[slot], slot)
            act = np.zeros(S, dtype=bool)
            act[:r] = True
            pr.load(pb, sel, None, act, all_bi, p_fix[sel], hi[sel])
            dev = pr.device
            runs.append(dict(pr=pr, r0=r0, r=r, act=torch.from_numpy(act).to(dev),
                             lo=torch.from_numpy(lo[sel]).to(dev),
                             hi=torch.from_numpy(hi[sel]).to(dev)))
        progs = [run["pr"] for run in runs]

        def probe(limits_of, active_of):
            for run in runs:
                pr = run["pr"]
                pr.init_state()
                pr.lim.copy_(limits_of(run))
                pr.active.copy_(active_of(run))
            _drive(progs, counts)
            res = []
            for run in runs:
                pr = run["pr"]
                per = pr.arr[:, :, 3].amax(dim=1)
                lat = pr.lat + pr.delta[:, n] / pr.b
                feas = (per <= pr.stop + _EPS) & (lat <= pr.lim + _EPS)
                res.append((per, lat, feas))
            return res

        # Ensure feasibility at the upper end first (the rowwise path's
        # probe0); its state seeds both the failure outputs and `best`.
        for run, (per, lat, feas) in zip(runs, probe(lambda run: run["hi"],
                                                     lambda run: run["act"])):
            pr = run["pr"]
            run["first"] = (pr.arr[:, :, :3].clone(), pr.m.clone(), pr.sp.clone(),
                            per, lat, feas)
            run["alive"] = feas & run["act"]
            run["best"] = [pr.arr[:, :, :3].clone(), pr.m.clone(), pr.sp.clone(),
                           per.clone(), lat.clone()]
        for _ in range(iters):
            for run in runs:
                run["mid"] = 0.5 * (run["lo"] + run["hi"])
            for run, (per, lat, feas) in zip(runs, probe(lambda run: run["mid"],
                                                         lambda run: run["alive"])):
                pr, alive, mid = run["pr"], run["alive"], run["mid"]
                b_it, b_m, b_sp, b_per, b_lat = run["best"]
                good = alive & feas
                run["hi"] = torch.where(good, mid, run["hi"])
                run["lo"] = torch.where(alive & ~feas, mid, run["lo"])
                better = good & ((lat < b_lat - _EPS)
                                 | (((lat - b_lat).abs() <= _EPS) & (per < b_per)))
                run["best"] = [torch.where(better[:, None, None], pr.arr[:, :, :3], b_it),
                               torch.where(better, pr.m, b_m),
                               torch.where(better, pr.sp, b_sp),
                               torch.where(better, per, b_per),
                               torch.where(better, lat, b_lat)]
        for run in runs:
            r0, r = run["r0"], run["r"]
            for name, val in zip(names, (*run["first"], *run["best"])):
                out[name][r0:r0 + r] = val[:r].cpu().numpy()
    return out


def run_fused_bisection(pb, p_fix: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                        iters: int) -> dict:
    """Run the ENTIRE H4 binary search device-resident on ``pb``'s device
    (:func:`run_bisection`), bit-identical to the host-driven search.  The
    caller (``batched._sp_bi_p_fused``) assembles HeuristicResults."""
    return run_bisection(pb, p_fix, lo, hi, iters, [pb.device], _COUNTS)
