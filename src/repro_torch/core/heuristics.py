"""Split scoring for the paper's splitting heuristics (Section 4).

The port's counterpart of the parts of ``repro.core.heuristics`` that the
lockstep engine (:mod:`repro_torch.core.batched`) runs:

  - the plain PyTorch split-scoring functions :func:`score_2way` /
    :func:`score_3way`, with the reference's guarded expressions, element for
    element, in float64 (``heuristics.py:225-256, 308-322``);
  - :func:`score_kernels`, which selects them or the hand-written CUDA
    kernels of :mod:`repro_torch.kernels.split_score`;
  - host copies of the scalar candidate generator and choice rules
    (``_three_way_candidates``, ``_pick_mono``, ``_pick_bi``) that the
    engine's 2-stage 3-way fallback reuses verbatim.

Exactness: every ``*`` and ``+`` is its own torch op (no ``addcmul``, ``lerp``
or ``addmm``), so each is rounded once, as in numpy.  ``b`` is turned into a
float64 tensor on the data's device before dividing by it: a CUDA division by
a Python scalar is computed as a multiplication by its reciprocal, which is
not the IEEE quotient numpy computes.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import torch

from .metrics import Mapping

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
# Scalar candidate enumeration and choice (host; the 2-stage 3-way fallback)
# ---------------------------------------------------------------------------

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
