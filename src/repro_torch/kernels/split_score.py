"""Wrappers of the hand-written CUDA split-scoring kernels.

The port's counterpart of ``repro.kernels.split_score`` (the Pallas kernels
``score_2way_pallas`` / ``score_3way_pallas``).  The kernels themselves are in
``csrc/split_score.cu``; :mod:`repro_torch.kernels.build` compiles them at
first use.  The calling convention is the reference's:

  - :func:`score_2way_cuda` takes lanes (A, K) and interval-end columns
    (A, 1) and returns ``(cyc1, cyc2, dlat)``, each (A, 2K), with both
    placement orders concatenated;
  - :func:`score_3way_cuda` takes ``dI``/``W``/``dO`` (A, 1, 3, K), ``invp``
    (A, 6, 3, 1) and ``base_term`` (A, 1, 1) and returns ``cyc`` (A, 6, 3, K),
    ``dlat`` (A, 6, K) and ``mx`` (A, 6, K).

Each takes a per-row live-lane bound ``need`` (int64, (A,)); lanes at or past
it are zero.  A CUDA tensor launches the kernel on the current stream (and
adds one to the wrapper's ``launches``); a CPU tensor runs the plain PyTorch
version of :mod:`repro_torch.core.heuristics` and zeroes the same lanes.
Nothing falls back: a CUDA input the kernel does not take raises.

A call made while the current stream is being captured into a CUDA graph
launches nothing: it adds one to the wrapper's ``captured`` instead, and
whoever replays the graph counts its launches (:mod:`repro_torch.core.fused`
adds each replay's kernels to ``launches``).  ``score_2way_cuda`` takes the
bandwidth ``b`` as a float, passed by value, or as a 0-dim float64 tensor on
the inputs' device, read by the kernel where it runs
(``score_2way_f64_bptr``), which is what a captured launch needs.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.heuristics import score_2way, score_3way
from . import build

__all__ = ["pair_need", "score_2way_cuda", "score_3way_cuda"]


def pair_need(span, lanes: int) -> torch.Tensor:
    """Last-valid-lane bound (exclusive) per row for the r1-major (c1, c2)
    pair layout of ``lanes``-span grids: a row of span ``s`` has its last
    valid pair (r1, r2) = (s-3, s-2) at index ``(s-3)(L-2) - (s-3)(s-4)/2``
    (pairs are prefix-dense in r1-groups).  Rows with span < 3 need 0 lanes.
    """
    span = torch.as_tensor(span, dtype=torch.int64)
    o1 = torch.clamp(span - 3, min=0)
    need = o1 * (lanes - 2) - torch.div(o1 * (o1 - 1), 2, rounding_mode="floor") + 1
    return torch.where(span >= 3, need, torch.zeros_like(need))


_ARGTYPES = {
    # 8 input pointers, need, b, zero, 3 output pointers, A, K (then the stream)
    "score_2way_f64": [ctypes.c_void_p] * 9 + [ctypes.c_double] * 2
    + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2,
    # the same with b as a device pointer
    "score_2way_f64_bptr": [ctypes.c_void_p] * 10 + [ctypes.c_double]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2,
    # 5 input pointers, need, zero, 3 output pointers, A, K (then the stream)
    "score_3way_f64": [ctypes.c_void_p] * 6 + [ctypes.c_double]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2,
}
_check = build.check_tensor


def _need(need, A: int, K: int, device) -> torch.Tensor:
    if need is None:
        return torch.full((A,), K, dtype=torch.int64, device=device)
    _check("need", need, (A,), torch.int64, device)
    return need


def _launch(wrapper, fn: str, *args) -> None:
    build.launch("split_score", fn, _ARGTYPES[fn], *args)
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def score_2way_cuda(pre_d1, pre_C, pre_e, delta_d1, delta_C, delta_e, b,
                    inv_j, inv_p, *, zero=0.0, need=None):
    """Every 2-way cut of each row's worst interval, both placement orders
    (see the module docstring for shapes).  ``b`` is a float or a 0-dim
    float64 tensor on the inputs' device."""
    A, K = pre_C.shape
    dev = pre_C.device
    need = _need(need, A, K, dev)
    if dev.type == "cpu":
        outs = score_2way(pre_d1, pre_C, pre_e, delta_d1, delta_C, delta_e, b,
                          inv_j, inv_p, zero=zero)
        live = torch.arange(K).repeat(2)[None, :] < need[:, None]
        return tuple(torch.where(live, o, torch.zeros_like(o)) for o in outs)
    if dev.type != "cuda":
        raise ValueError(f"score_2way_cuda runs on cuda or cpu, not {dev}")
    f64 = torch.float64
    _check("pre_C", pre_C, (A, K), f64, dev)
    _check("delta_C", delta_C, (A, K), f64, dev)
    cols = (pre_d1, pre_e, delta_d1, delta_e, inv_j, inv_p)
    for nm, c in zip(("pre_d1", "pre_e", "delta_d1", "delta_e", "inv_j", "inv_p"), cols):
        _check(nm, c, (A, 1), f64, dev)
    cyc1, cyc2, dlat = (torch.empty((A, 2 * K), dtype=f64, device=dev) for _ in range(3))
    ins = (pre_d1.data_ptr(), pre_C.data_ptr(), pre_e.data_ptr(), delta_d1.data_ptr(),
           delta_C.data_ptr(), delta_e.data_ptr(), inv_j.data_ptr(), inv_p.data_ptr(),
           need.data_ptr())
    outs = (cyc1.data_ptr(), cyc2.data_ptr(), dlat.data_ptr(), A, K)
    if isinstance(b, torch.Tensor):
        _check("b", b, (), f64, dev)
        _launch(score_2way_cuda, "score_2way_f64_bptr", *ins, b.data_ptr(), float(zero),
                *outs)
    else:
        _launch(score_2way_cuda, "score_2way_f64", *ins, float(b), float(zero), *outs)
    return cyc1, cyc2, dlat


def score_3way_cuda(dI, W, dO, invp, base_term, *, zero=0.0, need=None):
    """All r1-major (c1, c2) pairs x 6 processor permutations of each row's
    worst interval (see the module docstring for shapes)."""
    A, K = dI.shape[0], dI.shape[-1]
    dev = dI.device
    need = _need(need, A, K, dev)
    if dev.type == "cpu":
        outs = score_3way(dI, W, dO, invp, base_term, zero=zero)
        live = torch.arange(K)[None, :] < need[:, None]
        return tuple(torch.where(live.view((A,) + (1,) * (o.dim() - 2) + (K,)),
                                 o, torch.zeros_like(o)) for o in outs)
    if dev.type != "cuda":
        raise ValueError(f"score_3way_cuda runs on cuda or cpu, not {dev}")
    f64 = torch.float64
    for nm, t in (("dI", dI), ("W", W), ("dO", dO)):
        _check(nm, t, (A, 1, 3, K), f64, dev)
    _check("invp", invp, (A, 6, 3, 1), f64, dev)
    _check("base_term", base_term, (A, 1, 1), f64, dev)
    cyc = torch.empty((A, 6, 3, K), dtype=f64, device=dev)
    dlat = torch.empty((A, 6, K), dtype=f64, device=dev)
    mx = torch.empty((A, 6, K), dtype=f64, device=dev)
    _launch(score_3way_cuda, "score_3way_f64", dI.data_ptr(), W.data_ptr(), dO.data_ptr(),
            invp.data_ptr(), base_term.data_ptr(), need.data_ptr(), float(zero),
            cyc.data_ptr(), dlat.data_ptr(), mx.data_ptr(), A, K)
    return cyc, dlat, mx


score_2way_cuda.launches = score_2way_cuda.captured = 0
score_3way_cuda.launches = score_3way_cuda.captured = 0
