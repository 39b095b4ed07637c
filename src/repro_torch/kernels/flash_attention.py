"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

The port's counterpart of the reference's Pallas
``kernels/flash_attention.py::flash_attention``: causal and/or
sliding-window softmax attention with grouped KV heads (query head ``h``
reads KV head ``h // G``), float32 online softmax, whole tiles outside the
band skipped.

``q`` (B, S, H, hd), ``k``/``v`` (B, T, K, hd) of one type (float32 or
bfloat16); returns (B, S, H, hd) in ``q``'s type.  Unlike the TPU kernel it
needs no block divisibility of S or T.  Two routes, chosen by the type:
bfloat16 runs on the tensor cores (``mma.sync``, P split as hi + lo in bf16),
float32 on the CUDA cores (TF32 would not hold atol 2e-5).  A CUDA tensor
launches its route's kernel on the current stream and adds one to
``flash_attention.launches`` and to ``flash_attention.routes[route]``; a CPU
tensor runs the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`).  Nothing falls back,
from one route to the other or to the plain version: a CUDA input its route
does not take raises.  A ``meta`` tensor (the dry run) gets the result as a
meta tensor, allocated as on the card; nothing runs.  Both routes tell
:func:`~.build.note_launch` of the launch (:func:`flash_cost`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build
from .ref import flash_attention_ref

__all__ = ["band_pairs", "flash_attention", "flash_cost"]

MAX_HEAD_DIM = 256
# dtype -> (route, C entry point)
ROUTES = {torch.bfloat16: ("tc_bf16", "flash_attention_bf16"),
          torch.float32: ("cuda_f32", "flash_attention_f32")}
# q, k, v, out, B, S, T, H, K, hd, scale, causal, window (then the stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] \
    + [ctypes.c_int] * 2


def band_pairs(S: int, T: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs inside the causal and window masks, per batch row
    and head: query ``i`` sees keys ``j <= i`` (causal) with ``i - j <
    window``; without causality every key (the kernel applies the window
    only with it)."""
    if not causal:
        return S * T
    c = min(window or T, T)
    if S <= c:
        return S * (S + 1) // 2
    return c * (c + 1) // 2 + (S - c) * c


def flash_cost(B: int, S: int, T: int, H: int, K: int, hd: int, itemsize: int,
               causal: bool, window: Optional[int]) -> tuple:
    """(bytes, operations) of :func:`flash_attention`: q, k, v read and out
    written once; QK^T and PV over the pairs inside the band, 2 hd each
    (chip_smoke.py's bound for the row)."""
    nbytes = itemsize * (2 * B * S * H * hd + 2 * B * T * K * hd)
    return nbytes, 4 * hd * H * B * band_pairs(S, T, causal, window)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Softmax attention of ``q`` over ``k``/``v`` under the causal and
    window masks (absolute positions ``0..S-1`` and ``0..T-1``)."""
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    if q.dtype not in ROUTES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    route, entry = ROUTES[q.dtype]
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} KV heads")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} exceeds the kernel's {MAX_HEAD_DIM}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if max(S, T) >= 2 ** 31 or max(B, H) >= 2 ** 16:
        raise ValueError(f"shape {(B, S, T, H)} exceeds the kernel's grid")
    build.check_tensor("q", q, (B, S, H, hd), q.dtype, dev)
    build.check_tensor("k", k, (B, T, K, hd), q.dtype, dev)
    build.check_tensor("v", v, (B, T, K, hd), q.dtype, dev)
    out = torch.empty_like(q)
    if dev.type == "cuda":
        build.launch("flash_attention", entry, _ARGTYPES, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), B, S, T, H, K, hd, 1.0 / math.sqrt(hd),
                     int(causal), int(window or 0))
        flash_attention.launches += 1
        flash_attention.routes[route] += 1
    if build.LAUNCH_LISTENERS:
        build.note_launch("flash_attention",
                          *flash_cost(B, S, T, H, K, hd, q.element_size(), causal, window))
    return out


flash_attention.launches = 0
flash_attention.routes = {route: 0 for route, _ in ROUTES.values()}
