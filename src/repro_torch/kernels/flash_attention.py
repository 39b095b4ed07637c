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
does not take raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build
from .ref import flash_attention_ref

__all__ = ["flash_attention"]

MAX_HEAD_DIM = 256
# dtype -> (route, C entry point)
ROUTES = {torch.bfloat16: ("tc_bf16", "flash_attention_bf16"),
          torch.float32: ("cuda_f32", "flash_attention_f32")}
# q, k, v, out, B, S, T, H, K, hd, scale, causal, window (then the stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] \
    + [ctypes.c_int] * 2


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Softmax attention of ``q`` over ``k``/``v`` under the causal and
    window masks (absolute positions ``0..S-1`` and ``0..T-1``)."""
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
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
    build.launch("flash_attention", entry, _ARGTYPES, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), B, S, T, H, K, hd, 1.0 / math.sqrt(hd),
                 int(causal), int(window or 0))
    flash_attention.launches += 1
    flash_attention.routes[route] += 1
    return out


flash_attention.launches = 0
flash_attention.routes = {route: 0 for route, _ in ROUTES.values()}
