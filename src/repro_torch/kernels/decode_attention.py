"""Wrapper of the hand-written CUDA decode-attention kernel
(``csrc/decode_attention.cu``).

The port's counterpart of the reference's Pallas
``kernels/decode_attention.py::decode_attention``: one query token per
(batch row, head) against a KV cache, with a slot-validity mask built by the
caller (:func:`repro_torch.kernels.ops.decode_attention` builds it from the
cache's positions, as the reference's ``ops.py`` does).

``q`` (B, H, hd), ``k``/``v`` (B, C, K, hd) of one type (float32 or
bfloat16), ``mask`` (B, C) bool; returns (B, H, hd) in ``q``'s type.  A CUDA
tensor launches the kernel on the current stream and adds one to
``decode_attention.launches``; a CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.decode_attention_ref`).  Nothing falls back:
a CUDA input the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import decode_attention_ref
from .rmsnorm import DTYPE_CODES

__all__ = ["decode_attention"]

MAX_HEAD_DIM = 256
SPLIT = 128  # cache slots per block of the split pass (kSplit in the source)
# q, k, v, mask, out, part_ml, part_acc, B, C, K, G, hd, scale, dtype (then the stream)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int]


def decode_attention(q, k, v, mask) -> torch.Tensor:
    """Softmax attention of each single-token query over its cache slots."""
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_ref(q, k, v, mask)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {dev}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    B, H, hd = q.shape
    C, K = k.shape[1], k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} KV heads")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} exceeds the kernel's {MAX_HEAD_DIM}")
    n_split = -(-C // SPLIT)
    if max(B, C, H) >= 2 ** 31 or max(B, n_split) >= 2 ** 16:
        raise ValueError(f"shape {(B, C, H)} exceeds the kernel's grid")
    build.check_tensor("q", q, (B, H, hd), q.dtype, dev)
    build.check_tensor("k", k, (B, C, K, hd), q.dtype, dev)
    build.check_tensor("v", v, (B, C, K, hd), q.dtype, dev)
    build.check_tensor("mask", mask, (B, C), torch.bool, dev)
    out = torch.empty_like(q)
    part_ml = torch.empty((B, K, n_split, H // K, 2), dtype=torch.float32, device=dev)
    part_acc = torch.empty((B, K, n_split, H // K, hd), dtype=torch.float32, device=dev)
    build.launch("decode_attention", "decode_attention", _ARGTYPES, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                 part_ml.data_ptr(), part_acc.data_ptr(), B, C, K, H // K, hd,
                 1.0 / math.sqrt(hd), DTYPE_CODES[q.dtype])
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
