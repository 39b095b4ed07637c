"""Plain PyTorch oracles of the model kernels (the correctness contract).

Each function mirrors its namesake in the reference's ``kernels/ref.py``
(``rmsnorm_residual_ref`` follows the TPU kernel's formula instead):
the mathematical definition with materialized intermediates and the same
float32 intermediates, slow and memory-hungry but obviously correct.  The
kernel wrappers run them for CPU tensors; the tests and ``chip_smoke.py`` hold
the CUDA kernels against them on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["NEG_INF", "decode_attention_ref", "flash_attention_ref", "rmsnorm_ref",
           "rmsnorm_residual_ref"]

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,T,K,hd).  Materialized softmax attention."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    kf = k.repeat_interleave(G, dim=2)                   # (B,T,H,hd)
    vf = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float(), kf.float()) / math.sqrt(hd)
    pq = torch.arange(S, device=q.device)[:, None]
    pk = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pq >= pk
    if window is not None:
        mask &= (pq - pk) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", p, vf.float())
    return out.to(q.dtype)


def decode_attention_ref(q, k, v, mask) -> torch.Tensor:
    """q: (B,H,hd); k,v: (B,C,K,hd); mask: (B,C)."""
    B, H, hd = q.shape
    C, K = k.shape[1], k.shape[2]
    G = H // K
    kf = k.repeat_interleave(G, dim=2)
    vf = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bchd->bhc", q.float(), kf.float()) / math.sqrt(hd)
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhc,bchd->bhd", p, vf.float())
    return out.to(q.dtype)


def rmsnorm_ref(x, scale, *, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_residual_ref(x, residual, scale, *, eps: float = 1e-5) -> tuple:
    """``(norm of the float32 sum, sum rounded to x's type)``: the TPU
    kernel's formula (``kernels/rmsnorm.py:25-29``), which normalizes the
    float32 sum.  The reference's own oracle (``kernels/ref.py:63-65``)
    normalizes the sum rounded to x's type; the kernel is held to its own."""
    s = x.float() + residual.float()
    var = torch.mean(s * s, dim=-1, keepdim=True)
    return (s * torch.rsqrt(var + eps) * scale.float()).to(x.dtype), s.to(x.dtype)
