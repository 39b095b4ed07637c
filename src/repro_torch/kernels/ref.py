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
           "rmsnorm_residual_ref", "ssd_intra_chunk_ref", "ssd_ref"]

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


def decode_attention_ref(q, k, v, mask, return_lse: bool = False):
    """q: (B,H,hd); k,v: (B,C,K,hd); mask: (B,C).  With ``return_lse`` also
    each (row, head)'s log-sum-exp of its float32 scores (B, H), masked
    slots at -1e30: ``-1e30`` for a row with no valid slot."""
    B, H, hd = q.shape
    C, K = k.shape[1], k.shape[2]
    G = H // K
    kf = k.repeat_interleave(G, dim=2)
    vf = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bchd->bhc", q.float(), kf.float()) / math.sqrt(hd)
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhc,bchd->bhd", p, vf.float()).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


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


def ssd_ref(x, dt, A, Bmat, Cmat) -> tuple:
    """Sequential (step-by-step) SSD.  x: (B,S,H,P) float32; dt: (B,S,H);
    A: (H,); Bmat/Cmat: (B,S,N).  Returns (y (B,S,H,P), final state
    (B,H,P,N)): the reference's oracle (``kernels/ref.py:68-88``), its
    ``lax.scan`` as a loop over the steps."""
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)                                   # (B,H)
        upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bmat[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", Cmat[:, t], state))
    return torch.stack(ys, dim=1), state


def ssd_intra_chunk_ref(x, dt, A, Bmat, Cmat) -> tuple:
    """The SSD intra-chunk kernel's body (``kernels/mamba2_ssd.py:23-49``)
    for every (batch, chunk, head) at once, with its float32 intermediates:
    the inclusive cumsum of dt*A, the (Q, Q) decay matrix under a select,
    the C.B scores, then ``y = (scores * L * dt) @ x``, the chunk state
    ``(B * exp(cum_Q - cum) * dt)^T @ x`` and the chunk decay ``exp(cum_Q)``.

    x: (B,nc,Q,H,P); dt: (B,nc,Q,H); A: (H,); Bmat/Cmat: (B,nc,Q,N).
    Returns (y (B,nc,Q,H,P), chunk state (B,nc,H,N,P), chunk decay (B,nc,H)),
    float32."""
    x, dt, A = x.float(), dt.float(), A.float()
    Bm, Cm = Bmat.float(), Cmat.float()
    Q = x.shape[2]
    dth = dt.transpose(2, 3)                                    # (B,nc,H,Q)
    cum = torch.cumsum(dth * A[:, None], dim=-1)                # inclusive
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
    scores = torch.einsum("bcin,bcjn->bcij", Cm, Bm)            # (B,nc,Q,Q)
    w = scores[:, :, None] * L * dth[..., None, :]              # (B,nc,H,Q,Q)
    y = torch.einsum("bchij,bcjhp->bcihp", w, x)
    dec_state = torch.exp(cum[..., -1:] - cum) * dth            # (B,nc,H,Q)
    st = torch.einsum("bchjn,bcjhp->bchnp", Bm[:, :, None] * dec_state[..., None], x)
    return y, st, torch.exp(cum[..., -1])
