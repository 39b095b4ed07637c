"""Public wrappers of the model kernels, with the reference's signatures
(``repro/kernels/ops.py``): the model code calls these.

For a CPU tensor each runs its kernel's plain PyTorch version; for a CUDA
tensor it launches the hand-written kernel or raises.
"""

from __future__ import annotations

from typing import Optional

from . import decode_attention as _dec
from .flash_attention import flash_attention
from .mamba2_ssd import ssd_chunked_kernel
from .rmsnorm import rmsnorm, rmsnorm_residual

__all__ = ["decode_attention", "decode_mask", "flash_attention", "rmsnorm",
           "rmsnorm_residual", "ssd_chunked"]


def decode_mask(positions, pos, window: Optional[int] = None):
    """Slot validity of a cache: written (``>= 0``), not in the future, and
    inside the window; as the reference builds it (``ops.py:38-41``)."""
    valid = (positions >= 0) & (positions <= pos[:, None])
    if window is not None:
        valid &= positions > (pos[:, None] - window)
    return valid


def decode_attention(q, k, v, positions, pos, *, window: Optional[int] = None,
                     return_lse: bool = False):
    """q: (B,H,hd); cache k,v: (B,C,K,hd); positions: (B,C) absolute positions
    stored per slot (-1 = empty); pos: (B,) current decode position.  With
    ``return_lse``, (out, each (row, head)'s log-sum-exp)."""
    return _dec.decode_attention(q, k, v, decode_mask(positions, pos, window),
                                 return_lse=return_lse)


def ssd_chunked(x, dt, A, Bmat, Cmat, chunk: int = 256):
    """x: (B,S,H,P) float32; dt: (B,S,H); A: (H,); Bmat/Cmat: (B,S,N).
    Returns (y (B,S,H,P), final state (B,H,P,N)) through the SSD
    intra-chunk kernel (``ops.py:57-60``)."""
    return ssd_chunked_kernel(x, dt, A, Bmat, Cmat, chunk)
