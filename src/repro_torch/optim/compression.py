"""Gradient compression for bandwidth-constrained (inter-pod) reduction (the
port of the reference's ``optim/compression.py``, which has no caller there
either): top-k sparsification with error feedback, and int8 linear
quantization with a per-tensor scale.  Both decompress to the exact shape,
so they compose with any collective schedule.

Among entries of equal magnitude, ``torch.topk`` and ``jax.lax.top_k`` may
keep different ones; the decompressed tensors agree wherever the kept set
is decided by magnitude alone.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .tree import tree_map

__all__ = ["ErrorFeedbackState", "ef_compress_update", "ef_init", "int8_compress",
           "int8_decompress", "topk_compress", "topk_decompress"]


def topk_compress(x: torch.Tensor, frac: float):
    """Keep the top ``frac`` fraction of entries by magnitude.
    Returns (values, flat_indices, original_shape)."""
    flat = x.reshape(-1).float()
    k = max(1, int(flat.numel() * frac))
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx, tuple(x.shape)


def topk_decompress(values, idx, shape) -> torch.Tensor:
    out = torch.zeros(math.prod(shape), dtype=torch.float32, device=values.device)
    out[idx] = values
    return out.reshape(shape)


def int8_compress(x: torch.Tensor):
    flat = x.float()
    scale = torch.clamp(flat.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q, scale) -> torch.Tensor:
    return q.float() * scale


class ErrorFeedbackState(NamedTuple):
    residual: dict  # tree like grads


def ef_init(grads) -> ErrorFeedbackState:
    return ErrorFeedbackState(tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads))


def ef_compress_update(grads, state: ErrorFeedbackState, frac: float = 0.01):
    """Error-feedback top-k: compress (grad + residual); residual accumulates
    what was dropped.  Returns (compressed_tree, new_state) where each leaf
    of compressed is (values, idx, shape)."""
    def one(g, r):
        corrected = g.float() + r
        vals, idx, shape = topk_compress(corrected, frac)
        dense = topk_decompress(vals, idx, shape)
        return (vals, idx, shape), corrected - dense

    pairs = tree_map(one, grads, state.residual)
    return (tree_map(lambda g, pr: pr[0], grads, pairs),
            ErrorFeedbackState(tree_map(lambda g, pr: pr[1], grads, pairs)))
