"""Building blocks shared by the architectures: initializers, norms, rotary
embeddings, MLPs, embedding and unembedding (the port of the reference's
``models/layers.py``; its sharding constraints are no-ops on one card and are
left out)."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .common import ModelConfig

__all__ = ["apply_rope", "cast_matrices", "dense_init", "embed", "embed_init",
           "init_embed", "init_mlp", "mlp", "rms_norm", "rope_freqs", "tree_from_numpy",
           "unembed"]


# ---------------------------------------------------------------------------
# Initializers (the reference's distributions; torch's generator, so not its
# numbers: tests carry the reference's parameters across instead)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, fan_in: Optional[int] = None):
    fan = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    scale = 1.0 / math.sqrt(max(fan, 1))
    x = torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
    return x.mul_(torch.tensor(scale, dtype=dtype))


def embed_init(gen: torch.Generator, shape, dtype):
    x = torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
    return x.mul_(torch.tensor(0.02, dtype=dtype))


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

def cast_matrices(tree, dtype, stacked_axes: dict, keep=frozenset()):
    """Matrices (two or more axes of their own) to ``dtype``, once; vectors
    (norm scales) and the leaves named in ``keep`` unchanged.  A subtree
    named in ``stacked_axes`` stacks its weights on that many leading axes,
    which do not count as the weight's own."""
    def walk(node, lead, name):
        if isinstance(node, dict):
            return {k: walk(v, stacked_axes.get(k, lead), k) for k, v in node.items()}
        return node.to(dtype) if node.dim() - lead >= 2 and name not in keep else node
    return walk(tree, 0, "")


def tree_from_numpy(tree, dtype, device):
    """Nested dicts of numpy arrays as tensors of ``dtype`` on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, dtype, device) for k, v in tree.items()}
    # a copy: the caller's arrays may be read-only views of its buffers
    return torch.from_numpy(np.array(tree)).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             use_pallas: bool = False) -> torch.Tensor:
    """Two formulas, as in the reference.  With ``use_pallas`` the fused
    kernel's: ``x * rsqrt(var + eps) * scale`` in float32, rounded once.
    Without: ``x * rsqrt(var + eps)`` rounded to x's type first, then
    multiplied by the scale in x's type."""
    if use_pallas:
        from ..kernels import ops as kops

        return kops.rmsnorm(x, scale, eps=eps)
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # theta stays a Python number: a tensor made from it on the card would be
    # a blocking host-to-device copy on every call
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                      # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs      # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None,
             lead: tuple = ()) -> dict:
    """``lead`` prepends axes (the stacked layer axis) to every weight."""
    ff = d_ff if d_ff is not None else cfg.d_ff
    d = cfg.d_model
    pdt = cfg.torch_param_dtype
    p = {"wi": dense_init(gen, lead + (d, ff), pdt)}
    if cfg.act == "swiglu":
        p["wg"] = dense_init(gen, lead + (d, ff), pdt)
    p["wo"] = dense_init(gen, lead + (ff, d), pdt)
    return p


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.act == "swiglu":
        h = x @ params["wi"].to(dt)
        g = x @ params["wg"].to(dt)
        h = F.silu(g) * h
    else:
        h = F.gelu(x @ params["wi"].to(dt), approximate="tanh")
    return h @ params["wo"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, cfg: ModelConfig) -> dict:
    pdt = cfg.torch_param_dtype
    out = {"tok": embed_init(gen, (cfg.vocab_size, cfg.d_model), pdt)}
    if not cfg.tie_embeddings:
        out["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), pdt)
    return out


def embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["tok"].to(cfg.torch_dtype)[tokens.long()]


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = params["tok"].to(x.dtype).T
    else:
        w = params["unembed"].to(x.dtype)
    return x @ w
