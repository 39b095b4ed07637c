"""Attention: GQA, qk-norm, biases, sliding windows, KV caches (the port of
the reference's ``models/attention.py``).

Full-sequence attention takes the flash kernel (:mod:`repro_torch.kernels`)
where the reference takes its Pallas kernel, and the plain einsum softmax
where the reference does.  The reference's third branch, the blocked
attention for long sequences without kernels, is not ported yet and raises.
Decode runs one token against a ring-buffered KV cache.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .common import ModelConfig
from .layers import apply_rope, dense_init, rms_norm

__all__ = ["KVCache", "attention", "decode_attention_step", "init_attention",
           "init_cache", "plain_attention"]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, lead: tuple = ()) -> dict:
    """``lead`` prepends axes (the stacked layer axis) to every weight."""
    H, K, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    pdt = cfg.torch_param_dtype
    dev = gen.device
    p = {
        "wq": dense_init(gen, lead + (d, H, hd), pdt, fan_in=d),
        "wk": dense_init(gen, lead + (d, K, hd), pdt, fan_in=d),
        "wv": dense_init(gen, lead + (d, K, hd), pdt, fan_in=d),
        "wo": dense_init(gen, lead + (H, hd, d), pdt, fan_in=H * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (H, hd), dtype=pdt, device=dev)
        p["bk"] = torch.zeros(lead + (K, hd), dtype=pdt, device=dev)
        p["bv"] = torch.zeros(lead + (K, hd), dtype=pdt, device=dev)
    if cfg.qk_norm:
        p["q_scale"] = torch.ones(lead + (hd,), dtype=pdt, device=dev)
        p["k_scale"] = torch.ones(lead + (hd,), dtype=pdt, device=dev)
    return p


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(params, x, kv_x, cfg: ModelConfig, positions, kv_positions,
                 rope: bool = True):
    dt = x.dtype
    q = _proj(x, params["wq"].to(dt))
    k = _proj(kv_x, params["wk"].to(dt))
    v = _proj(kv_x, params["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_scale"], cfg.norm_eps)
        k = rms_norm(k, params["k_scale"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _out_proj(out, wo):
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.reshape(h * k, d)


# ---------------------------------------------------------------------------
# Plain attention (short sequences)
# ---------------------------------------------------------------------------

def plain_attention(q, k, v, *, causal: bool, window: Optional[int],
                    q_positions=None, k_positions=None) -> torch.Tensor:
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    q5 = q.reshape(B, S, K, G, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q5.float(), k.float()) * scale
    if causal or window is not None:
        pq = q_positions if q_positions is not None else torch.arange(S, device=q.device)
        pk = k_positions if k_positions is not None else torch.arange(T, device=q.device)
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
        if causal:
            mask &= pq[:, None] >= pk[None, :]
        if window is not None:
            mask &= pq[:, None] - pk[None, :] < window
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


# ---------------------------------------------------------------------------
# Full-sequence attention entry point (forward)
# ---------------------------------------------------------------------------

def attention(params, x, cfg: ModelConfig, *, positions=None, causal=True,
              window: Optional[int] = None, kv_x=None, rope=True) -> torch.Tensor:
    B, S, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    T = kv_x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    kv_positions = positions if kv_x is x else torch.arange(T, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, kv_x, cfg, positions, kv_positions, rope=rope)
    if cfg.use_pallas and S > 1024 and S % 512 == 0 and T % 512 == 0:
        from ..kernels import ops as kops

        out = kops.flash_attention(q, k, v, causal=causal, window=window)
    elif S <= 2048 or S % 512 or T % 512:
        out = plain_attention(q, k, v, causal=causal, window=window)
    else:
        raise NotImplementedError(
            f"attention at S={S} without kernels takes the reference's "
            "blocked_attention, which is not ported yet (ROADMAP.md, Queue 1: "
            "prefill / blocked_attention / MoE); run with use_pallas=True")
    return _out_proj(out, params["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor           # (B, C, K, hd)  C = cache capacity (seq_len or window)
    v: torch.Tensor
    pos: torch.Tensor         # (B,) next absolute position to write
    positions: torch.Tensor   # (B, C) absolute position stored in each slot (-1 empty)

    @property
    def capacity(self) -> int:
        return self.k.shape[1]


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device,
               n_kv: Optional[int] = None, head_dim: Optional[int] = None,
               dtype=None) -> KVCache:
    K = n_kv or cfg.n_kv_heads
    hd = head_dim or cfg.head_dim
    dt = dtype or cfg.torch_dtype
    return KVCache(
        k=torch.zeros((batch, capacity, K, hd), dtype=dt, device=device),
        v=torch.zeros((batch, capacity, K, hd), dtype=dt, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
        positions=torch.full((batch, capacity), -1, dtype=torch.int32, device=device),
    )


def decode_attention_step(params, x, cache: KVCache, cfg: ModelConfig,
                          window: Optional[int] = None) -> tuple:
    """One-token attention: x (B, 1, d) against the cache; returns (out, cache).

    Unlike the reference (a pure function), this writes the new key, value
    and position into the cache's tensors in place; the returned cache holds
    those tensors and ``pos + 1``."""
    B = x.shape[0]
    pos = cache.pos                                            # (B,)
    q, k_new, v_new = _project_qkv(params, x, x, cfg, pos[:, None], pos[:, None])
    C = cache.capacity
    slot = (pos % C).long()                                    # ring buffer slot
    bidx = torch.arange(B, device=x.device)
    k, v, positions = cache.k, cache.v, cache.positions
    k[bidx, slot] = k_new[:, 0].to(k.dtype)
    v[bidx, slot] = v_new[:, 0].to(v.dtype)
    positions[bidx, slot] = pos

    H, hd = q.shape[2], q.shape[3]
    K = k.shape[2]
    G = H // K
    if cfg.use_pallas:
        from ..kernels import ops as kops

        out = kops.decode_attention(q[:, 0], k, v, positions, pos, window=window)
        out = out[:, None]
    else:
        q5 = q.reshape(B, 1, K, G, hd)
        scores = torch.einsum("bskgh,btkh->bkgst", q5.float(), k.float()) / math.sqrt(hd)
        valid = (positions >= 0) & (positions <= pos[:, None])
        if window is not None:
            valid &= positions > pos[:, None] - window
        scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
        out = out.reshape(B, 1, H, hd)
    y = _out_proj(out, params["wo"].to(x.dtype))
    return y, KVCache(k=k, v=v, pos=pos + 1, positions=positions)
