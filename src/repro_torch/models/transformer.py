"""Decoder-only transformer LM, dense family (the port of the reference's
``models/transformer.py``).

Parameters are nested dicts of tensors in the reference's layout, the
per-layer weights stacked on a leading ``L`` axis; the layer loop is a
Python loop over that axis.  For serving, matrices (every weight with two
or more axes) are held in the compute dtype, cast once at load
(:func:`params_from_numpy`, :func:`init_params`): the reference casts each
float32 weight at every use, and the cast is deterministic, so the numbers
are the same while a decode step reads 2 bytes per weight instead of 4 + 2.
Norm scales stay in the parameter dtype, because the fused RMSNorm
multiplies by them in float32.  For training (``master=True``) every weight
stays in the parameter dtype and is cast at each use, as in the reference,
so the optimizer updates float32 master weights.

:func:`forward`, :func:`prefill` and :func:`decode_step` run under
``torch.inference_mode``; :func:`train_forward` is the same forward with
autograd, each block checkpointed when ``cfg.remat == "block"`` (the
reference's ``jax.checkpoint``).  Prefill takes the RMSNorm kernel with
``use_pallas`` but, as in the reference, never flash attention: plain
attention up to S = 2048, blocked attention above.

Not ported yet: the MoE FFN and the VLM routing (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from .attention import (KVCache, _out_proj, _project_qkv, attention, blocked_attention,
                        cache_from_prefill, decode_attention_step, init_attention,
                        plain_attention)
from .common import ModelConfig
from .layers import (cast_matrices, embed, init_embed, init_mlp, mlp, rms_norm,
                     tree_from_numpy, unembed)

__all__ = ["DecodeState", "block_forward", "check_family", "decode_step", "forward",
           "init_decode_state", "init_params", "params_from_numpy", "prefill",
           "train_forward"]


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family this module does not run (all but ``dense``;
    :func:`repro_torch.models.get_model` routes the other ported ones)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} does not run on the dense transformer; see ROADMAP.md Queue 1")


def _cast_matrices(tree, cfg: ModelConfig):
    return cast_matrices(tree, cfg.torch_dtype, {"layers": 1})


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig, master: bool = False) -> dict:
    """Random parameters with the reference's distributions, drawn from
    ``gen`` on ``gen.device`` (one draw per stacked weight); with ``master``
    every weight stays in the parameter dtype (training)."""
    check_family(cfg)
    L, d, pdt, dev = cfg.n_layers, cfg.d_model, cfg.torch_param_dtype, gen.device
    tree = {
        "embed": init_embed(gen, cfg),
        "layers": {
            "ln1": torch.ones((L, d), dtype=pdt, device=dev),
            "attn": init_attention(gen, cfg, lead=(L,)),
            "ln2": torch.ones((L, d), dtype=pdt, device=dev),
            "mlp": init_mlp(gen, cfg, lead=(L,)),
        },
        "ln_f": torch.ones((d,), dtype=pdt, device=dev),
    }
    return tree if master else _cast_matrices(tree, cfg)


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None,
                      master: bool = False) -> dict:
    """The port's parameters from the reference's parameter tree given as
    nested dicts of numpy arrays (layer weights stacked on a leading ``L``
    axis), on ``device`` (``None`` means cuda); with ``master`` the uncast
    tree in the parameter dtype (training)."""
    check_family(cfg)
    tree = tree_from_numpy(tree, cfg.torch_param_dtype, resolve_device(device))
    return tree if master else _cast_matrices(tree, cfg)


def _layer(params: dict, i: int) -> dict:
    def walk(node):
        return {k: walk(v) for k, v in node.items()} if isinstance(node, dict) else node[i]
    return walk(params["layers"])


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def block_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, positions) -> tuple:
    h = rms_norm(x, p["ln1"], cfg.norm_eps, cfg.use_pallas)
    h = attention(p["attn"], h, cfg, positions=positions, causal=True,
                  window=cfg.sliding_window)
    x = x + h
    h = rms_norm(x, p["ln2"], cfg.norm_eps, cfg.use_pallas)
    x = x + mlp(p["mlp"], h, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` checkpointed (its activations recomputed in the backward pass)
    where the reference checkpoints it; only while autograd records."""
    if cfg.remat == "block" and torch.is_grad_enabled():
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    return fn


def train_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Returns (logits, aux_loss), differentiable in ``params``.  tokens:
    (B, S) on the parameters' device."""
    check_family(cfg)
    x = embed(params["embed"], tokens, cfg)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _maybe_remat(lambda lp, x: block_forward(lp, x, cfg, positions), cfg)
    for i in range(cfg.n_layers):
        x, a = block(_layer(params, i), x)
        aux = aux + a
    x = rms_norm(x, params["ln_f"], cfg.norm_eps, cfg.use_pallas)
    return unembed(params["embed"], x, cfg), aux


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Returns (logits, aux_loss), under ``torch.inference_mode``.  tokens:
    (B, S) on the parameters' device."""
    with torch.inference_mode():
        return train_forward(params, tokens, cfg)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    caches: KVCache      # stacked over layers: fields (L, B, C, K, hd)


def _block_prefill(p, x, cfg: ModelConfig, positions):
    """Like block_forward but also returns this layer's (k, v) for the cache."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps, cfg.use_pallas)
    S = h.shape[1]
    q, k, v = _project_qkv(p["attn"], h, h, cfg, positions, positions)
    if S <= 2048 or S % 512:
        out = plain_attention(q, k, v, causal=True, window=cfg.sliding_window)
    else:
        out = blocked_attention(q, k, v, causal=True, window=cfg.sliding_window)
    x = x + _out_proj(out, p["attn"]["wo"].to(h.dtype))
    h = rms_norm(x, p["ln2"], cfg.norm_eps, cfg.use_pallas)
    return x + mlp(p["mlp"], h, cfg), (k, v)


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds: Optional[torch.Tensor] = None) -> tuple:
    """Forward pass that also builds the per-layer KV caches.  Returns
    (last_logits (B, 1, V), DecodeState), the state's caches stacked over
    layers in contiguous tensors that :func:`decode_step` writes in place.
    ``prefix_embeds`` (B, S_vis, d) are prepended before the text tokens.

    As in the reference, the cache capacity is the prompt length (or the
    window), so the first decode step after a prefill without a window
    writes ring slot ``S % S = 0`` and evicts position 0."""
    check_family(cfg)
    with torch.inference_mode():
        x = embed(params["embed"], tokens, cfg)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        caches = []
        for i in range(cfg.n_layers):
            x, (k, v) = _block_prefill(_layer(params, i), x, cfg, positions)
            caches.append(cache_from_prefill(cfg, k, v, cfg.sliding_window))
        x = rms_norm(x, params["ln_f"], cfg.norm_eps, cfg.use_pallas)
        logits = unembed(params["embed"], x[:, -1:], cfg)
        return logits, DecodeState(KVCache(*(torch.stack(f) for f in zip(*caches))))


def init_decode_state(cfg: ModelConfig, batch: int, capacity: int,
                      device=None) -> DecodeState:
    """Fresh decode state with given cache capacity (= seq_len, or window for SWA)."""
    dev = resolve_device(device)
    cap = min(capacity, cfg.sliding_window) if cfg.sliding_window else capacity
    L = cfg.n_layers
    shape = (L, batch, cap, cfg.n_kv_heads, cfg.head_dim)
    return DecodeState(KVCache(
        k=torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
        v=torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
        pos=torch.zeros((L, batch), dtype=torch.int32, device=dev),
        positions=torch.full((L, batch, cap), -1, dtype=torch.int32, device=dev),
    ))


def decode_step(params: dict, state: DecodeState, token: torch.Tensor,
                cfg: ModelConfig) -> tuple:
    """One decoding step: token (B, 1) -> (logits (B,1,V), state).  The
    caches are updated in place; the returned state holds the same tensors."""
    check_family(cfg)
    c = state.caches
    with torch.inference_mode():
        x = embed(params["embed"], token, cfg)
        for i in range(cfg.n_layers):
            lp = _layer(params, i)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            h, new = decode_attention_step(lp["attn"], h, KVCache(c.k[i], c.v[i], c.pos[i],
                                                                  c.positions[i]),
                                           cfg, window=cfg.sliding_window)
            c.pos[i] = new.pos
            x = x + h
            h = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + mlp(lp["mlp"], h, cfg)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return unembed(params["embed"], x, cfg), state
