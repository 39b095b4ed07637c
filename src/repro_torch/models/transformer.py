"""Decoder-only transformer LM covering the dense, MoE and VLM families (the
port of the reference's ``models/transformer.py``).

One block structure; config switches select the GQA shape, qk-norm, QKV
bias, sliding-window attention, and the MoE FFN (:mod:`.moe`) in place of
the dense one.  The VLM family is the same LM reading a prefix of
precomputed patch embeddings before its text tokens (the vision frontend is
a stub, as in the reference); its logits are those of the text positions.

Parameters are nested dicts of tensors in the reference's layout, the
per-layer weights stacked on a leading ``L`` axis; the layer loop is a
Python loop over that axis.  For serving, matrices (every weight with two
or more axes) are held in the compute dtype, cast once at load
(:func:`params_from_numpy`, :func:`init_params`): the reference casts each
float32 weight at every use, and the cast is deterministic, so the numbers
are the same while a decode step reads 2 bytes per weight instead of 4 + 2.
Norm scales stay in the parameter dtype, because the fused RMSNorm
multiplies by them in float32, and so does the MoE router, which the
reference casts to float32 at each use.  For training (``master=True``)
every weight stays in the parameter dtype and is cast at each use, as in
the reference, so the optimizer updates float32 master weights.

:func:`forward`, :func:`prefill` and :func:`decode_step` run under
``torch.inference_mode``; :func:`train_forward` is the same forward with
autograd, each block checkpointed when ``cfg.remat == "block"`` (the
reference's ``jax.checkpoint``).  Prefill takes the RMSNorm kernel with
``use_pallas`` but, as in the reference, never flash attention: plain
attention up to S = 2048, blocked attention above.  Decode gives the MoE a
capacity factor of at least 8, as the reference does for its small batches.
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
from . import layers
from .layers import (cast_matrices, draw_stacked, embed, index_tree, init_embed, init_mlp, mlp,
                     rms_norm, unembed)
from .moe import KEEP_FLOAT32, init_moe, moe_ffn

__all__ = ["DecodeState", "block_forward", "check_family", "decode_step", "forward",
           "init_decode_state", "init_params", "params_from_numpy", "prefill",
           "train_forward"]


FAMILIES = ("dense", "moe", "vlm")


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family this module does not run (:func:`repro_torch.models.get_model`
    routes the others to their own modules)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} does not run on the transformer "
                         f"(it runs {', '.join(FAMILIES)})")


def _cast_matrices(tree, cfg: ModelConfig):
    return cast_matrices(tree, cfg.torch_dtype, {"layers": 1}, KEEP_FLOAT32)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ModelConfig, lead: tuple) -> dict:
    d, pdt, dev = cfg.d_model, cfg.torch_param_dtype, gen.device
    p = {
        "ln1": torch.ones(lead + (d,), dtype=pdt, device=dev),
        "attn": init_attention(gen, cfg, lead=lead),
        "ln2": torch.ones(lead + (d,), dtype=pdt, device=dev),
    }
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, cfg, lead=lead)
    else:
        p["mlp"] = init_mlp(gen, cfg, lead=lead)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, master: bool = False) -> dict:
    """Random parameters with the reference's distributions, drawn from
    ``gen`` on ``gen.device``.  The layers are drawn one at a time and each
    is cast before the next is drawn, so the transient in the parameter
    dtype is one layer's (internvl2-26b's 48 layers would take ~80 GB in
    float32 at once); with ``master`` nothing is cast (training)."""
    check_family(cfg)
    cast = (lambda tree: tree) if master else (lambda tree: _cast_matrices(tree, cfg))
    tree = cast({"embed": init_embed(gen, cfg),
                 "ln_f": torch.ones((cfg.d_model,), dtype=cfg.torch_param_dtype,
                                    device=gen.device)})
    tree["layers"] = draw_stacked(cfg.n_layers, lambda: _init_block(gen, cfg, (1,)),
                                  lambda layer: cast({"layers": layer})["layers"])
    return tree


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None,
                      master: bool = False) -> dict:
    """The port's parameters from the reference's parameter tree given as
    nested dicts of numpy arrays (layer weights stacked on a leading ``L``
    axis), on ``device`` (``None`` means cuda); with ``master`` the uncast
    tree in the parameter dtype (training)."""
    check_family(cfg)
    return layers.params_from_numpy(tree, cfg, _cast_matrices, device, master)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def block_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, positions) -> tuple:
    h = rms_norm(x, p["ln1"], cfg.norm_eps, cfg.use_pallas)
    h = attention(p["attn"], h, cfg, positions=positions, causal=True,
                  window=cfg.sliding_window)
    x = x + h
    h = rms_norm(x, p["ln2"], cfg.norm_eps, cfg.use_pallas)
    if cfg.family == "moe":
        h, aux = moe_ffn(p["moe"], h, cfg)
    else:
        h, aux = mlp(p["mlp"], h, cfg), torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, aux


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` checkpointed (its activations recomputed in the backward pass)
    where the reference checkpoints it; only while autograd records."""
    if cfg.remat == "block" and torch.is_grad_enabled():
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    return fn


def _embed_with_prefix(params, tokens, cfg, prefix_embeds):
    x = embed(params["embed"], tokens, cfg)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def train_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                  prefix_embeds: Optional[torch.Tensor] = None) -> tuple:
    """Returns (logits, aux_loss), differentiable in ``params``; aux sums
    the MoE layers' load-balance losses.  tokens: (B, S_text) on the
    parameters' device; prefix_embeds (VLM): (B, S_vis, d) prepended before
    the text tokens, the logits then those of the text positions."""
    check_family(cfg)
    x = _embed_with_prefix(params, tokens, cfg, prefix_embeds)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _maybe_remat(lambda lp, x: block_forward(lp, x, cfg, positions), cfg)
    for i in range(cfg.n_layers):
        x, a = block(index_tree(params["layers"], i), x)
        aux = aux + a
    x = rms_norm(x, params["ln_f"], cfg.norm_eps, cfg.use_pallas)
    logits = unembed(params["embed"], x, cfg)
    if prefix_embeds is not None:
        logits = logits[:, prefix_embeds.shape[1]:]
    return logits, aux


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds: Optional[torch.Tensor] = None) -> tuple:
    """:func:`train_forward` under ``torch.inference_mode``."""
    with torch.inference_mode():
        return train_forward(params, tokens, cfg, prefix_embeds)


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
    h = moe_ffn(p["moe"], h, cfg)[0] if cfg.family == "moe" else mlp(p["mlp"], h, cfg)
    return x + h, (k, v)


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
        x = _embed_with_prefix(params, tokens, cfg, prefix_embeds)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        caches = []
        for i in range(cfg.n_layers):
            x, (k, v) = _block_prefill(index_tree(params["layers"], i), x, cfg, positions)
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
    # Boost MoE capacity for tiny decode batches so routing rarely drops.
    dcfg = cfg.replace(capacity_factor=max(cfg.capacity_factor, 8.0)) \
        if cfg.family == "moe" else cfg
    with torch.inference_mode():
        x = embed(params["embed"], token, cfg)
        for i in range(cfg.n_layers):
            lp = index_tree(params["layers"], i)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            h, new = decode_attention_step(lp["attn"], h, KVCache(c.k[i], c.v[i], c.pos[i],
                                                                  c.positions[i]),
                                           cfg, window=cfg.sliding_window)
            c.pos[i] = new.pos
            x = x + h
            h = rms_norm(x, lp["ln2"], cfg.norm_eps)
            h = moe_ffn(lp["moe"], h, dcfg)[0] if cfg.family == "moe" else mlp(lp["mlp"], h, cfg)
            x = x + h
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return unembed(params["embed"], x, cfg), state
