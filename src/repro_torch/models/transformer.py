"""Decoder-only transformer LM, dense family (the port of the reference's
``models/transformer.py``).

Parameters are nested dicts of tensors in the reference's layout, the
per-layer weights stacked on a leading ``L`` axis; the layer loop is a
Python loop over that axis.  Matrices (every weight with two or more axes)
are held in the compute dtype, cast once at load (:func:`params_from_numpy`,
:func:`init_params`): the reference casts each float32 weight at every use,
and the cast is deterministic, so the numbers are the same while a decode
step reads 2 bytes per weight instead of 4 + 2.  Norm scales stay in the
parameter dtype, because the fused RMSNorm multiplies by them in float32.

Not ported yet: the MoE FFN, the VLM prefix, ``prefill`` and
``cache_from_prefill`` (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from .attention import KVCache, attention, decode_attention_step, init_attention
from .common import ModelConfig
from .layers import (cast_matrices, embed, init_embed, init_mlp, mlp, rms_norm,
                     tree_from_numpy, unembed)

__all__ = ["DecodeState", "block_forward", "check_family", "decode_step", "forward",
           "init_decode_state", "init_params", "params_from_numpy"]


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

def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters with the reference's distributions, drawn from
    ``gen`` on ``gen.device`` (one draw per stacked weight)."""
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
    return _cast_matrices(tree, cfg)


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The port's parameters from the reference's parameter tree given as
    nested dicts of numpy arrays (layer weights stacked on a leading ``L``
    axis), on ``device`` (``None`` means cuda)."""
    check_family(cfg)
    return _cast_matrices(tree_from_numpy(tree, cfg.torch_param_dtype, resolve_device(device)),
                          cfg)


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


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Returns (logits, aux_loss).  tokens: (B, S) on the parameters' device."""
    check_family(cfg)
    with torch.inference_mode():
        x = embed(params["embed"], tokens, cfg)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_layers):
            x, a = block_forward(_layer(params, i), x, cfg, positions)
            aux = aux + a
        x = rms_norm(x, params["ln_f"], cfg.norm_eps, cfg.use_pallas)
        return unembed(params["embed"], x, cfg), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    caches: KVCache      # stacked over layers: fields (L, B, C, K, hd)


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
