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

Under an ambient mesh (:func:`repro_torch.launch.mesh.use_mesh`) the
forward, ``train_forward`` and prefill split the rows over the mesh's data
slots where their count divides the batch (else data slot 0 takes them
all), and run the layers one at a time over the slots, each slot on its
device (:func:`train_forward_slots`): the RMSNorm kernel and flash
attention per slot where the reference takes them, blocked attention
sequence-parallel over the slot's ``model`` slots where the head count does
not divide that axis, and the MoE per data slot (:func:`.moe.moe_ffn_slots`).
The outputs (and prefill's caches) are gathered back onto the tokens'
device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..launch import collectives
from ..launch.mesh import data_slot_scope
from .attention import (KVCache, _out_proj, _project_qkv, attention, blocked_attention,
                        cache_from_prefill, decode_attention_step, init_attention,
                        plain_attention)
from .common import ModelConfig, abstract_mesh
from . import layers
from .layers import (cast_matrices, draw_stacked, embed, index_tree, init_embed, init_mlp, mlp,
                     rms_norm, unembed)
from .moe import KEEP_FLOAT32, init_moe, moe_ffn, moe_ffn_slots

__all__ = ["DecodeState", "block_forward", "check_family", "decode_step", "forward",
           "init_decode_state", "init_params", "params_from_numpy", "prefill",
           "train_forward", "train_forward_slots"]


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

def _attend(p: dict, x: torch.Tensor, cfg: ModelConfig, positions) -> torch.Tensor:
    """A block's first half: x plus its attention."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps, cfg.use_pallas)
    h = attention(p["attn"], h, cfg, positions=positions, causal=True,
                  window=cfg.sliding_window)
    return x + h


def block_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, positions) -> tuple:
    x = _attend(p, x, cfg, positions)
    h = rms_norm(x, p["ln2"], cfg.norm_eps, cfg.use_pallas)
    if cfg.family == "moe":
        h, aux = moe_ffn(p["moe"], h, cfg)
    else:
        h, aux = mlp(p["mlp"], h, cfg), torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, aux


def _slots_block(lps: list, xs: list, cfg: ModelConfig, positions: list,
                 prefill: bool = False) -> tuple:
    """One layer over the data slots' rows (``xs[j]`` with its parameters
    ``lps[j]`` on slot ``j``'s device): each slot's attention half, then the
    FFN (the MoE across the slots).  Returns (the slots' outputs, the aux
    loss, each slot's (k, v) when ``prefill``)."""
    xs2, hs, kvs = [], [], []
    for j, (p, x) in enumerate(zip(lps, xs)):
        with data_slot_scope(j):
            if prefill:
                x, kv = _attend_prefill(p, x, cfg, positions[j])
                kvs.append(kv)
            else:
                x = _attend(p, x, cfg, positions[j])
        xs2.append(x)
        hs.append(rms_norm(x, p["ln2"], cfg.norm_eps, cfg.use_pallas))
    if cfg.family == "moe":
        ys, aux = moe_ffn_slots([p["moe"] for p in lps], hs, cfg)
    else:
        ys = [mlp(p["mlp"], h, cfg) for p, h in zip(lps, hs)]
        aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    return [x + y for x, y in zip(xs2, ys)], aux, kvs


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


def _slots_forward(params_slots: list, tokens_slots: list, cfg: ModelConfig,
                   prefix_slots=None, prefill: bool = False) -> tuple:
    """The layers over the data slots' rows: (each slot's final hidden
    state, the aux loss on the first slot's device, per layer each slot's
    (k, v) when ``prefill``)."""
    prefix_slots = prefix_slots or [None] * len(tokens_slots)
    xs = [_embed_with_prefix(p, t, cfg, pe)
          for p, t, pe in zip(params_slots, tokens_slots, prefix_slots)]
    positions = [torch.arange(x.shape[1], device=x.device)[None, :] for x in xs]
    aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    block = _maybe_remat(lambda lps, xs: _slots_block(lps, xs, cfg, positions, prefill), cfg)
    kvs = []
    for i in range(cfg.n_layers):
        xs, a, kv = block([index_tree(p["layers"], i) for p in params_slots], xs)
        kvs.append(kv)
        aux = aux + a
    return [rms_norm(x, p["ln_f"], cfg.norm_eps, cfg.use_pallas)
            for p, x in zip(params_slots, xs)], aux, kvs


def train_forward_slots(params_slots: list, tokens_slots: list, cfg: ModelConfig,
                        prefix_slots=None) -> tuple:
    """:func:`train_forward` over rows held per data slot of the ambient
    mesh: ``tokens_slots[j]`` on slot ``j``'s device with its parameter tree
    ``params_slots[j]`` (the mesh train step gives each slot its own copy).
    Returns (each slot's logits, the aux loss on the first slot's device)."""
    check_family(cfg)
    hs, aux, _ = _slots_forward(params_slots, tokens_slots, cfg, prefix_slots)
    logits = [unembed(p["embed"], h, cfg) for p, h in zip(params_slots, hs)]
    if prefix_slots is not None:
        logits = [lg[:, pe.shape[1]:] for lg, pe in zip(logits, prefix_slots)]
    return logits, aux


def _mesh_train_forward(params, tokens, cfg, prefix_embeds) -> tuple:
    devices = abstract_mesh().row_devices(tokens.shape[0])
    prefix = None if prefix_embeds is None else collectives.scatter(prefix_embeds, 0, devices)
    logits, aux = train_forward_slots(collectives.broadcast_tree(params, devices),
                                      collectives.scatter(tokens, 0, devices), cfg, prefix)
    return collectives.gather_to(logits, 0, tokens.device), aux.to(tokens.device)


def train_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                  prefix_embeds: Optional[torch.Tensor] = None) -> tuple:
    """Returns (logits, aux_loss), differentiable in ``params``; aux sums
    the MoE layers' load-balance losses.  tokens: (B, S_text) on the
    parameters' device; prefix_embeds (VLM): (B, S_vis, d) prepended before
    the text tokens, the logits then those of the text positions.  Under an
    ambient mesh the rows split over its data slots
    (:func:`train_forward_slots`)."""
    check_family(cfg)
    if abstract_mesh() is not None:
        return _mesh_train_forward(params, tokens, cfg, prefix_embeds)
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


def _attend_prefill(p, x, cfg: ModelConfig, positions) -> tuple:
    """A block's first half in prefill: (x plus its attention, (k, v))."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps, cfg.use_pallas)
    S = h.shape[1]
    q, k, v = _project_qkv(p["attn"], h, h, cfg, positions, positions)
    if S <= 2048 or S % 512:
        out = plain_attention(q, k, v, causal=True, window=cfg.sliding_window)
    else:
        out = blocked_attention(q, k, v, causal=True, window=cfg.sliding_window)
    return x + _out_proj(out, p["attn"]["wo"].to(h.dtype)), (k, v)


def _block_prefill(p, x, cfg: ModelConfig, positions):
    """Like block_forward but also returns this layer's (k, v) for the cache."""
    x, (k, v) = _attend_prefill(p, x, cfg, positions)
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
    if abstract_mesh() is not None:
        return _mesh_prefill(params, tokens, cfg, prefix_embeds)
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


def _mesh_prefill(params, tokens, cfg: ModelConfig, prefix_embeds) -> tuple:
    """:func:`prefill` with the rows split over the ambient mesh's data
    slots; the last logits and the caches gathered onto the tokens'
    device."""
    with torch.inference_mode():
        devices = abstract_mesh().row_devices(tokens.shape[0])
        prefix = None if prefix_embeds is None else collectives.scatter(prefix_embeds, 0, devices)
        params_slots = collectives.broadcast_tree(params, devices)
        hs, _, kvs = _slots_forward(params_slots, collectives.scatter(tokens, 0, devices), cfg,
                                    prefix, prefill=True)
        logits = [unembed(p["embed"], h[:, -1:], cfg) for p, h in zip(params_slots, hs)]
        caches = [cache_from_prefill(cfg, collectives.gather_to([kv[0] for kv in layer], 0,
                                                                tokens.device),
                                     collectives.gather_to([kv[1] for kv in layer], 0,
                                                           tokens.device), cfg.sliding_window)
                  for layer in kvs]
        return (collectives.gather_to(logits, 0, tokens.device),
                DecodeState(KVCache(*(torch.stack(f) for f in zip(*caches)))))


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
