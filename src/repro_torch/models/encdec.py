"""Whisper-style encoder-decoder backbone (the port of the reference's
``models/encdec.py``).  The conv/audio frontend is a stub, as in the
reference: the forward reads precomputed frame embeddings (B, enc_seq,
d_model).

Encoder: bidirectional self-attention blocks over the frames.  Decoder:
causal self-attention, cross-attention to the encoder output, GELU MLP.
LayerNorm with bias (:func:`.layers.layer_norm`) and GELU, as Whisper; the
self-attention takes rotary positions, as the reference does (not Whisper's
learned positions), and the cross-attention none.

Parameters are nested dicts of tensors in the reference's layout, the
encoder's and the decoder's blocks each stacked on a leading axis; matrices
are cast to the compute dtype once at load for serving, or kept in the
parameter dtype for training (``master=True``), as in
:mod:`.transformer`.  No RMSNorm here, and neither attention reaches the
flash kernel: the encoder's 1,500 frames are no whole number of 512-blocks
and the decoder's 448 positions are too few (``attention``'s gate, as the
reference's).  Decode takes the decode-attention kernel for the
self-attention and plain attention over the state's static cross K/V.

The reference's decode state starts with zero cross K/V and its serving
loop never runs :func:`encode`, so a served request attends to zeros; the
port mirrors that.  :func:`precompute_cross` gives a state's cross K/V from
an encoder output.

Under an ambient mesh (:func:`repro_torch.launch.mesh.use_mesh`) the forward
and ``train_forward`` split the rows (and frames) over the mesh's data slots
and each data slot's model slots compute tensor-parallel from their own
blocks (:func:`train_forward_slots`): every attention through
:func:`.attention.attention_row` (model slot 0 whole where the heads do not
divide the axis: whisper's 20 on 16 or 8), the MLP through
:func:`.layers.mlp_row`, the embedding and unembedding through
:func:`.layers.embed_row` / :func:`.layers.unembed_row`.  Decode under a
mesh runs over the grid too (:func:`decode_slots`): the self-attention
against the self cache's blocks (:func:`.attention.decode_attention_row`),
the cross attention against the static cross K/V's
(:func:`.attention.cross_attention_row`), each left where ``state_specs``
puts it; LayerNorm on each model slot's copy of the rows.
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import torch

from .. import resolve_device
from ..launch import collectives
from . import attention as attn
from .attention import (KVCache, _out_proj, _proj, attention, attention_row,
                        decode_attention_step, heads_parallel, init_attention, plain_attention)
from .common import ModelConfig, abstract_mesh
from . import layers, sharding, transformer
from .layers import (cast_matrices, draw_stacked, embed, index_tree, init_embed, init_mlp,
                     layer_norm, mlp, unembed)
from .transformer import _maybe_remat, slot_views

__all__ = ["EncDecState", "decode_independent", "decode_slots", "decode_step", "encode",
           "forward", "init_decode_state", "init_params", "params_from_numpy", "precompute_cross",
           "slot_views", "train_forward", "train_forward_slots"]

_STACKED_AXES = {"enc": 1, "dec": 1}


def _cast_matrices(tree, cfg: ModelConfig):
    return cast_matrices(tree, cfg.torch_dtype, _STACKED_AXES)


def _init_ln(d, pdt, dev, lead=()):
    return {"scale": torch.ones(lead + (d,), dtype=pdt, device=dev),
            "bias": torch.zeros(lead + (d,), dtype=pdt, device=dev)}


def _ln(x, p, cfg):
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _init_enc_block(gen, cfg: ModelConfig, lead: tuple) -> dict:
    d, pdt, dev = cfg.d_model, cfg.torch_param_dtype, gen.device
    return {
        "ln1": _init_ln(d, pdt, dev, lead),
        "attn": init_attention(gen, cfg, lead=lead),
        "ln2": _init_ln(d, pdt, dev, lead),
        "mlp": init_mlp(gen, cfg, lead=lead),
    }


def _init_dec_block(gen, cfg: ModelConfig, lead: tuple) -> dict:
    d, pdt, dev = cfg.d_model, cfg.torch_param_dtype, gen.device
    return {
        "ln1": _init_ln(d, pdt, dev, lead),
        "self_attn": init_attention(gen, cfg, lead=lead),
        "ln2": _init_ln(d, pdt, dev, lead),
        "cross_attn": init_attention(gen, cfg, lead=lead),
        "ln3": _init_ln(d, pdt, dev, lead),
        "mlp": init_mlp(gen, cfg, lead=lead),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig, master: bool = False) -> dict:
    """Random parameters with the reference's distributions, drawn from
    ``gen`` on ``gen.device``, one block at a time, each cast before the
    next is drawn; with ``master`` nothing is cast (training)."""
    cast = (lambda tree: tree) if master else (lambda tree: _cast_matrices(tree, cfg))
    d, pdt, dev = cfg.d_model, cfg.torch_param_dtype, gen.device
    tree = cast({"embed": init_embed(gen, cfg), "ln_enc": _init_ln(d, pdt, dev),
                 "ln_f": _init_ln(d, pdt, dev)})
    for name, n, block in (("enc", cfg.n_enc_layers, _init_enc_block),
                           ("dec", cfg.n_layers, _init_dec_block)):
        tree[name] = draw_stacked(n, lambda: block(gen, cfg, (1,)),
                                  lambda one: cast({name: one})[name])
    return tree


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None,
                      master: bool = False) -> dict:
    """:func:`layers.params_from_numpy` with this family's cast."""
    return layers.params_from_numpy(tree, cfg, _cast_matrices, device, master)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _enc_block(lp, x, cfg, positions):
    h = _ln(x, lp["ln1"], cfg)
    x = x + attention(lp["attn"], h, cfg, positions=positions, causal=False)
    h = _ln(x, lp["ln2"], cfg)
    return x + mlp(lp["mlp"], h, cfg)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, enc_seq, d) stub embeddings -> encoder output."""
    x = frames.to(cfg.torch_dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    block = _maybe_remat(lambda lp, x: _enc_block(lp, x, cfg, positions), cfg)
    for i in range(cfg.n_enc_layers):
        x = block(index_tree(params["enc"], i), x)
    return _ln(x, params["ln_enc"], cfg)


def _dec_block(lp, x, enc_out, cfg, positions):
    h = _ln(x, lp["ln1"], cfg)
    x = x + attention(lp["self_attn"], h, cfg, positions=positions, causal=True)
    h = _ln(x, lp["ln2"], cfg)
    x = x + attention(lp["cross_attn"], h, cfg, positions=positions, causal=False,
                      kv_x=enc_out, rope=False)
    h = _ln(x, lp["ln3"], cfg)
    return x + mlp(lp["mlp"], h, cfg)


def _enc_block_row(lrows: list, ldims: dict, xs: list, cfg, positions: list, devs: list) -> list:
    """One encoder block over the grid (``xs[jj][m]`` model slot ``m``'s
    copy of computing data slot ``jj``'s rows, ``lrows[jj][m]`` its block
    of the layer's weights)."""
    out = []
    for row, x, pos, dv in zip(lrows, xs, positions, devs):
        own = heads_parallel(cfg, len(dv))
        h = [_ln(a, p["ln1"], cfg) if own or m == 0 else None
             for m, (p, a) in enumerate(zip(row, x))]
        att, _, _ = attention_row([p["attn"] for p in row], ldims["attn"], h, cfg, pos, dv,
                                  causal=False)
        x = [a + b for a, b in zip(x, att)]
        h = [_ln(a, p["ln2"], cfg) for p, a in zip(row, x)]
        out.append([a + b for a, b in zip(x, layers.mlp_row([p["mlp"] for p in row],
                                                             ldims["mlp"], h, cfg, dv))])
    return out


def _dec_block_row(lrows: list, ldims: dict, xs: list, encs: list, cfg, positions: list,
                   devs: list) -> list:
    """One decoder block over the grid; ``encs[jj][m]`` model slot ``m``'s
    copy of the encoder output of data slot ``jj``'s rows."""
    out = []
    for row, x, enc, pos, dv in zip(lrows, xs, encs, positions, devs):
        own = heads_parallel(cfg, len(dv))
        h = [_ln(a, p["ln1"], cfg) if own or m == 0 else None
             for m, (p, a) in enumerate(zip(row, x))]
        att, _, _ = attention_row([p["self_attn"] for p in row], ldims["self_attn"], h, cfg, pos,
                                  dv)
        x = [a + b for a, b in zip(x, att)]
        h = [_ln(a, p["ln2"], cfg) if own or m == 0 else None
             for m, (p, a) in enumerate(zip(row, x))]
        att, _, _ = attention_row([p["cross_attn"] for p in row], ldims["cross_attn"], h, cfg,
                                  pos, dv, causal=False, kv_hs=enc, rope=False)
        x = [a + b for a, b in zip(x, att)]
        h = [_ln(a, p["ln3"], cfg) for p, a in zip(row, x)]
        out.append([a + b for a, b in zip(x, layers.mlp_row([p["mlp"] for p in row],
                                                             ldims["mlp"], h, cfg, dv))])
    return out


def train_forward_slots(views, tokens_slots: list, cfg: ModelConfig, frames=None,
                        n_data: Optional[int] = None) -> tuple:
    """:func:`train_forward` over the ambient mesh's grid (``views`` the
    weights' :class:`.sharding.SlotViews`, ``tokens_slots[jj]`` and
    ``frames[jj]`` computing data slot ``views.data_slots[jj]``'s rows on
    its device): the frames are rows of each data slot, every model slot
    holding its copy; LayerNorm is local; each attention (the encoder's
    bidirectional, the decoder's causal and its cross-attention over the
    encoder rows) runs through :func:`.attention.attention_row`, the GELU
    MLP through :func:`.layers.mlp_row`, the embedding and the unembedding
    through :func:`.layers.embed_row` / :func:`.layers.unembed_row`; each
    block checkpointed under ``remat == "block"``.  Returns (each data
    slot's :class:`.layers.SlotLogits`, each data slot's aux loss, zero)."""
    mesh = abstract_mesh()
    D = len(views.data_slots)
    devs = [mesh.model_devices(j) for j in views.data_slots]
    xs = [collectives.broadcast(f.to(cfg.torch_dtype), dv) if len(dv) > 1
          else [f.to(cfg.torch_dtype)] for f, dv in zip(frames, devs)]
    enc_pos = [torch.arange(row[0].shape[1], device=row[0].device)[None, :] for row in xs]
    edims = views.layer_dims("enc")
    block = _maybe_remat(lambda lrows, xs: _enc_block_row(lrows, edims, xs, cfg, enc_pos, devs),
                         cfg)
    for i in range(cfg.n_enc_layers):
        xs = block([views.layer(jj, i, cfg.n_enc_layers, "enc") for jj in range(D)], xs)
    encs = [[_ln(a, p["ln_enc"], cfg) for p, a in zip(views.rows[jj], xs[jj])] for jj in range(D)]
    xs = [layers.embed_row(views.rows[jj], views.dims, t, cfg, devs[jj])
          for jj, t in enumerate(tokens_slots)]
    dec_pos = [torch.arange(row[0].shape[1], device=row[0].device)[None, :] for row in xs]
    ddims = views.layer_dims("dec")
    block = _maybe_remat(lambda lrows, xs, encs: _dec_block_row(lrows, ddims, xs, encs, cfg,
                                                                dec_pos, devs), cfg)
    for i in range(cfg.n_layers):
        xs = block([views.layer(jj, i, cfg.n_layers, "dec") for jj in range(D)], xs, encs)
    logits = [layers.unembed_row(views.rows[jj], views.dims,
                                 [_ln(a, p["ln_f"], cfg) for p, a in zip(views.rows[jj], xs[jj])],
                                 cfg, devs[jj]) for jj in range(D)]
    return logits, [torch.zeros((), dtype=torch.float32, device=row[0].device) for row in xs]


def train_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                  frames: torch.Tensor = None) -> tuple:
    """Returns (logits, aux_loss = 0), differentiable in ``params``.
    tokens: (B, S) decoder tokens; frames: (B, enc_seq, d) stub embeddings.
    Under an ambient mesh the rows split over its data slots, each
    tensor-parallel over its model slots (:func:`train_forward_slots`)."""
    if abstract_mesh() is not None:
        return transformer.mesh_train_forward(sys.modules[__name__], params, tokens, cfg,
                                              frames=frames)
    enc_out = encode(params, frames, cfg)
    x = embed(params["embed"], tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    block = _maybe_remat(lambda lp, x, enc_out: _dec_block(lp, x, enc_out, cfg, positions),
                         cfg)
    for i in range(cfg.n_layers):
        x = block(index_tree(params["dec"], i), x, enc_out)
    x = _ln(x, params["ln_f"], cfg)
    return (unembed(params["embed"], x, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            frames: torch.Tensor = None) -> tuple:
    """:func:`train_forward` under ``torch.inference_mode``."""
    with torch.inference_mode():
        return train_forward(params, tokens, cfg, frames)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class EncDecState(NamedTuple):
    self_caches: KVCache     # (L, B, C, K, hd)
    cross_k: torch.Tensor    # (L, B, T, K, hd): static after encode
    cross_v: torch.Tensor


def init_decode_state(cfg: ModelConfig, batch: int, capacity: int,
                      device=None) -> EncDecState:
    """Fresh decode state on ``device`` (``None`` means cuda): empty self
    caches and zero cross K/V, as the reference's."""
    dev = resolve_device(device)
    L, K, hd, dt = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.torch_dtype
    kv = (L, batch, capacity, K, hd)
    cross = (L, batch, cfg.enc_seq, K, hd)
    return EncDecState(
        self_caches=KVCache(
            k=torch.zeros(kv, dtype=dt, device=dev),
            v=torch.zeros(kv, dtype=dt, device=dev),
            pos=torch.zeros((L, batch), dtype=torch.int32, device=dev),
            positions=torch.full((L, batch, capacity), -1, dtype=torch.int32, device=dev),
        ),
        cross_k=torch.zeros(cross, dtype=dt, device=dev),
        cross_v=torch.zeros(cross, dtype=dt, device=dev),
    )


def precompute_cross(params: dict, enc_out: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Per-layer cross K/V (L, B, T, K, hd) from the encoder output."""
    with torch.inference_mode():
        dt = enc_out.dtype
        ks, vs = [], []
        for i in range(cfg.n_layers):
            ca = params["dec"]["cross_attn"]
            ks.append(_proj(enc_out, ca["wk"][i].to(dt)))
            vs.append(_proj(enc_out, ca["wv"][i].to(dt)))
        return torch.stack(ks), torch.stack(vs)


def _cross_blocks(state: EncDecState, cfg: ModelConfig, mesh, rows: int):
    return sharding.StateBlocks({"cross_k": state.cross_k, "cross_v": state.cross_v}, cfg, mesh,
                                rows)


def decode_independent(cfg: ModelConfig, state: EncDecState, rows: int) -> bool:
    """Whether, under the ambient mesh, each data slot's part of a decode
    step over ``rows`` rows depends on no other data slot's: the rows split
    over every data slot and every cache's data split on its batch dim (not
    its length)."""
    mesh = abstract_mesh()
    if len(mesh.row_devices(rows)) == 1:
        return False
    kv = sharding.StateBlocks(state.self_caches, cfg, mesh, rows)
    return kv.data_dims() == {"k": 1, "v": 1, "pos": 1, "positions": 1} and \
        _cross_blocks(state, cfg, mesh, rows).data_dims() == {"cross_k": 1, "cross_v": 1}


def decode_slots(views, state: EncDecState, tokens_slots: list, cfg: ModelConfig,
                 n_data: Optional[int] = None) -> list:
    """:func:`decode_step` over the ambient mesh's grid (``views`` the
    weights' :class:`.sharding.SlotViews`, ``tokens_slots[jj]`` the rows of
    computing data slot ``views.data_slots[jj]``, with ``n_data`` data slots
    taking rows in all), ``state`` placed by ``state_specs`` or whole.  Per
    layer each model slot applies LayerNorm to its copy of the rows, in the
    reference's rounding; the self-attention reads and writes the self
    cache's blocks in place (:func:`.attention.decode_attention_row`: whole
    heads with the decode kernel, or the head-dim columns), ``pos``
    advances in every block that holds it, the cross attention reads the
    static cross K/V's blocks where they lie
    (:func:`.attention.cross_attention_row`: by heads or head-dim columns,
    frames split over the data slots merged by log-sum-exp), and the MLP
    runs as in the forward.  Returns each data slot's
    :class:`.layers.SlotLogits`."""
    mesh = abstract_mesh()
    data_slots = views.data_slots
    n_data = n_data or len(data_slots)
    b = tokens_slots[0].shape[0]
    kv = sharding.StateBlocks(state.self_caches, cfg, mesh, b * n_data)
    xb = _cross_blocks(state, cfg, mesh, b * n_data)
    M = views.msize
    layout, clayout = attn.decode_layout(kv, M), attn.decode_layout(xb, M, "cross_k")
    cols, ccols = attn.decode_cols(kv, mesh, layout), attn.decode_cols(xb, mesh, clayout,
                                                                       "cross_k")
    rows = [slice(j * b, (j + 1) * b) if n_data > 1 else slice(0, b) for j in data_slots]
    devs = [mesh.model_devices(j) for j in data_slots]
    xs = [layers.embed_row(views.rows[jj], views.dims, t, cfg, dv)
          for jj, (t, dv) in enumerate(zip(tokens_slots, devs))]
    ldims = views.layer_dims("dec")
    L = cfg.n_layers
    for i in range(L):
        for jj, j in enumerate(data_slots):
            row = views.layer(jj, i, L, "dec")
            h = [_ln(x, p["ln1"], cfg) for p, x in zip(row, xs[jj])]
            out = attn.decode_attention_layer(kv, mesh, i, rows[jj], j,
                                              [p["self_attn"] for p in row], ldims["self_attn"],
                                              h, cfg, devs[jj], layout, cols)
            x = [a + o for a, o in zip(xs[jj], out)]
            h = [_ln(a, p["ln2"], cfg) for p, a in zip(row, x)]
            cross = attn.decode_cache_slices(xb, mesh, i, rows[jj], j,
                                             ("cross_k", "cross_v", None))
            out = attn.cross_attention_row([p["cross_attn"] for p in row], ldims["cross_attn"],
                                           h, cfg, j, devs[jj], cross, clayout, ccols)
            x = [a + o for a, o in zip(x, out)]
            h = [_ln(a, p["ln3"], cfg) for p, a in zip(row, x)]
            y = layers.mlp_row([p["mlp"] for p in row], ldims["mlp"], h, cfg, devs[jj])
            xs[jj] = [a + o for a, o in zip(x, y)]
    return [layers.unembed_row(views.rows[jj], views.dims,
                               [_ln(a, p["ln_f"], cfg) for p, a in zip(views.rows[jj], xs[jj])],
                               cfg, devs[jj])
            for jj in range(len(data_slots))]


def decode_step(params: dict, state: EncDecState, token: torch.Tensor,
                cfg: ModelConfig) -> tuple:
    """One decoding step: token (B, 1) -> (logits (B,1,V), state).  The self
    caches are updated in place; the returned state holds the same tensors.
    Under an ambient mesh the step runs over its grid (:func:`decode_slots`),
    ``params`` placed or whole, ``state`` placed by ``state_specs`` or whole."""
    if abstract_mesh() is not None:
        return transformer.mesh_decode(sys.modules[__name__], params, state, token, cfg)
    c = state.self_caches
    with torch.inference_mode():
        x = embed(params["embed"], token, cfg)
        for i in range(cfg.n_layers):
            lp = index_tree(params["dec"], i)
            h = _ln(x, lp["ln1"], cfg)
            h, new = decode_attention_step(lp["self_attn"], h,
                                           KVCache(c.k[i], c.v[i], c.pos[i], c.positions[i]),
                                           cfg)
            c.pos[i] = new.pos
            x = x + h
            h = _ln(x, lp["ln2"], cfg)
            # cross attention against the static K/V
            ca = lp["cross_attn"]
            q = _proj(h, ca["wq"].to(h.dtype))
            out = plain_attention(q, state.cross_k[i], state.cross_v[i], causal=False,
                                  window=None)
            x = x + _out_proj(out, ca["wo"].to(h.dtype))
            h = _ln(x, lp["ln3"], cfg)
            x = x + mlp(lp["mlp"], h, cfg)
        x = _ln(x, params["ln_f"], cfg)
        return unembed(params["embed"], x, cfg), state
