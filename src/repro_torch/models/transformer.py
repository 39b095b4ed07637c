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
all), and each data slot's model slots compute tensor-parallel from their
own blocks of the weights (:class:`repro_torch.models.sharding.SlotViews`:
from a placed tree, or cut from a whole one; a ``zero1_specs`` block
all-gathered over the data slots where a layer uses it, inside the layer's
checkpoint), layer by layer over the grid (:func:`train_forward_slots`).
The embedding, the attention heads, the FFN's inner dim (or the experts)
and the vocabulary split over ``model`` as ``param_specs`` places them,
each split layer a column-parallel product and a row-parallel partial sum
(:func:`.layers.embed_row`, :func:`.attention.attention_row`,
:func:`.layers.mlp_row`, :func:`.moe.moe_ffn_grid`,
:func:`.layers.unembed_row`).  Between blocks the forward and
``train_forward`` hold each model slot's block of the positions where the
model axis divides them (:func:`seq_parallel`, the reference's ``seq_sp``):
each half normalizes the slot's block (the RMSNorm kernel under
``use_pallas``), all-gathers the normalized rows over the model slots and
reduce-scatters its partial sums over the positions, rounded once from
float32 as the all-reduce rounds, so the logits equal the replicated
form's bit for bit.  Prefill, a sequence the axis does not divide, and
decode keep every model slot's copy of the rows, the partial sums
all-reduced.  Flash attention runs per slot at its head counts.  Where the
heads do not divide the model axis, model slot 0 takes one layer's
projections whole and runs the attention sequence-parallel over the model
slots, as the reference does.  The logits stay split over the vocabulary
(:class:`.layers.SlotLogits`) until the forward gathers them onto the
tokens' device; prefill's caches come out with their K/V heads per model
slot and are gathered there too.

Under an ambient mesh :func:`decode_step` runs over the grid as well
(:func:`decode_slots`), with the decode state left where ``state_specs``
puts it: a state placed by :func:`repro_torch.models.sharding.place` (or a
whole one, read through views of the blocks ``state_specs`` gives each
slot) is read and written in place, each slot its own blocks
(:class:`.sharding.StateBlocks`, :func:`.attention.decode_attention_row`),
and ``pos`` advances per block; no slot gathers the cache or a split weight.
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..launch import collectives
from ..launch.mesh import data_slot_scope
from . import attention as attn
from .attention import (KVCache, _out_proj, _project_qkv, attention, cache_from_prefill,
                        core_attention, decode_attention_step, init_attention)
from .common import ModelConfig, abstract_mesh
from . import layers, moe, sharding
from .layers import (cast_matrices, draw_stacked, embed, index_tree, init_embed, init_mlp, mlp,
                     rms_norm, unembed)
from .moe import KEEP_FLOAT32, init_moe, moe_ffn

__all__ = ["DecodeState", "block_forward", "check_family", "data_slots_independent",
           "decode_independent", "decode_slots", "decode_step", "forward", "init_decode_state",
           "init_params", "mesh_train_forward", "params_from_numpy", "prefill", "seq_parallel",
           "slot_views", "train_forward", "train_forward_slots"]


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


def seq_parallel(cfg: ModelConfig, msize: int, seq: int) -> bool:
    """Whether a mesh forward's block edges split the positions over the
    ``msize`` model slots (the reference's ``("batch", "seq_sp",
    "d_model")`` constraint, ``seq_sp`` on ``model``): where the model axis
    divides the ``seq`` positions.  Elsewhere every model slot holds the
    rows whole, as the reference's ``shard`` drops an axis that does not
    divide its dim."""
    return msize > 1 and seq % msize == 0


def _grid_block(lrows: list, ldims: dict, xs: list, cfg: ModelConfig, positions: list,
                data_slots: list, n_data: int, prefill: bool = False, sp: bool = False) -> tuple:
    """One layer over the grid: ``xs[jj][m]`` model slot ``m``'s copy of
    computing data slot ``data_slots[jj]``'s rows (with ``sp``, its block
    of their positions), ``lrows[jj][m]`` its block of the layer's weights.
    Each data slot's attention half over its model slots, then the FFN (the
    MoE across the grid).  With ``sp`` each half normalizes the slot's
    block, all-gathers the normalized rows over the model slots (onto model
    slot 0 where it runs the attention whole) and reduce-scatters its
    row-parallel partial sums over the positions, the residual added on the
    block (Megatron's sequence parallelism, in both halves).  Returns (the
    slots' outputs, each data slot's aux loss, each data slot's (per-slot
    (k, v), their K/V heads) when ``prefill``)."""
    mesh = abstract_mesh()
    x2s, hs, kvs = [], [], []
    for jj, j in enumerate(data_slots):
        devs = mesh.model_devices(j)
        row = lrows[jj]
        own = attn.heads_parallel(cfg, len(devs))
        with data_slot_scope(j):
            h1 = [rms_norm(x, p["ln1"], cfg.norm_eps, cfg.use_pallas) if sp or own or m == 0
                  else None for m, (p, x) in enumerate(zip(row, xs[jj]))]
            if sp:
                h1 = collectives.all_gather(h1, 1, devs, grad32=True) if own else \
                    [collectives.gather_to(h1, 1, devs[0])] + [None] * (len(devs) - 1)
            out, kv, heads = attn.attention_row([p["attn"] for p in row], ldims["attn"], h1, cfg,
                                                positions[jj][0], devs, prefill, seq_out=sp)
        x2 = [x + a for x, a in zip(xs[jj], out)]
        x2s.append(x2)
        kvs.append((kv, heads))
        h2 = [rms_norm(x, p["ln2"], cfg.norm_eps, cfg.use_pallas) for p, x in zip(row, x2)]
        hs.append(collectives.all_gather(h2, 1, devs, grad32=True) if sp else h2)
    if cfg.family == "moe":
        ys, auxes = moe.moe_ffn_grid([[p["moe"] for p in row] for row in lrows], ldims["moe"], hs,
                                     cfg, n_data, data_slots, seq_out=sp)
    else:
        ys = [layers.mlp_row([p["mlp"] for p in row], ldims["mlp"], h, cfg,
                             mesh.model_devices(j), seq_out=sp)
              for row, h, j in zip(lrows, hs, data_slots)]
        auxes = [torch.zeros((), dtype=torch.float32, device=x2[0].device) for x2 in x2s]
    return [[x + y for x, y in zip(x2, yr)] for x2, yr in zip(x2s, ys)], auxes, kvs


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


def slot_views(params, cfg: ModelConfig, data_slots, leaves: bool = False):
    """The :class:`.sharding.SlotViews` of ``params`` on the ambient mesh's
    computing data slots ``data_slots``: a placed tree as placed, a whole
    tree cut by ``param_specs``."""
    mesh = abstract_mesh()
    if isinstance(params["embed"]["tok"], sharding.ShardedTensor):
        return sharding.SlotViews(params, mesh, data_slots, leaves=leaves)
    return sharding.SlotViews(params, mesh, data_slots, sharding.param_specs(params, cfg, mesh),
                              leaves=leaves)


def _grid_forward(views, tokens_slots: list, cfg: ModelConfig, prefix_slots=None,
                  prefill: bool = False, n_data: Optional[int] = None) -> tuple:
    """The layers over the grid of ``views``' computing data slots
    (``tokens_slots[jj]`` and ``prefix_slots[jj]`` data slot
    ``views.data_slots[jj]``'s, on its device): (each slot's final hidden
    state, whole over the positions, each data slot's aux loss, per layer
    each data slot's prefill (k, v) and K/V heads when ``prefill``).  A
    forward whose positions the model axis divides (:func:`seq_parallel`;
    never a prefill, as in the reference) holds each slot's block of the
    positions between the blocks; the final norm runs on the blocks and the
    normalized rows are all-gathered for the unembedding.  Each layer's
    weights are taken (a ``zero1_specs`` block gathered over the data
    slots) inside its checkpoint."""
    mesh = abstract_mesh()
    data_slots = views.data_slots
    n_data = n_data or len(data_slots)
    prefix_slots = prefix_slots or [None] * len(tokens_slots)
    devs = [mesh.model_devices(j) for j in data_slots]
    xs = [layers.embed_row(views.top(jj, "embed"), views.dims, t, cfg, dv, pe)
          for jj, (dv, t, pe) in enumerate(zip(devs, tokens_slots, prefix_slots))]
    positions = [[torch.arange(x.shape[1], device=x.device)[None, :] for x in row] for row in xs]
    sp = not prefill and seq_parallel(cfg, views.msize, xs[0][0].shape[1])
    if sp:
        xs = [layers.seq_blocks(row) for row in xs]
    auxes = [torch.zeros((), dtype=torch.float32, device=row[0].device) for row in xs]
    ldims = views.layer_dims()
    block = _maybe_remat(lambda i, xs: _grid_block(
        [views.layer(jj, i, cfg.n_layers) for jj in range(len(data_slots))], ldims, xs, cfg,
        positions, data_slots, n_data, prefill, sp), cfg)
    kvs = []
    for i in range(cfg.n_layers):
        xs, a, kv = block(i, xs)
        kvs.append(kv)
        auxes = [x + y for x, y in zip(auxes, a)]
    hs = [[rms_norm(x, p["ln_f"], cfg.norm_eps, cfg.use_pallas)
           for p, x in zip(views.top(jj, "ln_f"), row)] for jj, row in enumerate(xs)]
    if sp:
        hs = [collectives.all_gather(row, 1, dv, grad32=True) for row, dv in zip(hs, devs)]
    return hs, auxes, kvs


def train_forward_slots(views, tokens_slots: list, cfg: ModelConfig, prefix_embeds=None,
                        n_data: Optional[int] = None) -> tuple:
    """:func:`train_forward` over the ambient mesh's grid: ``views`` the
    :class:`.sharding.SlotViews` of the weights (:func:`slot_views`),
    ``tokens_slots[jj]`` (and a VLM's ``prefix_embeds[jj]``) the rows of
    computing data slot ``views.data_slots[jj]`` on its device, ``n_data``
    the data slots that take rows in all (the MoE's groups follow the whole
    batch).  Returns (each data slot's :class:`.layers.SlotLogits` over its
    model slots, of the text positions; each data slot's aux loss on its
    first model slot's device)."""
    check_family(cfg)
    mesh = abstract_mesh()
    hs, auxes, _ = _grid_forward(views, tokens_slots, cfg, prefix_embeds, n_data=n_data)
    logits = []
    for jj, (j, row) in enumerate(zip(views.data_slots, hs)):
        if prefix_embeds is not None:
            row = [h[:, prefix_embeds[jj].shape[1]:] for h in row]
        logits.append(layers.unembed_row(views.top(jj, "embed"), views.dims, row, cfg,
                                         mesh.model_devices(j)))
    return logits, auxes


def data_slots_independent(cfg: ModelConfig, rows: int, seq: int) -> bool:
    """Whether, under the ambient mesh, the data slots' parts of a forward
    over ``rows`` x ``seq`` tokens depend on no other data slot's (so each
    may run, and be differentiated, on its own): always but for an MoE
    whose dispatch gathers the data slots' rows (:func:`.moe.per_data_slot`)."""
    return cfg.family != "moe" or moe.per_data_slot(cfg, rows, seq)


def _joined(parts: list) -> torch.Tensor:
    """The data slots' rows, already on one device, as one tensor."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def mesh_train_forward(module, params, tokens, cfg: ModelConfig, **extras) -> tuple:
    """A family module's ``train_forward`` under the ambient mesh: the rows
    of ``tokens`` and of each of ``extras`` (a VLM's ``prefix_embeds``, the
    enc-dec model's ``frames``; ``None`` for none) scattered over the data
    slots that take them, ``module.train_forward_slots`` over the grid of
    ``module.slot_views`` of ``params`` (placed or whole), the logits
    gathered onto the tokens' device and the aux losses summed there."""
    mesh = abstract_mesh()
    devices = mesh.row_devices(tokens.shape[0])
    extras = {k: collectives.scatter(v, 0, devices) for k, v in extras.items() if v is not None}
    views = module.slot_views(params, cfg, range(len(devices)))
    logits, auxes = module.train_forward_slots(views, collectives.scatter(tokens, 0, devices),
                                               cfg, **extras)
    return (_joined([layers.gather_logits(lg, tokens.device) for lg in logits]),
            collectives.psum(auxes, tokens.device))


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
        return mesh_train_forward(sys.modules[__name__], params, tokens, cfg,
                                  prefix_embeds=prefix_embeds)
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
    q, k, v = _project_qkv(p["attn"], h, h, cfg, positions, positions)
    out = core_attention(q, k, v, cfg, window=cfg.sliding_window, prefill=True)
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
    """:func:`prefill` over the ambient mesh's grid (rows over the data
    slots, each data slot tensor-parallel over its model slots); the last
    logits and the caches (each K/V head from a model slot that computed
    it) gathered onto the tokens' device."""
    with torch.inference_mode():
        mesh = abstract_mesh()
        devices = mesh.row_devices(tokens.shape[0])
        prefix = None if prefix_embeds is None else collectives.scatter(prefix_embeds, 0, devices)
        views = slot_views(params, cfg, range(len(devices)))
        hs, _, kvs = _grid_forward(views, collectives.scatter(tokens, 0, devices), cfg, prefix,
                                   prefill=True)
        dev = tokens.device
        logits = [layers.gather_logits(layers.unembed_row(
            views.top(jj, "embed"), views.dims, [h[:, -1:] for h in row], cfg,
            mesh.model_devices(jj)), dev) for jj, row in enumerate(hs)]
        caches = []
        for layer in kvs:
            per_slot = [attn.prefill_cache_kv(kv, heads, cfg.n_kv_heads, dev)
                        for kv, heads in layer]
            caches.append(cache_from_prefill(cfg, _joined([k for k, _ in per_slot]),
                                             _joined([v for _, v in per_slot]),
                                             cfg.sliding_window))
        return _joined(logits), DecodeState(KVCache(*(torch.stack(f) for f in zip(*caches))))


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


def _decode_cfg(cfg: ModelConfig) -> ModelConfig:
    """Decode's config: the MoE's capacity boosted for tiny decode batches
    so that routing rarely drops."""
    return cfg.replace(capacity_factor=max(cfg.capacity_factor, 8.0)) \
        if cfg.family == "moe" else cfg


def decode_independent(cfg: ModelConfig, state: DecodeState, rows: int) -> bool:
    """Whether, under the ambient mesh, each data slot's part of a decode
    step over ``rows`` rows depends on no other data slot's: the rows split
    over every data slot, each state leaf's data split on its batch dim
    (not the cache length), and the MoE dispatching per data slot."""
    mesh = abstract_mesh()
    if len(mesh.row_devices(rows)) == 1:
        return False
    blocks = sharding.StateBlocks(state.caches, cfg, mesh, rows)
    batch_dim = {"k": 1, "v": 1, "pos": 1, "positions": 1}
    return blocks.data_dims() == batch_dim and (
        cfg.family != "moe" or moe.per_data_slot(_decode_cfg(cfg), rows, 1))


def decode_slots(views, state: DecodeState, tokens_slots: list, cfg: ModelConfig,
                 n_data: Optional[int] = None) -> list:
    """:func:`decode_step` over the ambient mesh's grid: ``views`` the
    weights' :class:`.sharding.SlotViews`, ``tokens_slots[jj]`` the rows of
    computing data slot ``views.data_slots[jj]`` on its device (with ``n_data``
    data slots taking rows in all; one takes every row), ``state`` placed by
    ``state_specs`` or whole.  Each data slot embeds its rows, then per
    layer each model slot normalizes its copy, the attention reads and
    writes the cache blocks in place (:func:`.attention.decode_attention_row`;
    the layout from the cache's ``model`` split), ``pos`` advances in every
    block that holds it, and the FFN runs as in the forward
    (:func:`.layers.mlp_row`, :func:`.moe.moe_ffn_grid` at decode's
    capacity).  Returns each data slot's :class:`.layers.SlotLogits`."""
    check_family(cfg)
    mesh = abstract_mesh()
    data_slots = views.data_slots
    n_data = n_data or len(data_slots)
    b = tokens_slots[0].shape[0]
    blocks = sharding.StateBlocks(state.caches, cfg, mesh, b * n_data)
    layout = attn.decode_layout(blocks, views.msize)
    cols = attn.decode_cols(blocks, mesh, layout)
    rows = [slice(j * b, (j + 1) * b) if n_data > 1 else slice(0, b) for j in data_slots]
    devs = [mesh.model_devices(j) for j in data_slots]
    dcfg = _decode_cfg(cfg)
    xs = [layers.embed_row(views.top(jj, "embed"), views.dims, t, cfg, dv)
          for jj, (t, dv) in enumerate(zip(tokens_slots, devs))]
    ldims = views.layer_dims()
    for i in range(cfg.n_layers):
        lrows = [views.layer(jj, i, cfg.n_layers) for jj in range(len(data_slots))]
        x2s, hs = [], []
        for jj, j in enumerate(data_slots):
            row = lrows[jj]
            h = [rms_norm(x, p["ln1"], cfg.norm_eps) for p, x in zip(row, xs[jj])]
            out = attn.decode_attention_layer(blocks, mesh, i, rows[jj], j,
                                              [p["attn"] for p in row], ldims["attn"], h, cfg,
                                              devs[jj], layout, cols)
            x2 = [x + a for x, a in zip(xs[jj], out)]
            x2s.append(x2)
            hs.append([rms_norm(x, p["ln2"], cfg.norm_eps) for p, x in zip(row, x2)])
        if cfg.family == "moe":
            ys, _ = moe.moe_ffn_grid([[p["moe"] for p in row] for row in lrows], ldims["moe"],
                                     hs, dcfg, n_data, data_slots)
        else:
            ys = [layers.mlp_row([p["mlp"] for p in row], ldims["mlp"], h, cfg, dv)
                  for row, h, dv in zip(lrows, hs, devs)]
        xs = [[x + y for x, y in zip(x2, yr)] for x2, yr in zip(x2s, ys)]
    return [layers.unembed_row(views.top(jj, "embed"), views.dims,
                               [rms_norm(x, p["ln_f"], cfg.norm_eps)
                                for p, x in zip(views.top(jj, "ln_f"), xs[jj])], cfg, devs[jj])
            for jj in range(len(data_slots))]


def mesh_decode(module, params, state, token, cfg: ModelConfig) -> tuple:
    """A family module's ``decode_step`` over the ambient mesh: the rows
    over the data slots (``module.decode_slots`` over ``slot_views`` of
    ``params``, placed or whole), the logits gathered onto the token's
    device; the state updated in place where it lies."""
    with torch.inference_mode():
        mesh = abstract_mesh()
        devices = mesh.row_devices(token.shape[0])
        views = slot_views(params, cfg, range(len(devices)))
        logits = module.decode_slots(views, state, collectives.scatter(token, 0, devices), cfg)
        return _joined([layers.gather_logits(lg, token.device) for lg in logits]), state


def decode_step(params: dict, state: DecodeState, token: torch.Tensor,
                cfg: ModelConfig) -> tuple:
    """One decoding step: token (B, 1) -> (logits (B,1,V), state).  The
    caches are updated in place; the returned state holds the same tensors.
    Under an ambient mesh the step runs over its grid (:func:`decode_slots`),
    ``params`` placed or whole, ``state`` placed by ``state_specs`` or whole."""
    check_family(cfg)
    if abstract_mesh() is not None:
        return mesh_decode(sys.modules[__name__], params, state, token, cfg)
    c = state.caches
    dcfg = _decode_cfg(cfg)
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
