"""Zamba2-style hybrid: a Mamba2 backbone with a *shared* full-attention
block applied every ``cfg.attn_every`` layers (the port of the reference's
``models/hybrid.py``).

The n_layers Mamba blocks are grouped into ng = ceil(L / attn_every) groups
of ``attn_every``; each group runs [shared attention + MLP] -> [its Mamba
layers].  As in the reference, the last group is padded to full size: the
padded layers are computed and their output multiplied by a zero mask
(zamba2-7b: 14 groups of 6, 84 layers for 81).  The reference's scans over
groups and layers are Python loops here.

Parameters are nested dicts of tensors in the reference's layout:
``mamba_groups`` and ``mamba_ln`` are stacked on two leading axes (ng, g),
the shared block and the embeddings on none.  For serving, matrices are
held in the compute dtype, cast once at load (:func:`params_from_numpy`,
:func:`init_params`), except ``conv_w``, which stays float32 because the
decode step reads it in float32; for training (``master=True``) every
weight stays in the parameter dtype and is cast at each use, as in the
reference.  :func:`forward` and :func:`decode_step` run under
``torch.inference_mode``; :func:`train_forward` is the same forward with
autograd, each group checkpointed when ``cfg.remat == "block"`` (the
reference's ``jax.checkpoint`` of its group body).  Every RMSNorm is the
plain formula, as in the reference (no call site of ``hybrid.py`` takes the
kernel); the shared attention takes the flash kernel at S > 1024 with
``use_pallas``, and decode takes the decode-attention kernel.

Decode updates the KV caches and the Mamba states in place, as
:func:`repro_torch.models.transformer.decode_step` does; the returned state
holds the same tensors.

Under an ambient mesh (:func:`repro_torch.launch.mesh.use_mesh`) the forward
and ``train_forward`` split the rows over the mesh's data slots and each
data slot's model slots compute tensor-parallel from their own blocks of the
weights (:func:`train_forward_slots`, :class:`.sharding.SlotViews`): the
shared block through :func:`.attention.attention_row` and
:func:`.layers.mlp_row`, each Mamba2 layer through :func:`.ssm.mamba2_row`
(each slot its SSM heads; model slot 0 runs the mixer whole where the heads
do not divide the axis).  Decode under a mesh runs over the grid too
(:func:`decode_slots`): the shared attention through
:func:`.attention.decode_attention_row` against the K/V cache's blocks, each
Mamba2 layer through :func:`.ssm.mamba2_decode_row` against its conv window's
and SSM state's blocks, every block of the state read and written in place
where ``state_specs`` puts it.
"""

from __future__ import annotations

import math
import sys
from typing import NamedTuple, Optional

import torch

from .. import resolve_device
from . import attention as attn
from .attention import (KVCache, attention, attention_row, decode_attention_step,
                        heads_parallel, init_attention)
from .common import ModelConfig, abstract_mesh
from . import layers, sharding, transformer
from .layers import (cast_matrices, draw_stacked, embed, index_tree, init_embed, init_mlp, mlp,
                     rms_norm, unembed)
from .ssm import (MambaState, init_mamba2, mamba2_decode_row, mamba2_decode_step,
                  mamba2_forward, mamba2_row, ssm_dims)
from .transformer import _maybe_remat, slot_views

__all__ = ["HybridState", "decode_independent", "decode_slots", "decode_step", "forward",
           "group_shape", "init_decode_state", "init_params", "params_from_numpy", "slot_views",
           "train_forward", "train_forward_slots"]

# weights stacked over (groups, layers of a group), and those that stay float32
_STACKED_AXES = {"mamba_groups": 2, "mamba_ln": 2}
_KEEP_FLOAT32 = {"conv_w"}


def group_shape(cfg: ModelConfig) -> tuple:
    """(n_groups, group_size, n_padded_layers)."""
    g = cfg.attn_every
    ng = math.ceil(cfg.n_layers / g)
    pad = ng * g - cfg.n_layers
    return ng, g, pad


def _cast_matrices(tree, cfg: ModelConfig):
    return cast_matrices(tree, cfg.torch_dtype, _STACKED_AXES, _KEEP_FLOAT32)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig, master: bool = False) -> dict:
    """Random parameters with the reference's distributions, drawn from
    ``gen`` on ``gen.device``.  The Mamba weights are drawn one group at a
    time and cast before the next is drawn, so the float32 transient is one
    group's, not the whole stack's; with ``master`` nothing is cast
    (training)."""
    cast = (lambda tree: tree) if master else (lambda tree: _cast_matrices(tree, cfg))
    ng, g, _ = group_shape(cfg)
    d, pdt, dev = cfg.d_model, cfg.torch_param_dtype, gen.device
    tree = {
        "embed": init_embed(gen, cfg),
        "shared_attn": {
            "ln": torch.ones((d,), dtype=pdt, device=dev),
            "attn": init_attention(gen, cfg),
            "ln2": torch.ones((d,), dtype=pdt, device=dev),
            "mlp": init_mlp(gen, cfg),
        },
        "mamba_ln": torch.ones((ng, g, d), dtype=pdt, device=dev),
        "ln_f": torch.ones((d,), dtype=pdt, device=dev),
    }
    tree = cast(tree)
    tree["mamba_groups"] = draw_stacked(
        ng, lambda: init_mamba2(gen, cfg, lead=(1, g)),
        lambda grp: cast({"mamba_groups": grp})["mamba_groups"])
    return tree


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None,
                      master: bool = False) -> dict:
    """:func:`layers.params_from_numpy` with this family's cast."""
    return layers.params_from_numpy(tree, cfg, _cast_matrices, device, master)


def _layer_mask(cfg: ModelConfig, device, dtype) -> torch.Tensor:
    """(ng, g): 1 for a real layer, 0 for a padded one."""
    ng, g, _ = group_shape(cfg)
    return (torch.arange(ng * g, device=device) < cfg.n_layers).reshape(ng, g).to(dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _group_forward(shared, params, i, mask, x, cfg, positions):
    """Group ``i``: the shared attention block, then the group's Mamba
    layers, each masked."""
    h = rms_norm(x, shared["ln"], cfg.norm_eps)
    h = attention(shared["attn"], h, cfg, positions=positions, causal=True)
    x = x + h
    h = rms_norm(x, shared["ln2"], cfg.norm_eps)
    x = x + mlp(shared["mlp"], h, cfg)
    for j in range(mask.shape[1]):
        h = rms_norm(x, params["mamba_ln"][i, j], cfg.norm_eps)
        h = mamba2_forward(index_tree(params["mamba_groups"], i, j), h, cfg)
        x = x + mask[i, j] * h
    return x


def _grid_group(shared_rows: list, sdims: dict, mrows: list, mdims: dict, xs: list, masks: list,
                cfg: ModelConfig, positions: list, devs: list) -> list:
    """One group over the grid: ``xs[jj][m]`` model slot ``m``'s copy of
    computing data slot ``jj``'s rows, ``shared_rows[jj][m]`` its block of
    the shared block's weights, ``mrows[jj][j][m]`` of the group's Mamba
    layer ``j``, ``masks[jj][j]`` that layer's mask on the data slot's
    devices.  Returns the slots' outputs."""
    out = []
    for jj, (row, x) in enumerate(zip(shared_rows, xs)):
        own = heads_parallel(cfg, len(devs[jj]))
        h = [rms_norm(a, p["ln"], cfg.norm_eps) if own or m == 0 else None
             for m, (p, a) in enumerate(zip(row, x))]
        att, _, _ = attention_row([p["attn"] for p in row], sdims["attn"], h, cfg,
                                  positions[jj], devs[jj])
        x = [a + b for a, b in zip(x, att)]
        h = [rms_norm(a, p["ln2"], cfg.norm_eps) for p, a in zip(row, x)]
        y = layers.mlp_row([p["mlp"] for p in row], sdims["mlp"], h, cfg, devs[jj])
        x = [a + b for a, b in zip(x, y)]
        for j, lrow in enumerate(mrows[jj]):
            h = [rms_norm(a, p["ln"], cfg.norm_eps) for p, a in zip(lrow, x)]
            y = mamba2_row([p["mix"] for p in lrow], mdims, h, cfg, devs[jj])
            x = [a + mk[j] * b for a, b, mk in zip(x, y, masks[jj])]
        out.append(x)
    return out


def train_forward_slots(views, tokens_slots: list, cfg: ModelConfig,
                        n_data: Optional[int] = None) -> tuple:
    """:func:`train_forward` over the ambient mesh's grid (``views`` the
    weights' :class:`.sharding.SlotViews`, ``tokens_slots[jj]`` computing
    data slot ``views.data_slots[jj]``'s rows on its device): each model
    slot holds its copy of the rows; the shared block runs through
    :func:`.attention.attention_row` and :func:`.layers.mlp_row`, each
    Mamba layer through :func:`.ssm.mamba2_row`, the padded layers
    computed and masked, each group checkpointed under ``remat ==
    "block"``.  Returns (each data slot's :class:`.layers.SlotLogits`, each
    data slot's aux loss, zero)."""
    mesh = abstract_mesh()
    devs = [mesh.model_devices(j) for j in views.data_slots]
    xs = [layers.embed_row(views.top(jj, "embed"), views.dims, t, cfg, dv)
          for jj, (t, dv) in enumerate(zip(tokens_slots, devs))]
    positions = [torch.arange(row[0].shape[1], device=row[0].device)[None, :] for row in xs]
    ng, g, _ = group_shape(cfg)
    masks = [[_layer_mask(cfg, a.device, a.dtype) for a in row] for row in xs]
    sdims = views.dims["shared_attn"]
    mdims = views.entry_dims("mamba_groups", 2)
    D = len(views.data_slots)

    def run_group(i, xs, ms):
        # the group's weights taken (zero1 blocks gathered) inside its checkpoint
        srows = [[r["shared_attn"] for r in views.top(jj, "shared_attn")] for jj in range(D)]
        mrows = [[[{"ln": ln, "mix": mix}
                   for ln, mix in zip(views.entry(jj, "mamba_ln", i, j),
                                      views.entry(jj, "mamba_groups", i, j))]
                  for j in range(g)] for jj in range(D)]
        return _grid_group(srows, sdims, mrows, mdims, xs, ms, cfg, positions, devs)

    group = _maybe_remat(run_group, cfg)
    for i in range(ng):
        xs = group(i, xs, [[mk[i] for mk in row] for row in masks])
    logits = [layers.unembed_row(views.top(jj, "embed"), views.dims,
                                 [rms_norm(a, p["ln_f"], cfg.norm_eps)
                                  for p, a in zip(views.top(jj, "ln_f"), xs[jj])], cfg, devs[jj])
              for jj in range(D)]
    return logits, [torch.zeros((), dtype=torch.float32, device=row[0].device) for row in xs]


def train_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Returns (logits, aux_loss), differentiable in ``params``.  tokens:
    (B, S) on the parameters' device.  Under an ambient mesh the rows split
    over its data slots, each tensor-parallel over its model slots
    (:func:`train_forward_slots`)."""
    if abstract_mesh() is not None:
        return transformer.mesh_train_forward(sys.modules[__name__], params, tokens, cfg)
    x = embed(params["embed"], tokens, cfg)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    mask = _layer_mask(cfg, x.device, x.dtype)
    group = _maybe_remat(lambda params, x, i: _group_forward(
        params["shared_attn"], params, i, mask, x, cfg, positions), cfg)
    for i in range(mask.shape[0]):
        x = group(params, x, i)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return (unembed(params["embed"], x, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Returns (logits, aux_loss), under ``torch.inference_mode``.  tokens:
    (B, S) on the parameters' device."""
    with torch.inference_mode():
        return train_forward(params, tokens, cfg)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class HybridState(NamedTuple):
    caches: KVCache        # stacked (ng, B, C, K, hd): one per attention application
    mamba: MambaState      # stacked (ng, g, B, ...): one per layer


def init_decode_state(cfg: ModelConfig, batch: int, capacity: int,
                      device=None) -> HybridState:
    """Fresh decode state on ``device`` (``None`` means cuda)."""
    dev = resolve_device(device)
    ng, g, _ = group_shape(cfg)
    d_in, H, P, N = ssm_dims(cfg)
    conv_dim = d_in + 2 * N
    kv = (ng, batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    caches = KVCache(
        k=torch.zeros(kv, dtype=cfg.torch_dtype, device=dev),
        v=torch.zeros(kv, dtype=cfg.torch_dtype, device=dev),
        pos=torch.zeros((ng, batch), dtype=torch.int32, device=dev),
        positions=torch.full((ng, batch, capacity), -1, dtype=torch.int32, device=dev),
    )
    mamba = MambaState(
        conv=torch.zeros((ng, g, batch, conv_dim, cfg.ssm_conv - 1), dtype=torch.float32,
                         device=dev),
        ssm=torch.zeros((ng, g, batch, H, P, N), dtype=torch.float32, device=dev),
    )
    return HybridState(caches, mamba)


def decode_independent(cfg: ModelConfig, state: HybridState, rows: int) -> bool:
    """Whether, under the ambient mesh, each data slot's part of a decode
    step over ``rows`` rows depends on no other data slot's: the rows split
    over every data slot and each state leaf's data split on its batch dim."""
    mesh = abstract_mesh()
    if len(mesh.row_devices(rows)) == 1:
        return False
    kv = sharding.StateBlocks(state.caches, cfg, mesh, rows)
    mb = sharding.StateBlocks(state.mamba, cfg, mesh, rows)
    return kv.data_dims() == {"k": 1, "v": 1, "pos": 1, "positions": 1} and \
        mb.data_dims() == {"conv": 2, "ssm": 2}


def decode_slots(views, state: HybridState, tokens_slots: list, cfg: ModelConfig,
                 n_data: Optional[int] = None) -> list:
    """:func:`decode_step` over the ambient mesh's grid (``views`` the
    weights' :class:`.sharding.SlotViews`, ``tokens_slots[jj]`` the rows of
    computing data slot ``views.data_slots[jj]``, with ``n_data`` data slots
    taking rows in all), ``state`` placed by ``state_specs`` or whole.  Per
    group each model slot normalizes its copy of the rows; the shared
    attention reads and writes the K/V cache's blocks in place
    (:func:`.attention.decode_attention_row`, the layout from the cache's
    ``model`` split: whole heads with the decode kernel, or the head-dim
    columns; a cache length split over the data slots merges the kernel's
    log-sum-exp partials), ``pos`` advances in every block that holds it,
    the shared MLP runs as in the forward, and each Mamba2 layer runs
    through :func:`.ssm.mamba2_decode_row` against its conv window's and
    SSM state's blocks, masked where padded.  Returns each data slot's
    :class:`.layers.SlotLogits`."""
    mesh = abstract_mesh()
    data_slots = views.data_slots
    n_data = n_data or len(data_slots)
    b = tokens_slots[0].shape[0]
    kv = sharding.StateBlocks(state.caches, cfg, mesh, b * n_data)
    mb = sharding.StateBlocks(state.mamba, cfg, mesh, b * n_data)
    layout = attn.decode_layout(kv, views.msize)
    cols = attn.decode_cols(kv, mesh, layout)
    rows = [slice(j * b, (j + 1) * b) if n_data > 1 else slice(0, b) for j in data_slots]
    devs = [mesh.model_devices(j) for j in data_slots]
    xs = [layers.embed_row(views.top(jj, "embed"), views.dims, t, cfg, dv)
          for jj, (t, dv) in enumerate(zip(tokens_slots, devs))]
    ng, g, _ = group_shape(cfg)
    masks = [[_layer_mask(cfg, a.device, a.dtype) for a in row] for row in xs]
    sdims = views.dims["shared_attn"]
    mdims = views.entry_dims("mamba_groups", 2)
    for i in range(ng):
        for jj, j in enumerate(data_slots):
            row = [r["shared_attn"] for r in views.top(jj, "shared_attn")]
            h = [rms_norm(x, p["ln"], cfg.norm_eps) for p, x in zip(row, xs[jj])]
            out = attn.decode_attention_layer(kv, mesh, i, rows[jj], j, [p["attn"] for p in row],
                                              sdims["attn"], h, cfg, devs[jj], layout, cols)
            x = [a + o for a, o in zip(xs[jj], out)]
            h = [rms_norm(a, p["ln2"], cfg.norm_eps) for p, a in zip(row, x)]
            y = layers.mlp_row([p["mlp"] for p in row], sdims["mlp"], h, cfg, devs[jj])
            x = [a + o for a, o in zip(x, y)]
            for jl in range(g):
                lns = views.entry(jj, "mamba_ln", i, jl)
                mixes = views.entry(jj, "mamba_groups", i, jl)
                h = [rms_norm(a, ln, cfg.norm_eps) for ln, a in zip(lns, x)]
                y = mamba2_decode_row(mixes, mdims, h, cfg, devs[jj], mb, (i, jl), rows[jj], j)
                x = [a + mk[i, jl] * o for a, o, mk in zip(x, y, masks[jj])]
            xs[jj] = x
    return [layers.unembed_row(views.top(jj, "embed"), views.dims,
                               [rms_norm(a, p["ln_f"], cfg.norm_eps)
                                for p, a in zip(views.top(jj, "ln_f"), xs[jj])], cfg, devs[jj])
            for jj in range(len(data_slots))]


def decode_step(params: dict, state: HybridState, token: torch.Tensor,
                cfg: ModelConfig) -> tuple:
    """One decoding step: token (B, 1) -> (logits (B,1,V), state).  The
    caches and Mamba states are updated in place.  Under an ambient mesh the
    step runs over its grid (:func:`decode_slots`), ``params`` placed or
    whole, ``state`` placed by ``state_specs`` or whole."""
    if abstract_mesh() is not None:
        return transformer.mesh_decode(sys.modules[__name__], params, state, token, cfg)
    c, ms = state.caches, state.mamba
    shared = params["shared_attn"]
    with torch.inference_mode():
        x = embed(params["embed"], token, cfg)
        mask = _layer_mask(cfg, x.device, x.dtype)
        ng, g = mask.shape
        for i in range(ng):
            h = rms_norm(x, shared["ln"], cfg.norm_eps)
            h, new = decode_attention_step(shared["attn"], h,
                                           KVCache(c.k[i], c.v[i], c.pos[i], c.positions[i]),
                                           cfg)
            c.pos[i] = new.pos
            x = x + h
            h = rms_norm(x, shared["ln2"], cfg.norm_eps)
            x = x + mlp(shared["mlp"], h, cfg)
            for j in range(g):
                h = rms_norm(x, params["mamba_ln"][i, j], cfg.norm_eps)
                h, _ = mamba2_decode_step(index_tree(params["mamba_groups"], i, j), h,
                                          MambaState(ms.conv[i, j], ms.ssm[i, j]), cfg)
                x = x + mask[i, j] * h
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return unembed(params["embed"], x, cfg), state
