"""Building blocks shared by the architectures: the logical sharding rules,
initializers, norms, rotary embeddings, MLPs, embedding and unembedding (the
port of the reference's ``models/layers.py``).  The reference's sharding
constraints inside the model code change no value; the port resolves them
(:func:`shard_spec`) where a caller asks, and places tensors on a mesh's
slots with :func:`repro_torch.models.sharding.place`.

Under a mesh the MLP, the embedding and the unembedding run per model slot
of a data slot (``*_row``: ``ps[m]`` the slot's block of the weights, as
:class:`repro_torch.models.sharding.SlotViews` gives it, ``dims`` the dims
split over ``model``, ``devs`` the data slot's model devices), the
reference's Megatron layout: a weight split along its output dim gives each
slot a slice of the activations, one split along its input dim a partial
sum, reduced with ``collectives.psum`` in model-slot order.  A layout that
splits neither way takes the layer's weight whole onto model slot 0
(:func:`whole_on`), computes there and broadcasts."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..optim.tree import tree_leaves, tree_map
from .common import ModelConfig, abstract_mesh
from .sharding import PartitionSpec

__all__ = ["LOGICAL_RULES", "SlotLogits", "apply_rope", "cast_matrices", "dense_init",
           "draw_stacked", "embed", "embed_init", "embed_row", "gather_logits", "index_tree",
           "init_embed", "init_mlp", "layer_norm", "logical_sharding", "mlp", "mlp_row",
           "params_from_numpy", "rms_norm", "rope_freqs", "shard", "shard_spec", "take_columns",
           "tree_from_numpy", "unembed", "unembed_row", "vocab_offset", "whole_on"]


# ---------------------------------------------------------------------------
# Logical sharding (the reference's rules, verbatim): the one place where
# logical axis names bind to mesh axes.  'batch' spreads over the data axes
# ('pod', 'data'); 'model' carries tensor parallelism.
# ---------------------------------------------------------------------------

LOGICAL_RULES = {
    "batch": ("pod", "data"),
    "seq": None,                # sequences are replicated except for long-context decode
    "seq_sp": ("model",),       # megatron-style sequence parallelism at block edges
    "seq_kv": ("data",),        # KV-cache sequence dim for B=1 long-context decode
    "d_model": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "moe_cap": ("data",),       # MoE capacity dim: shard expert token-slots over data
    "stage": ("pod",),          # pipeline stage axis (paper technique)
}


def _resolve(axis, mesh_axes):
    if axis is None:
        return None
    rule = LOGICAL_RULES.get(axis, None)
    if rule is None:
        return None
    picked = tuple(a for a in rule if a in mesh_axes)
    if not picked:
        return None
    return picked if len(picked) > 1 else picked[0]


def shard_spec(shape, *logical_axes, mesh=None, manual=()):
    """The spec the reference's ``shard(x, *logical_axes)`` constrains an
    array of ``shape`` to under ``mesh`` (the ambient mesh by default;
    ``None`` without one): axes in ``manual`` (a ``shard_map``'s) are not
    used, a mesh axis appears at most once, and an axis whose size does not
    divide its dimension is dropped."""
    mesh = abstract_mesh() if mesh is None else mesh
    if mesh is None:
        return None
    mesh_axes = set(mesh.axis_names) - set(manual)
    entries, used = [], set()
    for dim, a in enumerate(logical_axes):
        r = _resolve(a, mesh_axes)
        if r is not None:
            axes = r if isinstance(r, tuple) else (r,)
            if used & set(axes):
                r = None  # a mesh axis can appear at most once per spec
            elif shape[dim] % math.prod(mesh.shape[ax] for ax in axes):
                r = None
            else:
                used |= set(axes)
        entries.append(r)
    return PartitionSpec(*entries)


def shard(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """``x`` itself: the reference's constraint changes no value, and the
    port computes a mesh's slots explicitly (:func:`shard_spec` gives the
    spec)."""
    return x


def logical_sharding(logical_axes, mesh) -> PartitionSpec:
    """The placement spec of a parameter or batch from logical axis names
    (the spec of the reference's ``NamedSharding``, which refuses a mesh
    axis named twice)."""
    mesh_axes = set(mesh.axis_names)
    spec = PartitionSpec(*(_resolve(a, mesh_axes) for a in logical_axes))
    used = [ax for e in spec if e is not None for ax in (e if isinstance(e, tuple) else (e,))]
    if len(used) != len(set(used)):
        raise ValueError(f"{spec} names a mesh axis twice")
    return spec


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


def draw_stacked(n: int, draw, cast=lambda tree: tree):
    """A tree of weights stacked on a leading axis of ``n`` (at least 1),
    drawn one entry at a time: ``draw()`` returns one entry's tree, each
    leaf with a leading axis of 1, and ``cast`` its stored form.  Each entry
    is cast before the next is drawn, so the transient in the parameter
    dtype is one entry's; the entries are then joined one weight at a time,
    each weight's parts freed as soon as it is joined, so the peak is the
    stored tree plus its largest stacked weight (a preallocated stack beside
    a whole drawn entry would not fit arctic-480b's two layers of bf16
    experts, 26.8 GB each, on one 80 GB card)."""
    entries, skeleton = [], None
    for _ in range(n):
        one = cast(draw())
        if skeleton is None:
            skeleton = tree_map(lambda v: 0, one)
        entries.append(tree_leaves(one))
        del one
    joined = []
    for j in range(len(entries[0])):
        joined.append(torch.cat([e[j] for e in entries], dim=0))
        for e in entries:
            e[j] = None
    leaves = iter(joined)
    return tree_map(lambda _: next(leaves), skeleton)


def tree_from_numpy(tree, dtype, device):
    """Nested dicts of numpy arrays as tensors of ``dtype`` on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, dtype, device) for k, v in tree.items()}
    # a copy: the caller's arrays may be read-only views of its buffers;
    # numpy has no bfloat16 of its own (a JAX bf16 array converts to
    # ml_dtypes' type, which torch does not read), and float32 holds it exactly
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def params_from_numpy(tree: dict, cfg: ModelConfig, cast, device=None,
                      master: bool = False) -> dict:
    """A family's parameters from the reference's parameter tree given as
    nested dicts of numpy arrays, on ``device`` (``None`` means cuda), cast
    to their stored form by the family's ``cast(tree, cfg)``; with
    ``master`` the uncast tree in the parameter dtype (training)."""
    tree = tree_from_numpy(tree, cfg.torch_param_dtype, resolve_device(device))
    return tree if master else cast(tree, cfg)


def index_tree(tree: dict, *idx) -> dict:
    """Every leaf of nested dicts indexed at ``idx`` on its leading axes
    (one layer of a stacked tree)."""
    return {k: index_tree(v, *idx) if isinstance(v, dict) else v[idx] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             use_pallas: bool = False) -> torch.Tensor:
    """Two formulas, as in the reference.  With ``use_pallas`` the fused
    kernel's: ``x * rsqrt(var + eps) * scale`` in float32, rounded once.
    Without: ``x * rsqrt(var + eps)`` rounded to x's type first, then
    multiplied by the scale in x's type.  The kernel takes a float32 scale;
    a bfloat16 one (arctic-480b's parameters) is widened first, exactly, as
    the TPU kernel widens it inside."""
    if use_pallas:
        from ..kernels import ops as kops

        return kops.rmsnorm(x, scale.float(), eps=eps)
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """The reference's formula: statistics in float32, the normalized value
    rounded to x's type, then scale and bias applied in x's type (not
    ``F.layer_norm``, which applies them in float32 and rounds once)."""
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * scale.to(dt) + bias.to(dt)


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


# ---------------------------------------------------------------------------
# Per model slot (tensor parallelism over a data slot's model slots)
# ---------------------------------------------------------------------------

def whole_on(leaves: list, dim, device) -> torch.Tensor:
    """One layer's weight whole on ``device`` (model slot 0's) from its model
    slots' blocks ``leaves``: slot 0's own where the weight is replicated
    (``dim`` None), else gathered over the model slots (split on ``dim``;
    ``"owner"``: the one slot that holds the layer).  A gathered weight is
    one layer's, for a route that needs it whole, and is freed with it."""
    from ..launch import collectives

    if dim is None:
        return leaves[0]
    if dim == "owner":
        return collectives.gather_to([x for x in leaves if x is not None], 0, device)
    return collectives.gather_to(leaves, dim, device)


def take_columns(blocks: list, spans: list, device, dim: int = -1) -> torch.Tensor:
    """The global indices ``spans`` (a list of ``(lo, hi)``) along ``dim``
    of a tensor split over the model slots in equal blocks along that dim
    (``blocks[m]`` model slot ``m``'s), joined in order on ``device``: one
    gather, each piece read from the slot whose block holds it.  Moves
    activations between a column-parallel product's slots (or a few rows
    of a weight); differentiable, so each piece's gradient goes back to
    its slot.  With one block (one model slot) the pieces are joined
    locally, no collective."""
    from ..launch import collectives

    if len(blocks) == 1:
        return torch.cat([blocks[0].narrow(dim, lo, hi - lo) for lo, hi in spans], dim=dim)
    width = blocks[0].shape[dim]
    parts = []
    for lo, hi in spans:
        c = lo
        while c < hi:
            m = c // width
            e = min(hi, (m + 1) * width)
            parts.append(blocks[m].narrow(dim, c - m * width, e - c))
            c = e
    return collectives.gather_to(parts, dim, device)


def _whole_tree(ps: list, dims, device):
    if isinstance(ps[0], dict) or isinstance(dims, dict):
        keys = next(p for p in ps if p is not None).keys()
        return {k: _whole_tree([p[k] for p in ps], dims[k], device) for k in keys}
    return whole_on(ps, dims, device)


def mlp_row(ps: list, dims: dict, hs: list, cfg: ModelConfig, devs) -> list:
    """:func:`mlp` over one data slot's model slots (``hs[m]`` slot ``m``'s
    copy of the rows): with the inner dim split (``wi``/``wg`` by column,
    ``wo`` by row, or ``wo`` replicated, each slot reading its rows of it:
    the hybrid's shared MLP, whose ``wo`` ``param_specs`` takes for an
    attention output) each slot's product is a partial sum, all-reduced in
    model-slot order; otherwise model slot 0 computes with the layer's
    weights whole and broadcasts.  Returns each slot's output."""
    from ..launch import collectives

    if len(devs) == 1:
        return [mlp(ps[0], hs[0], cfg)]
    if dims["wi"] == 1 and dims["wo"] in (0, None):
        if dims["wo"] is None:
            f = ps[0]["wi"].shape[-1]
            ps = [dict(p, wo=p["wo"][m * f:(m + 1) * f]) for m, p in enumerate(ps)]
        return collectives.psum([mlp(p, h, cfg) for p, h in zip(ps, hs)], list(devs))
    w = _whole_tree(ps, dims, devs[0])
    return collectives.broadcast(mlp(w, hs[0], cfg), devs)


def vocab_offset(m: int, block: int) -> int:
    """The first vocabulary row of model slot ``m``'s block of ``block`` rows."""
    return m * block


def embed_row(ps: list, dims: dict, tokens: torch.Tensor, cfg: ModelConfig, devs,
              prefix: Optional[torch.Tensor] = None) -> list:
    """:func:`embed` (and a VLM's ``prefix`` before it) on every model slot
    of a data slot, each slot's copy of the rows: a table split over the
    vocabulary looks up the tokens in each slot's range, the others zeroed,
    and all-reduces; a table split over ``d_model`` (a vocabulary the model
    axis does not divide) looks up its columns and all-gathers them; a
    replicated table is read on each slot."""
    from ..launch import collectives

    dt = cfg.torch_dtype
    if len(devs) == 1:
        x = embed(ps[0]["embed"], tokens, cfg)
        xs = [x]
        pes = [prefix]
    else:
        toks = collectives.broadcast(tokens, devs)
        pes = collectives.broadcast(prefix, devs) if prefix is not None else [None] * len(devs)
        dim = dims["embed"]["tok"]
        tabs = [p["embed"]["tok"].to(dt) for p in ps]
        if dim == 0:
            rows = tabs[0].shape[0]
            parts = []
            for m, (tab, t) in enumerate(zip(tabs, toks)):
                local = t.long() - vocab_offset(m, rows)
                inside = (local >= 0) & (local < rows)
                e = tab[local.clamp(0, rows - 1)]
                parts.append(torch.where(inside[..., None], e, torch.zeros((), dtype=dt,
                                                                            device=e.device)))
            xs = collectives.psum(parts, list(devs))
        elif dim == 1:
            xs = collectives.all_gather([tab[t.long()] for tab, t in zip(tabs, toks)], -1, devs)
        else:
            xs = [tab[t.long()] for tab, t in zip(tabs, toks)]
    if pes[0] is None:
        return xs
    return [torch.cat([pe.to(x.dtype), x], dim=1) for pe, x in zip(pes, xs)]


class SlotLogits(NamedTuple):
    """One data slot's logits over its model slots.  ``kind`` ``"vocab"``:
    ``parts[m]`` holds the columns of model slot ``m``'s vocabulary block
    (:func:`vocab_offset`); ``"seq"``: ``parts[m]`` the whole vocabulary at
    model slot ``m``'s block of positions; ``"one"``: ``parts[0]`` whole, on
    model slot 0."""
    kind: str
    parts: list


def unembed_row(ps: list, dims: dict, hs: list, cfg: ModelConfig, devs) -> SlotLogits:
    """:func:`unembed` over a data slot's model slots (``hs[m]`` slot ``m``'s
    copy of the final hidden rows): a weight split over the vocabulary
    leaves each slot its columns of the logits, so no slot holds a full
    row; one split over ``d_model`` gives partial logits, reduce-scattered
    over the positions (summed onto model slot 0 where the model axis does
    not divide them); a replicated one is applied on model slot 0."""
    from ..launch import collectives

    if len(devs) == 1:
        return SlotLogits("one", [unembed(ps[0]["embed"], hs[0], cfg)])
    dt = hs[0].dtype
    if cfg.tie_embeddings:
        ws = [p["embed"]["tok"].to(dt).T for p in ps]
        dim = dims["embed"]["tok"]
        dim = None if dim is None else 1 - dim
    else:
        ws = [p["embed"]["unembed"].to(dt) for p in ps]
        dim = dims["embed"]["unembed"]
    M = len(devs)
    if dim == 1:
        return SlotLogits("vocab", [h @ w for h, w in zip(hs, ws)])
    if dim == 0:
        partial = [torch.chunk(h, M, dim=-1)[m] @ w for m, (h, w) in enumerate(zip(hs, ws))]
        if hs[0].shape[1] % M == 0:
            return SlotLogits("seq", collectives.reduce_scatter(partial, 1, devs))
        return SlotLogits("one", [collectives.psum(partial, devs[0])])
    return SlotLogits("one", [hs[0] @ ws[0]])


def gather_logits(lg: SlotLogits, device) -> torch.Tensor:
    """A data slot's logits whole on ``device``."""
    from ..launch import collectives

    if lg.kind == "vocab":
        return collectives.gather_to(lg.parts, -1, device)
    if lg.kind == "seq":
        return collectives.gather_to(lg.parts, 1, device)
    return collectives.gather_to(lg.parts, 0, device)
