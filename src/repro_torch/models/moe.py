"""Mixture-of-Experts FFN with sort-based token dispatch (the port of the
reference's ``models/moe.py``).

Dispatch is capacity-bounded and sort-based: the (token, choice) pairs are
sorted by expert id (a stable sort), ranked within their expert, and
scattered into dense (E, C, d) buffers, so the expert compute is three
batched products over active experts only; pairs beyond an expert's
capacity C are dropped (zeroed).  The combine gathers each pair's expert
output back through the inverse permutation.  Arctic's "dense residual"
(a standard MLP beside the experts) is summed at the output.

Routing is the reference's to the bit where the router products are:
  - the router runs in float32 (its weight is held in float32 at load,
    :data:`KEEP_FLOAT32`, and cast at use as the reference casts it);
  - the top k break ties by the lower expert index, as ``jax.lax.top_k``
    does (:func:`top_k`; ``torch.topk`` does not);
  - the capacity is ``max(1, ceil(n * k / E * capacity_factor))`` in the
    reference's order of operations;
  - a dropped pair is zeroed but still lands on slot ``C - 1`` of its
    expert, where a kept pair may sit, so the buffer fill accumulates
    (``index_add_``) instead of overwriting.

The tokens split into one dispatch group per data slot of the ambient mesh
where that divides the batch (``_moe_groups``; one group without a mesh).
With ``cfg.moe_shard_map`` each data slot dispatches its own groups on its
device (the reference's ``shard_map`` branch), else one dispatch runs over
all the groups with the rows gathered (its GSPMD branch).  Dropping is per
group, so at a low capacity factor the drops of G groups differ from one
group's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..launch import collectives
from ..launch.mesh import data_axis_size
from .common import ModelConfig, abstract_mesh
from .layers import dense_init, init_mlp, mlp

__all__ = ["KEEP_FLOAT32", "Routing", "init_moe", "moe_ffn", "moe_ffn_slots", "moe_ffn_tokens",
           "route", "top_k"]

# weights a serving load keeps in float32: the reference casts the router to
# float32 at each use, which a bf16 copy could not give back
KEEP_FLOAT32 = frozenset({"router"})


def init_moe(gen: torch.Generator, cfg: ModelConfig, lead: tuple = ()) -> dict:
    """``lead`` prepends axes (the stacked layer axis) to every weight."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    pdt = cfg.torch_param_dtype
    p = {
        "router": dense_init(gen, lead + (d, E), pdt),
        "wi": dense_init(gen, lead + (E, d, f), pdt, fan_in=d),
        "wg": dense_init(gen, lead + (E, d, f), pdt, fan_in=d),
        "wo": dense_init(gen, lead + (E, f, d), pdt, fan_in=f),
    }
    if cfg.dense_residual:
        p["dense"] = init_mlp(gen, cfg, d_ff=cfg.d_ff, lead=lead)
    return p


def top_k(x: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the ``k`` largest entries of the last axis, in
    descending order, a tie broken by the lower index (``jax.lax.top_k``'s
    order): a stable descending sort keeps equal values in index order."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class Routing(NamedTuple):
    """One dispatch's routing, over (G, n) token groups with k choices each."""
    logits: torch.Tensor     # (G, n, E) float32 router products
    top_ids: torch.Tensor    # (G, n, k) chosen experts, best first
    weights: torch.Tensor    # (G, n, k) softmax over the chosen logits, x's dtype
    aux: torch.Tensor        # () Switch load-balance loss
    order: torch.Tensor      # (G, nk) stable sort of the pairs by expert
    keep: torch.Tensor       # (G, nk) sorted pair within its expert's capacity
    r_idx: torch.Tensor      # (G, nk) sorted pair's slot in its expert's buffer
    capacity: int


def route(flat: torch.Tensor, router: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The router and the sort-based dispatch plan of ``flat`` (G, n, d)."""
    G, n, _ = flat.shape
    E, k = cfg.n_experts, cfg.top_k
    nk = n * k
    C = max(1, int(math.ceil(n * k / E * cfg.capacity_factor)))

    logits = flat.float() @ router.float()                           # (G, n, E)
    probs_full = torch.softmax(logits, dim=-1)
    top_logits, top_ids = top_k(logits, k)                           # (G, n, k)
    weights = torch.softmax(top_logits, dim=-1).to(flat.dtype)      # mixtral convention

    # Load-balance aux loss (Switch): E * sum_e f_e * P_e
    me = torch.mean(probs_full, dim=(0, 1))
    # one-hot by comparison: F.one_hot reads its input on the CPU (a min/max
    # check) and takes another formula on meta tensors, so the op analysis
    # of a dry run would differ from a real run's
    first = top_ids[..., 0, None] == torch.arange(E, device=top_ids.device)
    ce = torch.mean(first.float(), dim=(0, 1))
    aux = E * torch.sum(me * ce)

    eids = top_ids.reshape(G, nk)
    order = torch.argsort(eids, dim=-1, stable=True)                 # (G, nk)
    e_sorted = torch.gather(eids, -1, order)
    # counts per expert from the sorted rows: binary search
    bounds = torch.arange(E + 1, device=flat.device).expand(G, E + 1).contiguous()
    offsets = torch.searchsorted(e_sorted, bounds, side="left")[:, :-1]   # (G, E)
    rank = torch.arange(nk, device=flat.device)[None] - torch.gather(offsets, -1, e_sorted)
    keep = rank < C
    return Routing(logits, top_ids, weights, aux, order, keep,
                   torch.clamp(rank, max=C - 1), C)


def _grouped_dispatch(params: dict, flat: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Dispatch + expert compute for (G, n, d) token groups -> (y, aux)."""
    G, n, d = flat.shape
    E, k = cfg.n_experts, cfg.top_k
    dt = flat.dtype
    nk = n * k
    r = route(flat, params["router"], cfg)
    C = r.capacity
    token_of = torch.arange(n, device=flat.device).repeat_interleave(k).expand(G, nk)
    e_sorted = torch.gather(r.top_ids.reshape(G, nk), -1, r.order)
    tok_sorted = torch.gather(token_of, -1, r.order)

    gathered = torch.gather(flat, 1, tok_sorted[..., None].expand(G, nk, d))
    gathered = gathered * r.keep[..., None].to(dt)                  # (G, nk, d)

    # one scatter, group-major; a dropped pair adds its zeros on slot C - 1
    loc_sorted = e_sorted * C + r.r_idx                              # (G, nk)
    gidx = (torch.arange(G, device=flat.device)[:, None] * (E * C) + loc_sorted).reshape(-1)
    buf = torch.zeros((G * E * C, d), dtype=dt, device=flat.device)
    buf.index_add_(0, gidx, gathered.reshape(G * nk, d))
    buf = buf.reshape(G, E, C, d)

    # expert compute (explicit G dim)
    h = torch.einsum("gecd,edf->gecf", buf, params["wi"].to(dt))
    g = torch.einsum("gecd,edf->gecf", buf, params["wg"].to(dt))
    h = F.silu(g) * h
    out = torch.einsum("gecf,efd->gecd", h, params["wo"].to(dt))

    # scatter-free combine: inverse-permutation gathers
    inv_order = torch.argsort(r.order, dim=-1)                       # (G, nk)
    loc = torch.gather(loc_sorted, -1, inv_order)                    # pair order
    keep_pair = torch.gather(r.keep, -1, inv_order)
    back = torch.gather(out.reshape(G, E * C, d), 1, loc[..., None].expand(G, nk, d))
    back = back * (r.weights.reshape(G, nk) * keep_pair.to(dt))[..., None]
    y = back.reshape(G, n, k, d).sum(dim=2)                          # (G, n, d)
    return y, r.aux


def _moe_groups(N: int, E: int, B: int) -> int:
    """Number of dispatch groups: one per data slot of the ambient mesh
    when that divides the batch, halved while a group would feed an expert
    fewer than 2 tokens on average (the reference's rule)."""
    mesh = abstract_mesh()
    G = 1 if mesh is None else data_axis_size(mesh)
    while G > 1 and (B % G or (N // G) < 2 * E):
        G //= 2
    return max(G, 1)


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple:
    """x: (B, S, d) -> (y, aux_loss).  Under an ambient mesh the rows split
    over its data slots where their count divides the batch
    (:func:`moe_ffn_slots`), and the output is gathered back onto x's
    device."""
    B, S, d = x.shape
    mesh = abstract_mesh()
    if mesh is None:
        y, aux = _grouped_dispatch(params, x.reshape(1, B * S, d), cfg)
        y = y.reshape(B, S, d)
        if cfg.dense_residual:
            y = y + mlp(params["dense"], x, cfg)
        return y, aux
    devices = mesh.row_devices(B)
    ys, aux = moe_ffn_slots(collectives.broadcast_tree(params, devices),
                            collectives.scatter(x, 0, devices), cfg)
    return collectives.gather_to(ys, 0, x.device), aux.to(x.device)


def _staged(w: torch.Tensor, done: dict) -> torch.Tensor:
    """A bf16 expert weight widened to float32 once per tensor (the
    reference stages them so that its boundary gradient sum runs in
    float32); others as they are."""
    if w.dtype != torch.bfloat16:
        return w
    if id(w) not in done:
        done[id(w)] = w.float()
    return done[id(w)]


def moe_ffn_slots(params_slots: list, xs: list, cfg: ModelConfig) -> tuple:
    """The MoE under the ambient mesh over rows held per data slot:
    ``xs[j]`` (B_j, S, d) on data slot ``j``'s device with its parameter
    tree ``params_slots[j]`` (each slot's own copy in the mesh train step).
    Returns (each slot's output, the aux loss on the first slot's device).

    With ``cfg.moe_shard_map``, the rows over every data slot and the group
    count a multiple of the slots', each slot dispatches its own groups on
    its device with its weights staged through float32, and the aux loss is
    the slots' summed in order over their count (the reference's
    ``shard_map`` branch; under ``fsdp_params`` the trees are the weights
    gathered at use).  Otherwise the rows are gathered onto the first slot
    and dispatched there in all G groups with its tree, and each slot gets
    its rows back."""
    mesh = abstract_mesh()
    S, d = xs[0].shape[1:]
    B = sum(x.shape[0] for x in xs)
    N, E = B * S, cfg.n_experts
    G = _moe_groups(N, E, B)
    n = N // G
    dsize = data_axis_size(mesh)
    devices = [x.device for x in xs]
    if cfg.moe_shard_map and dsize > 1 and G % dsize == 0 and len(xs) == dsize:
        done, ys, auxes = {}, [], []
        for p, x in zip(params_slots, xs):
            cap = {kk: _staged(p[kk], done) for kk in ("router", "wi", "wg", "wo")}
            y, a = _grouped_dispatch(cap, x.reshape(G // dsize, n, d), cfg)
            ys.append(y.reshape(x.shape))
            auxes.append(a)
        aux = collectives.psum(auxes, devices[0]) / dsize
    else:
        flat = collectives.gather_to(xs, 0, devices[0]).reshape(G, n, d)
        y, aux = _grouped_dispatch(params_slots[0], flat, cfg)
        ys = collectives.scatter(y.reshape(B, S, d), 0, devices)
    if cfg.dense_residual:
        ys = [y + mlp(p["dense"], x, cfg) for y, p, x in zip(ys, params_slots, xs)]
    return ys, aux


def moe_ffn_tokens(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Decode-friendly MoE for small N (B tokens): per-token expert gather,
    no capacity and no drops.  The reference defines it and calls it
    nowhere; the port keeps it, equally off the path."""
    B, S, d = x.shape
    N = B * S
    dt = x.dtype
    flat = x.reshape(N, d)
    logits = flat.float() @ params["router"].float()
    top_logits, top_ids = top_k(logits, cfg.top_k)
    weights = torch.softmax(top_logits, dim=-1).to(dt)              # (N, k)
    wi = params["wi"].to(dt)[top_ids]                                # (N, k, d, f)
    wg = params["wg"].to(dt)[top_ids]
    wo = params["wo"].to(dt)[top_ids]                                # (N, k, f, d)
    h = torch.einsum("nd,nkdf->nkf", flat, wi)
    g = torch.einsum("nd,nkdf->nkf", flat, wg)
    h = F.silu(g) * h
    out = torch.einsum("nkf,nkfd->nkd", h, wo)
    y = torch.einsum("nkd,nk->nd", out, weights).reshape(B, S, d)
    if cfg.dense_residual:
        y = y + mlp(params["dense"], x, cfg)
    return y
