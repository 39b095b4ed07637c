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

The reference splits the tokens into one dispatch group per data shard of
its mesh (``_moe_groups``); one card has one shard, so the port dispatches
one group (the mesh is ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import ModelConfig
from .layers import dense_init, init_mlp, mlp

__all__ = ["KEEP_FLOAT32", "Routing", "init_moe", "moe_ffn", "moe_ffn_tokens", "route",
           "top_k"]

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
    ce = torch.mean(F.one_hot(top_ids[..., 0], E).float(), dim=(0, 1))
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


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple:
    """x: (B, S, d) -> (y, aux_loss)."""
    B, S, d = x.shape
    # one dispatch group per data shard of the mesh: one card is one shard
    y, aux = _grouped_dispatch(params, x.reshape(1, B * S, d), cfg)
    y = y.reshape(B, S, d)
    if cfg.dense_residual:
        y = y + mlp(params["dense"], x, cfg)
    return y, aux


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
