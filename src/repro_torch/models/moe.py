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

:func:`moe_ffn_grid` adds the ``model`` axis (the transformer's mesh
forward and train step): where the experts divide it, each model slot
dispatches the data slot's groups to its own experts; else ``param_specs``
splits each expert's ``ff`` and each model slot runs every expert on its
columns.  Either way a slot's combine is a partial sum, all-reduced over
the model slots in order.  The router is replicated, so every model slot
routes alike; the aux loss is taken from model slot 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..launch import collectives
from ..launch.mesh import data_axis_size
from .common import ModelConfig, abstract_mesh
from .layers import _whole_tree, dense_init, init_mlp, mlp, mlp_row, row_spread, row_sum

__all__ = ["KEEP_FLOAT32", "Routing", "init_moe", "moe_ffn", "moe_ffn_grid", "moe_ffn_slots",
           "moe_ffn_tokens", "route", "top_k"]

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


def _grouped_dispatch(params: dict, flat: torch.Tensor, cfg: ModelConfig,
                      expert0=None) -> tuple:
    """Dispatch + expert compute for (G, n, d) token groups -> (y, aux).
    With ``expert0`` the expert weights are the ``E_loc`` experts from
    ``expert0`` on (one model slot's): pairs routed elsewhere are dropped
    from this slot's buffers and combine, so ``y`` is the slot's part."""
    G, n, d = flat.shape
    E, k = cfg.n_experts, cfg.top_k
    dt = flat.dtype
    nk = n * k
    r = route(flat, params["router"], cfg)
    C = r.capacity
    token_of = torch.arange(n, device=flat.device).repeat_interleave(k).expand(G, nk)
    e_sorted = torch.gather(r.top_ids.reshape(G, nk), -1, r.order)
    tok_sorted = torch.gather(token_of, -1, r.order)
    keep = r.keep
    if expert0 is not None:
        E = params["wi"].shape[0]
        keep = keep & (e_sorted >= expert0) & (e_sorted < expert0 + E)
        e_sorted = (e_sorted - expert0).clamp(0, E - 1)

    gathered = torch.gather(flat, 1, tok_sorted[..., None].expand(G, nk, d))
    gathered = gathered * keep[..., None].to(dt)                    # (G, nk, d)

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
    keep_pair = torch.gather(keep, -1, inv_order)
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
    float32); others as they are.  Without autograd, views of the same
    memory (data slots sharing a card) share one widened copy."""
    if w.dtype != torch.bfloat16:
        return w
    key = id(w) if w.is_meta or torch.is_grad_enabled() else \
        (w.device, w.data_ptr(), w.storage_offset(), tuple(w.shape), w.stride())
    if key not in done:
        done[key] = w.float()
    return done[key]


def moe_ffn_slots(params_slots: list, xs: list, cfg: ModelConfig) -> tuple:
    """The MoE under the ambient mesh over rows held per data slot:
    ``xs[j]`` (B_j, S, d) on data slot ``j``'s device with a whole
    parameter tree ``params_slots[j]`` (:func:`moe_ffn` broadcasts its
    caller's; the transformer's mesh paths take :func:`moe_ffn_grid`).
    Returns (each slot's output, the aux loss on the first slot's device).

    With ``cfg.moe_shard_map``, the rows over every data slot and the group
    count a multiple of the slots', each slot dispatches its own groups on
    its device with its weights staged through float32, and the aux loss is
    the slots' summed in order over their count (the reference's
    ``shard_map`` branch).  Otherwise the rows are gathered onto the first
    slot and dispatched there in all G groups with its tree, and each slot
    gets its rows back."""
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


def _per_data_slot(cfg: ModelConfig, rows: int, seq: int, n_data: int) -> tuple:
    """(groups G, whether each data slot dispatches its own G / dsize) for a
    batch of ``rows`` x ``seq`` tokens over ``n_data`` computing data slots
    of the ambient mesh (the branch :func:`moe_ffn_slots` takes)."""
    dsize = data_axis_size(abstract_mesh())
    G = _moe_groups(rows * seq, cfg.n_experts, rows)
    return G, bool(cfg.moe_shard_map and dsize > 1 and G % dsize == 0 and n_data == dsize)


def per_data_slot(cfg: ModelConfig, rows: int, seq: int) -> bool:
    """Whether, under the ambient mesh, every data slot that takes rows
    dispatches its own (so the data slots compute independently): the
    ``shard_map`` branch, or rows on one data slot only."""
    n = len(abstract_mesh().row_devices(rows))
    return n == 1 or _per_data_slot(cfg, rows, seq, n)[1]


def moe_ffn_grid(ps: list, dims: dict, hs: list, cfg: ModelConfig, n_data: int,
                 data_slots: list, seq_out: bool = False) -> tuple:
    """The MoE of the transformer's mesh forward over the grid of computing
    data slots ``data_slots`` (of ``n_data`` that take rows) and their model
    slots: ``hs[jj][m]`` model slot ``m``'s copy of data slot
    ``data_slots[jj]``'s rows, ``ps[jj][m]`` its block of the layer's MoE
    weights, ``dims`` the dims split over ``model``.  Returns (each slot's
    output, each data slot's aux loss on its first model slot's device).

    The groups follow :func:`moe_ffn_slots`: with its ``shard_map`` branch
    each data slot dispatches its own G / dsize groups and its aux is its
    own over dsize; otherwise every data slot's rows are gathered per model
    slot onto the first data slot, dispatched in all G groups there and
    scattered back, and the aux is data slot 0's.  Per model slot: where
    ``param_specs`` splits the experts, slot ``m`` dispatches to its block
    of them; where it splits each expert's ``ff``, to every expert on its
    columns; the slots' combines are partial sums, all-reduced in model-slot
    order (with ``seq_out`` reduce-scattered over the positions, each slot
    its block: :func:`.layers.row_sum`).  A layout that splits neither runs
    whole on model slot 0.  bf16
    expert weights are staged through float32, as :func:`moe_ffn_slots`
    stages them.  Arctic's dense residual is :func:`layers.mlp_row`."""
    mesh = abstract_mesh()
    M = len(ps[0])
    rows, S, d = hs[0][0].shape
    G, own = _per_data_slot(cfg, rows * n_data, S, n_data)
    dsize = data_axis_size(mesh)
    devs = [mesh.model_devices(j) for j in data_slots]
    split = M > 1 and dims["wi"] in (0, 2)
    keys = ("router", "wi", "wg", "wo")
    done = {}

    def experts(prow, dev) -> list:
        """The expert trees each model slot dispatches with: its own
        blocks, or the layer's whole on model slot 0."""
        if split:
            return prow
        return [_whole_tree([{k: q[k] for k in keys} for q in prow],
                            {k: dims[k] for k in keys}, dev)]

    def dispatch(p, x, m, groups) -> tuple:
        cap = {k: _staged(p[k], done) for k in keys}
        e0 = m * cap["wi"].shape[0] if split and dims["wi"] == 0 else None
        y, a = _grouped_dispatch(cap, x.reshape(groups, -1, d), cfg, e0)
        return y.reshape(x.shape), a

    def reduce(parts, dv) -> list:
        if split:
            return row_sum(parts, dv, seq_out)
        return parts if M == 1 else row_spread(parts[0], dv, seq_out)

    if own:
        ys, auxes = [], []
        for prow, hrow, dv in zip(ps, hs, devs):
            outs = [dispatch(p, h, m, G // dsize)
                    for m, (p, h) in enumerate(zip(experts(prow, dv[0]), hrow))]
            ys.append(reduce([y for y, _ in outs], dv))
            auxes.append(outs[0][1] / dsize)
    else:
        scattered, aux = [], None
        for m, p in enumerate(experts(ps[0], devs[0][0])):
            flat = collectives.gather_to([hrow[m] for hrow in hs], 0, devs[0][m])
            y, a = dispatch(p, flat, m, G)
            scattered.append(collectives.scatter(y, 0, [dv[m] for dv in devs]))
            aux = a if aux is None else aux
        ys = [reduce([part[jj] for part in scattered], dv) for jj, dv in enumerate(devs)]
        auxes = [aux] + [torch.zeros((), dtype=torch.float32, device=dv[0]) for dv in devs[1:]]
    if cfg.dense_residual:
        ys = [[y + r for y, r in zip(yrow, mlp_row([p["dense"] for p in prow], dims["dense"],
                                                   hrow, cfg, dv, seq_out))]
              for yrow, prow, hrow, dv in zip(ys, ps, hs, devs)]
    return ys, auxes


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
