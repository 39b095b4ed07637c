"""Attention: GQA, qk-norm, biases, sliding windows, KV caches (the port of
the reference's ``models/attention.py``).

Full-sequence attention takes the flash kernel (:mod:`repro_torch.kernels`)
where the reference takes its Pallas kernel, the plain einsum softmax where
the reference does, and otherwise (long sequences without kernels: training,
and prefill at any setting) the reference's blocked attention: an online
softmax per query block over the static list of key blocks in its causal /
sliding-window band, in plain PyTorch (the reference computes it outside any
Pallas kernel).  Under an ambient mesh whose ``model`` axis the head count
does not divide, blocked attention goes sequence-parallel, as the
reference's does (:func:`seq_parallel_attention`): each ``model`` slot of the
data slot being computed owns a contiguous query chunk, K and V are
all-gathered once in float32, and each slot scans its rectangle of block
pairs on its device.  Decode runs one token against a ring-buffered KV
cache, which :func:`cache_from_prefill` builds from a prefill's keys and
values.

:func:`attention_row` is the attention of one data slot over its model
slots (causal or bidirectional self-attention, or cross-attention over each
slot's copy of other rows), tensor-parallel where the head count divides
the model axis: slot
``m`` takes query heads ``[m H/M, (m+1) H/M)`` and the K/V heads they read
(its own block where ``param_specs`` splits the K/V heads; where it splits
their ``head_dim`` instead, the slot all-gathers over ``model`` only the
columns of the heads it reads, :func:`kv_heads`), and its ``wo`` block gives
a partial sum, all-reduced in model-slot order.  Where the heads do not
divide the axis, model slot 0 takes the layer's projections whole (one
layer's, freed after it) and runs :func:`attention`, sequence-parallel over
the model slots under the reference's condition, and broadcasts.

:func:`decode_attention_row` is one data slot's one-token attention over its
model slots against a cache left where ``state_specs`` places it (the
blocks of :class:`repro_torch.models.sharding.StateBlocks`, read and written
in place; nothing of the cache moves).  Its layout follows the cache's
``model`` split (:func:`decode_layout`): whole K/V heads per model slot
(``heads``: each slot projects its heads and runs the decode-attention
kernel on them), or each head's ``head_dim`` columns per model slot
(``cols``: the per-token q and new k are all-gathered whole over the model
slots for qk-norm and RoPE, each slot's partial scores over its columns are
all-reduced in float32 in slot order, and each slot applies the softmax to
its V columns; the kernel's whole-head contract cannot hold there, so that
attention is plain PyTorch).  Where the cache length is split over the data
slots (a batch the data axes do not divide), only the data slot whose block
holds ring slot ``pos % C`` writes the new token, every data slot computes
its partial attention and log-sum-exp over its slice, and the partials are
merged by their weights onto the data slot that carries the row.
:func:`cross_attention_row` is the enc-dec decode's cross attention over a
static K/V placed the same way (whole heads, or head-dim columns with
float32 score all-reduces; frames split over the data slots merged by
their log-sum-exps), which writes nothing.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..launch import collectives
from .common import ModelConfig, abstract_mesh, data_slot
from .layers import _whole_tree, apply_rope, dense_init, rms_norm

__all__ = ["CacheSlice", "KVCache", "attention", "attention_row", "blocked_attention",
           "cache_from_prefill", "core_attention", "cross_attention_row", "decode_attention_layer",
           "decode_attention_row", "decode_attention_step", "decode_cache_slices", "decode_cols",
           "decode_layout", "heads_parallel",
           "init_attention", "init_cache", "kv_heads", "merge_partials", "plain_attention",
           "prefill_cache_kv", "read_pos", "seq_parallel_attention"]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, lead: tuple = ()) -> dict:
    """``lead`` prepends axes (the stacked layer axis) to every weight."""
    H, K, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    pdt = cfg.torch_param_dtype
    dev = gen.device
    p = {
        "wq": dense_init(gen, lead + (d, H, hd), pdt, fan_in=d),
        "wk": dense_init(gen, lead + (d, K, hd), pdt, fan_in=d),
        "wv": dense_init(gen, lead + (d, K, hd), pdt, fan_in=d),
        "wo": dense_init(gen, lead + (H, hd, d), pdt, fan_in=H * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (H, hd), dtype=pdt, device=dev)
        p["bk"] = torch.zeros(lead + (K, hd), dtype=pdt, device=dev)
        p["bv"] = torch.zeros(lead + (K, hd), dtype=pdt, device=dev)
    if cfg.qk_norm:
        p["q_scale"] = torch.ones(lead + (hd,), dtype=pdt, device=dev)
        p["k_scale"] = torch.ones(lead + (hd,), dtype=pdt, device=dev)
    return p


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(params, x, kv_x, cfg: ModelConfig, positions, kv_positions,
                 rope: bool = True):
    dt = x.dtype
    q = _proj(x, params["wq"].to(dt))
    k = _proj(kv_x, params["wk"].to(dt))
    v = _proj(kv_x, params["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_scale"], cfg.norm_eps)
        k = rms_norm(k, params["k_scale"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _out_proj(out, wo):
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.reshape(h * k, d)


# ---------------------------------------------------------------------------
# Plain attention (short sequences)
# ---------------------------------------------------------------------------

def plain_attention(q, k, v, *, causal: bool, window: Optional[int],
                    q_positions=None, k_positions=None) -> torch.Tensor:
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    q5 = q.reshape(B, S, K, G, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q5.float(), k.float()) * scale
    if causal or window is not None:
        pq = q_positions if q_positions is not None else torch.arange(S, device=q.device)
        pk = k_positions if k_positions is not None else torch.arange(T, device=q.device)
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
        if causal:
            mask &= pq[:, None] >= pk[None, :]
        if window is not None:
            mask &= pq[:, None] - pk[None, :] < window
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


# ---------------------------------------------------------------------------
# Blocked attention with a static block-pair schedule
# ---------------------------------------------------------------------------

def _block_pairs(nq: int, nk: int, bq: int, bk: int, causal: bool,
                 window: Optional[int]) -> list:
    """Static (qi, ki) schedule: only blocks intersecting the visibility band."""
    pairs = []
    for qi in range(nq):
        q_lo, q_hi = qi * bq, qi * bq + bq - 1
        for ki in range(nk):
            k_lo, k_hi = ki * bk, ki * bk + bk - 1
            if causal and k_lo > q_hi:
                continue  # entirely in the future
            if window is not None and k_hi < q_lo - window + 1:
                continue  # entirely outside the window
            pairs.append((qi, ki))
    return pairs


def _mesh_model_size() -> int:
    mesh = abstract_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return mesh.shape["model"]


def _slot_attention(q_l, kf, vf, q_off: int, *, causal: bool, window: Optional[int],
                    block_q: int, block_k: int) -> torch.Tensor:
    """One ``model`` slot's part of :func:`seq_parallel_attention`: queries
    ``q_l`` (B,K,G,S_loc,hd) at absolute offset ``q_off`` against the whole
    float32 ``kf``/``vf`` (B,T,K,hd), every (query block, key block) pair in
    order (the rectangle: the schedule is not pruned per slot), masked by
    absolute position; returns (B,K,G,S_loc,hd) in q's dtype."""
    B, K, G, S_loc, hd = q_l.shape
    T = kf.shape[1]
    dev = q_l.device
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for qs in range(0, S_loc, block_q):
        qb = q_l[:, :, :, qs:qs + block_q].float()
        m = torch.full((B, K, G, block_q), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, K, G, block_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, K, G, block_q, hd), dtype=torch.float32, device=dev)
        pq = q_off + qs + torch.arange(block_q, device=dev)
        for ks in range(0, T, block_k):
            s_blk = torch.einsum("bkgqh,btkh->bkgqt", qb, kf[:, ks:ks + block_k]) * scale
            pk = ks + torch.arange(block_k, device=dev)
            mask = torch.ones((block_q, block_k), dtype=torch.bool, device=dev)
            if causal:
                mask &= pq[:, None] >= pk[None, :]
            if window is not None:
                mask &= pq[:, None] - pk[None, :] < window
            s_blk = torch.where(mask, s_blk, NEG_INF)
            m_blk = s_blk.amax(dim=-1)
            p_blk = torch.exp(s_blk - m_blk[..., None])
            l_blk = p_blk.sum(dim=-1)
            a_blk = torch.einsum("bkgqt,btkh->bkgqh", p_blk, vf[:, ks:ks + block_k])
            m_new = torch.maximum(m, m_blk)
            alpha = torch.exp(m - m_new)
            beta = torch.exp(m_blk - m_new)
            l = alpha * l + beta * l_blk
            acc = alpha[..., None] * acc + beta[..., None] * a_blk
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        outs.append(acc / l[..., None])
    return torch.cat(outs, dim=3).to(q_l.dtype)


def seq_parallel_attention(q, k, v, *, causal: bool, window: Optional[int],
                           block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Sequence-parallel blocked attention over the ambient mesh's ``model``
    axis (the reference's ``shard_map`` over 'model'), for head counts that
    do not divide that axis (56, 40, 20 heads on a 16-way axis).  Model
    slot ``m`` of the data slot being computed owns the queries
    ``[m * S_loc, (m + 1) * S_loc)``; K and V go through float32 and are
    all-gathered once; each slot scans its rectangle ``S_loc x T`` of block
    pairs (twice the causal triangle's work) on its device; the slots'
    outputs are gathered back onto q's device.  Plain PyTorch and
    differentiable."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    mesh = abstract_mesh()
    devices = mesh.model_devices(data_slot()) if mesh is not None else (q.device,)
    S_loc = S // len(devices)
    q5 = q.reshape(B, S, K, G, hd).permute(0, 2, 3, 1, 4)        # (B,K,G,S,hd)
    q_parts = collectives.scatter(q5, 3, devices)
    kf = collectives.all_gather(collectives.scatter(k.float(), 1, devices), 1)
    vf = collectives.all_gather(collectives.scatter(v.float(), 1, devices), 1)
    outs = [_slot_attention(q_parts[m], kf[m], vf[m], m * S_loc, causal=causal, window=window,
                            block_q=block_q, block_k=block_k) for m in range(len(devices))]
    out = collectives.gather_to(outs, 3, q.device)                # (B,K,G,S,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def blocked_attention(q, k, v, *, causal: bool, window: Optional[int],
                      block_q: int = 512, block_k: int = 512,
                      sequence_parallel: bool = True) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: each query block runs an
    online softmax with a block-sized float32 carry over its own in-band key
    blocks, so memory stays one (block_q x block_k) score block per step and
    causal / sliding-window pruning is exact.  Differentiable (training runs
    it under autograd).  Falls back to :func:`plain_attention` when the
    sequence lengths are not whole blocks, as the reference does; under an
    ambient mesh whose ``model`` axis the head count does not divide, goes
    sequence-parallel under the reference's condition (not where the caller
    already holds one model slot's heads, ``sequence_parallel=False``)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if S % block_q or T % block_k:
        return plain_attention(q, k, v, causal=causal, window=window)
    msize = _mesh_model_size() if sequence_parallel else 1
    if msize > 1 and H % msize != 0 and S == T and S % msize == 0 \
            and (S // msize) % 128 == 0:
        # head count does not divide the model axis: go sequence-parallel
        return seq_parallel_attention(q, k, v, causal=causal, window=window,
                                      block_q=min(block_q, S // msize), block_k=block_k)
    pairs_by_q: dict = {}
    for qi, ki in _block_pairs(S // block_q, T // block_k, block_q, block_k, causal,
                               window):
        pairs_by_q.setdefault(qi, []).append(ki)

    q5 = q.reshape(B, S, K, G, hd).permute(0, 2, 3, 1, 4)        # (B,K,G,S,hd)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    def run_qblock(qi: int, kis: list) -> torch.Tensor:
        qs = qi * block_q
        qb = q5[:, :, :, qs:qs + block_q].float()                 # (B,K,G,bq,hd)
        m = torch.full((B, K, G, block_q), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, K, G, block_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, K, G, block_q, hd), dtype=torch.float32, device=dev)
        pq = qs + torch.arange(block_q, device=dev)
        for ki in kis:
            ks = ki * block_k
            kb = k[:, ks:ks + block_k].float()
            vb = v[:, ks:ks + block_k].float()
            s_blk = torch.einsum("bkgqh,btkh->bkgqt", qb, kb) * scale   # (B,K,G,bq,bk)
            pk = ks + torch.arange(block_k, device=dev)
            mask = torch.ones((block_q, block_k), dtype=torch.bool, device=dev)
            if causal:
                mask &= pq[:, None] >= pk[None, :]
            if window is not None:
                mask &= pq[:, None] - pk[None, :] < window
            s_blk = torch.where(mask, s_blk, NEG_INF)
            m_blk = s_blk.amax(dim=-1)
            p_blk = torch.exp(s_blk - m_blk[..., None])
            m_new = torch.maximum(m, m_blk)
            alpha = torch.exp(m - m_new)
            beta = torch.exp(m_blk - m_new)
            l = alpha * l + beta * p_blk.sum(dim=-1)
            a_blk = torch.einsum("bkgqt,btkh->bkgqh", p_blk, vb)
            acc = alpha[..., None] * acc + beta[..., None] * a_blk
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        return acc / l[..., None]                                   # (B,K,G,bq,hd)

    out = torch.cat([run_qblock(qi, pairs_by_q[qi]) for qi in sorted(pairs_by_q)],
                    dim=3)                                          # (B,K,G,S,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Full-sequence attention entry point (train / prefill)
# ---------------------------------------------------------------------------

def core_attention(q, k, v, cfg: ModelConfig, *, causal: bool = True, window=None,
                   prefill: bool = False, sequence_parallel: bool = True):
    """The route of :func:`attention` (the flash kernel where its gate
    passes under ``use_pallas``, plain attention up to S = 2048, blocked
    above) or, with ``prefill``, of a prefill (plain up to S = 2048,
    blocked above; never flash, as in the reference)."""
    S, T = q.shape[1], k.shape[1]
    if prefill:
        if S <= 2048 or S % 512:
            return plain_attention(q, k, v, causal=causal, window=window)
        return blocked_attention(q, k, v, causal=causal, window=window,
                                 sequence_parallel=sequence_parallel)
    if cfg.use_pallas and S > 1024 and S % 512 == 0 and T % 512 == 0:
        from ..kernels import ops as kops

        return kops.flash_attention(q, k, v, causal=causal, window=window)
    if S <= 2048 or S % 512 or T % 512:
        return plain_attention(q, k, v, causal=causal, window=window)
    return blocked_attention(q, k, v, causal=causal, window=window,
                             block_q=min(cfg.attn_chunk, 512), block_k=min(cfg.attn_chunk, 512),
                             sequence_parallel=sequence_parallel)


def attention(params, x, cfg: ModelConfig, *, positions=None, causal=True,
              window: Optional[int] = None, kv_x=None, rope=True) -> torch.Tensor:
    B, S, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    T = kv_x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    kv_positions = positions if kv_x is x else torch.arange(T, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, kv_x, cfg, positions, kv_positions, rope=rope)
    out = core_attention(q, k, v, cfg, causal=causal, window=window)
    return _out_proj(out, params["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# Per model slot (tensor parallelism over a data slot's model slots)
# ---------------------------------------------------------------------------

def heads_parallel(cfg: ModelConfig, msize: int) -> bool:
    """Whether a data slot's model slots split the attention by heads (the
    head count divides the axis), each slot normalizing its own copy of the
    rows; else model slot 0 runs the layer's attention whole."""
    return msize == 1 or cfg.n_heads % msize == 0


def kv_heads(m: int, H: int, K: int, M: int) -> list:
    """The K/V heads model slot ``m`` of ``M`` reads for its query heads
    ``[m H/M, (m+1) H/M)``, one per local K/V head: each distinct head once
    where they serve equal runs of the slot's query heads, else one per
    query head."""
    h, G = H // M, H // K
    ids = [(m * h + i) // G for i in range(h)]
    uniq = sorted(set(ids))
    if h % len(uniq) == 0 and ids == [u for u in uniq for _ in range(h // len(uniq))]:
        return uniq
    return ids


def _take(x: torch.Tensor, axis: int, ids: list) -> torch.Tensor:
    if ids == list(range(ids[0], ids[0] + len(ids))):
        return x.narrow(axis, ids[0], len(ids))
    return torch.index_select(x, axis, torch.tensor(ids, device=x.device))


def _kv_row(leaves: list, dim, axis: int, heads: list, devs) -> list:
    """Each model slot's K or V weight (``axis`` its head axis: 1 for
    ``wk``/``wv``, 0 for the biases) for the heads ``heads[m]`` it reads:
    its own block where the heads are split; where ``head_dim`` is split,
    each head's columns all-gathered over ``model`` to the slots that read
    it; else the layer's weight whole (all-gathered where split otherwise)
    and the slot's heads taken from it."""
    M = len(devs)
    if dim == axis:
        return leaves
    if dim == axis + 1:
        cols = {}
        for g in range(leaves[0].shape[axis]):
            readers = [m for m in range(M) if g in heads[m]]
            if readers:
                got = collectives.all_gather([x.narrow(axis, g, 1) for x in leaves], dim,
                                             [devs[m] for m in readers])
                cols.update({(m, g): t for m, t in zip(readers, got)})
        return [torch.cat([cols[(m, g)] for g in heads[m]], dim=axis) for m in range(M)]
    if dim is None:
        full = leaves
    elif dim == "owner":
        full = collectives.broadcast(next(x for x in leaves if x is not None), devs)
    else:
        full = collectives.all_gather(leaves, dim, devs)
    return [_take(x, axis, heads[m]) for m, x in enumerate(full)]


def attention_row(ps: list, dims: dict, hs: list, cfg: ModelConfig, positions, devs,
                  prefill: bool = False, *, causal: bool = True, kv_hs: Optional[list] = None,
                  rope: bool = True) -> tuple:
    """Self-attention (causal unless ``causal`` is off) of one data slot
    over its model slots: ``hs[m]`` model slot ``m``'s copy of the
    normalized rows (only ``hs[0]`` is read where the heads do not divide
    the axis), ``ps[m]`` its block of the layer's attention weights.  With
    ``kv_hs`` (each slot's copy of the rows the keys and values come from,
    at positions from 0) it is a cross-attention; ``rope`` off applies no
    rotary positions.  Returns (each slot's output, each slot's (k, v) over
    its K/V heads, :func:`kv_heads` of the slots or ``None`` where slot 0
    holds every head)."""
    M = len(devs)
    kv_in = hs if kv_hs is None else kv_hs

    def kv_positions(x):
        return positions if kv_hs is None else torch.arange(x.shape[1], device=x.device)[None, :]

    if M > 1 and heads_parallel(cfg, M):
        H, K = cfg.n_heads, cfg.n_kv_heads
        heads = [kv_heads(m, H, K, M) for m in range(M)]
        names = ("wk", "wv", "bk", "bv") if cfg.qkv_bias else ("wk", "wv")
        kv = {n: _kv_row([p[n] for p in ps], dims[n], 1 if n[0] == "w" else 0, heads, devs)
              for n in names}
        outs, kvs = [], []
        for m, (p, h, x) in enumerate(zip(ps, hs, kv_in)):
            p = dict(p, **{n: kv[n][m] for n in names})
            q, k, v = _project_qkv(p, h, x, cfg, positions, kv_positions(x), rope=rope)
            out = core_attention(q, k, v, cfg, causal=causal, window=cfg.sliding_window,
                                 prefill=prefill, sequence_parallel=False)
            outs.append(_out_proj(out, p["wo"].to(h.dtype)))
            kvs.append((k, v))
        return collectives.psum(outs, list(devs)), kvs, heads
    w = _whole_tree(ps, dims, devs[0])
    h, x = hs[0], kv_in[0]
    q, k, v = _project_qkv(w, h, x, cfg, positions, kv_positions(x), rope=rope)
    out = _out_proj(core_attention(q, k, v, cfg, causal=causal, window=cfg.sliding_window,
                                   prefill=prefill), w["wo"].to(h.dtype))
    outs = [out] if M == 1 else collectives.broadcast(out, devs)
    return outs, [(k, v)], None


def prefill_cache_kv(kvs: list, heads, n_kv: int, device) -> tuple:
    """A data slot's prefill (k, v) over all ``n_kv`` K/V heads on
    ``device``, from :func:`attention_row`'s per-slot (k, v) and heads:
    each head taken from the first model slot that computed it, the runs
    of heads from one slot gathered together."""
    if heads is None:
        runs = [(0, 0, n_kv)]
    else:
        runs = []
        for g in range(n_kv):
            m = next(m for m, hs in enumerate(heads) if g in hs)
            i = heads[m].index(g)
            if runs and runs[-1][0] == m and runs[-1][1] + runs[-1][2] == i:
                runs[-1] = (m, runs[-1][1], runs[-1][2] + 1)
            else:
                runs.append((m, i, 1))
    return tuple(collectives.gather_to([kvs[m][f].narrow(2, i, n) for m, i, n in runs], 2, device)
                 for f in (0, 1))


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor           # (B, C, K, hd)  C = cache capacity (seq_len or window)
    v: torch.Tensor
    pos: torch.Tensor         # (B,) next absolute position to write
    positions: torch.Tensor   # (B, C) absolute position stored in each slot (-1 empty)

    @property
    def capacity(self) -> int:
        return self.k.shape[1]


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device,
               n_kv: Optional[int] = None, head_dim: Optional[int] = None,
               dtype=None) -> KVCache:
    K = n_kv or cfg.n_kv_heads
    hd = head_dim or cfg.head_dim
    dt = dtype or cfg.torch_dtype
    return KVCache(
        k=torch.zeros((batch, capacity, K, hd), dtype=dt, device=device),
        v=torch.zeros((batch, capacity, K, hd), dtype=dt, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
        positions=torch.full((batch, capacity), -1, dtype=torch.int32, device=device),
    )


def cache_from_prefill(cfg: ModelConfig, k, v, window: Optional[int] = None) -> KVCache:
    """Build a cache holding full-prefill K/V (optionally only the last window).
    As in the reference, the capacity is the prefill's length (or the
    window), so decode's ring slot ``pos % C`` is not the slot this cache put
    ``pos`` in once ``S`` is not a multiple of the capacity."""
    B, S = k.shape[0], k.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=k.device)[None, :].expand(B, S)
    if window is not None and S > window:
        k, v = k[:, -window:], v[:, -window:]
        positions = positions[:, -window:]
    return KVCache(k=k, v=v, pos=torch.full((B,), S, dtype=torch.int32, device=k.device),
                   positions=positions)


def decode_attention_step(params, x, cache: KVCache, cfg: ModelConfig,
                          window: Optional[int] = None) -> tuple:
    """One-token attention: x (B, 1, d) against the cache; returns (out, cache).

    Unlike the reference (a pure function), this writes the new key, value
    and position into the cache's tensors in place; the returned cache holds
    those tensors and ``pos + 1``."""
    B = x.shape[0]
    pos = cache.pos                                            # (B,)
    q, k_new, v_new = _project_qkv(params, x, x, cfg, pos[:, None], pos[:, None])
    C = cache.capacity
    slot = (pos % C).long()                                    # ring buffer slot
    bidx = torch.arange(B, device=x.device)
    k, v, positions = cache.k, cache.v, cache.positions
    k[bidx, slot] = k_new[:, 0].to(k.dtype)
    v[bidx, slot] = v_new[:, 0].to(v.dtype)
    positions[bidx, slot] = pos

    H, hd = q.shape[2], q.shape[3]
    K = k.shape[2]
    G = H // K
    if cfg.use_pallas:
        from ..kernels import ops as kops

        out = kops.decode_attention(q[:, 0], k, v, positions, pos, window=window)
        out = out[:, None]
    else:
        q5 = q.reshape(B, 1, K, G, hd)
        scores = torch.einsum("bskgh,btkh->bkgst", q5.float(), k.float()) / math.sqrt(hd)
        valid = (positions >= 0) & (positions <= pos[:, None])
        if window is not None:
            valid &= positions > pos[:, None] - window
        scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
        out = out.reshape(B, 1, H, hd)
    y = _out_proj(out, params["wo"].to(x.dtype))
    return y, KVCache(k=k, v=v, pos=pos + 1, positions=positions)


# ---------------------------------------------------------------------------
# Decode over the mesh: the cache stays where state_specs places it
# ---------------------------------------------------------------------------

class CacheSlice(NamedTuple):
    """One layer's cache blocks that data slot ``j`` (model devices
    ``devs``) holds for the rows a data slot computes: per model slot its
    K, V and positions blocks (views, written in place) over the cache slots
    ``[c0, c0 + C_l)``; ``keys[m]`` names the positions block (model slots
    that share one are written once); ``compute`` is false for a replica of
    a slice that another data slot computes."""
    j: int
    devs: tuple
    c0: int
    k: list
    v: list
    positions: list
    keys: list
    compute: bool


def decode_layout(blocks, msize: int, key: str = "k") -> str:
    """How the ``model`` split of cache leaf ``key`` lays out a decode step:
    ``heads`` (whole K/V heads per model slot, or one model slot), ``cols``
    (each head's ``head_dim`` split) or ``whole`` (every model slot holds
    the cache whole)."""
    from .sharding import model_dim

    k = blocks.leaves[key]
    d = model_dim(k.spec)
    nd = len(k.shape)
    if msize == 1 or d == nd - 2:
        return "heads"
    return "cols" if d == nd - 1 else "whole"


def decode_cache_slices(blocks, mesh, i: int, rows: slice, j: int,
                        names: tuple = ("k", "v", "positions")) -> list:
    """Layer ``i``'s cache for the global rows ``rows`` that data slot
    ``j`` computes, as :class:`CacheSlice` per data slot that holds a part
    of it, in data-slot order: one slice where the batch is split over the
    data slots (data slot ``j``'s own), one per data slot where the cache
    length is (its range of slots), a replica on each where the cache is
    replicated (computed by ``j``, written on every one).  ``names`` are
    the K, V and positions leaves' keys (no positions for a static cache:
    the enc-dec model's cross K/V, every frame valid)."""
    from ..launch.mesh import data_axis_size, model_axis_size

    k, v = blocks.leaves[names[0]], blocks.leaves[names[1]]
    p = blocks.leaves[names[2]] if names[2] else None
    M = model_axis_size(mesh)
    out, seen = [], {}
    order = [j] + [jj for jj in range(data_axis_size(mesh)) if jj != j]
    for jj in order:
        slots = [mesh.slot(**mesh.data_coords(jj), model=m) for m in range(M)]
        if k.find({0: i, 1: rows}, slots[:1]) is None:
            continue
        reg = k.regions[slots[0]][2]
        if p is not None and p.regions[slots[0]][2] != reg:
            raise ValueError("the positions and the K cache split the cache length apart")
        idx = {0: i, 1: rows}
        sl = CacheSlice(jj, mesh.model_devices(jj), reg.start,
                        [k.local(s, idx) for s in slots], [v.local(s, idx) for s in slots],
                        [p.local(s, idx) if p else None for s in slots],
                        [id(p.blocks[s]) if p else None for s in slots],
                        (reg.start, reg.stop) not in seen)
        seen[(reg.start, reg.stop)] = jj
        out.append(sl)
    if not out:
        raise ValueError(f"no mesh slot holds layer {i}'s cache of rows {rows}")
    return sorted(out, key=lambda sl: sl.j)


def read_pos(blocks, mesh, i: int, rows: slice, j: int, m: int, device) -> torch.Tensor:
    """Layer ``i``'s next position of ``rows`` for model slot ``m`` of data
    slot ``j``: its own ``pos`` block where that covers them, else the first
    mesh slot's that does, broadcast to ``device``."""
    pos = blocks.leaves["pos"]
    own = mesh.slot(**mesh.data_coords(j), model=m)
    s = pos.find({0: i, 1: rows}, [own] + list(range(mesh.size)))
    if s is None:
        raise ValueError(f"no mesh slot holds layer {i}'s pos of rows {rows}")
    x = pos.local(s, {0: i, 1: rows})
    return x if s == own else collectives.broadcast(x, [device])[0]


def advance_pos(blocks, mesh, i: int, rows: slice) -> None:
    """``pos + 1`` for layer ``i``'s ``rows`` in every block that holds
    them (each distinct block once)."""
    pos = blocks.leaves["pos"]
    done = set()
    for s in range(mesh.size):
        if id(pos.blocks[s]) in done or pos.find({0: i, 1: rows}, [s]) is None:
            continue
        done.add(id(pos.blocks[s]))
        pos.local(s, {0: i, 1: rows}).add_(1)


def decode_attention_layer(blocks, mesh, i: int, rows: slice, j: int, ps: list, dims: dict,
                           hs: list, cfg: ModelConfig, devs, layout: str, cols: list) -> list:
    """Layer ``i``'s one-token attention for data slot ``j``'s global
    ``rows`` against the cache of ``blocks``: its slices
    (:func:`decode_cache_slices`), each holder's ``pos`` (:func:`read_pos`),
    :func:`decode_attention_row`, then ``pos + 1`` (:func:`advance_pos`).
    Returns each model slot's output (B, 1, d)."""
    M = len(devs)
    slices = decode_cache_slices(blocks, mesh, i, rows, j)
    poss = {h_j: [read_pos(blocks, mesh, i, rows, h_j, m, mesh.model_devices(h_j)[m])
                  for m in range(M)]
            for h_j in dict.fromkeys([j] + [sl.j for sl in slices])}
    out = decode_attention_row(ps, dims, hs, cfg, j, devs, poss, slices,
                               blocks.leaves["k"].shape[-3], layout, cols)
    advance_pos(blocks, mesh, i, rows)
    return out


def decode_cols(blocks, mesh, layout: str, key: str = "k") -> list:
    """Each model slot's ``head_dim`` columns of cache leaf ``key`` in the
    ``cols`` layout (every column otherwise)."""
    from ..launch.mesh import model_axis_size

    k = blocks.leaves[key]
    return [k.regions[mesh.slot(model=m)][-1] if layout == "cols" else slice(None)
            for m in range(model_axis_size(mesh))]


def _proj_whole(ps: list, dims: dict, hs: list, w: str, b: Optional[str], devs) -> list:
    """The per-token projection ``h @ w (+ b)`` (B, 1, N, hd) whole on every
    model slot from the slots' blocks: all-gathered where ``w`` splits its
    heads or ``head_dim`` (the bias block added first), all-reduced where it
    splits ``d_model``, computed on each slot where it is replicated."""
    d, bd = dims[w], (dims[b] if b else None)
    parts = []
    for p, h in zip(ps, hs):
        x = _proj(h, p[w].to(h.dtype))
        if b and bd is not None:
            x = x + p[b].to(h.dtype)
        parts.append(x)
    if len(devs) > 1 and d is not None:
        parts = collectives.psum(parts, list(devs)) if d == 0 else \
            collectives.all_gather(parts, d + 1, devs)
    if b and bd is None:
        parts = [x + p[b].to(x.dtype) for x, p in zip(parts, ps)]
    return parts


def _qk_finish(x, scale, cfg: ModelConfig, pos) -> torch.Tensor:
    """qk-norm (``scale``) and RoPE at ``pos`` (B,) of whole heads x (B, 1, N, hd)."""
    if cfg.qk_norm:
        x = rms_norm(x, scale, cfg.norm_eps)
    return apply_rope(x, pos[:, None], cfg.rope_theta)


def _ring_write(sl: CacheSlice, m: int, k_new, v_new, pos, C: int, done: set) -> None:
    """Write one token's k/v (B, K_l, hd_l) and position into slice ``sl``'s
    model slot ``m`` at ring slot ``pos % C``, for the rows whose slot lies
    in the slice (every row where the slice is the whole cache)."""
    kb, vb, pb = sl.k[m], sl.v[m], sl.positions[m]
    Cl = kb.shape[1]
    slot = (pos % C).long() - sl.c0
    b = torch.arange(kb.shape[0], device=kb.device)
    write_pos = sl.keys[m] not in done
    done.add(sl.keys[m])
    if Cl == C:
        kb[b, slot] = k_new.to(kb.dtype)
        vb[b, slot] = v_new.to(vb.dtype)
        if write_pos:
            pb[b, slot] = pos
        return
    inside = (slot >= 0) & (slot < Cl)
    idx = slot.clamp(0, Cl - 1)
    kb[b, idx] = torch.where(inside[:, None, None], k_new.to(kb.dtype), kb[b, idx])
    vb[b, idx] = torch.where(inside[:, None, None], v_new.to(vb.dtype), vb[b, idx])
    if write_pos:
        pb[b, idx] = torch.where(inside, pos, pb[b, idx])


def _plain_decode(q, k, v, valid, lse: bool):
    """The one-device plain decode attention (:func:`decode_attention_step`'s)
    of q (B, H, hd) over k/v (B, C, K, hd) under ``valid`` (B, C); with
    ``lse`` also each (row, head)'s log-sum-exp (B, H)."""
    B, H, hd = q.shape
    K = k.shape[2]
    q5 = q.reshape(B, 1, K, H // K, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q5.float(), k.float()) / math.sqrt(hd)
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v).reshape(B, H, hd)
    return (out, torch.logsumexp(scores, dim=-1).reshape(B, H)) if lse else out


def _heads_partial(q, kb, vb, pb, pos, cfg: ModelConfig, lse: bool):
    """One model slot's attention over its whole K/V heads of a slice: the
    decode-attention kernel under ``use_pallas`` (as one device runs it),
    else the plain formula.  The kernel reads packed rows: a whole state's
    block is a strided view of it (its heads of every slot), packed first
    (a read of the slot's block); a placed block is packed already."""
    if cfg.use_pallas:
        from ..kernels import ops as kops

        return kops.decode_attention(q, kb.contiguous(), vb.contiguous(), pb, pos,
                                     window=cfg.sliding_window, return_lse=lse)
    from ..kernels.ops import decode_mask

    return _plain_decode(q, kb, vb, decode_mask(pb, pos, cfg.sliding_window), lse)


def _cols_partial(sl: CacheSlice, qs: list, poss: list, cfg: ModelConfig, hd: int,
                  split: bool, lse: bool) -> list:
    """A slice's attention over each model slot's ``head_dim`` columns:
    partial scores ``q[:, :, cols] . k_colsᵀ`` in float32, all-reduced over
    the slice's model slots in slot order (``split``), then on every slot
    the mask, the softmax and the product with its V columns.  Plain
    PyTorch: the kernel needs whole heads."""
    from ..kernels.ops import decode_mask

    B, H = qs[0].shape[:2]
    K = sl.k[0].shape[2]
    scores = [torch.einsum("bkgh,bckh->bkgc", q.reshape(B, K, H // K, -1).float(), k.float())
              for q, k in zip(qs, sl.k)]
    if split:
        scores = collectives.psum(scores, list(sl.devs))
    out = []
    for s, v, pb, pos in zip(scores, sl.v, sl.positions, poss):
        s = s / math.sqrt(hd)
        valid = decode_mask(pb, pos, cfg.sliding_window)
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        probs = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgc,bckh->bkgh", probs.to(v.dtype), v).reshape(B, H, -1)
        out.append((o, torch.logsumexp(s, dim=-1).reshape(B, H)) if lse else o)
    return out


def merge_partials(parts: list) -> torch.Tensor:
    """Partial attentions over slices of one cache, ``(out, lse)`` each on
    one device in slice order, merged by their weights ``exp(lse)`` in
    float32 and rounded once to out's type.  A slice with no valid slot
    (lse -1e30) adds nothing beside one with a valid slot; where no slice
    has one, the equal slices weigh alike and the row gets the mean of V."""
    lse = torch.stack([l for _, l in parts])
    w = torch.exp(lse - lse.amax(dim=0))
    acc = sum(wi[..., None] * o.float() for wi, (o, _) in zip(w, parts))
    return (acc / w.sum(dim=0)[..., None]).to(parts[0][0].dtype)


def _out_row(outs: list, ps: list, dims: dict, devs, cols_split: bool) -> list:
    """The output projection of the head-dim layout's attention (each slot
    holding its columns ``outs[m]`` (B, H, hd_l), or the whole output where
    the cache is not split): the columns all-gathered (unless ``wo`` splits
    them too), each slot's part of ``wo`` applied and the partial sums
    all-reduced (``wo`` split over heads or ``head_dim``), the output
    columns all-gathered (split over ``d_model``), or the whole ``wo`` on
    each slot (replicated)."""
    dt = outs[0].dtype
    d, M = dims["wo"], len(devs)
    if d == 1 and cols_split:
        return collectives.psum([_out_proj(o[:, None], p["wo"].to(dt))
                                 for o, p in zip(outs, ps)], list(devs))
    whole = collectives.all_gather(outs, -1, devs) if cols_split else outs
    if d is None or M == 1:
        return [_out_proj(o[:, None], p["wo"].to(dt)) for o, p in zip(whole, ps)]
    if d == 2:
        return collectives.all_gather([_out_proj(o[:, None], p["wo"].to(dt))
                                       for o, p in zip(whole, ps)], -1, devs)
    parts = []
    for m, (o, p) in enumerate(zip(whole, ps)):
        n = p["wo"].shape[d]
        o = o.narrow(1, m * n, n) if d == 0 else o.narrow(2, m * n, n)
        parts.append(_out_proj(o[:, None], p["wo"].to(dt)))
    return collectives.psum(parts, list(devs))


def decode_attention_row(ps: list, dims: dict, hs: list, cfg: ModelConfig, j: int, devs,
                         poss: dict, slices: list, capacity: int, layout: str,
                         cols: list) -> list:
    """One-token attention of data slot ``j`` (model devices ``devs``) over
    its model slots, against the cache ``slices`` (:func:`decode_cache_slices`)
    of ring ``capacity``: ``hs[m]`` model slot ``m``'s copy of the
    normalized rows (B, 1, d), ``ps[m]`` its block of the layer's attention
    weights, ``poss[jj][m]`` the rows' next position as data slot ``jj``'s
    model slot ``m`` holds it (:func:`read_pos`), ``cols[m]`` its
    ``head_dim`` columns (``cols`` layout).  Writes the new token into the
    slice that holds ring slot ``pos % C`` (and each replica of it); returns
    each model slot's output (B, 1, d)."""
    M = len(devs)
    if layout == "heads":
        toks = []
        for p, h, pos in zip(ps, hs, poss[j]):
            q, k, v = _project_qkv(p, h, h, cfg, pos[:, None], pos[:, None])
            toks.append((q[:, 0], k[:, 0], v[:, 0]))
    else:
        qw = _proj_whole(ps, dims, hs, "wq", "bq" if cfg.qkv_bias else None, devs)
        kw = _proj_whole(ps, dims, hs, "wk", "bk" if cfg.qkv_bias else None, devs)
        if layout == "cols" and dims["wv"] == 2:       # the cache's columns: no gather
            vs = []
            for p, h in zip(ps, hs):
                v = _proj(h, p["wv"].to(h.dtype))
                vs.append(v + p["bv"].to(h.dtype) if cfg.qkv_bias else v)
        else:
            vs = [v[..., c] for v, c in zip(_proj_whole(
                ps, dims, hs, "wv", "bv" if cfg.qkv_bias else None, devs), cols)]
        toks = []
        for m, (p, pos) in enumerate(zip(ps, poss[j])):
            q = _qk_finish(qw[m], p.get("q_scale"), cfg, pos)[..., cols[m]]
            k = _qk_finish(kw[m], p.get("k_scale"), cfg, pos)[..., cols[m]]
            toks.append((q[:, 0], k[:, 0], vs[m][:, 0]))
    # the per-token vectors, packed, to each other data slot holding a part
    remote = [sl for sl in slices if sl.j != j]
    got = {}
    if remote:
        for m in range(M):
            sizes = [t.shape[1] for t in toks[m]]
            for sl, x in zip(remote, collectives.broadcast(torch.cat(toks[m], dim=1),
                                                           [sl.devs[m] for sl in remote])):
                got[(sl.j, m)] = torch.split(x, sizes, dim=1)
    done, parts = set(), []
    lse = sum(sl.compute for sl in slices) > 1
    for sl in slices:
        here = [got.get((sl.j, m), toks[m]) for m in range(M)]
        for m, (_, k_new, v_new) in enumerate(here):
            _ring_write(sl, m, k_new, v_new, poss[sl.j][m], capacity, done)
        if not sl.compute:
            continue
        if layout == "heads":
            part = [_heads_partial(here[m][0], sl.k[m], sl.v[m], sl.positions[m],
                                   poss[sl.j][m], cfg, lse) for m in range(M)]
        else:
            part = _cols_partial(sl, [t[0] for t in here], poss[sl.j], cfg, cfg.head_dim,
                                 layout == "cols" and M > 1, lse)
        parts.append((sl.j, part))
    outs = []
    for m in range(M):
        if not lse:
            jj, part = parts[0]
            outs.append(part[m] if jj == j else collectives.gather_to([part[m]], 0, devs[m]))
            continue
        o = collectives.gather_to([part[m][0][None] for _, part in parts], 0, devs[m])
        ls = collectives.gather_to([part[m][1][None] for _, part in parts], 0, devs[m])
        outs.append(merge_partials(list(zip(o, ls))))
    if layout == "heads":
        dt = hs[0].dtype
        ys = [_out_proj(o[:, None], p["wo"].to(dt)) for o, p in zip(outs, ps)]
        return ys if M == 1 else collectives.psum(ys, list(devs))
    return _out_row(outs, ps, dims, devs, layout == "cols" and M > 1)


# ---------------------------------------------------------------------------
# Cross attention over a static K/V placed by state_specs (the enc-dec decode)
# ---------------------------------------------------------------------------

def _cross_partial(q, k, v, lse: bool):
    """The reference's decode cross attention (``plain_attention``, not
    causal, every frame valid) of q (B, H, hd) over k/v (B, T, K, hd); with
    ``lse`` also each (row, head)'s log-sum-exp (B, H)."""
    B, H, hd = q.shape
    K = k.shape[2]
    q5 = q.reshape(B, K, H // K, hd)
    scores = torch.einsum("bkgh,btkh->bkgt", q5.float(), k.float()) * (1.0 / math.sqrt(hd))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", probs.to(v.dtype), v).reshape(B, H, hd)
    return (out, torch.logsumexp(scores, dim=-1).reshape(B, H)) if lse else out


def _cross_cols(sl: CacheSlice, qs: list, hd: int, split: bool, lse: bool) -> list:
    """A static slice's cross attention over each model slot's ``head_dim``
    columns: partial scores in float32 all-reduced over the slice's model
    slots in slot order (``split``), then on every slot the softmax and the
    product with its V columns."""
    B, H = qs[0].shape[:2]
    K = sl.k[0].shape[2]
    scores = [torch.einsum("bkgh,btkh->bkgt", q.reshape(B, K, H // K, -1).float(), k.float())
              for q, k in zip(qs, sl.k)]
    if split:
        scores = collectives.psum(scores, list(sl.devs))
    out = []
    for s, v in zip(scores, sl.v):
        s = s * (1.0 / math.sqrt(hd))
        probs = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgt,btkh->bkgh", probs.to(v.dtype), v).reshape(B, H, -1)
        out.append((o, torch.logsumexp(s, dim=-1).reshape(B, H)) if lse else o)
    return out


def cross_attention_row(ps: list, dims: dict, hs: list, cfg: ModelConfig, j: int, devs,
                        slices: list, layout: str, cols: list) -> list:
    """The decode step's cross attention of data slot ``j`` (model devices
    ``devs``) over its model slots, against the static K/V ``slices``
    (:func:`decode_cache_slices` of the ``cross_k`` / ``cross_v`` blocks):
    ``hs[m]`` model slot ``m``'s copy of the normalized rows (B, 1, d),
    ``ps[m]`` its block of the layer's cross-attention weights.  By the
    K/V's ``model`` split: whole heads a slot (``heads``: the slot's query
    heads from its block of ``wq``, its output heads through its rows of
    ``wo``, a partial sum all-reduced), or each head's ``head_dim`` columns
    (``cols``: the slot's query columns, float32 partial scores
    all-reduced, a local P V, ``wo`` row-parallel).  Where the frames are
    split over the data slots (a batch of one), the query goes to each
    slice's data slot, each computes its slice with its log-sum-exp, and
    the partials merge by it on data slot ``j`` (:func:`merge_partials`).
    Nothing is written.  Plain PyTorch, as the reference's.  Returns each
    model slot's output (B, 1, d)."""
    M = len(devs)
    dt = hs[0].dtype
    if layout == "heads" or (layout == "cols" and dims["wq"] == 2):
        qs = [_proj(h, p["wq"].to(dt))[:, 0] for p, h in zip(ps, hs)]
    elif layout == "cols":
        qs = [q[:, 0, :, c] for q, c in zip(_proj_whole(ps, dims, hs, "wq", None, devs), cols)]
    else:
        raise ValueError("a cross attention over the mesh needs its K/V split over model by "
                         "heads or head_dim")
    remote = [sl for sl in slices if sl.j != j and sl.compute]   # nothing to write
    got = {}
    for m in range(M):
        if remote:
            for sl, x in zip(remote, collectives.broadcast(qs[m], [sl.devs[m] for sl in remote])):
                got[(sl.j, m)] = x
    lse = sum(sl.compute for sl in slices) > 1
    parts = []
    for sl in slices:
        if not sl.compute:
            continue
        here = [got.get((sl.j, m), qs[m]) for m in range(M)]
        if layout == "heads":
            part = [_cross_partial(here[m], sl.k[m], sl.v[m], lse) for m in range(M)]
        else:
            part = _cross_cols(sl, here, cfg.head_dim, M > 1, lse)
        parts.append((sl.j, part))
    outs = []
    for m in range(M):
        if not lse:
            jj, part = parts[0]
            outs.append(part[m] if jj == j else collectives.gather_to([part[m]], 0, devs[m]))
            continue
        o = collectives.gather_to([part[m][0][None] for _, part in parts], 0, devs[m])
        ls = collectives.gather_to([part[m][1][None] for _, part in parts], 0, devs[m])
        outs.append(merge_partials(list(zip(o, ls))))
    if layout == "heads":
        ys = [_out_proj(o[:, None], p["wo"].to(dt)) for o, p in zip(outs, ps)]
        return ys if M == 1 else collectives.psum(ys, list(devs))
    return _out_row(outs, ps, dims, devs, M > 1)
