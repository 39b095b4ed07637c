"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar
memory, recurrent), in the 7:1 arrangement of the xLSTM paper (the port of
the reference's ``models/xlstm.py``).

The mLSTM runs in a chunked linear-attention form with exponential input
gates and sigmoid forget gates, without the paper's max-stabilizer in the
chunked path (compute is float32 and the gates are bounded at init), as the
reference does.  The sLSTM's recurrent gate connections make it sequential:
its time loop is a Python loop of eager operations, as the reference's is a
``lax.scan``; its stabilizer ``m`` starts at -1e30 in float32.

Parameters are nested dicts of tensors in the reference's layout: the mLSTM
weights stacked on (groups, mLSTM layers of a group), the sLSTM weights on
(groups,).  For serving, matrices are held in the compute dtype, cast once
at load, except the sLSTM's recurrent ``r``, which the reference casts to
float32 at each use and so stays in the parameter dtype; for training
(``master=True``) nothing is cast.  Every RMSNorm here is the plain
formula, as in the reference, which passes no ``use_pallas`` at any of its
call sites: the family reaches no hand-written kernel.

Under an ambient mesh (:func:`repro_torch.launch.mesh.use_mesh`) the forward
and ``train_forward`` split the rows over the mesh's data slots and each
data slot's model slots compute tensor-parallel from their own blocks
(:func:`train_forward_slots`): the mLSTM by its q/k/v output columns
(:func:`mlstm_row`), the sLSTM's time loop on model slot 0 with its input
projection column-parallel and its output row-parallel (:func:`slstm_row`).
Decode under a mesh runs over the grid too (:func:`decode_slots`): each
model slot updates its blocks of the mLSTM's ``C`` and ``n`` and of the
sLSTM's ``c``, ``n``, ``m`` and ``h`` in place where ``state_specs`` puts
them (:func:`mlstm_decode_row`, :func:`slstm_decode_row`), the per-token
activations moving between the weights' and the state's layouts.
"""

from __future__ import annotations

import math
import sys
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import resolve_device
from .common import ModelConfig, abstract_mesh
from . import layers, sharding, transformer
from .layers import (cast_matrices, dense_init, draw_stacked, embed, index_tree, init_embed,
                     init_mlp, mlp, rms_norm, unembed)
from .transformer import _maybe_remat, slot_views

__all__ = ["MLSTMState", "SLSTMState", "XLSTMState", "decode_independent", "decode_slots",
           "decode_step", "ffn_dim", "forward", "init_decode_state", "init_mlstm_state",
           "init_params", "init_slstm_state", "mlstm_decode_row", "mlstm_decode_step",
           "mlstm_dims", "mlstm_forward", "mlstm_parallel", "mlstm_row", "params_from_numpy",
           "slot_views", "slstm_decode_row", "slstm_decode_step", "slstm_dims", "slstm_forward",
           "slstm_row", "train_forward", "train_forward_slots", "whole_r", "xlstm_group_shape"]

_STACKED_AXES = {"mlstm": 2, "slstm": 1}
_KEEP_FLOAT32 = {"r"}


def mlstm_dims(cfg: ModelConfig) -> tuple:
    d_in = 2 * cfg.d_model
    H = cfg.n_heads
    P = d_in // H
    return d_in, H, P


def slstm_dims(cfg: ModelConfig) -> tuple:
    H = cfg.n_heads
    dh = cfg.d_model // H
    return H, dh


def ffn_dim(cfg: ModelConfig) -> int:
    # the xLSTM paper's 4/3 projection-factor FFN after sLSTM blocks (d_ff = 0
    # in the config means "use the family default")
    return int(math.ceil(4 * cfg.d_model / 3 / 128) * 128)


def _cast_matrices(tree, cfg: ModelConfig):
    return cast_matrices(tree, cfg.torch_dtype, _STACKED_AXES, _KEEP_FLOAT32)


def _log_sigmoid(x):
    return -F.softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, cfg: ModelConfig, lead: tuple = ()) -> dict:
    d = cfg.d_model
    d_in, H, P = mlstm_dims(cfg)
    pdt = cfg.torch_param_dtype
    return {
        "ln": torch.ones(lead + (d,), dtype=pdt, device=gen.device),
        "up": dense_init(gen, lead + (d, 2 * d_in), pdt),          # x_in, z
        "wq": dense_init(gen, lead + (d_in, d_in), pdt),
        "wk": dense_init(gen, lead + (d_in, d_in), pdt),
        "wv": dense_init(gen, lead + (d_in, d_in), pdt),
        "wif": dense_init(gen, lead + (d_in, 2 * H), pdt),         # input/forget gates
        "down": dense_init(gen, lead + (d_in, d), pdt),
    }


def _mlstm_chunked(q, k, v, li, lf, chunk: int) -> torch.Tensor:
    """q,k: (B,S,H,P) fp32, v: (B,S,H,Pv) (a head's value columns, all or
    some: each is computed on its own); li: log input gate, lf: log forget
    gate (B,S,H).  Returns h (B,S,H,Pv)."""
    B, S, H, P = q.shape
    Q = min(chunk, S)
    assert S % Q == 0
    nc = S // Q
    q, k, v, li, lf = (a.reshape((B, nc, Q) + a.shape[2:]) for a in (q, k, v, li, lf))
    scale = 1.0 / math.sqrt(P)

    A = torch.cumsum(lf, dim=2)                                  # (B,nc,Q,H) inclusive
    # intra-chunk decay: D_ij = exp(A_i - A_j + li_j), j <= i
    diff = A[:, :, :, None, :] - A[:, :, None, :, :] + li[:, :, None, :, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()[None, None, :, :, None]
    D = torch.where(mask, torch.exp(diff), 0.0)                  # (B,nc,Q,Q,H)
    qk = torch.einsum("bcqhp,bckhp->bcqkh", q, k) * scale        # (B,nc,Q,Q,H)
    w = qk * D
    intra_h = torch.einsum("bcqkh,bckhp->bcqhp", w, v)
    intra_n = w.sum(dim=3)                                       # (B,nc,Q,H) = q.n intra

    # inter-chunk state: C (B,H,P,P), n (B,H,P)
    dec_state = torch.exp(A[:, :, -1:, :] - A + li)              # (B,nc,Q,H)
    new_C = torch.einsum("bcqhp,bcqhr->bchpr", dec_state[..., None] * k, v)
    new_n = torch.einsum("bcqh,bcqhp->bchp", dec_state, k)
    chunk_dec = torch.exp(A[:, :, -1, :])                        # (B,nc,H)

    C = torch.zeros((B, H, P, v.shape[-1]), dtype=q.dtype, device=q.device)
    n = torch.zeros((B, H, P), dtype=q.dtype, device=q.device)
    Cs, ns = [], []
    for c in range(nc):                                          # states before chunk c
        Cs.append(C)
        ns.append(n)
        C = C * chunk_dec[:, c, :, None, None] + new_C[:, c]
        n = n * chunk_dec[:, c, :, None] + new_n[:, c]
    Cs, ns = torch.stack(Cs, dim=1), torch.stack(ns, dim=1)      # (B,nc,H,P,P), (B,nc,H,P)

    qs = torch.exp(A)[..., None] * (q * scale)                   # (B,nc,Q,H,P)
    inter_h = torch.einsum("bcqhp,bchpr->bcqhr", qs, Cs)
    inter_n = torch.einsum("bcqhp,bchp->bcqh", qs, ns)
    denom = torch.clamp(torch.abs(intra_n + inter_n), min=1.0)
    h = (intra_h + inter_h) / denom[..., None]
    return h.reshape(B, S, H, v.shape[-1])


def mlstm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, S, d = x.shape
    d_in, H, P = mlstm_dims(cfg)
    dt = x.dtype
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    x_in, z = torch.chunk(h @ p["up"].to(dt), 2, dim=-1)
    q = (x_in @ p["wq"].to(dt)).reshape(B, S, H, P)
    k = (x_in @ p["wk"].to(dt)).reshape(B, S, H, P)
    v = (x_in @ p["wv"].to(dt)).reshape(B, S, H, P)
    gi, gf = torch.chunk((x_in @ p["wif"].to(dt)).float(), 2, dim=-1)   # (B,S,H)
    y = _mlstm_chunked(q.float(), k.float(), v.float(), _log_sigmoid(gi), _log_sigmoid(gf),
                       cfg.xlstm_chunk)
    y = y.reshape(B, S, d_in).to(dt) * F.silu(z)
    return y @ p["down"].to(dt)


class MLSTMState(NamedTuple):
    C: torch.Tensor   # (B, H, P, P)
    n: torch.Tensor   # (B, H, P)


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> MLSTMState:
    dev = resolve_device(device)
    d_in, H, P = mlstm_dims(cfg)
    return MLSTMState(C=torch.zeros((batch, H, P, P), dtype=torch.float32, device=dev),
                      n=torch.zeros((batch, H, P), dtype=torch.float32, device=dev))


def mlstm_decode_step(p: dict, x: torch.Tensor, state: MLSTMState, cfg: ModelConfig):
    """One token: x (B, 1, d) -> (out (B, 1, d), the new state)."""
    B = x.shape[0]
    d_in, H, P = mlstm_dims(cfg)
    dt = x.dtype
    h = rms_norm(x, p["ln"], cfg.norm_eps)[:, 0]
    x_in, z = torch.chunk(h @ p["up"].to(dt), 2, dim=-1)
    q = (x_in @ p["wq"].to(dt)).reshape(B, H, P).float()
    k = (x_in @ p["wk"].to(dt)).reshape(B, H, P).float()
    v = (x_in @ p["wv"].to(dt)).reshape(B, H, P).float()
    gi, gf = torch.chunk((x_in @ p["wif"].to(dt)).float(), 2, dim=-1)
    fi = torch.exp(_log_sigmoid(gi))                             # sigmoid-style gates
    ff = torch.exp(_log_sigmoid(gf))
    C = state.C * ff[..., None, None] + fi[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = state.n * ff[..., None] + fi[..., None] * k
    scale = 1.0 / math.sqrt(P)
    num = torch.einsum("bhp,bhpr->bhr", q * scale, C)
    den = torch.clamp(torch.abs(torch.einsum("bhp,bhp->bh", q * scale, n)), min=1.0)
    y = (num / den[..., None]).reshape(B, d_in).to(dt) * F.silu(z)
    return (y @ p["down"].to(dt))[:, None], MLSTMState(C=C, n=n)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg: ModelConfig, lead: tuple = ()) -> dict:
    d = cfg.d_model
    H, dh = slstm_dims(cfg)
    pdt = cfg.torch_param_dtype
    return {
        "ln": torch.ones(lead + (d,), dtype=pdt, device=gen.device),
        "wx": dense_init(gen, lead + (d, 4 * d), pdt),           # z,i,f,o from input
        # recurrent, block-diagonal per head
        "r": dense_init(gen, lead + (H, dh, 4 * dh), pdt).mul_(torch.tensor(0.1, dtype=pdt)),
        "ln2": torch.ones(lead + (d,), dtype=pdt, device=gen.device),
        "ffn": init_mlp(gen, cfg, d_ff=ffn_dim(cfg), lead=lead),
        "out": dense_init(gen, lead + (d, d), pdt),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, d) float32
    n: torch.Tensor
    m: torch.Tensor   # log-space stabilizer, from -1e30
    h: torch.Tensor


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> SLSTMState:
    dev = resolve_device(device)
    shape = (batch, cfg.d_model)
    return SLSTMState(c=torch.zeros(shape, dtype=torch.float32, device=dev),
                      n=torch.zeros(shape, dtype=torch.float32, device=dev),
                      m=torch.full(shape, -1e30, dtype=torch.float32, device=dev),
                      h=torch.zeros(shape, dtype=torch.float32, device=dev))


def _slstm_cell(p, xt, state: SLSTMState, cfg: ModelConfig) -> SLSTMState:
    """One recurrent step.  xt: (B, 4d) fp32 pre-activation from W x."""
    B, d = state.h.shape
    H, dh = slstm_dims(cfg)
    hr = state.h.reshape(B, H, dh)
    rec = torch.einsum("bhd,hde->bhe", hr, p["r"].float()).reshape(B, 4 * d)
    zt, it, ft, ot = torch.chunk(xt + rec, 4, dim=-1)
    m_new = torch.maximum(ft + state.m, it)                      # log-space stabilizer
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + state.m - m_new)
    c = f_ * state.c + i_ * torch.tanh(zt)
    n = torch.clamp(f_ * state.n + i_, min=1e-6)
    h = torch.sigmoid(ot) * c / n
    return SLSTMState(c=c, n=n, m=m_new, h=h)


def slstm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, S, d = x.shape
    dt = x.dtype
    h_in = rms_norm(x, p["ln"], cfg.norm_eps)
    xt = (h_in @ p["wx"].to(dt)).float()
    state = init_slstm_state(cfg, B, x.device)
    hs = []
    for t in range(S):
        state = _slstm_cell(p, xt[:, t], state, cfg)
        hs.append(state.h)
    y = torch.stack(hs, dim=1).to(dt)                            # (B,S,d)
    x = x + y @ p["out"].to(dt)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["ffn"], h2, cfg)


def slstm_decode_step(p: dict, x: torch.Tensor, state: SLSTMState, cfg: ModelConfig):
    dt = x.dtype
    h_in = rms_norm(x, p["ln"], cfg.norm_eps)[:, 0]
    new = _slstm_cell(p, (h_in @ p["wx"].to(dt)).float(), state, cfg)
    x = x + (new.h.to(dt) @ p["out"].to(dt))[:, None]
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["ffn"], h2, cfg), new


# ---------------------------------------------------------------------------
# Per model slot (tensor parallelism over a data slot's model slots)
# ---------------------------------------------------------------------------

def mlstm_parallel(cfg: ModelConfig, dims: dict, msize: int) -> bool:
    """Whether a data slot's model slots split the mLSTM by the q/k/v
    output columns: ``param_specs`` splits ``up`` and ``wq``/``wk``/``wv``
    by columns and ``down`` by rows, and each slot's columns are whole heads
    or a part of one head; else model slot 0 runs the layer whole."""
    d_in, H, P = mlstm_dims(cfg)
    cw = d_in // msize
    return (msize > 1 and dims["up"] == dims["wq"] == dims["wk"] == dims["wv"] == 1
            and dims["down"] == 0 and (cw % P == 0 or P % cw == 0))


def _head_cols(qs: list, head_group: list, devs) -> list:
    """Each model slot's q (or k) columns of the whole heads it reads: its
    own where it holds whole heads, else its head's columns all-gathered
    over the slots that hold them (``head_group[m]``: those slots)."""
    from ..launch import collectives

    out = list(qs)
    for group in dict.fromkeys(tuple(g) for g in head_group):
        if len(group) > 1:
            got = collectives.all_gather([qs[m] for m in group], -1, [devs[m] for m in group])
            for m, t in zip(group, got):
                out[m] = t
    return out


def mlstm_row(ps: list, dims: dict, xs: list, cfg: ModelConfig, devs) -> list:
    """:func:`mlstm_forward` over one data slot's model slots (``xs[m]``
    slot ``m``'s copy of the residual rows, ``ps[m]`` its block of the
    layer's weights), where :func:`mlstm_parallel`: ``up`` is
    column-parallel and x_in is all-gathered over the model slots for the
    q/k/v and gate products; ``wif`` is replicated, so every slot computes
    the gates; slot ``m`` computes its q/k/v columns, and where a head's
    head_dim is split over several slots those slots all-gather that
    head's q and k columns (v and the output stay split: each value
    column's output is computed on its own, with no score all-reduce); z's
    columns move to the output's layout for the ``silu(z)`` product;
    ``down`` is row-parallel, a partial sum all-reduced in model-slot
    order.  Otherwise model slot 0 runs the layer whole and broadcasts.
    Returns each slot's output."""
    from ..launch import collectives
    from .layers import _whole_tree, take_columns

    M = len(devs)
    if M == 1:
        return [mlstm_forward(ps[0], xs[0], cfg)]
    if not mlstm_parallel(cfg, dims, M):
        w = _whole_tree(ps, dims, devs[0])
        return collectives.broadcast(mlstm_forward(w, xs[0], cfg), devs)
    B, S, _ = xs[0].shape
    d_in, H, P = mlstm_dims(cfg)
    cw = d_in // M
    dt = xs[0].dtype
    hs = [rms_norm(x, p["ln"], cfg.norm_eps) for p, x in zip(ps, xs)]
    ups = [h @ p["up"].to(dt) for p, h in zip(ps, hs)]
    uw = ups[0].shape[-1]
    x_in = collectives.all_gather([ups[m][..., :min(uw, d_in - m * uw)]
                                   for m in range((d_in + uw - 1) // uw)], -1, devs)
    zs = [take_columns(ups, [(d_in + m * cw, d_in + (m + 1) * cw)], dev)
          for m, dev in enumerate(devs)]
    per = max(cw // P, 1)                         # whole heads a slot reads
    group = [[m] if cw >= P else list(range(m - m % (P // cw), m - m % (P // cw) + P // cw))
             for m in range(M)]
    q = _head_cols([x @ p["wq"].to(dt) for p, x in zip(ps, x_in)], group, devs)
    k = _head_cols([x @ p["wk"].to(dt) for p, x in zip(ps, x_in)], group, devs)
    outs = []
    for m, (p, x) in enumerate(zip(ps, x_in)):
        h0 = (m * cw) // P                        # the slot's first head
        heads = slice(h0, h0 + per)
        v = (x @ p["wv"].to(dt)).reshape(B, S, per, -1)
        gi, gf = torch.chunk((x @ p["wif"].to(dt)).float(), 2, dim=-1)
        y = _mlstm_chunked(q[m].reshape(B, S, per, P).float(), k[m].reshape(B, S, per, P).float(),
                           v.float(), _log_sigmoid(gi[..., heads]), _log_sigmoid(gf[..., heads]),
                           cfg.xlstm_chunk)
        y = y.reshape(B, S, cw).to(dt) * F.silu(zs[m])
        outs.append(y @ p["down"].to(dt))
    return collectives.psum(outs, list(devs))


def whole_r(leaves: list, dim, device) -> torch.Tensor:
    """The sLSTM's recurrent ``r`` (H, dh, 4 dh) whole on ``device``, from
    its model slots' blocks: gathered once per layer where ``param_specs``
    splits it (over dh, not the heads), slot 0's own where replicated."""
    from .layers import whole_on

    return whole_on(leaves, dim, device)


def slstm_row(ps: list, dims: dict, xs: list, cfg: ModelConfig, devs) -> list:
    """:func:`slstm_forward` over one data slot's model slots (``xs[m]``
    slot ``m``'s copy of the residual rows).  The reference's recurrence
    joins the heads' outputs (B, H, 4 dh) into one (B, 4d) vector before
    splitting it into the z, i, f, o gates, so every gate of every
    position reads every head's state at every step: the time loop runs
    on model slot 0, which takes ``r`` whole once per layer
    (:func:`whole_r`) and every column of the input projection, each slot
    computing its block of ``wx``'s columns; no collective runs inside the
    loop, and the other model slots wait.  The output's columns then go to
    the slots that hold their rows of ``out`` (row-parallel, a partial sum
    all-reduced in model-slot order), and the FFN runs through
    :func:`.layers.mlp_row`.  Returns each slot's output."""
    from ..launch import collectives
    from .layers import mlp_row, whole_on

    M = len(devs)
    if M == 1:
        return [slstm_forward(ps[0], xs[0], cfg)]
    B, S, d = xs[0].shape
    dt = xs[0].dtype
    dev0 = devs[0]
    hs = [rms_norm(x, p["ln"], cfg.norm_eps) for p, x in zip(ps, xs)]
    if dims["wx"] == 1:
        xt = collectives.gather_to([h @ p["wx"].to(dt) for p, h in zip(ps, hs)], -1, dev0)
    else:
        xt = hs[0] @ whole_on([p["wx"] for p in ps], dims["wx"], dev0).to(dt)
    xt = xt.float()
    cell = {"r": whole_r([p["r"] for p in ps], dims["r"], dev0).float()}
    state = init_slstm_state(cfg, B, dev0)
    steps = []
    for t in range(S):
        state = _slstm_cell(cell, xt[:, t], state, cfg)
        steps.append(state.h)
    y = torch.stack(steps, dim=1).to(dt)                           # (B,S,d) on slot 0
    if dims["out"] == 0:
        o = collectives.psum([a @ p["out"].to(dt) for p, a in
                              zip(ps, collectives.scatter(y, -1, devs))], list(devs))
    else:
        o = collectives.broadcast(y @ whole_on([p["out"] for p in ps], dims["out"], dev0).to(dt),
                                  devs)
    x2 = [x + a for x, a in zip(xs, o)]
    h2 = [rms_norm(x, p["ln2"], cfg.norm_eps) for p, x in zip(ps, x2)]
    return [x + f for x, f in zip(x2, mlp_row([p["ffn"] for p in ps], dims["ffn"], h2, cfg,
                                               devs))]


def _grid_group(mrows: list, srows: list, mdims: dict, sdims: dict, xs: list, cfg,
                devs: list) -> list:
    """One group over the grid: ``xs[jj][m]`` model slot ``m``'s copy of
    computing data slot ``jj``'s rows, ``mrows[jj][j][m]`` its block of
    mLSTM layer ``j``, ``srows[jj][m]`` of the sLSTM layer."""
    out = []
    for jj, x in enumerate(xs):
        for lrow in mrows[jj]:
            x = [a + b for a, b in zip(x, mlstm_row(lrow, mdims, x, cfg, devs[jj]))]
        out.append(slstm_row(srows[jj], sdims, x, cfg, devs[jj]))
    return out


def train_forward_slots(views, tokens_slots: list, cfg: ModelConfig,
                        n_data: Optional[int] = None) -> tuple:
    """:func:`train_forward` over the ambient mesh's grid (``views`` the
    weights' :class:`.sharding.SlotViews`, ``tokens_slots[jj]`` computing
    data slot ``views.data_slots[jj]``'s rows on its device): each model
    slot holds its copy of the rows, each mLSTM layer runs through
    :func:`mlstm_row`, each sLSTM layer through :func:`slstm_row`, each
    group checkpointed under ``remat == "block"``.  Returns (each data
    slot's :class:`.layers.SlotLogits`, each data slot's aux loss, zero)."""
    mesh = abstract_mesh()
    D = len(views.data_slots)
    devs = [mesh.model_devices(j) for j in views.data_slots]
    xs = [layers.embed_row(views.top(jj, "embed"), views.dims, t, cfg, devs[jj])
          for jj, t in enumerate(tokens_slots)]
    ng, nm = xlstm_group_shape(cfg)
    mdims, sdims = views.entry_dims("mlstm", 2), views.entry_dims("slstm", 1)
    group = _maybe_remat(lambda g, xs: _grid_group(
        [[views.entry(jj, "mlstm", g, j) for j in range(nm)] for jj in range(D)],
        [views.entry(jj, "slstm", g) for jj in range(D)], mdims, sdims, xs, cfg, devs), cfg)
    for g in range(ng):
        xs = group(g, xs)
    logits = [layers.unembed_row(views.top(jj, "embed"), views.dims,
                                 [rms_norm(a, p["ln_f"], cfg.norm_eps)
                                  for p, a in zip(views.top(jj, "ln_f"), xs[jj])], cfg, devs[jj])
              for jj in range(D)]
    return logits, [torch.zeros((), dtype=torch.float32, device=row[0].device) for row in xs]


# ---------------------------------------------------------------------------
# Full model: groups of (slstm_every - 1) mLSTM + 1 sLSTM
# ---------------------------------------------------------------------------

def xlstm_group_shape(cfg: ModelConfig) -> tuple:
    k = cfg.slstm_every
    assert cfg.n_layers % k == 0, "n_layers must be divisible by slstm_every"
    return cfg.n_layers // k, k - 1          # (n_groups, mlstm per group)


def init_params(gen: torch.Generator, cfg: ModelConfig, master: bool = False) -> dict:
    """Random parameters with the reference's distributions, drawn from
    ``gen`` on ``gen.device``, one group at a time, each cast before the
    next is drawn; with ``master`` nothing is cast (training)."""
    cast = (lambda tree: tree) if master else (lambda tree: _cast_matrices(tree, cfg))
    ng, nm = xlstm_group_shape(cfg)
    tree = cast({"embed": init_embed(gen, cfg),
                 "ln_f": torch.ones((cfg.d_model,), dtype=cfg.torch_param_dtype,
                                    device=gen.device)})
    tree["mlstm"] = draw_stacked(ng, lambda: init_mlstm(gen, cfg, (1, nm)),
                                 lambda one: cast({"mlstm": one})["mlstm"])
    tree["slstm"] = draw_stacked(ng, lambda: init_slstm(gen, cfg, (1,)),
                                 lambda one: cast({"slstm": one})["slstm"])
    return tree


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None,
                      master: bool = False) -> dict:
    """:func:`layers.params_from_numpy` with this family's cast."""
    return layers.params_from_numpy(tree, cfg, _cast_matrices, device, master)


def _group_forward(params, g, x, cfg):
    _, nm = xlstm_group_shape(cfg)
    for j in range(nm):
        x = x + mlstm_forward(index_tree(params["mlstm"], g, j), x, cfg)
    return slstm_forward(index_tree(params["slstm"], g), x, cfg)


def train_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Returns (logits, aux_loss = 0), differentiable in ``params``; each
    group recomputed in the backward pass when ``cfg.remat == "block"``.
    Under an ambient mesh the rows split over its data slots, each
    tensor-parallel over its model slots (:func:`train_forward_slots`)."""
    if abstract_mesh() is not None:
        return transformer.mesh_train_forward(sys.modules[__name__], params, tokens, cfg)
    x = embed(params["embed"], tokens, cfg)
    group = _maybe_remat(lambda params, x, g: _group_forward(params, g, x, cfg), cfg)
    for g in range(xlstm_group_shape(cfg)[0]):
        x = group(params, x, g)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return (unembed(params["embed"], x, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> tuple:
    """:func:`train_forward` under ``torch.inference_mode``."""
    with torch.inference_mode():
        return train_forward(params, tokens, cfg)


class XLSTMState(NamedTuple):
    ml: MLSTMState    # (ng, nm, ...)
    sl: SLSTMState    # (ng, ...)


def init_decode_state(cfg: ModelConfig, batch: int, capacity: int = 0,
                      device=None) -> XLSTMState:
    """Fresh recurrent state on ``device`` (``None`` means cuda); the
    capacity is unused (the state does not grow)."""
    dev = resolve_device(device)
    ng, nm = xlstm_group_shape(cfg)
    d_in, H, P = mlstm_dims(cfg)
    sl = (ng, batch, cfg.d_model)
    f32 = torch.float32
    return XLSTMState(
        MLSTMState(C=torch.zeros((ng, nm, batch, H, P, P), dtype=f32, device=dev),
                   n=torch.zeros((ng, nm, batch, H, P), dtype=f32, device=dev)),
        SLSTMState(c=torch.zeros(sl, dtype=f32, device=dev),
                   n=torch.zeros(sl, dtype=f32, device=dev),
                   m=torch.full(sl, -1e30, dtype=f32, device=dev),
                   h=torch.zeros(sl, dtype=f32, device=dev)))


# ---------------------------------------------------------------------------
# Decode per model slot, the state where state_specs puts it
# ---------------------------------------------------------------------------

def _index(idx: tuple, rows: slice) -> dict:
    return {i: x for i, x in enumerate(idx)} | {len(idx): rows}


def mlstm_decode_row(ps: list, dims: dict, xs: list, cfg: ModelConfig, devs, blocks,
                     idx: tuple, rows: slice, j: int) -> list:
    """:func:`mlstm_decode_step` over one data slot's model slots (``xs[m]``
    slot ``m``'s copy of the residual rows (B, 1, d), ``ps[m]`` its block
    of the layer's weights) against ``C`` and ``n`` of ``blocks`` (the
    :class:`XLSTMState`'s :class:`.sharding.StateBlocks`, leaves ``ml/C``
    and ``ml/n``) at the stacked index ``idx`` and the global ``rows`` of
    data slot ``j``.

    ``up``'s x_in columns are all-gathered (the q/k/v products need it
    whole), each slot computes its q, k and v columns and every gate
    (``wif`` replicated); q and k are all-gathered whole; each slot takes
    the v columns of its ``C`` block (one gather).  ``C`` may be split over
    heads or over its value index r (the columns of ``num``), ``n`` over
    heads or its key index p: the slot updates its blocks in place and
    computes its part of ``num``; ``den = |q . n|`` is a sum over p, each
    slot's part all-reduced in float32 (B x H values).  y and z then move
    to ``down``'s row owners (a gather each), and ``down`` is row-parallel,
    a partial sum all-reduced in model-slot order.  Returns each slot's
    output (B, 1, d)."""
    from ..launch import collectives
    from .layers import take_columns
    from .ssm import channels_to

    M = len(devs)
    d_in, H, P = mlstm_dims(cfg)
    dt = xs[0].dtype
    if M > 1 and not (dims["up"] == dims["wq"] == dims["wk"] == dims["wv"] == 1
                      and dims["down"] == 0 and dims["wif"] is None):
        raise ValueError("an mLSTM decode over the mesh needs up, wq, wk and wv split by "
                         "columns, down by rows and wif replicated")
    lead = len(idx)
    index = _index(idx, rows)
    Cs = [blocks.piece("ml/C", index, j, m, dev) for m, dev in enumerate(devs)]
    ns = [blocks.piece("ml/n", index, j, m, dev) for m, dev in enumerate(devs)]
    if any(pc.region[lead + 2] != slice(0, P) for pc in Cs):
        raise ValueError("an mLSTM decode over the mesh needs C split over heads or its value "
                         "index, not its key index")
    hs = [rms_norm(x, p["ln"], cfg.norm_eps)[:, 0] for p, x in zip(ps, xs)]
    ups = [h @ p["up"].to(dt) for p, h in zip(ps, hs)]
    uw = ups[0].shape[-1]
    if M == 1:
        x_in = [ups[0][:, :d_in]]
    else:
        x_in = collectives.all_gather([ups[m][..., :min(uw, d_in - m * uw)]
                                       for m in range((d_in + uw - 1) // uw)], -1, devs)
    qb = [x @ p["wq"].to(dt) for p, x in zip(ps, x_in)]
    kb = [x @ p["wk"].to(dt) for p, x in zip(ps, x_in)]
    vb = [x @ p["wv"].to(dt) for p, x in zip(ps, x_in)]
    q, k = (qb, kb) if M == 1 else (collectives.all_gather(qb, -1, devs),
                                    collectives.all_gather(kb, -1, devs))
    B = hs[0].shape[0]
    scale = 1.0 / math.sqrt(P)
    heads, rcols, news, nums, dens = [], [], [], [], []
    for m, (p, dev) in enumerate(zip(ps, devs)):
        qm, km = q[m].reshape(B, H, P).float(), k[m].reshape(B, H, P).float()
        gi, gf = torch.chunk((x_in[m] @ p["wif"].to(dt)).float(), 2, dim=-1)
        fi, ff = torch.exp(_log_sigmoid(gi)), torch.exp(_log_sigmoid(gf))
        hc, rc = Cs[m].region[lead + 1], Cs[m].region[lead + 3]
        spans = [(h * P + rc.start, h * P + rc.stop) for h in range(hc.start, hc.stop)]
        v = take_columns(vb, spans, dev).reshape(B, hc.stop - hc.start, -1).float()
        C = Cs[m].old * ff[:, hc, None, None] + fi[:, hc, None, None] * (
            km[:, hc, :, None] * v[:, :, None, :])
        hn, pn = ns[m].region[lead + 1], ns[m].region[lead + 2]
        n = ns[m].old * ff[:, hn, None] + fi[:, hn, None] * km[:, hn, pn]
        news.append((C, n))
        nums.append(torch.einsum("bhp,bhpr->bhr", qm[:, hc] * scale, C))
        part = torch.zeros((B, H), dtype=torch.float32, device=dev)
        part[:, hn] = torch.einsum("bhp,bhp->bh", qm[:, hn, pn] * scale, n)
        dens.append(part)
        heads.append(hc)
        rcols.append(rc)
    if M > 1:
        dens = collectives.psum(dens, list(devs))
    ys = [(num / torch.clamp(torch.abs(den), min=1.0)[:, hc, None]).to(dt)
          for num, den, hc in zip(nums, dens, heads)]
    cd = d_in // M
    outs = []
    for m, (p, dev) in enumerate(zip(ps, devs)):
        y = channels_to(ys, heads, rcols, P, m * cd, (m + 1) * cd, m, dev)
        z = take_columns(ups, [(d_in + m * cd, d_in + (m + 1) * cd)], dev)
        outs.append(((y * F.silu(z)) @ p["down"].to(dt))[:, None])
    for (C, n), pc, pn in zip(news, Cs, ns):
        sharding.write_piece(pc, C)
        sharding.write_piece(pn, n)
    return outs if M == 1 else collectives.psum(outs, list(devs))


def slstm_decode_row(ps: list, dims: dict, xs: list, cfg: ModelConfig, devs, blocks,
                     idx: tuple, rows: slice, j: int) -> list:
    """:func:`slstm_decode_step` over one data slot's model slots (``xs[m]``
    slot ``m``'s copy of the residual rows (B, 1, d)) against the sLSTM's
    ``c``, ``n``, ``m`` and ``h`` of ``blocks`` (leaves ``sl/*``, each split
    over ``d``) at the stacked index ``idx`` and the global ``rows`` of data
    slot ``j``.

    One step of the recurrence per layer: the old h is all-gathered whole
    (B x d float32), each slot computes its partial recurrent product from
    its rows of ``r`` (the rows of each head's dh that ``param_specs``
    gives it; the whole product where ``r`` is replicated) and the partial
    products are all-reduced.  The reference joins the heads' outputs
    (B, H, 4 dh) into one (B, 4d) vector before cutting the z, i, f, o
    gates from it, so each slot then takes its d-columns of each gate: of
    the sum locally, of the input projection (``wx`` split by columns) in
    one gather.  The cell updates the slot's blocks in place, ``out`` is
    row-parallel on the same columns (a partial sum all-reduced), and the
    FFN runs through :func:`.layers.mlp_row`.  No collective runs per
    head.  Returns each slot's new residual (B, 1, d)."""
    from ..launch import collectives
    from .layers import mlp_row, take_columns

    M = len(devs)
    H, dh = slstm_dims(cfg)
    d = cfg.d_model
    dt = xs[0].dtype
    if M > 1 and not (dims["wx"] == 1 and dims["out"] == 0 and dims["r"] in (1, None)):
        raise ValueError("an sLSTM decode over the mesh needs wx split by columns, out by rows "
                         "and r by its rows or replicated")
    lead = len(idx)
    index = _index(idx, rows)
    st = {f: [blocks.piece(f"sl/{f}", index, j, m, dev) for m, dev in enumerate(devs)]
          for f in ("c", "n", "m", "h")}
    cols = [pc.region[lead + 1] for pc in st["h"]]
    w = d // M
    if any(c != slice(m * w, (m + 1) * w) for m, c in enumerate(cols)) or any(
            pc.region[lead + 1] != c for f in "cnm" for pc, c in zip(st[f], cols)):
        raise ValueError("an sLSTM decode over the mesh needs its state split over d alike")
    hs = [rms_norm(x, p["ln"], cfg.norm_eps)[:, 0] for p, x in zip(ps, xs)]
    xt = [h @ p["wx"].to(dt) for p, h in zip(ps, hs)]
    B = hs[0].shape[0]
    olds = [pc.old for pc in st["h"]]
    h_all = olds if M == 1 else collectives.all_gather(olds, -1, devs)
    if M > 1 and dims["r"] == 1:
        rw = dh // M
        rec = collectives.psum([
            torch.einsum("bhd,hde->bhe", h.reshape(B, H, dh)[:, :, m * rw:(m + 1) * rw],
                         p["r"].float()).reshape(B, 4 * d)
            for m, (p, h) in enumerate(zip(ps, h_all))], list(devs))
    else:
        rec = [torch.einsum("bhd,hde->bhe", h.reshape(B, H, dh), p["r"].float()).reshape(B, 4 * d)
               for p, h in zip(ps, h_all)]
    news, ys = [], []
    for m, (c, dev) in enumerate(zip(cols, devs)):
        spans = [(g * d + c.start, g * d + c.stop) for g in range(4)]
        pre = take_columns(xt, spans, dev).float() + torch.cat(
            [rec[m][:, lo:hi] for lo, hi in spans], dim=-1)
        zt, it, ft, ot = torch.chunk(pre, 4, dim=-1)
        c_old, n_old, m_old = (st[f][m].old for f in "cnm")
        m_new = torch.maximum(ft + m_old, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(ft + m_old - m_new)
        cc = f_ * c_old + i_ * torch.tanh(zt)
        nn = torch.clamp(f_ * n_old + i_, min=1e-6)
        hh = torch.sigmoid(ot) * cc / nn
        news.append({"c": cc, "n": nn, "m": m_new, "h": hh})
        ys.append((hh.to(dt) @ ps[m]["out"].to(dt))[:, None])
    o = ys if M == 1 else collectives.psum(ys, list(devs))
    for m, new in enumerate(news):
        for f in ("c", "n", "m", "h"):
            sharding.write_piece(st[f][m], new[f])
    x2 = [x + a for x, a in zip(xs, o)]
    h2 = [rms_norm(x, p["ln2"], cfg.norm_eps) for p, x in zip(ps, x2)]
    return [x + f for x, f in zip(x2, mlp_row([p["ffn"] for p in ps], dims["ffn"], h2, cfg,
                                               devs))]


_BATCH_DIMS = {"ml/C": 2, "ml/n": 2, "sl/c": 1, "sl/n": 1, "sl/m": 1, "sl/h": 1}


def decode_independent(cfg: ModelConfig, state: XLSTMState, rows: int) -> bool:
    """Whether, under the ambient mesh, each data slot's part of a decode
    step over ``rows`` rows depends on no other data slot's: the rows split
    over every data slot and each state leaf's data split on its batch dim
    (``state_specs`` splits a stacked axis instead where the group count
    equals the batch, as the reference's does)."""
    mesh = abstract_mesh()
    if len(mesh.row_devices(rows)) == 1:
        return False
    return sharding.StateBlocks(state, cfg, mesh, rows).data_dims() == _BATCH_DIMS


def decode_slots(views, state: XLSTMState, tokens_slots: list, cfg: ModelConfig,
                 n_data: Optional[int] = None) -> list:
    """:func:`decode_step` over the ambient mesh's grid (``views`` the
    weights' :class:`.sharding.SlotViews`, ``tokens_slots[jj]`` the rows of
    computing data slot ``views.data_slots[jj]``, with ``n_data`` data slots
    taking rows in all), ``state`` placed by ``state_specs`` or whole: each
    mLSTM layer through :func:`mlstm_decode_row`, each sLSTM layer through
    :func:`slstm_decode_row`, every state block read and written in place
    (a block another data slot holds is read from it and written back to
    it).  Returns each data slot's :class:`.layers.SlotLogits`."""
    mesh = abstract_mesh()
    data_slots = views.data_slots
    n_data = n_data or len(data_slots)
    b = tokens_slots[0].shape[0]
    blocks = sharding.StateBlocks(state, cfg, mesh, b * n_data)
    rows = [slice(j * b, (j + 1) * b) if n_data > 1 else slice(0, b) for j in data_slots]
    devs = [mesh.model_devices(j) for j in data_slots]
    xs = [layers.embed_row(views.top(jj, "embed"), views.dims, t, cfg, dv)
          for jj, (t, dv) in enumerate(zip(tokens_slots, devs))]
    ng, nm = xlstm_group_shape(cfg)
    mdims, sdims = views.entry_dims("mlstm", 2), views.entry_dims("slstm", 1)
    for g in range(ng):
        for jj, j in enumerate(data_slots):
            x = xs[jj]
            for jm in range(nm):
                y = mlstm_decode_row(views.entry(jj, "mlstm", g, jm), mdims, x, cfg, devs[jj],
                                     blocks, (g, jm), rows[jj], j)
                x = [a + o for a, o in zip(x, y)]
            xs[jj] = slstm_decode_row(views.entry(jj, "slstm", g), sdims, x, cfg, devs[jj],
                                      blocks, (g,), rows[jj], j)
    return [layers.unembed_row(views.top(jj, "embed"), views.dims,
                               [rms_norm(a, p["ln_f"], cfg.norm_eps)
                                for p, a in zip(views.top(jj, "ln_f"), xs[jj])], cfg, devs[jj])
            for jj in range(len(data_slots))]


def decode_step(params: dict, state: XLSTMState, token: torch.Tensor, cfg: ModelConfig):
    """One decoding step: token (B, 1) -> (logits (B,1,V), state).  The
    recurrent states are updated in place; the returned state holds the same
    tensors.  Under an ambient mesh the step runs over its grid
    (:func:`decode_slots`), ``params`` placed or whole, ``state`` placed by
    ``state_specs`` or whole."""
    if abstract_mesh() is not None:
        return transformer.mesh_decode(sys.modules[__name__], params, state, token, cfg)
    ng, nm = xlstm_group_shape(cfg)
    ml, sl = state
    with torch.inference_mode():
        x = embed(params["embed"], token, cfg)
        for g in range(ng):
            for j in range(nm):
                y, new = mlstm_decode_step(index_tree(params["mlstm"], g, j), x,
                                           MLSTMState(ml.C[g, j], ml.n[g, j]), cfg)
                ml.C[g, j], ml.n[g, j] = new
                x = x + y
            x, new = slstm_decode_step(index_tree(params["slstm"], g), x,
                                       SLSTMState(*(f[g] for f in sl)), cfg)
            for f, v in zip(sl, new):
                f[g] = v
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return unembed(params["embed"], x, cfg), state
