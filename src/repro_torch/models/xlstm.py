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
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from .common import ModelConfig
from . import layers
from .layers import (cast_matrices, dense_init, draw_stacked, embed, index_tree, init_embed,
                     init_mlp, mlp, rms_norm, unembed)
from .transformer import _maybe_remat

__all__ = ["MLSTMState", "SLSTMState", "XLSTMState", "decode_step", "ffn_dim", "forward",
           "init_decode_state", "init_mlstm_state", "init_params", "init_slstm_state",
           "mlstm_decode_step", "mlstm_dims", "mlstm_forward", "params_from_numpy",
           "slstm_decode_step", "slstm_dims", "slstm_forward", "train_forward",
           "xlstm_group_shape"]

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
    """q,k,v: (B,S,H,P) fp32; li: log input gate, lf: log forget gate (B,S,H).
    Returns h (B,S,H,P)."""
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

    C = torch.zeros((B, H, P, P), dtype=q.dtype, device=q.device)
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
    return h.reshape(B, S, H, P)


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
    group recomputed in the backward pass when ``cfg.remat == "block"``."""
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


def decode_step(params: dict, state: XLSTMState, token: torch.Tensor, cfg: ModelConfig):
    """One decoding step: token (B, 1) -> (logits (B,1,V), state).  The
    recurrent states are updated in place; the returned state holds the same
    tensors."""
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
