"""Mamba2 (state-space duality) blocks, chunked-scan formulation (the port
of the reference's ``models/ssm.py``).

The SSD forward runs in chunks of ``cfg.ssm_chunk``: within-chunk terms are
quadratic in the chunk, the inter-chunk state (B, H, P, N) is carried by a
loop over the chunks.  Decode is the O(1) recurrence.

Shapes follow the Mamba2 paper: d_inner = expand * d_model, H = d_inner / P
heads of head-dim P, a single B/C group, state size N = cfg.ssm_state.

One routing differs from the reference, by design: the reference's
``mamba2_forward`` always takes the plain ``ssd_chunked`` and never reaches
its own SSD kernel, which only ``kernels/ops.ssd_chunked`` calls (its test
holds the two equal at atol 2e-4).  Here, with ``cfg.use_pallas`` ("use the
kernels for hot paths") the forward takes ``kernels.ops.ssd_chunked``, the
hand-written intra-chunk kernel; without it, the plain ``ssd_chunked``, as
the reference does.  The function computed is the same.

Casts follow the reference: x, B and C enter the SSD in float32; the
forward reads ``conv_w``/``conv_b`` in the compute dtype and the decode step
in float32; the gated norm is the plain RMSNorm formula, never the kernel.

:func:`mamba2_row` is the mixer of one data slot over its model slots under
a mesh, each model slot owning a block of the SSM heads where they divide
the axis.  :func:`mamba2_decode_row` is the decode step of one data slot
over its model slots, the conv window and the SSM state read and written in
place in the blocks ``state_specs`` gives them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from .common import ModelConfig
from .layers import dense_init, rms_norm

__all__ = ["MambaState", "channels_to", "heads_parallel", "in_proj_spans", "init_mamba2",
           "init_mamba_state", "mamba2_decode_row", "mamba2_decode_step", "mamba2_forward",
           "mamba2_row", "softplus", "ssd_chunked", "ssm_dims"]


def ssm_dims(cfg: ModelConfig) -> tuple:
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    return d_in, H, cfg.ssm_head_dim, cfg.ssm_state


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, lead: tuple = ()) -> dict:
    """``lead`` prepends axes (the stacked layer axes) to every weight."""
    d = cfg.d_model
    d_in, H, P, N = ssm_dims(cfg)
    conv_dim = d_in + 2 * N                       # x, B, C go through the conv
    pdt, dev = cfg.torch_param_dtype, gen.device
    return {
        "in_proj": dense_init(gen, lead + (d, 2 * d_in + 2 * N + H), pdt, fan_in=d),
        "conv_w": dense_init(gen, lead + (conv_dim, cfg.ssm_conv), pdt, fan_in=cfg.ssm_conv),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=pdt, device=dev),
        "A_log": torch.zeros(lead + (H,), dtype=pdt, device=dev),   # A = -1 at init
        "D": torch.ones(lead + (H,), dtype=pdt, device=dev),
        "dt_bias": torch.zeros(lead + (H,), dtype=pdt, device=dev),
        "norm": torch.ones(lead + (d_in,), dtype=pdt, device=dev),
        "out_proj": dense_init(gen, lead + (d_in, d), pdt, fan_in=d_in),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``.  ``F.softplus``
    is not used: below its threshold of 20 it computes ``log1p(exp(x))``,
    which rounds differently."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, K shifted copies.  x: (B, S, C); w: (C, K)."""
    S = x.shape[1]
    K = w.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + S, :] * w[:, i]
    return out + b


def _segsum_chunk(dA: torch.Tensor) -> torch.Tensor:
    """dA: (..., Q) per-step log-decay.  Returns (..., Q, Q) matrix
    M[i,j] = sum_{t=j+1..i} dA_t  for j <= i, -inf above the diagonal."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]      # cs_i - cs_j
    mask = torch.ones((Q, Q), dtype=torch.bool, device=dA.device).tril()
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, A, Bmat, Cmat, chunk: int) -> tuple:
    """Chunked SSD scan in plain PyTorch.

    x: (B, S, H, P); dt: (B, S, H); A: (H,); Bmat/Cmat: (B, S, N).
    Returns (y (B,S,H,P), final_state (B,H,P,N)).
    """
    Bb, S, H, P = x.shape
    N = Bmat.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc = S // Q

    xc = x.reshape(Bb, nc, Q, H, P)
    dtc = dt.reshape(Bb, nc, Q, H)
    Bc = Bmat.reshape(Bb, nc, Q, N)
    Cc = Cmat.reshape(Bb, nc, Q, N)
    dA = dtc * A                                     # (B,nc,Q,H) log-decay per step
    cs = torch.cumsum(dA, dim=2)                     # within-chunk cumulative

    # Intra-chunk (quadratic in Q): y_i += C_i . sum_{j<=i} exp(cs_i-cs_j) dt_j B_j x_j
    L = _segsum_chunk(dA.transpose(2, 3))            # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)  # (B,nc,Q,Q)
    gated = scores[:, :, None] * torch.exp(L)        # (B,nc,H,Q,Q)
    y_intra = torch.einsum("bchqk,bckh,bckhp->bcqhp", gated, dtc, xc)

    # Inter-chunk state recurrence over chunks.
    decay_out = torch.exp(cs)                                      # (B,nc,Q,H)
    decay_state = torch.exp(cs[:, :, -1:, :] - cs)                 # exp(cs_Q - cs_j)
    chunk_state = torch.einsum("bcqh,bcqh,bcqhp,bcqn->bchpn",
                               decay_state, dtc, xc, Bc)           # per-chunk new-state term
    chunk_decay = torch.exp(cs[:, :, -1, :])                       # (B,nc,H)

    state = torch.zeros((Bb, H, P, N), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):                                            # the state BEFORE chunk c
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    prev_states = torch.stack(prev, dim=1)                         # (B,nc,H,P,N)

    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, decay_out, prev_states)
    y = (y_intra + y_inter).reshape(Bb, S, H, P)
    return y, state


def mamba2_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 mixer.  x: (B, S, d) -> (B, S, d).  With
    ``cfg.use_pallas`` the SSD goes through the intra-chunk kernel."""
    B, S, d = x.shape
    d_in, H, P, N = ssm_dims(cfg)
    dt = x.dtype
    z_x_bc_dt = x @ p["in_proj"].to(dt)
    z, xbc, dtv = torch.split(z_x_bc_dt, [d_in, d_in + 2 * N, H], dim=-1)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"].to(dt), p["conv_b"].to(dt)))
    xs, Bmat, Cmat = torch.split(xbc, [d_in, N, N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    dtv = softplus(dtv.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    if cfg.use_pallas:
        from ..kernels import ops as kops

        ssd = kops.ssd_chunked
    else:
        ssd = ssd_chunked
    y, _ = ssd(xs.float(), dtv, A, Bmat.float(), Cmat.float(), cfg.ssm_chunk)
    y = y + xs.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(B, S, d_in).to(dt)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(dt)


# ---------------------------------------------------------------------------
# Per model slot (tensor parallelism over a data slot's model slots)
# ---------------------------------------------------------------------------

def heads_parallel(cfg: ModelConfig, dims: dict, msize: int) -> bool:
    """Whether a data slot's model slots split the mixer by SSM heads: the
    heads divide the axis and ``param_specs`` splits ``in_proj`` by its
    output columns, ``conv_w`` by channels and ``out_proj`` by rows (the
    heads' channels); else model slot 0 runs the mixer whole."""
    H = ssm_dims(cfg)[1]
    return (msize > 1 and H % msize == 0 and dims["in_proj"] == 1 and dims["conv_w"] == 0
            and dims["out_proj"] == 0)


def in_proj_spans(cfg: ModelConfig, msize: int, m: int) -> list:
    """The ``in_proj`` output columns model slot ``m`` computes with, as
    ``(lo, hi)`` spans in the order it reads them: z and x of its heads,
    B and C (the single group, every slot), dt of its heads."""
    d_in, H, P, N = ssm_dims(cfg)
    c, h, dt0 = d_in // msize, H // msize, 2 * d_in + 2 * N
    return [(m * c, (m + 1) * c), (d_in + m * c, d_in + (m + 1) * c), (2 * d_in, dt0),
            (dt0 + m * h, dt0 + (m + 1) * h)]


def _gated_norm_row(gs: list, scales: list, eps: float, d_in: int, devs) -> list:
    """``rms_norm(g, norm)`` over the whole ``d_in`` channels from each
    model slot's columns ``gs[m]`` (and its scale columns ``scales[m]``):
    each slot's float32 sum of squares is all-reduced over the model slots
    before any slot scales its columns, as the plain formula does."""
    from ..launch import collectives

    g32 = [g.float() for g in gs]
    sq = collectives.psum([(x * x).sum(dim=-1, keepdim=True) for x in g32], list(devs))
    return [(x * torch.rsqrt(s / d_in + eps)).to(g.dtype) * w.to(g.dtype)
            for x, s, g, w in zip(g32, sq, gs, scales)]


def mamba2_row(ps: list, dims: dict, hs: list, cfg: ModelConfig, devs) -> list:
    """:func:`mamba2_forward` over one data slot's model slots (``hs[m]``
    slot ``m``'s copy of the normed rows, ``ps[m]`` its block of the
    layer's weights).  Where the SSM heads divide the axis
    (:func:`heads_parallel`) model slot ``m`` owns heads ``[m H/M, (m+1)
    H/M)``: it computes its block of ``in_proj``'s output columns, and the
    activations move to their heads' owners (:func:`in_proj_spans`, one
    gather a slot; the blocks cross the z | x B C | dt boundaries); the
    depthwise conv's tap rows of its x channels and of B and C come to it
    (a few rows of ``conv_w``: (d_in / M + 2N) x 4 values, where the
    activations they would otherwise meet are B x S times as many); A, D
    and dt_bias are its heads' slices; the SSD runs on its heads; the gated
    RMSNorm's sum of squares is all-reduced over the whole d_in
    (:func:`_gated_norm_row`); ``out_proj``'s rows are its heads', a
    partial sum all-reduced in model-slot order.  Otherwise model slot 0
    runs the mixer with the layer's weights whole and broadcasts.  Returns
    each slot's output."""
    from ..launch import collectives
    from .layers import _whole_tree, take_columns

    M = len(devs)
    if M == 1:
        return [mamba2_forward(ps[0], hs[0], cfg)]
    if not heads_parallel(cfg, dims, M):
        w = _whole_tree(ps, dims, devs[0])
        return collectives.broadcast(mamba2_forward(w, hs[0], cfg), devs)
    d_in, H, P, N = ssm_dims(cfg)
    c, hp = d_in // M, H // M
    dt = hs[0].dtype
    acts = [h @ p["in_proj"].to(dt) for p, h in zip(ps, hs)]
    zxs = [take_columns(acts, in_proj_spans(cfg, M, m), dev) for m, dev in enumerate(devs)]
    conv_rows = [[(m * c, (m + 1) * c), (d_in, d_in + 2 * N)] for m in range(M)]
    ws = [take_columns([p["conv_w"] for p in ps], r, dev, dim=0)
          for r, dev in zip(conv_rows, devs)]
    ys, scales = [], []
    if cfg.use_pallas:
        from ..kernels import ops as kops

        ssd = kops.ssd_chunked
    else:
        ssd = ssd_chunked
    for m, (p, zx, w) in enumerate(zip(ps, zxs, ws)):
        B, S, _ = zx.shape
        z, xbc, dtv = torch.split(zx, [c, c + 2 * N, hp], dim=-1)
        b = torch.cat([p["conv_b"][lo:hi] for lo, hi in conv_rows[m]])
        xbc = F.silu(_causal_conv(xbc, w.to(dt), b.to(dt)))
        xs, Bmat, Cmat = torch.split(xbc, [c, N, N], dim=-1)
        xs = xs.reshape(B, S, hp, P)
        heads = slice(m * hp, (m + 1) * hp)
        dtv = softplus(dtv.float() + p["dt_bias"][heads].float())
        A = -torch.exp(p["A_log"][heads].float())
        y, _ = ssd(xs.float(), dtv, A, Bmat.float(), Cmat.float(), cfg.ssm_chunk)
        y = y + xs.float() * p["D"][heads].float()[None, None, :, None]
        ys.append(y.reshape(B, S, c).to(dt) * F.silu(z))
        scales.append(p["norm"][m * c:(m + 1) * c])
    gs = _gated_norm_row(ys, scales, cfg.norm_eps, d_in, devs)
    return collectives.psum([g @ p["out_proj"].to(dt) for p, g in zip(ps, gs)], list(devs))


# ---------------------------------------------------------------------------
# Decode (O(1) state)
# ---------------------------------------------------------------------------

class MambaState(NamedTuple):
    conv: torch.Tensor    # (B, conv_dim, K-1) last inputs, float32
    ssm: torch.Tensor     # (B, H, P, N), float32


def init_mamba_state(cfg: ModelConfig, batch: int, device=None) -> MambaState:
    """Zero state on ``device`` (``None`` means cuda)."""
    dev = resolve_device(device)
    d_in, H, P, N = ssm_dims(cfg)
    conv_dim = d_in + 2 * N
    return MambaState(
        conv=torch.zeros((batch, conv_dim, cfg.ssm_conv - 1), dtype=torch.float32, device=dev),
        ssm=torch.zeros((batch, H, P, N), dtype=torch.float32, device=dev),
    )


def mamba2_decode_step(p: dict, x: torch.Tensor, state: MambaState,
                       cfg: ModelConfig) -> tuple:
    """x: (B, 1, d) -> (y (B,1,d), state).  Unlike the reference (a pure
    function), this writes the new conv window and SSM state into
    ``state``'s tensors in place and returns the same state."""
    B = x.shape[0]
    d_in, H, P, N = ssm_dims(cfg)
    dt = x.dtype
    z_x_bc_dt = (x @ p["in_proj"].to(dt))[:, 0]
    z, xbc, dtv = torch.split(z_x_bc_dt, [d_in, d_in + 2 * N, H], dim=-1)
    # conv over the stored window + current input
    hist = torch.cat([state.conv, xbc.float()[:, :, None]], dim=-1)
    w = p["conv_w"].float()
    conv_out = (hist * w[None]).sum(-1) + p["conv_b"].float()
    xbc = F.silu(conv_out)
    state.conv.copy_(hist[:, :, 1:])
    xs, Bmat, Cmat = torch.split(xbc, [d_in, N, N], dim=-1)
    xs = xs.reshape(B, H, P)
    dtv = softplus(dtv.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dtv * A)                               # (B, H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dtv, xs, Bmat)
    ssm = state.ssm * decay[..., None, None] + upd
    state.ssm.copy_(ssm)
    y = torch.einsum("bn,bhpn->bhp", Cmat, ssm)
    y = y + xs * p["D"].float()[None, :, None]
    y = y.reshape(B, d_in).to(dt)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = (y @ p["out_proj"].to(dt))[:, None]
    return out, state


# ---------------------------------------------------------------------------
# Decode per model slot, the state where state_specs puts it
# ---------------------------------------------------------------------------

def _rows_of(ps: list, dims: dict, key: str, lo: int, hi: int, m: int, device) -> torch.Tensor:
    """Rows ``[lo, hi)`` of weight ``key`` for model slot ``m``: its own
    block where those are its rows, else those rows gathered from the slots
    that hold them (a few rows of a small weight), or sliced where
    replicated."""
    from .layers import take_columns

    d, w = dims.get(key), ps[m][key]
    if d is None:
        return w[lo:hi]
    if d != 0:
        raise ValueError(f"{key} is split over model on dim {d}, not its rows")
    n = w.shape[0]
    if (lo, hi) == (m * n, (m + 1) * n):
        return w
    return take_columns([p[key] for p in ps], [(lo, hi)], device, dim=0)


def channels_to(parts: list, heads: list, cols: list, P: int, lo: int, hi: int, m: int,
                 device) -> torch.Tensor:
    """The channels ``[lo, hi)`` (channel ``h P + p``) of a (B, H, P) tensor
    held as blocks ``parts[m']`` over heads ``heads[m']`` and columns
    ``cols[m']``, joined on model slot ``m``'s ``device``: one gather
    where another slot holds a piece, none where ``m`` holds them all."""
    from ..launch import collectives

    pieces, own = [], True
    c = lo
    while c < hi:
        h, p = divmod(c, P)
        src = next(k for k, (hs, ps) in enumerate(zip(heads, cols))
                   if hs.start <= h < hs.stop and ps.start <= p < ps.stop)
        e = min(hi, h * P + cols[src].stop)
        pieces.append(parts[src][:, h - heads[src].start,
                                 p - cols[src].start:e - h * P - cols[src].start])
        own = own and src == m
        c = e
    if own:
        return torch.cat(pieces, dim=-1)
    return collectives.gather_to(pieces, -1, device)


def mamba2_decode_row(ps: list, dims: dict, hs: list, cfg: ModelConfig, devs, blocks,
                      idx: tuple, rows: slice, j: int) -> list:
    """:func:`mamba2_decode_step` over one data slot's model slots (``hs[m]``
    slot ``m``'s copy of the normed rows (B, 1, d), ``ps[m]`` its block of
    the layer's weights), against the state of ``blocks`` (a
    :class:`.sharding.StateBlocks` of the :class:`MambaState`) at the
    stacked index ``idx`` and the global ``rows`` of data slot ``j``.

    The state's layout is read from its blocks, not assumed.  Each slot
    computes its block of ``in_proj``'s output columns; one gather a slot
    brings it its z columns (those of its ``out_proj`` rows), the x B C
    channels of its conv-window block and the dt columns of its SSM heads.
    The depthwise conv runs in the conv window's channel blocks (the
    window's tap rows of ``conv_w`` are the slot's own where the window and
    the weight split alike), so the window is read and written in place.
    One gather a slot then moves the conv's output to the SSM state's
    block: its heads' (the state split over heads) or its columns of every
    head (split over the head dim), with B and C whole.  The SSM update and
    ``y = C . ssm`` are local; y moves to ``out_proj``'s row owners (no
    collective where the state splits by heads), the gated RMSNorm's
    float32 sum of squares is all-reduced over d_in
    (:func:`_gated_norm_row`) and ``out_proj`` is row-parallel, a partial
    sum all-reduced in model-slot order.  Every new window and state is
    computed from the old before it is written, each distinct storage once
    (:func:`.sharding.write_piece`).  Returns each slot's output (B, 1, d)."""
    from ..launch import collectives
    from . import sharding
    from .layers import take_columns

    M = len(devs)
    d_in, H, P, N = ssm_dims(cfg)
    conv_dim = d_in + 2 * N
    if M > 1 and (dims["in_proj"] != 1 or dims["out_proj"] != 0):
        raise ValueError(f"a Mamba2 decode over {M} model slots needs in_proj split by columns "
                         f"and out_proj by rows, not {dims['in_proj']} / {dims['out_proj']}")
    dt = hs[0].dtype
    lead = len(idx)
    index = {i: x for i, x in enumerate(idx)} | {lead: rows}
    conv = [blocks.piece("conv", index, j, m, dev) for m, dev in enumerate(devs)]
    ssm = [blocks.piece("ssm", index, j, m, dev) for m, dev in enumerate(devs)]
    cr = [pc.region[lead + 1] for pc in conv]
    heads = [pc.region[lead + 1] for pc in ssm]
    cols = [pc.region[lead + 2] for pc in ssm]
    wc = conv_dim // M
    if any(r != slice(m * wc, (m + 1) * wc) for m, r in enumerate(cr)) or \
            any(pc.region[lead + 2].stop - pc.region[lead + 2].start != cfg.ssm_conv - 1
                for pc in conv) or \
            any(pc.region[lead + 3] != slice(0, N) for pc in ssm):
        raise ValueError("a Mamba2 decode over the mesh needs the conv window split by channels "
                         "and the SSM state by heads or head dim (state_specs' layouts)")
    c = d_in // M
    dt0 = 2 * d_in + 2 * N
    acts = [h[:, 0] @ p["in_proj"].to(dt) for p, h in zip(ps, hs)]
    xbcs, zs, dts, windows = [], [], [], []
    for m, dev in enumerate(devs):
        spans = [(m * c, (m + 1) * c), (d_in + cr[m].start, d_in + cr[m].stop),
                 (dt0 + heads[m].start, dt0 + heads[m].stop)]
        z, xbc, dtv = torch.split(take_columns(acts, spans, dev),
                                  [hi - lo for lo, hi in spans], dim=-1)
        zs.append(z)
        # the depthwise conv in the window's channel blocks
        hist = torch.cat([conv[m].old, xbc.float()[:, :, None]], dim=-1)
        w = _rows_of(ps, dims, "conv_w", cr[m].start, cr[m].stop, m, dev).float()
        b = _rows_of(ps, dims, "conv_b", cr[m].start, cr[m].stop, m, dev).float()
        xbcs.append(F.silu((hist * w[None]).sum(-1) + b))
        windows.append(hist[:, :, 1:])
        dts.append(dtv)
    news, ys = [], []
    for m, (p, dev) in enumerate(zip(ps, devs)):
        hsl, psl = heads[m], cols[m]
        spans = [(h * P + psl.start, h * P + psl.stop) for h in range(hsl.start, hsl.stop)]
        if psl == slice(0, P):
            spans = [(hsl.start * P, hsl.stop * P)]
        xbc = take_columns(xbcs, spans + [(d_in, d_in + 2 * N)], dev)
        nx = (hsl.stop - hsl.start) * (psl.stop - psl.start)
        xs, Bmat, Cmat = torch.split(xbc, [nx, N, N], dim=-1)
        xs = xs.reshape(xs.shape[0], hsl.stop - hsl.start, -1)
        dtv = softplus(dts[m].float() + p["dt_bias"][hsl].float())
        A = -torch.exp(p["A_log"][hsl].float())
        decay = torch.exp(dtv * A)
        upd = torch.einsum("bh,bhp,bn->bhpn", dtv, xs, Bmat)
        new = ssm[m].old * decay[..., None, None] + upd
        news.append(new)
        y = torch.einsum("bn,bhpn->bhp", Cmat, new)
        ys.append((y + xs * p["D"][hsl].float()[None, :, None]).to(dt))
    gs = [channels_to(ys, heads, cols, P, m * c, (m + 1) * c, m, dev) * F.silu(z)
          for m, (z, dev) in enumerate(zip(zs, devs))]
    scales = [p["norm"][m * c:(m + 1) * c] for m, p in enumerate(ps)]
    if M == 1:
        gs = [rms_norm(gs[0], scales[0], cfg.norm_eps)]
    else:
        gs = _gated_norm_row(gs, scales, cfg.norm_eps, d_in, devs)
    outs = [(g @ p["out_proj"].to(dt))[:, None] for p, g in zip(ps, gs)]
    for pc, window, ps_, new in zip(conv, windows, ssm, news):
        sharding.write_piece(pc, window)
        sharding.write_piece(ps_, new)
    return outs if M == 1 else collectives.psum(outs, list(devs))
