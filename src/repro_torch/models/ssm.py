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
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from .common import ModelConfig
from .layers import dense_init, rms_norm

__all__ = ["MambaState", "init_mamba2", "init_mamba_state", "mamba2_decode_step",
           "mamba2_forward", "softplus", "ssd_chunked", "ssm_dims"]


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
