"""Wrapper of the hand-written CUDA Mamba2 SSD intra-chunk kernel
(``csrc/mamba2_ssd.cu``), and the chunked SSD built on it.

The port's counterpart of the reference's Pallas
``kernels/mamba2_ssd.py``: :func:`ssd_intra_chunk` computes, per (batch row,
chunk, head), the intra-chunk output, the chunk's state contribution and the
chunk decay; :func:`ssd_chunked_kernel` runs the O(nc) inter-chunk
recurrence around it in plain PyTorch, a loop over the chunks, as the
reference's wrapper runs a ``lax.scan``.

A CUDA tensor launches the kernel on the current stream and adds one to
``ssd_intra_chunk.launches``; a CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.ssd_intra_chunk_ref`).  Nothing falls back:
a CUDA input the kernel does not take raises.  The kernel is two launches
(the chunk's C.B^T scores once, then the heads on the tensor cores); the
wrapper allocates their scratch and sizes the heads' groups from the card's
SMs (:func:`head_group`).  A ``meta`` tensor (the dry run) gets the three
results as meta tensors, allocated as on the card (the scratch left out);
nothing runs.  Both routes tell :func:`~.build.note_launch` of the launch
(:func:`ssd_cost`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import ssd_intra_chunk_ref

__all__ = ["head_group", "scratch_floats", "ssd_chunked_kernel", "ssd_cost", "ssd_intra_chunk"]

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 64, 64
# x, dt, A, B, C, scores, B^T, y, state, decay, B, nc, Q, H, P, N, G, vec
# (then the stream)
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8


def head_group(B: int, nc: int, H: int, n_sm: int) -> int:
    """Heads per block of the heads kernel (one block of 8 warps per batch
    row, chunk and group of heads, one block per SM): the fewest that keep
    the grid within one wave of ``n_sm`` blocks.  On the H100's 132 SMs at
    zamba2-7b's full width (B 1, nc 16, H 112): 14, so 128 blocks."""
    for G in range(max(1, math.ceil(B * nc * H / n_sm)), H):
        if B * nc * -(-H // G) <= n_sm:
            return G
    return H


def scratch_floats(B: int, nc: int, Q: int, N: int) -> tuple:
    """Floats of the kernel's two scratch buffers: the causal C.B^T score
    tiles (16 x 8, Mq (Mq + 1) per chunk, Mq = ceil(Q / 16)) and B^T's tiles
    (ceil(N / 16) x 2 Mq per chunk), 128 floats a tile."""
    mq = -(-Q // 16)
    return B * nc * mq * (mq + 1) * 128, B * nc * -(-N // 16) * 2 * mq * 128


def ssd_cost(B: int, nc: int, Q: int, H: int, P: int, N: int) -> tuple:
    """(bytes, operations) of :func:`ssd_intra_chunk` (chip_smoke.py's bound
    for the row): each float32 input read and each output written once; the
    causal pairs' C.B scores once per chunk, then per head the pairs' w x
    and the chunk state, multiply-adds counting 2."""
    pairs = Q * (Q + 1) // 2
    flops = B * nc * (2 * pairs * N + H * (2 * pairs * P + 2 * Q * N * P))
    nbytes = 4 * (2 * B * nc * Q * H * P + B * nc * H * N * P + 2 * B * nc * Q * N
                  + B * nc * Q * H + B * nc * H + H)
    return nbytes, flops


def ssd_intra_chunk(x, dt, A, Bmat, Cmat) -> tuple:
    """x: (B,nc,Q,H,P); dt: (B,nc,Q,H); A: (H,); Bmat/Cmat: (B,nc,Q,N), all
    float32.  Returns (y (B,nc,Q,H,P), chunk state (B,nc,H,N,P), chunk decay
    (B,nc,H)), float32."""
    dev = x.device
    if dev.type == "cpu":
        return ssd_intra_chunk_ref(x, dt, A, Bmat, Cmat)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_intra_chunk runs on cuda or cpu, not {dev}")
    f32 = torch.float32
    B, nc, Q, H, P = x.shape
    N = Bmat.shape[-1]
    if Q > MAX_CHUNK or P > MAX_HEAD_DIM or N > MAX_STATE:
        raise ValueError(f"chunk {Q}, head dim {P} or state {N} exceeds the kernel's "
                         f"{MAX_CHUNK}, {MAX_HEAD_DIM}, {MAX_STATE}")
    if H >= 2 ** 31 or max(B, nc) >= 2 ** 16:
        raise ValueError(f"shape {(B, nc, H)} exceeds the kernel's grid")
    build.check_tensor("x", x, (B, nc, Q, H, P), f32, dev)
    build.check_tensor("dt", dt, (B, nc, Q, H), f32, dev)
    build.check_tensor("A", A, (H,), f32, dev)
    build.check_tensor("Bmat", Bmat, (B, nc, Q, N), f32, dev)
    build.check_tensor("Cmat", Cmat, (B, nc, Q, N), f32, dev)
    if dev.type == "meta":
        out = (torch.empty_like(x), torch.empty((B, nc, H, N, P), dtype=f32, device=dev),
               torch.empty((B, nc, H), dtype=f32, device=dev))
        if build.LAUNCH_LISTENERS:
            build.note_launch("ssd_intra_chunk", *ssd_cost(B, nc, Q, H, P, N))
        return out
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    G = head_group(B, nc, H, torch.cuda.get_device_properties(idx).multi_processor_count)
    y = torch.empty_like(x)
    st = torch.empty((B, nc, H, N, P), dtype=f32, device=dev)
    dec = torch.empty((B, nc, H), dtype=f32, device=dev)
    n_sc, n_bt = scratch_floats(B, nc, Q, N)
    sc = torch.empty(n_sc, dtype=f32, device=dev)
    bt = torch.empty(n_bt, dtype=f32, device=dev)
    vec = int(P % 4 == 0 and x.data_ptr() % 16 == 0)
    build.launch("mamba2_ssd", "ssd_intra_chunk", _ARGTYPES, x.data_ptr(), dt.data_ptr(),
                 A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(), sc.data_ptr(), bt.data_ptr(),
                 y.data_ptr(), st.data_ptr(), dec.data_ptr(), B, nc, Q, H, P, N, G, vec)
    ssd_intra_chunk.launches += 1
    if build.LAUNCH_LISTENERS:
        build.note_launch("ssd_intra_chunk", *ssd_cost(B, nc, Q, H, P, N))
    return y, st, dec


ssd_intra_chunk.launches = 0


def ssd_chunked_kernel(x, dt, A, Bmat, Cmat, chunk: int) -> tuple:
    """The full SSD through :func:`ssd_intra_chunk` and a plain inter-chunk
    recurrence (the reference's ``mamba2_ssd.py:85-116``).  Same contract as
    :func:`repro_torch.models.ssm.ssd_chunked`: x (B,S,H,P) float32, dt
    (B,S,H), A (H,), Bmat/Cmat (B,S,N); returns (y (B,S,H,P), final state
    (B,H,P,N))."""
    Bb, S, H, P = x.shape
    N = Bmat.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc = S // Q
    xc = x.reshape(Bb, nc, Q, H, P).contiguous()
    dtc = dt.reshape(Bb, nc, Q, H).contiguous()
    Bc = Bmat.reshape(Bb, nc, Q, N).contiguous()
    Cc = Cmat.reshape(Bb, nc, Q, N).contiguous()

    y_intra, chunk_state, chunk_decay = ssd_intra_chunk(xc, dtc, A.contiguous(), Bc, Cc)

    state = torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):                                  # the state BEFORE chunk c
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    prev = torch.stack(prev, dim=1)                      # (B,nc,H,N,P)

    cum = torch.cumsum(dtc * A, dim=2)                   # (B,nc,Q,H)
    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cc, torch.exp(cum), prev)
    y = (y_intra + y_inter).reshape(Bb, S, H, P)
    return y, state.transpose(-1, -2)                    # state as (B,H,P,N)
