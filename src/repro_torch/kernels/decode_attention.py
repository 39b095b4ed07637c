"""Wrapper of the hand-written CUDA decode-attention kernel
(``csrc/decode_attention.cu``).

The port's counterpart of the reference's Pallas
``kernels/decode_attention.py::decode_attention``: one query token per
(batch row, head) against a KV cache, with a slot-validity mask built by the
caller (:func:`repro_torch.kernels.ops.decode_attention` builds it from the
cache's positions, as the reference's ``ops.py`` does).

``q`` (B, H, hd), ``k``/``v`` (B, C, K, hd) of one type (float32 or
bfloat16), ``mask`` (B, C) bool; returns (B, H, hd) in ``q``'s type, and
with ``return_lse`` also each (row, head)'s log-sum-exp (B, H) float32,
which the kernel's combine pass writes from the max and sum it holds (a
cache split over devices merges its slices' partial results by it).  A CUDA
tensor launches the kernel on the current stream and adds one to
``decode_attention.launches``; a CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.decode_attention_ref`).  Nothing falls back:
a CUDA input the kernel does not take raises.

The wrapper picks what the kernel cannot see: the split of the cache, sized
from the card's SMs and occupancy (:func:`split_slots`, :func:`card_shape`);
16-byte or 2-byte K/V loads, by head dim and alignment; and the scratch for
the splits' partial results, allocated per call.

A ``meta`` tensor (the dry run) gets the result as a meta tensor, allocated
as on the card (the split's scratch, which depends on the card, is left
out); nothing runs.  Both routes tell :func:`~.build.note_launch` of the
launch (:func:`decode_cost`), counting every cache slot live: the analysis
does not read the mask.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import decode_attention_ref
from .rmsnorm import DTYPE_CODES

__all__ = ["decode_attention", "decode_cost"]

MAX_HEAD_DIM = 256
TILE = 64  # cache slots per tile (kTile in the source)
GROUP = 8  # query heads of one KV head per block (kGroup)
MAX_SPLIT_TILES = 32  # tiles per split (kMaxTiles)
# q, k, v, mask, out, lse, part_ml, part_acc, B, C, K, G, hd, split, scale,
# dtype, vec (then the stream)
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int])
_CARD: dict = {}


def split_slots(B: int, K: int, G: int, C: int, n_sm: int, per_sm: int) -> int:
    """Cache slots per block of the split pass: whole tiles, as many splits
    per (batch row, KV head, group of query heads) as let the grid run in one
    wave of ``per_sm`` blocks on each of ``n_sm`` SMs, at most
    ``MAX_SPLIT_TILES`` tiles.  On the H100's 132 SMs at 2 blocks per SM:
    qwen3-4b's serve step (B 4, K 8, G 4, C 1024) 128 slots, 8 splits, 256
    blocks; zamba2-7b's (K 32, G 1) 512 slots, 2 splits, 256 blocks."""
    tiles = max(1, -(-C // TILE))
    blocks = B * K * -(-G // GROUP)
    splits = min(tiles, max(1, per_sm * n_sm // blocks))
    return min(-(-tiles // splits), MAX_SPLIT_TILES) * TILE


def card_shape(dev, hd: int, code: int) -> tuple:
    """(SMs of the card, split-pass blocks of head dim ``hd`` that fit on one
    SM), asked of the card once per (device, hd, dtype)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (idx, hd, code)
    if key not in _CARD:
        f = build.load("decode_attention").decode_attention_blocks_per_sm
        f.argtypes, f.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        with torch.cuda.device(idx):
            per_sm = f(hd, code)
        if per_sm <= 0:
            raise RuntimeError(f"decode_attention: occupancy query failed ({per_sm})")
        _CARD[key] = (torch.cuda.get_device_properties(idx).multi_processor_count, per_sm)
    return _CARD[key]


def decode_cost(B: int, H: int, K: int, hd: int, C: int, itemsize: int,
                live: int = None, lse: bool = False) -> tuple:
    """(bytes, operations) of :func:`decode_attention` over ``live`` live
    slots in all (every slot, ``B * C``, by default): q read and out
    written, the live slots' K and V read (a masked slot's never reach the
    output), the mask read, with ``lse`` the float32 log-sum-exp written;
    q.K and p.V at 2 hd each.  The bound of the row in ``chip_smoke.py``."""
    live = B * C if live is None else live
    return (itemsize * (2 * B * H * hd + 2 * live * K * hd) + B * C + (4 * B * H if lse else 0),
            4 * hd * H * live)


def decode_attention(q, k, v, mask, *, return_lse: bool = False):
    """Softmax attention of each single-token query over its cache slots;
    with ``return_lse``, (out, lse)."""
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_ref(q, k, v, mask, return_lse)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention runs on cuda or cpu, not {dev}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    B, H, hd = q.shape
    C, K = k.shape[1], k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} KV heads")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} exceeds the kernel's {MAX_HEAD_DIM}")
    if dev.type == "meta":
        for name, t, shape, dt in (("q", q, (B, H, hd), q.dtype),
                                   ("k", k, (B, C, K, hd), q.dtype),
                                   ("v", v, (B, C, K, hd), q.dtype),
                                   ("mask", mask, (B, C), torch.bool)):
            build.check_tensor(name, t, shape, dt, dev)
        out = torch.empty_like(q)
        lse = torch.empty((B, H), dtype=torch.float32, device=dev) if return_lse else None
        if build.LAUNCH_LISTENERS:
            build.note_launch("decode_attention", *decode_cost(B, H, K, hd, C, q.element_size(),
                                                               lse=return_lse))
        return (out, lse) if return_lse else out
    G = H // K
    split = split_slots(B, K, G, C, *card_shape(dev, hd, DTYPE_CODES[q.dtype]))
    n_split = -(-C // split)
    if (max(B * C * K * hd, B * H * hd * max(n_split, 1)) >= 2 ** 31
            or max(B, n_split) >= 2 ** 16):
        raise ValueError(f"shape {(B, C, H, hd)} exceeds the kernel's grid")
    build.check_tensor("q", q, (B, H, hd), q.dtype, dev)
    build.check_tensor("k", k, (B, C, K, hd), q.dtype, dev)
    build.check_tensor("v", v, (B, C, K, hd), q.dtype, dev)
    build.check_tensor("mask", mask, (B, C), torch.bool, dev)
    # 16-byte K/V loads need whole 16-byte rows and aligned bases; else 2-byte
    vec = int(hd * q.element_size() % 16 == 0 and k.data_ptr() % 16 == 0
              and v.data_ptr() % 16 == 0)
    out = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev) if return_lse else None
    part_ml = torch.empty((B, H, n_split, 2), dtype=torch.float32, device=dev)
    part_acc = torch.empty((B, H, n_split, hd), dtype=torch.float32, device=dev)
    build.launch("decode_attention", "decode_attention", _ARGTYPES, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), part_ml.data_ptr(),
                 part_acc.data_ptr(), B, C, K, G, hd, split, 1.0 / math.sqrt(hd),
                 DTYPE_CODES[q.dtype], vec)
    decode_attention.launches += 1
    if build.LAUNCH_LISTENERS:
        build.note_launch("decode_attention", *decode_cost(B, H, K, hd, C, q.element_size(),
                                                           lse=return_lse))
    return (out, lse) if return_lse else out


decode_attention.launches = 0
