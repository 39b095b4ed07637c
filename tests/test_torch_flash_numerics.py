"""The numerical design of the bf16 flash-attention kernel, on the CPU.

``csrc/flash_attention.cu`` (bf16 route) runs QK^T on the tensor cores with
bf16 inputs and float32 sums, an online softmax in float32 over 64-key tiles
(exp2 with scale * log2(e) folded into the scores), and the PV product with
P split as hi + lo in bf16: two products, since the tensor cores take P only
in bf16.  This file emulates that tile arithmetic in plain torch and holds
it to ``flash_attention_ref`` under the limit that ``chip_smoke.py`` holds the
card's kernel to (per element 2e-5 + 2^-6 |want|).  It also shows why P is
split: rounded once to bf16, P breaks that limit.  No card and no JAX needed.
"""

from __future__ import annotations

import math
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import NEG_INF, flash_attention_ref  # noqa: E402

LOG2E = 1.4426950408889634
TILE = 64


def kernel_arithmetic(q, k, v, *, causal=True, window=None, split_p=True):
    """The bf16 kernel's arithmetic, one 64-key tile at a time: float32
    scores of bf16 inputs in log2 units, masked keys at -1e30, a running max
    and sum per row, the accumulator rescaled per tile, P (hi + lo, or hi
    alone) times V in float32, the l == 0 -> 1 guard, one rounding at the end."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(G, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, 2).transpose(1, 2)
    c = LOG2E / math.sqrt(hd)
    m = torch.full((B, H, S, 1), NEG_INF)
    l = torch.zeros(B, H, S, 1)
    o = torch.zeros(B, H, S, hd)
    rows = torch.arange(S)[:, None]
    for kt in range(0, T, TILE):
        kk, vv = kf[:, :, kt:kt + TILE], vf[:, :, kt:kt + TILE]
        s = (qf @ kk.transpose(-1, -2)) * c
        cols = torch.arange(kt, kt + kk.shape[2])[None, :]
        ok = torch.ones(S, cols.shape[1], dtype=torch.bool)
        if causal:
            ok &= rows >= cols
        if window is not None:
            ok &= rows - cols < window
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vv
        if split_p:
            pv = pv + (p - hi).bfloat16().float() @ vv
        o = o * alpha + pv
        m = m_new
    l = torch.where(l == 0, 1.0, l)
    return (o / l).transpose(1, 2).to(q.dtype)


def _inputs(hd, H, K, S=1024, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape):  # chip_smoke.py phase 7's inputs: N(0, 0.25) in bf16
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.5).bfloat16()
    return r(1, S, H, hd), r(1, S, K, hd), r(1, S, K, hd)


def _over_limit(got, want):
    """Share of elements outside chip_smoke.py's bf16 limit, and the worst
    error over its limit."""
    got, want = got.float(), want.float()
    ratio = (got - want).abs() / (chip_smoke.F32_TOL + chip_smoke.BF16_RTOL * want.abs())
    return float((ratio > 1).float().mean()), float(ratio.max())


# qwen3-4b's heads (hd 80, G = 4) and zamba2-7b's (hd 112, G = 1), narrowed
SHAPES = [(80, 8, 2, None), (80, 8, 2, 256), (112, 4, 4, None)]


@pytest.mark.parametrize("hd,H,K,window", SHAPES)
def test_split_p_holds_the_chip_smoke_limit(hd, H, K, window):
    q, k, v = _inputs(hd, H, K)
    want = flash_attention_ref(q, k, v, causal=True, window=window)
    share, worst = _over_limit(kernel_arithmetic(q, k, v, window=window), want)
    assert share == 0.0 and worst <= 0.75, (share, worst)


@pytest.mark.parametrize("hd,H,K,window", SHAPES)
def test_p_rounded_once_to_bf16_breaks_the_limit(hd, H, K, window):
    q, k, v = _inputs(hd, H, K)
    want = flash_attention_ref(q, k, v, causal=True, window=window)
    share, worst = _over_limit(kernel_arithmetic(q, k, v, window=window, split_p=False), want)
    assert share > 1e-3 and worst > 4.0, (share, worst)


def test_cpu_tensors_take_the_plain_version_and_no_route():
    q, k, v = _inputs(80, 4, 2, S=256)
    before = (kfa.flash_attention.launches, dict(kfa.flash_attention.routes))
    got = ops.flash_attention(q, k, v, causal=True, window=100)
    assert torch.equal(got, flash_attention_ref(q, k, v, causal=True, window=100))
    assert (kfa.flash_attention.launches, kfa.flash_attention.routes) == before
    assert set(kfa.flash_attention.routes) == {"tc_bf16", "cuda_f32"}
