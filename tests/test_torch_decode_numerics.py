"""The schedule of the decode-attention kernel, on the CPU.

``csrc/decode_attention.cu`` splits each batch row's cache into blocks of
``split_slots`` slots (sized from the grid), walks each split in 64-slot
tiles with an online softmax in float32 (exp2, scores in log2 units), skips
every tile that holds no valid slot when the row holds one (the row rule),
writes (max -1e30, sum 0) for a split with no tile to read, and combines the
splits by rescaling to their common max.  This file emulates that schedule
in plain torch and holds it to ``decode_attention_ref`` under the limits
that ``chip_smoke.py`` holds the card's kernel to: float32 atol 2e-5,
bfloat16 per element 2e-5 + 2^-6 |want|.  It also shows why the row rule is
there: skipping dead tiles without it gives a row with no valid slot 0
instead of the mean of V.  No card and no JAX needed.
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
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import NEG_INF, decode_attention_ref  # noqa: E402

LOG2E = 1.4426950408889634
N_SM = 132  # the H100 SXM's SMs
PER_SM = 2  # split-pass blocks per SM on the H100 at hd 80 and 112 in bf16


def kernel_schedule(q, k, v, mask, *, row_rule=True, n_sm=N_SM, per_sm=PER_SM):
    """The kernel's schedule and arithmetic; returns (out in q's type,
    tiles read per (batch row, KV head))."""
    B, H, hd = q.shape
    C, K = k.shape[1], k.shape[2]
    G = H // K
    split = kdec.split_slots(B, K, G, C, n_sm, per_sm)
    n_split = -(-C // split)
    qf = q.float().view(B, K, G, hd)
    kf, vf = k.float(), v.float()
    c2 = LOG2E / math.sqrt(hd)
    row_live = mask.any(1)
    part_m = torch.full((n_split, B, K, G), NEG_INF)
    part_l = torch.zeros(n_split, B, K, G)
    part_acc = torch.zeros(n_split, B, K, G, hd)
    tiles_read = torch.zeros(B, dtype=torch.long)
    for sp in range(n_split):
        c0, c1 = sp * split, min(C, (sp + 1) * split)
        m = torch.full((B, K, G), NEG_INF)
        l = torch.zeros(B, K, G)
        acc = torch.zeros(B, K, G, hd)
        for cb in range(c0, c1, kdec.TILE):
            ce = min(cb + kdec.TILE, c1)
            read = mask[:, cb:ce].any(1)
            if row_rule:
                read |= ~row_live
            if not bool(read.any()):
                continue
            tiles_read += read
            s = torch.einsum("bkgd,bckd->bkgc", qf, kf[:, cb:ce]) * c2
            s = torch.where(mask[:, None, None, cb:ce], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            r = read[:, None, None]
            l = torch.where(r, alpha * l + p.sum(-1), l)
            acc = torch.where(r[..., None], alpha[..., None] * acc
                              + torch.einsum("bkgc,bckd->bkgd", p, vf[:, cb:ce]), acc)
            m = torch.where(r, m_new, m)
        part_m[sp], part_l[sp], part_acc[sp] = m, l, acc
    # the combine: a split of weight 0 (a skipped one) adds nothing
    m = part_m.amax(0)
    w = torch.exp2(part_m - m)
    l = (w * part_l).sum(0)
    acc = torch.where(w[..., None] > 0, w[..., None] * part_acc, 0.0).sum(0)
    l = torch.where(l == 0, 1.0, l)
    return (acc / l[..., None]).reshape(B, H, hd).to(q.dtype), tiles_read * K


def _inputs(rng, B, C, H, K, hd, dtype, kind):
    def r(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.5).to(dtype)
    q, k, v = r(B, H, hd), r(B, C, K, hd), r(B, C, K, hd)
    slots = np.arange(C)[None, :]
    window = None
    if kind == "empty_slots":
        pos = rng.integers(0, C, B)
        positions = np.where(slots <= pos[:, None], slots, -1)
        positions[:, 0] = -1
    elif kind == "wrapped_window":
        pos = rng.integers(C, 3 * C, B)
        positions = pos[:, None] - ((pos[:, None] - slots) % C)
        window = max(1, C // 3)
    elif kind == "all_empty":
        pos = np.zeros(B, np.int64)
        positions = np.full((B, C), -1)
    else:  # last_split: live slots only in the last split, one row left empty
        split = kdec.split_slots(B, K, H // K, C, N_SM, PER_SM)
        lo = (C - 1) // split * split
        pos = np.full(B, C - 1)
        positions = np.where((slots >= lo) & (rng.random((B, C)) < 0.5), slots, -1)
        positions[-1] = -1
    mask = ops.decode_mask(torch.from_numpy(positions.astype(np.int32)),
                           torch.from_numpy(pos.astype(np.int32)), window)
    return q, k, v, mask


def _limit(want):
    lim = chip_smoke.F32_TOL
    if want.dtype == torch.bfloat16:
        lim = lim + chip_smoke.BF16_RTOL * want.float().abs()
    return lim


SHAPES = [(2, 64, 8, 2, 16), (4, 1024, 32, 8, 80), (4, 1024, 32, 32, 112),
          (1, 100, 4, 4, 64), (3, 300, 16, 2, 128)]  # G = 4, 4, 1, 1, 8


@pytest.mark.parametrize("B,C,H,K,hd", SHAPES)
@pytest.mark.parametrize("kind", ["empty_slots", "wrapped_window", "all_empty", "last_split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_schedule_matches_the_oracle(B, C, H, K, hd, kind, dtype):
    """At 2 and at 1 blocks per SM: shorter splits, or longer ones."""
    q, k, v, mask = _inputs(np.random.default_rng(3), B, C, H, K, hd, dtype, kind)
    want = decode_attention_ref(q, k, v, mask)
    for per_sm in (PER_SM, 1):
        got, _ = kernel_schedule(q, k, v, mask, per_sm=per_sm)
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= _limit(want)).all()), (per_sm, float(diff.max()))


def test_without_the_row_rule_an_empty_row_gets_zero_not_the_mean_of_v():
    B, C, H, K, hd = 2, 300, 8, 2, 64
    q, k, v, mask = _inputs(np.random.default_rng(4), B, C, H, K, hd, torch.float32,
                            "all_empty")
    want = decode_attention_ref(q, k, v, mask)
    mean_v = v.mean(1).repeat_interleave(H // K, dim=1)
    torch.testing.assert_close(want, mean_v, atol=2e-6, rtol=0)
    good, _ = kernel_schedule(q, k, v, mask)
    torch.testing.assert_close(good, want, atol=chip_smoke.F32_TOL, rtol=0)
    bad, tiles = kernel_schedule(q, k, v, mask, row_rule=False)
    assert int(tiles.sum()) == 0 and not bool(bad.any())
    assert float((bad - want).abs().max()) > 100 * chip_smoke.F32_TOL


def test_dead_tiles_are_skipped_at_the_serve_runs_live_count():
    """96 live slots of 1024: 2 tiles per (batch row, KV head) are read, not 16."""
    plan = chip_smoke.decode_plan(torch, "serve_live", 32, 8, 80, 512,
                                  torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    B, C, K = plan["B"], plan["C"], 8
    q = torch.from_numpy(rng.normal(size=(B, 32, 80)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, C, K, 80)).astype(np.float32))
            for _ in range(2))
    got, tiles = kernel_schedule(q, k, v, plan["mask"])
    assert tiles.tolist() == [2 * K] * B
    torch.testing.assert_close(got, decode_attention_ref(q, k, v, plan["mask"]),
                               atol=chip_smoke.F32_TOL, rtol=0)


@pytest.mark.parametrize("B,K,G,C,per_sm,slots,n_split", [
    (4, 8, 4, 1024, 2, 128, 8),      # qwen3-4b's serve step: 256 blocks, one wave of 264
    (4, 32, 1, 1024, 2, 512, 2),     # zamba2-7b's: 256 blocks
    (4, 8, 4, 1024, 4, 64, 16),      # 4 blocks per SM: 512 blocks
    (1, 1, 1, 5, 4, 64, 1),
    (1, 8, 4, 100000, 4, 1536, 66),
    (1, 8, 4, 10 ** 6, 4, 2048, 489),  # capped at 32 tiles
    (64, 8, 4, 1024, 4, 1024, 1),    # a wide batch fills the card unsplit
])
def test_split_is_sized_from_the_grid(B, K, G, C, per_sm, slots, n_split):
    got = kdec.split_slots(B, K, G, C, N_SM, per_sm)
    assert (got, -(-C // got)) == (slots, n_split)
    assert got % kdec.TILE == 0 and got <= kdec.TILE * kdec.MAX_SPLIT_TILES
