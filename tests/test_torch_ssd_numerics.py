"""The numerical design of the Mamba2 SSD intra-chunk kernel, on the CPU.

``csrc/mamba2_ssd.cu`` runs its three products (the scores C.B^T, y = w x
and the chunk state (B * exp(cum_{Q-1} - cum) * dt)^T x) on the tensor cores
in TF32 with error compensation: each operand a is split as hi = a rounded to
TF32 (to nearest, ties away from zero, as ``cvt.rna``) and lo = a - hi cut to
TF32, and a b is summed as hi.lo + lo.hi + hi.hi into float32 accumulators,
one ``mma.sync.m16n8k8`` (8 deep) at a time.  The weights w_ij = s_ij *
exp(cum_i - cum_j) * dt_j, the select above the diagonal and the scan stay in
float32.  This file emulates that arithmetic in plain torch, tile order and
select included, and holds it to ``ssd_intra_chunk_ref`` under the limit
that ``chip_smoke.py`` holds the card's kernel to (per element 2e-5 + 1e-4
|want|).  It also shows why the products are compensated: in plain TF32
(hi.hi alone) they break that limit.

The products are emulated on the reference's cumsum, so that they alone
differ from it: at the model's dt two float32 summation orders of the
running sum already part by more than the limit (the card tests hold both
routes against a float64 oracle there).  The kernel's own scan order is
emulated at the reference's small dt.  No card and no JAX needed.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import mamba2_ssd as kssd  # noqa: E402
from repro_torch.kernels.ref import ssd_intra_chunk_ref  # noqa: E402
from test_torch_model_kernels_cuda import _ssd_inputs  # noqa: E402

# zamba2-7b's chunk and head shapes (Q 256, P = N = 64), a few heads
B, NC, Q, H, P, N = 1, 2, 256, 3, 64, 64
KEYS = 8  # keys (or state columns) per mma.sync step


def tf32_hi(a: torch.Tensor) -> torch.Tensor:
    """a rounded to TF32, to nearest with ties away from zero (on the bits,
    as the kernel does it)."""
    bits = (a.contiguous().view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def tf32_cut(a: torch.Tensor) -> torch.Tensor:
    return (a.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tensor_product(a, b, compensated: bool) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) the way the kernel's mma.sync run it: K
    in steps of 8, each step's product added to a float32 accumulator;
    compensated: hi.lo, lo.hi, then hi.hi; else hi.hi alone."""
    ah, bh = tf32_hi(a), tf32_hi(b)
    al, bl = tf32_cut(a - ah), tf32_cut(b - bh)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k in range(0, a.shape[-1], KEYS):
        s = slice(k, k + KEYS)
        if compensated:
            acc = acc + ah[..., s] @ bl[..., s, :]
            acc = acc + al[..., s] @ bh[..., s, :]
        acc = acc + ah[..., s] @ bh[..., s, :]
    return acc


def kernel_scan(dA: torch.Tensor) -> torch.Tensor:
    """The kernel's inclusive cumsum over the last axis (<= 256 rows, one per
    thread): a Hillis-Steele scan in each warp of 32 rows, then one over the
    8 warp totals, each warp adding the totals of the warps before it."""
    rows = dA.shape[-1]
    v = torch.nn.functional.pad(dA, (0, 256 - rows)).reshape(dA.shape[:-1] + (8, 32))
    for off in (1, 2, 4, 8, 16):
        v = torch.cat([v[..., :off], v[..., off:] + v[..., :-off]], dim=-1)
    tot = v[..., 31]
    for off in (1, 2, 4):
        tot = torch.cat([tot[..., :off], tot[..., off:] + tot[..., :-off]], dim=-1)
    before = torch.cat([torch.zeros_like(tot[..., :1]), tot[..., :-1]], dim=-1)
    return (v + before[..., None]).reshape(dA.shape[:-1] + (256,))[..., :rows]


def kernel_arithmetic(x, dt, A, Bm, Cm, *, compensated=True, scan="reference"):
    """The kernel's function with its arithmetic: returns (y, state, decay)
    in the reference's layouts."""
    Bb, nc, q, h, p = x.shape
    dth = dt.transpose(2, 3)                                    # (B,nc,H,Q)
    dA = dth * A[:, None]
    cum = torch.cumsum(dA, dim=-1) if scan == "reference" else kernel_scan(dA)
    # launch 1: the scores once per chunk, over N in 8-deep steps
    s = tensor_product(Cm, Bm.transpose(-1, -2), compensated)   # (B,nc,Q,Q)
    # launch 2: per head, w with a select above the diagonal (the exp's
    # argument is 0 there), then w x over the keys in 8-key blocks
    i = torch.arange(q)
    tri = i[:, None] >= i[None, :]
    e = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :], 0.0))
    w = torch.where(tri, s[:, :, None] * e * dth[..., None, :], 0.0)
    y = tensor_product(w, x.permute(0, 1, 3, 2, 4), compensated)  # (B,nc,H,Q,P)
    # the state: each half of the keys on its own, the halves then added
    dsc = torch.exp(cum[..., -1:] - cum) * dth                   # (B,nc,H,Q)
    a = (Bm[:, :, None] * dsc[..., None]).transpose(-1, -2)      # (B,nc,H,N,Q)
    xk = x.permute(0, 1, 3, 2, 4)
    half = KEYS * (-(-q // 16))  # keys of the first half: Mq blocks of 8
    st = (tensor_product(a[..., :half], xk[..., :half, :], compensated)
          + tensor_product(a[..., half:], xk[..., half:, :], compensated))
    return y.permute(0, 1, 3, 2, 4), st, torch.exp(cum[..., -1])


def _over_limit(got, want) -> tuple:
    """Share of elements outside chip_smoke.py's SSD limit, and the worst
    error in units of that limit, over y, state and decay."""
    share, worst = 0.0, 0.0
    for g, w in zip(got, want):
        ratio = (g - w).abs() / (chip_smoke.SSD_ATOL + chip_smoke.SSD_RTOL * w.abs())
        share = max(share, float((ratio > 1).float().mean()))
        worst = max(worst, float(ratio.max()))
    return share, worst


def _inputs(kind):
    return _ssd_inputs(np.random.default_rng(6), B, NC, Q, H, P, N, "cpu", kind)


@pytest.mark.parametrize("kind", ["small", "model"])
def test_compensated_tf32_holds_the_chip_smoke_limit(kind):
    ins = _inputs(kind)
    got = kernel_arithmetic(*ins)
    share, worst = _over_limit(got, ssd_intra_chunk_ref(*ins))
    assert share == 0.0 and worst <= 0.25, (share, worst)
    assert all(bool(torch.isfinite(g).all()) for g in got)


@pytest.mark.parametrize("kind", ["small", "model"])
def test_plain_tf32_breaks_the_chip_smoke_limit(kind):
    ins = _inputs(kind)
    share, worst = _over_limit(kernel_arithmetic(*ins, compensated=False),
                               ssd_intra_chunk_ref(*ins))
    assert share > 0.5 and worst > 20.0, (share, worst)


def test_the_kernels_scan_order_holds_the_limit_at_small_dt():
    ins = _inputs("small")
    cum_ref = torch.cumsum(ins[1].transpose(2, 3) * ins[2][:, None], dim=-1)
    cum_kernel = kernel_scan(ins[1].transpose(2, 3) * ins[2][:, None])
    assert not torch.equal(cum_ref, cum_kernel)  # another summation order
    share, worst = _over_limit(kernel_arithmetic(*ins, scan="kernel"), ssd_intra_chunk_ref(*ins))
    assert share == 0.0 and worst <= 0.25, (share, worst)


def test_the_head_group_fills_the_card_in_one_wave():
    # zamba2-7b at full width on 132 SMs: 14 heads a block, 8 blocks a chunk
    assert kssd.head_group(1, 16, 112, 132) == 14
    for b, nc, h in [(1, 16, 112), (2, 3, 5), (1, 48, 8), (4, 200, 112), (1, 1, 1)]:
        g = kssd.head_group(b, nc, h, 132)
        blocks = b * nc * -(-h // g)
        assert 1 <= g <= h and (blocks <= 132 or g == h)
        assert g == 1 or b * nc * -(-h // (g - 1)) > 132  # the fewest heads that fit
    sc, bt = kssd.scratch_floats(1, 16, 256, 64)
    assert sc * 4 == 16 * 139_264 and bt * 4 == 16 * 65_536


def test_cpu_tensors_take_the_plain_version():
    ins = _ssd_inputs(np.random.default_rng(0), 1, 2, 32, 2, 16, 16, "cpu", "small")
    before = kssd.ssd_intra_chunk.launches
    for g, w in zip(kssd.ssd_intra_chunk(*ins), ssd_intra_chunk_ref(*ins)):
        assert torch.equal(g, w)
    assert kssd.ssd_intra_chunk.launches == before
