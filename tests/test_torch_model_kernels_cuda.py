"""The hand-written CUDA model kernels (RMSNorm, RMSNorm + residual, flash
attention, decode attention, the Mamba2 SSD intra-chunk kernel) against their
plain PyTorch versions, on the card; and the smoke models' prefill, decode
and train steps on the card against the cpu.

These tests need a CUDA device (marker ``cuda``) and skip without one.  The
file imports only torch, numpy and the port, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_model_kernels_cuda.py

Inputs are random with a fixed seed.  Tolerance: atol 2e-5 in float32 (the
reference's kernel tests); in bfloat16, per element 2e-5 + 2^-6 |want| (two
bf16 spacings of the value), since both sides compute in float32 and round
once, so they differ only in summation order and may round a near-tie apart.
The SSD kernel (float32 only): per element 2e-5 + 1e-4 |want| at the
reference's test inputs (small dt), since its sums run in another order; at
the model's dt, where exp(cum_i - cum_j) carries the rounding of a running
sum of ~-180, both float32 routes are held against a float64 oracle instead.
"""

import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import mamba2_ssd as kssd
from repro_torch.kernels import rmsnorm as krn
from repro_torch.launch import first_forward_probe
from repro_torch.models import get_model

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _rand(rng, shape, dtype, device, scale=0.5):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(
        device=device, dtype=DTYPES[dtype])


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    lim = 2e-5 + (2.0 ** -6 * want.float().abs() if dtype == "bfloat16" else 0.0)
    assert bool((diff <= lim).all()), float(diff.max())


@pytest.mark.parametrize("shape", [(4, 256), (2, 128, 256), (3, 7, 512), (5, 100),
                                   (4096, 2560)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain(cuda_device, shape, dtype):
    rng = np.random.default_rng(0)
    x = _rand(rng, shape, dtype, cuda_device)
    sc = _rand(rng, shape[-1:], "float32", cuda_device)
    before = krn.rmsnorm.launches
    got = ops.rmsnorm(x, sc, eps=1e-6)
    assert krn.rmsnorm.launches == before + 1
    _close(got, ref.rmsnorm_ref(x, sc, eps=1e-6), dtype)


@pytest.mark.parametrize("shape", [(4, 64, 256), (7, 100), (4096, 2560)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_residual_kernel_matches_plain(cuda_device, shape, dtype):
    rng = np.random.default_rng(1)
    x, r = _rand(rng, shape, dtype, cuda_device), _rand(rng, shape, dtype, cuda_device)
    sc = _rand(rng, shape[-1:], "float32", cuda_device)
    before = krn.rmsnorm_residual.launches
    got = ops.rmsnorm_residual(x, r, sc)
    assert krn.rmsnorm_residual.launches == before + 1
    want = ref.rmsnorm_residual_ref(x, r, sc)
    _close(got[0], want[0], dtype)
    torch.testing.assert_close(got[1], want[1], atol=0, rtol=0)  # one rounding of one sum


@pytest.mark.parametrize("B,S,T,H,K,hd,causal,window", [
    (1, 256, 256, 4, 2, 16, True, None),
    (2, 256, 256, 8, 2, 64, True, None),
    (1, 512, 512, 8, 2, 80, True, None),
    (1, 384, 384, 6, 3, 128, False, None),
    (1, 200, 200, 4, 1, 80, True, 50),
    (2, 100, 100, 4, 4, 48, False, 30),
    (1, 1024, 1024, 32, 8, 80, True, 256),
    (1, 512, 512, 8, 8, 112, True, None),
    (2, 300, 300, 4, 4, 112, False, 100),
    # the bf16 kernel's edges: head dims zero-padded to its tile (160, 256;
    # 20 and an odd 37 also take 2-byte loads and stores), S and T off the
    # 128-row and 64-key tiles with S != T, G = 8, a window smaller than one
    # key tile that crosses tile edges, S < 64
    (1, 256, 256, 4, 2, 160, True, None),
    (1, 300, 300, 2, 1, 256, True, 100),
    (2, 200, 200, 4, 4, 256, False, None),
    (1, 333, 517, 8, 2, 80, True, None),
    (2, 517, 333, 4, 1, 112, True, None),
    (1, 190, 250, 4, 2, 64, False, None),
    (1, 300, 300, 16, 2, 64, True, None),
    (1, 700, 700, 8, 1, 80, True, 40),
    (1, 200, 200, 4, 2, 112, False, 20),
    (1, 50, 50, 4, 2, 80, True, None),
    (2, 40, 70, 4, 4, 112, False, 20),
    (1, 130, 130, 4, 2, 20, True, None),
    (1, 129, 129, 2, 1, 37, True, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(cuda_device, B, S, T, H, K, hd, causal, window,
                                              dtype):
    rng = np.random.default_rng(2)
    q = _rand(rng, (B, S, H, hd), dtype, cuda_device)
    k = _rand(rng, (B, T, K, hd), dtype, cuda_device)
    v = _rand(rng, (B, T, K, hd), dtype, cuda_device)
    before = kfa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert kfa.flash_attention.launches == before + 1
    _close(got, ref.flash_attention_ref(q, k, v, causal=causal, window=window), dtype)


def test_flash_attention_route_follows_the_dtype(cuda_device):
    """bfloat16 takes the tensor-core kernel, float32 the CUDA-core one; each
    call moves its own route's counter and no other."""
    rng = np.random.default_rng(11)
    for dtype, route in (("bfloat16", "tc_bf16"), ("float32", "cuda_f32")):
        q, k, v = (_rand(rng, (1, 200, 4, 80), dtype, cuda_device) for _ in range(3))
        before = dict(kfa.flash_attention.routes)
        ops.flash_attention(q, k, v)
        after = dict(kfa.flash_attention.routes)
        assert after == before | {route: before[route] + 1}, (dtype, before, after)


def test_flash_attention_bf16_route_raises_rather_than_taking_the_f32_kernel(cuda_device):
    """What the bf16 route refuses raises: nothing is converted to float32
    and sent down the other route."""
    rng = np.random.default_rng(12)
    q = _rand(rng, (1, 64, 4, 80), "bfloat16", cuda_device)
    before = (kfa.flash_attention.launches, dict(kfa.flash_attention.routes))
    with pytest.raises(TypeError):  # k and v in float32
        ops.flash_attention(q, q.float(), q.float())
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())
    big = _rand(rng, (1, 64, 4, 264), "bfloat16", cuda_device)
    with pytest.raises(ValueError):  # head dim past the kernel's 256
        ops.flash_attention(big, big, big)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, window=0)
    assert (kfa.flash_attention.launches, kfa.flash_attention.routes) == before


@pytest.mark.parametrize("B,C,H,K,hd", [(2, 64, 8, 2, 16), (4, 1024, 32, 8, 80),
                                        (4, 1024, 32, 32, 112),
                                        (1, 100, 4, 4, 64), (3, 300, 16, 2, 128)])
@pytest.mark.parametrize("kind", ["empty_slots", "wrapped_window", "all_empty"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_kernel_matches_plain(cuda_device, B, C, H, K, hd, kind, dtype):
    """Empty slots, a wrapped ring under a window, and rows with no valid slot
    at all (which get equal weights on every slot, as the oracle's softmax
    gives them)."""
    rng = np.random.default_rng(3)
    q = _rand(rng, (B, H, hd), dtype, cuda_device)
    k = _rand(rng, (B, C, K, hd), dtype, cuda_device)
    v = _rand(rng, (B, C, K, hd), dtype, cuda_device)
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
    else:
        pos = np.zeros(B, np.int64)
        positions = np.full((B, C), -1)
    positions = torch.from_numpy(positions.astype(np.int32)).to(cuda_device)
    pos = torch.from_numpy(pos.astype(np.int32)).to(cuda_device)
    mask = ops.decode_mask(positions, pos, window)
    before = kdec.decode_attention.launches
    got = ops.decode_attention(q, k, v, positions, pos, window=window)
    assert kdec.decode_attention.launches == before + 1
    _close(got, ref.decode_attention_ref(q, k, v, mask), dtype)


def _decode_case(rng, B, C, H, K, hd, dtype, device, valid, offset=0):
    """q, k, v (views ``offset`` elements into their buffers, still
    contiguous) and a mask of ``valid`` (B, C) numpy bools."""
    def r(shape):
        n = int(np.prod(shape))
        buf = _rand(rng, (n + offset,), dtype, device)
        return buf[offset:].view(shape)
    q, k, v = r((B, H, hd)), r((B, C, K, hd)), r((B, C, K, hd))
    return q, k, v, torch.from_numpy(valid).to(device)


def _decode_valid(kind, B, C, K, G, rng, hd=80, dtype="bfloat16"):
    slots = np.arange(C)[None, :]
    if kind == "serve_live":  # the serve runs' 96 live slots of 1024
        return np.broadcast_to(slots <= 95, (B, C)).copy()
    if kind == "last_split":  # live slots confined to the last split
        code = 1 if dtype == "bfloat16" else 0
        split = kdec.split_slots(B, K, G, C, *kdec.card_shape(torch.device("cuda"), hd, code))
        lo = (C - 1) // split * split
        return np.broadcast_to(slots >= lo, (B, C)) & (rng.random((B, C)) < 0.5)
    return rng.random((B, C)) < 0.3  # scattered


@pytest.mark.parametrize("B,C,H,K,hd,kind,offset", [
    (4, 1024, 32, 8, 80, "serve_live", 0),
    (4, 1024, 32, 32, 112, "serve_live", 0),
    (4, 1024, 32, 8, 80, "last_split", 0),
    (2, 1000, 32, 8, 80, "last_split", 0),
    (2, 300, 8, 2, 100, "scattered", 0),   # hd * 2 bytes not a multiple of 16
    (3, 129, 4, 4, 36, "scattered", 0),
    (2, 257, 8, 2, 80, "scattered", 1),    # views 2 (bf16) / 4 bytes off 16-byte alignment
    (1, 1024, 32, 32, 112, "serve_live", 1),
    (4, 1024, 64, 8, 80, "scattered", 0),  # G = 8
    (2, 333, 16, 2, 128, "last_split", 0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_kernel_skips_dead_tiles_and_takes_every_layout(
        cuda_device, B, C, H, K, hd, kind, offset, dtype):
    """The serve runs' live count, live slots in one split only, head dims
    that take the 2-byte path, misaligned views, G = 8: equal to the plain
    version within the limits, one launch each."""
    rng = np.random.default_rng(13)
    q, k, v, mask = _decode_case(rng, B, C, H, K, hd, dtype, cuda_device,
                                 _decode_valid(kind, B, C, K, H // K, rng, hd, dtype), offset)
    assert q.is_contiguous() and (offset == 0) == (k.data_ptr() % 16 == 0)
    before = kdec.decode_attention.launches
    got = kdec.decode_attention(q, k, v, mask)
    assert kdec.decode_attention.launches == before + 1
    _close(got, ref.decode_attention_ref(q, k, v, mask), dtype)


def test_decode_attention_launches_at_most_two_kernels_per_call(cuda_device):
    """The split pass and the combine, and nothing else."""
    rng = np.random.default_rng(16)
    q, k, v, mask = _decode_case(rng, 4, 1024, 32, 8, 80, "bfloat16", cuda_device,
                                 _decode_valid("serve_live", 4, 1024, 8, 4, rng))
    kdec.decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        kdec.decode_attention(q, k, v, mask)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and "Memcpy" not in e.name and "Memset" not in e.name]
    assert len(names) == 2, names
    assert sum("decode_attention_split" in n for n in names) == 1, names
    assert sum("decode_attention_combine" in n for n in names) == 1, names


RMS_WIDTHS = [2560, 3584, 4096, 5120, 8192, 2561, 12288]


@pytest.mark.parametrize("d", RMS_WIDTHS)
@pytest.mark.parametrize("rows", [1, 7, 4097])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_at_the_config_widths(cuda_device, d, rows, dtype):
    """Both RMSNorm kernels at the configs' widths and at widths only the
    block kernel takes (2561: not whole 16-byte vectors; 12288, and 5120 or
    8192 in float32: wider than the warp kernel holds)."""
    rng = np.random.default_rng(14)
    x = _rand(rng, (rows, d), dtype, cuda_device)
    sc = _rand(rng, (d,), "float32", cuda_device)
    vec = 8 if dtype == "bfloat16" else 4
    assert krn.rmsnorm_route(x, sc) == (
        "warp" if d % vec == 0 and d <= 32 * krn.WARP_MAX_VECTORS * vec else "block")
    before = krn.rmsnorm.launches
    got = ops.rmsnorm(x, sc, eps=1e-6)
    assert krn.rmsnorm.launches == before + 1
    _close(got, ref.rmsnorm_ref(x, sc, eps=1e-6), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_on_a_misaligned_row_start(cuda_device, dtype):
    """A contiguous view one element into its buffer takes the block kernel."""
    rng = np.random.default_rng(15)
    d, rows = 2560, 33
    x = _rand(rng, (rows * d + 1,), dtype, cuda_device)[1:].view(rows, d)
    sc = _rand(rng, (d,), "float32", cuda_device)
    assert krn.rmsnorm_route(x, sc) == "block"
    before = krn.rmsnorm.launches
    got = ops.rmsnorm(x, sc, eps=1e-6)
    assert krn.rmsnorm.launches == before + 1
    _close(got, ref.rmsnorm_ref(x, sc, eps=1e-6), dtype)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    rng = np.random.default_rng(4)
    x = _rand(rng, (4, 64), "bfloat16", cuda_device)
    sc = _rand(rng, (64,), "float32", cuda_device)
    with pytest.raises(TypeError):
        ops.rmsnorm(x, sc.bfloat16())
    with pytest.raises(TypeError):
        ops.rmsnorm(x.half(), sc)
    with pytest.raises(ValueError):
        ops.rmsnorm(x.T.contiguous().T, sc)
    q = _rand(rng, (1, 64, 4, 16), "bfloat16", cuda_device)
    k = _rand(rng, (1, 64, 3, 16), "bfloat16", cuda_device)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError):  # a strided view, not contiguous
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2].contiguous())
    big = _rand(rng, (1, 64, 4, 264), "bfloat16", cuda_device)
    with pytest.raises(ValueError):
        ops.flash_attention(big, big, big)
    qd = _rand(rng, (2, 4, 16), "bfloat16", cuda_device)
    kd = _rand(rng, (2, 8, 2, 16), "bfloat16", cuda_device)
    with pytest.raises(ValueError):
        kdec.decode_attention(qd, kd, kd, torch.ones((2, 8), dtype=torch.bool))
    with pytest.raises(TypeError):
        kdec.decode_attention(qd, kd.float(), kd, torch.ones((2, 8), dtype=torch.bool,
                                                             device=cuda_device))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_model_on_card_matches_cpu(cuda_device, dtype, tmp_path):
    """The smoke qwen3-4b with kernels on the card against the same model
    with plain versions on the CPU: a forward that takes the flash kernel
    (S = 1536) and 6 decode steps.  float32 logits within 1e-4 (summation
    order only); bfloat16 within the reference's model criterion.

    The float32 reference is the plain CPU forward, run in a child process
    with ``MKL_CBWR=COMPATIBLE`` (``chip_smoke.cpu_refs_in_child``).  Where
    ``REPRO_TORCH_FORWARD_RECORD`` names a file, the CPU forward instead runs
    twice with every op recorded (``first_forward_probe.recorded_cpu_forwards``),
    in this process after the tests before it: the first is held to the
    limit, and the record (whether the two repeat, the first op that differs)
    goes onto one JSON line of the file.  On a miss, the recorded forwards
    run after it and their record joins the failure message."""
    cfg = get_smoke_config("qwen3-4b").replace(dtype=dtype, use_pallas=True)
    api = get_model(cfg)
    params = api.init(0, "cpu")
    on_card = _to(params, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(5).integers(1, cfg.vocab_size, (1, 1536)))
    before = (krn.rmsnorm.launches, kfa.flash_attention.launches)
    got, _ = api.forward(on_card, {"tokens": toks.to(cuda_device)}, cfg)
    assert krn.rmsnorm.launches > before[0] and kfa.flash_attention.launches > before[1]
    record = os.environ.get("REPRO_TORCH_FORWARD_RECORD") if dtype == "float32" else None
    if record:
        want, _, rec = first_forward_probe.recorded_cpu_forwards(api, params, toks, cfg, got)
        with open(record, "a") as f:
            f.write(json.dumps(rec) + "\n")
    elif dtype == "float32":
        sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
        import chip_smoke

        inputs = {"params": params, "toks": toks, "batch": {"tokens": toks}}
        want = chip_smoke.cpu_refs_in_child(torch, {"qwen3-4b": inputs}, tmp_path)
        want, rec = want["qwen3-4b"]["forward"], None
    else:
        want, _ = api.forward(params, {"tokens": toks}, cfg)
        rec = None

    def diagnose():
        cpu = rec or first_forward_probe.recorded_cpu_forwards(api, params, toks, cfg, got)[2]
        return {"cpu_forwards": cpu} | _diagnose(api, cfg, params, on_card, toks, got, want)

    _check_logits(got.cpu(), want, dtype, diagnose=diagnose)
    st_card, st_cpu = api.init_decode_state(2, 8, cuda_device), api.init_decode_state(2, 8, "cpu")
    before = kdec.decode_attention.launches
    for t in range(6):
        tok = toks[:, t:t + 2].reshape(2, 1)
        got, st_card = api.decode(on_card, st_card, tok.to(cuda_device))
        want, st_cpu = api.decode(params, st_cpu, tok)
        _check_logits(got.cpu(), want, dtype)
    assert kdec.decode_attention.launches == before + 6 * cfg.n_layers


# (B, nc, Q, H, P, N): zamba2's smoke config at S = 1536, its full width at
# S = 4096, and odd edges (P = 48, Q not a multiple of the 64-row tile)
SSD_SHAPES = [(1, 48, 32, 8, 32, 16), (1, 16, 256, 112, 64, 64), (2, 3, 16, 4, 16, 16),
              (1, 2, 100, 5, 48, 32), (2, 2, 64, 3, 64, 64)]


def _ssd_inputs(rng, B, nc, Q, H, P, N, device, dt_kind):
    """x, B, C ~ N(0, 0.25); dt small (the reference's kernel tests) or as
    the model makes it at init (softplus of N(0, 1), A = -1), where the
    decays underflow to 0 within a chunk."""
    def r(*shape, scale=0.5):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)
    x, Bm, Cm = r(B, nc, Q, H, P), r(B, nc, Q, N), r(B, nc, Q, N)
    if dt_kind == "small":
        dt, A = r(B, nc, Q, H).abs() * 0.1, -r(H).abs() * 0.5
    else:
        dt = torch.nn.functional.softplus(r(B, nc, Q, H, scale=1.0))
        A = -torch.ones(H, device=device)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("B,nc,Q,H,P,N", SSD_SHAPES)
def test_ssd_intra_chunk_kernel_matches_plain(cuda_device, B, nc, Q, H, P, N):
    ins = _ssd_inputs(np.random.default_rng(6), B, nc, Q, H, P, N, cuda_device, "small")
    before = kssd.ssd_intra_chunk.launches
    got = kssd.ssd_intra_chunk(*ins)
    assert kssd.ssd_intra_chunk.launches == before + 1
    want = ref.ssd_intra_chunk_ref(*ins)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        diff = (g - w).abs()
        assert bool((diff <= 2e-5 + 1e-4 * w.abs()).all()), float(diff.max())


# partly filled last tiles of each product: Q = 100 (a 16-row tile and an
# 8-key block cut short), P = 20 (an 8-column tile cut short), N = 24 (the
# scores' last 8-deep step and the state's last 16-row tile cut short); Q = 7
# and P = 6 (one tile, mostly empty; rows of 24 bytes, copied 4 bytes at a
# time); and, with nc from the card's SMs, 5 heads in groups of 2 and of 3
# (the last block of a chunk takes fewer heads)
SSD_EDGES = [(1, 2, 100, 5, 20, 24), (1, 1, 7, 3, 6, 8), (1, 2, 64, 5, 64, 64),
             (2, "sms/6", 16, 5, 16, 16), (2, "sms/4", 16, 5, 16, 16)]


@pytest.mark.parametrize("B,nc,Q,H,P,N", SSD_EDGES)
def test_ssd_kernel_partial_tiles_and_head_groups_match_plain(cuda_device, B, nc, Q, H, P, N):
    if isinstance(nc, str):
        sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        nc = sms // int(nc.split("/")[1])
        assert H % kssd.head_group(B, nc, H, sms) != 0
    ins = _ssd_inputs(np.random.default_rng(11), B, nc, Q, H, P, N, cuda_device, "small")
    before = kssd.ssd_intra_chunk.launches
    got = kssd.ssd_intra_chunk(*ins)
    assert kssd.ssd_intra_chunk.launches == before + 1
    want = ref.ssd_intra_chunk_ref(*ins)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        diff = (g - w).abs()
        assert bool((diff <= 2e-5 + 1e-4 * w.abs()).all()), float(diff.max())


@pytest.mark.parametrize("B,nc,Q,H,P,N", [SSD_SHAPES[0], SSD_SHAPES[1], SSD_SHAPES[4]])
def test_ssd_kernel_route_at_model_dt_is_as_accurate_as_the_plain_route(
        cuda_device, B, nc, Q, H, P, N):
    """At the model's dt the running sum cum reaches ~-0.7 Q, and two float32
    summation orders of it part by ~1e-4 in exp(cum_i - cum_j): the kernel
    and its plain version then differ by up to ~3e-4.  So here both float32
    routes of the whole SSD (the kernel's, ``ops.ssd_chunked``, and the
    plain ``ssd_chunked`` of the model) are held against the sequential
    oracle in float64: the kernel route's error is at most 4x the plain
    route's (+ 1e-5), and everything is finite (the decays underflow to 0)."""
    from repro_torch.models.ssm import ssd_chunked

    x, dt, A, Bm, Cm = _ssd_inputs(np.random.default_rng(10), B, nc, Q, H, P, N, cuda_device,
                                   "model")
    S = nc * Q
    args = (x.reshape(B, S, H, P), dt.reshape(B, S, H), A, Bm.reshape(B, S, N),
            Cm.reshape(B, S, N))
    truth = ref.ssd_ref(*(a.double() for a in args))
    kernel = ops.ssd_chunked(*args, chunk=Q)
    plain = ssd_chunked(*args, Q)
    for k, p, t in zip(kernel, plain, truth):
        assert bool(torch.isfinite(k).all())
        k_err, p_err = float((k.double() - t).abs().max()), float((p.double() - t).abs().max())
        assert k_err <= 4 * p_err + 1e-5, (k_err, p_err)


def test_ssd_chunked_kernel_matches_sequential_oracle(cuda_device):
    """The kernel route of the whole SSD against the step-by-step oracle at
    the reference's SSD tolerance (atol 2e-4)."""
    B, nc, Q, H, P, N = 2, 4, 32, 4, 32, 16
    x, dt, A, Bm, Cm = _ssd_inputs(np.random.default_rng(7), B, nc, Q, H, P, N, cuda_device,
                                   "small")
    S = nc * Q
    args = (x.reshape(B, S, H, P), dt.reshape(B, S, H), A, Bm.reshape(B, S, N),
            Cm.reshape(B, S, N))
    got = ops.ssd_chunked(*args, chunk=Q)
    want = ref.ssd_ref(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-4, rtol=0)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    rng = np.random.default_rng(8)
    ins = _ssd_inputs(rng, 1, 2, 32, 2, 16, 16, cuda_device, "small")
    with pytest.raises(TypeError):
        kssd.ssd_intra_chunk(ins[0].bfloat16(), *ins[1:])
    with pytest.raises(ValueError):  # a strided view, not contiguous
        kssd.ssd_intra_chunk(ins[0].transpose(1, 2).contiguous().transpose(1, 2), *ins[1:])
    with pytest.raises(ValueError):
        kssd.ssd_intra_chunk(*ins[:4], ins[4].cpu())
    big = _ssd_inputs(rng, 1, 1, 32, 2, 128, 16, cuda_device, "small")
    with pytest.raises(ValueError):
        kssd.ssd_intra_chunk(*big)


@pytest.mark.parametrize("dtype,S", [("float32", 1536), ("bfloat16", 64)])
def test_smoke_hybrid_on_card_matches_cpu(cuda_device, dtype, S):
    """zamba2's smoke config with kernels on the card against the same model
    with plain versions on the CPU: a forward through the SSD kernel (and
    flash attention at S = 1536) and 6 decode steps through decode
    attention.  float32 forward logits within 3e-4 (the hybrid's carried
    rounding, see ``tests/test_torch_hybrid.py``), decode within 1e-4;
    bfloat16 within the reference's model criterion, at S = 64: at S = 1536
    the SSD's summation order alone moves this model's bf16 logits by up to
    0.26 of the 0.35 allowed (``python -m repro_torch.launch.rounding_probe
    --device cpu --seed 0``), too close to tell a fault from rounding."""
    cfg = get_smoke_config("zamba2-7b").replace(dtype=dtype, use_pallas=True)
    api = get_model(cfg)
    params = api.init(0, "cpu")
    on_card = _to(params, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(9).integers(1, cfg.vocab_size, (1, S)))
    before = (kssd.ssd_intra_chunk.launches, kfa.flash_attention.launches,
              krn.rmsnorm.launches)
    got, _ = api.forward(on_card, {"tokens": toks.to(cuda_device)}, cfg)
    ng = -(-cfg.n_layers // cfg.attn_every)
    assert kssd.ssd_intra_chunk.launches == before[0] + ng * cfg.attn_every
    assert kfa.flash_attention.launches == before[1] + (ng if S > 1024 else 0)
    assert krn.rmsnorm.launches == before[2]
    want, _ = api.forward(params, {"tokens": toks}, cfg)
    _check_logits(got.cpu(), want, dtype, f32_tol=3e-4)
    st_card, st_cpu = api.init_decode_state(2, 8, cuda_device), api.init_decode_state(2, 8, "cpu")
    before = kdec.decode_attention.launches
    for t in range(6):
        tok = toks[:, t:t + 2].reshape(2, 1)
        got, st_card = api.decode(on_card, st_card, tok.to(cuda_device))
        want, st_cpu = api.decode(params, st_cpu, tok)
        _check_logits(got.cpu(), want, dtype)
    assert kdec.decode_attention.launches == before + 6 * ng


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _diagnose(api, cfg, params, card, toks, got, want) -> dict:
    """chip_smoke.py's diagnosis of a card forward that parts from the cpu
    one (a second card forward, the parameters whose card copy differs, each
    layer's gap, each kernel call against its plain version)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke.diagnose_forward(torch, api, cfg, params, card, toks, got, want)


def _check_logits(got, want, dtype, f32_tol=1e-4, diagnose=None):
    """``diagnose`` (float32 only) is called when the check fails, and its
    result goes into the failure message."""
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    if dtype == "float32":
        # the message is a string, so pytest prints the whole diagnosis
        assert float(err.max()) < f32_tol, f"{float(err.max())} {diagnose and diagnose()}"
    else:
        assert float(err.max()) < 0.35 and float(err.mean() / want.float().abs().mean()) < 0.05



def test_smoke_prefill_and_decode_on_card_match_cpu(cuda_device):
    """The smoke qwen3-4b in float32 prefilled at S = 4096 (RMSNorm kernel,
    blocked attention) on the card and on the cpu, then 4 greedy decode
    steps from each state (decode-attention kernel on the card): logits and
    caches within atol 1e-4, the same tokens."""
    from repro_torch.models import transformer

    cfg = get_smoke_config("qwen3-4b").replace(dtype="float32", use_pallas=True)
    params = get_model(cfg).init(7, "cpu")
    card = _tree_to(params, cuda_device)
    toks = torch.randint(1, cfg.vocab_size, (2, 4096), generator=torch.Generator().manual_seed(3))
    want, wstate = transformer.prefill(params, toks, cfg)
    got, gstate = transformer.prefill(card, toks.to(cuda_device), cfg)
    torch.cuda.synchronize()
    for g, w in zip(gstate.caches, wstate.caches):
        if w.dtype == torch.int32:
            assert torch.equal(g.cpu(), w)
        else:
            assert float((g.cpu() - w).abs().max()) <= 1e-4
    for _ in range(4):
        assert float((got.cpu() - want).abs().max()) <= 1e-4
        tw = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        assert torch.equal(got[:, -1].argmax(-1).to(torch.int32)[:, None].cpu(), tw)
        want, wstate = transformer.decode_step(params, wstate, tw, cfg)
        got, gstate = transformer.decode_step(card, gstate, tw.to(cuda_device), cfg)
    assert float((got.cpu() - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-7b"])
def test_smoke_train_steps_on_card_match_cpu(cuda_device, arch):
    """Three train steps of the smoke config in float32 from the same master
    weights on the card and on the cpu (plain autograd, no kernel): losses
    within atol 1e-4, parameters within the sum of the learning rates, and
    the worst leaf's update within 1e-2 of the cpu's, relative to its size
    (``chip_smoke.update_rel_err``: 1 for an update that never happened)."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models.train import init_optimizer, make_train_step

    cfg = get_smoke_config(arch).replace(dtype="float32")
    api = get_model(cfg)
    init = api.init(7, "cpu", master=True)
    out = []
    for dev in ("cpu", cuda_device):
        params = _tree_to(init, dev, copy=True)    # AdamW updates in place
        state = init_optimizer(params)
        step = make_train_step(api.train_forward, cfg, base_lr=1e-3, warmup=1, total_steps=10)
        ds = SyntheticLMDataset(cfg.vocab_size, 64, 2, seed=0)
        losses, lr_sum = [], 0.0
        for i in range(3):
            b = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(i).items()}
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
            lr_sum += float(m["lr"])
        out.append((losses, lr_sum, _tree_to(params, "cpu")))
    (wl, lr_sum, wp), (gl, _, gp) = out
    assert max(abs(a - b) for a, b in zip(gl, wl)) <= 1e-4
    assert lr_sum > 0 and _tree_max_err(gp, wp) <= lr_sum
    assert _update_rel_err(gp, wp, init) <= 1e-2


def _tree_to(tree, device, copy: bool = False):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, copy) for k, v in tree.items()}
    return tree.to(device, copy=copy)


def _tree_max_err(got, want) -> float:
    if isinstance(got, dict):
        return max(_tree_max_err(got[k], want[k]) for k in got)
    return float((got - want).abs().max())


def _update_rel_err(got, want, init) -> float:
    """The worst leaf's ``|got - want| / |want - init|``."""
    if isinstance(got, dict):
        return max(_update_rel_err(got[k], want[k], init[k]) for k in got)
    return float((got.double() - want.double()).norm() / (want.double() - init.double()).norm())


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b", "internvl2-26b",
                                  "whisper-large-v3", "xlstm-350m"])
def test_smoke_family_on_card_matches_cpu(cuda_device, arch, tmp_path):
    """The smoke config of each family ported last in float32, the same
    weights on the cpu (plain versions, in a child process with
    ``MKL_CBWR=COMPATIBLE``) and the card (kernels): a forward at S = 1536
    within atol 1e-4 with every MoE layer's routing ``==`` (and held to
    chip_smoke's plain routing and plain MoE on each device), 4 decode steps
    within atol 1e-4, one train step's loss within atol 1e-4 (chip_smoke.py
    phase 19's last check)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    try:
        res = chip_smoke.family_smoke_phase(torch, [arch], str(cuda_device),
                                            work=tmp_path / "refs")[arch]
    except SystemExit:
        pytest.fail(f"{arch}: the smoke config parts card from cpu (stderr has the reading)")
    assert res["forward"]["ok"] and res["decode"]["ok"] and res["train"]["ok"]
