"""The hand-written CUDA model kernels (RMSNorm, RMSNorm + residual, flash
attention, decode attention) against their plain PyTorch versions, on the
card.

These tests need a CUDA device (marker ``cuda``) and skip without one.  The
file imports only torch, numpy and the port, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_model_kernels_cuda.py

Inputs are random with a fixed seed.  Tolerance: atol 2e-5 in float32 (the
reference's kernel tests); in bfloat16, per element 2e-5 + 2^-6 |want| (two
bf16 spacings of the value), since both sides compute in float32 and round
once, so they differ only in summation order and may round a near-tie apart.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import rmsnorm as krn
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


@pytest.mark.parametrize("B,S,H,K,hd,causal,window", [
    (1, 256, 4, 2, 16, True, None),
    (2, 256, 8, 2, 64, True, None),
    (1, 512, 8, 2, 80, True, None),
    (1, 384, 6, 3, 128, False, None),
    (1, 200, 4, 1, 80, True, 50),
    (2, 100, 4, 4, 48, False, 30),
    (1, 1024, 32, 8, 80, True, 256),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(cuda_device, B, S, H, K, hd, causal, window,
                                              dtype):
    rng = np.random.default_rng(2)
    q = _rand(rng, (B, S, H, hd), dtype, cuda_device)
    k = _rand(rng, (B, S, K, hd), dtype, cuda_device)
    v = _rand(rng, (B, S, K, hd), dtype, cuda_device)
    before = kfa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert kfa.flash_attention.launches == before + 1
    _close(got, ref.flash_attention_ref(q, k, v, causal=causal, window=window), dtype)


@pytest.mark.parametrize("B,C,H,K,hd", [(2, 64, 8, 2, 16), (4, 1024, 32, 8, 80),
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
def test_smoke_model_on_card_matches_cpu(cuda_device, dtype):
    """The smoke qwen3-4b with kernels on the card against the same model
    with plain versions on the CPU: a forward that takes the flash kernel
    (S = 1536) and 6 decode steps.  float32 logits within 1e-4 (summation
    order only); bfloat16 within the reference's model criterion."""
    cfg = get_smoke_config("qwen3-4b").replace(dtype=dtype, use_pallas=True)
    api = get_model(cfg)
    params = api.init(0, "cpu")
    on_card = _to(params, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(5).integers(1, cfg.vocab_size, (1, 1536)))
    before = (krn.rmsnorm.launches, kfa.flash_attention.launches)
    got, _ = api.forward(on_card, {"tokens": toks.to(cuda_device)}, cfg)
    assert krn.rmsnorm.launches > before[0] and kfa.flash_attention.launches > before[1]
    want, _ = api.forward(params, {"tokens": toks}, cfg)
    _check_logits(got.cpu(), want, dtype)
    st_card, st_cpu = api.init_decode_state(2, 8, cuda_device), api.init_decode_state(2, 8, "cpu")
    before = kdec.decode_attention.launches
    for t in range(6):
        tok = toks[:, t:t + 2].reshape(2, 1)
        got, st_card = api.decode(on_card, st_card, tok.to(cuda_device))
        want, st_cpu = api.decode(params, st_cpu, tok)
        _check_logits(got.cpu(), want, dtype)
    assert kdec.decode_attention.launches == before + 6 * cfg.n_layers


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _check_logits(got, want, dtype):
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    if dtype == "float32":
        assert float(err.max()) < 1e-4, float(err.max())
    else:
        assert float(err.max()) < 0.35 and float(err.mean() / want.float().abs().mean()) < 0.05

