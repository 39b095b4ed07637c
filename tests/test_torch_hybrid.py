"""The port's hybrid family (Mamba2 + shared attention, zamba2-7b) and its
SSD kernel against the JAX reference, on the CPU.

Same inputs, made with numpy from a seed, go through the reference function
and its counterpart in ``repro_torch``.  The reference's kernels run as its
own tests run them (``repro.kernels.ops`` and ``mamba2_ssd`` in interpret
mode); the port's kernel wrappers run their plain PyTorch versions on CPU
tensors.  Model parameters are the reference's own, carried across with
``repro_torch.models.hybrid.params_from_numpy``.

Tolerances:
  - the SSD: atol 2e-4, as the reference holds its own SSD kernel
    (``tests/test_kernels.py``); the intra-chunk body and the layers: atol
    2e-5 in float32 (the reference's kernel tolerance), scaled to the
    output's size where that is O(10);
  - decode logits: atol 1e-4 in float32; in bfloat16 the reference's model
    criterion, max error < 0.35 and mean relative error < 0.05
    (``tests/test_models_smoke.py``);
  - forward logits in float32: atol 3e-4.  Each Mamba layer differs from
    the reference by float32 rounding (~2e-6 of its output: the decay
    exp(cum_i - cum_j) takes the difference of two running sums that reach
    ~20 over a chunk), and the gated RMSNorm about doubles the carried
    difference at every group: ``test_forward_matches_reference`` reads
    ~4e-5 at S = 64 and ~1.2e-4 at S = 1536 (logits up to ~5).  A planted
    SSD fault moves logits by more than 1 (``tests/test_torch_chip_smoke.py``).
"""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.kernels import mamba2_ssd as jssd
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import get_model as j_get_model
from repro.models import hybrid as jhybrid
from repro.models import ssm as jssm

import repro_torch.launch.serve as tserve
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.mamba2_ssd import ssd_intra_chunk
from repro_torch.models import get_model, hybrid, ssm

ARCH = "zamba2-7b"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FWD_F32_TOL = 3e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _check_logits(got, want, dtype, f32_tol=1e-4):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= f32_tol, f"max err {err.max()}"
    else:
        rel = err.mean() / (np.abs(want).mean() + 1e-9)
        assert err.max() < 0.35, f"max err {err.max()}"
        assert rel < 0.05, f"mean relative err {rel}"


def _ssd_inputs(rng, B, S, H, P, N):
    """The reference's SSD test inputs (``tests/test_kernels.py:97-101``)."""
    x = rng.normal(size=(B, S, H, P)) * 0.5
    dt = np.abs(rng.normal(size=(B, S, H)) * 0.5) * 0.1
    A = -np.abs(rng.normal(size=H) * 0.5) * 0.5
    Bm, Cm = rng.normal(size=(B, S, N)) * 0.5, rng.normal(size=(B, S, N)) * 0.5
    return [np.asarray(a, np.float32) for a in (x, dt, A, Bm, Cm)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# The SSD kernel and its oracles
# ---------------------------------------------------------------------------

SSD_SHAPES = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 64, 64), (2, 64, 8, 16, 32, 16)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
@pytest.mark.parametrize("fn", ["ops.ssd_chunked", "ssd_ref"])
def test_ssd_matches_reference(B, S, H, P, N, chunk, fn):
    """``ops.ssd_chunked`` (the kernel route) against the reference's kernel
    route, and the sequential oracle against the reference's oracle."""
    arrays = _ssd_inputs(np.random.default_rng(0), B, S, H, P, N)
    if fn == "ssd_ref":
        got, want = ref.ssd_ref(*_t(arrays)), jref.ssd_ref(*arrays)
    else:
        got = ops.ssd_chunked(*_t(arrays), chunk=chunk)
        want = jops.ssd_chunked(*arrays, chunk=chunk)
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    for g, w in zip(got, want):
        _close(g, w, 2e-4)
    _close(ops.ssd_chunked(*_t(arrays), chunk=chunk)[0], jref.ssd_ref(*arrays)[0], 2e-4)


@pytest.mark.parametrize("B,nc,Q,H,P,N", [(2, 4, 32, 4, 32, 16), (1, 2, 64, 2, 64, 64),
                                          (1, 1, 256, 2, 16, 32)])
def test_ssd_intra_chunk_plain_matches_reference_kernel(B, nc, Q, H, P, N):
    """The kernel's plain version against the Pallas kernel (interpret
    mode): y, chunk state and chunk decay."""
    x, dt, A, Bm, Cm = _ssd_inputs(np.random.default_rng(1), B, nc * Q, H, P, N)
    arrays = (x.reshape(B, nc, Q, H, P), dt.reshape(B, nc, Q, H), A,
              Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N))
    want = jssd.ssd_intra_chunk(*(jnp.asarray(a) for a in arrays), interpret=True)
    got = ssd_intra_chunk(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        _close(g, w, 2e-5)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_model_ssd_chunked_matches_reference(B, S, H, P, N, chunk):
    arrays = _ssd_inputs(np.random.default_rng(2), B, S, H, P, N)
    got = ssm.ssd_chunked(*_t(arrays), chunk)
    want = jssm.ssd_chunked(*(jnp.asarray(a) for a in arrays), chunk)
    for g, w in zip(got, want):
        _close(g, w, 2e-5)


def test_softplus_and_causal_conv_match_reference():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=200) * 10, [-40.0, -20.5, 19.5, 20.5, 40.0]])
    x = x.astype(np.float32)
    np.testing.assert_array_max_ulp(ssm.softplus(torch.from_numpy(x)).numpy(),
                                    np.asarray(jax.nn.softplus(x)), maxulp=2)
    xs = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w, b = rng.normal(size=(12, 4)).astype(np.float32), rng.normal(size=12).astype(np.float32)
    _close(ssm._causal_conv(*_t((xs, w, b))), jssm._causal_conv(xs, w, b), 1e-6)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _mamba_layer(dtype: str, seed: int = 4):
    cfg = get_smoke_config(ARCH).replace(dtype=dtype)
    jcfg = j_get_smoke_config(ARCH).replace(dtype=dtype)
    jp = jssm.init_mamba2(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, A_log=jp["A_log"] + 0.3, dt_bias=jp["dt_bias"] - 1.0)  # not the init values
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return cfg, jcfg, tp, jp


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_matches_reference(use_pallas, dtype):
    cfg, jcfg, tp, jp = _mamba_layer(dtype)
    cfg = cfg.replace(use_pallas=use_pallas)
    x = np.random.default_rng(5).normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    got = ssm.mamba2_forward(tp, torch.from_numpy(x).to(TDT[dtype]), cfg)
    want = jssm.mamba2_forward(jp, jnp.asarray(x, JDT[dtype]), jcfg)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == want.shape
    scale = float(np.abs(_np(want)).max())
    _close(got, want, (2e-5 if dtype == "float32" else 0.08) * max(1.0, scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_steps_match_reference(dtype):
    """Six steps through one layer, the state carried on both sides; the
    port's state is updated in place."""
    cfg, jcfg, tp, jp = _mamba_layer(dtype)
    B = 2
    xs = np.random.default_rng(6).normal(size=(6, B, 1, cfg.d_model)).astype(np.float32)
    jstate = jssm.init_mamba_state(jcfg, B)
    tstate = ssm.init_mamba_state(cfg, B, "cpu")
    for x in xs:
        want, jstate = jssm.mamba2_decode_step(jp, jnp.asarray(x, JDT[dtype]), jstate, jcfg)
        got, st = ssm.mamba2_decode_step(tp, torch.from_numpy(x).to(TDT[dtype]), tstate, cfg)
        assert st.conv is tstate.conv and st.ssm is tstate.ssm
        assert got.dtype == TDT[dtype]
        scale = max(1.0, float(np.abs(_np(want)).max()))
        _close(got, want, (2e-5 if dtype == "float32" else 0.08) * scale)
        _close(tstate.conv, jstate.conv, 2e-5 if dtype == "float32" else 0.08)
        _close(tstate.ssm, jstate.ssm, 2e-5 if dtype == "float32" else 0.08)


# ---------------------------------------------------------------------------
# The slice at the smoke config, with the reference's parameters
# ---------------------------------------------------------------------------

def _models(dtype: str, use_pallas: bool, seed: int = 0):
    cfg = get_smoke_config(ARCH).replace(dtype=dtype, use_pallas=use_pallas)
    jcfg = j_get_smoke_config(ARCH).replace(dtype=dtype, use_pallas=use_pallas)
    japi = j_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(seed))
    tparams = hybrid.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return (cfg, get_model(cfg), tparams), (jcfg, japi, jparams)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_group_shape_matches_reference():
    """The smoke config pads 5 layers to 3 groups of 2; zamba2-7b pads 81 to
    14 groups of 6."""
    assert hybrid.group_shape(get_smoke_config(ARCH)) == (3, 2, 1)
    assert hybrid.group_shape(get_config(ARCH)) == jhybrid.group_shape(j_get_config(ARCH))
    assert hybrid.group_shape(get_config(ARCH)) == (14, 6, 3)


def test_params_from_numpy_keeps_conv_w_float32_and_casts_matrices_once():
    """Matrices in bf16, cast once from the reference's float32; ``conv_w``
    (read in float32 by decode), norm scales and vectors stay float32.  The
    stacked Mamba weights count their own axes, not the (ng, g) axes."""
    (cfg, _, tp), (_, _, jp) = _models("bfloat16", False)
    flat_t = dict(_flatten(tp))
    flat_j = dict(_flatten(jax.tree.map(np.asarray, jp)))
    assert flat_t.keys() == flat_j.keys()
    assert tp["mamba_groups"]["conv_w"].dtype == torch.float32
    for key, t in flat_t.items():
        assert tuple(t.shape) == flat_j[key].shape, key
        own_axes = t.dim() - (2 if key[0] in ("mamba_groups", "mamba_ln") else 0)
        matrix = own_axes >= 2 and key[-1] != "conv_w"
        assert t.dtype == (torch.bfloat16 if matrix else torch.float32), key
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(jnp.asarray(flat_j[key]).astype(
                jnp.bfloat16 if matrix else jnp.float32), np.float32))


def test_init_params_layout_matches_reference():
    """The port's own random parameters have the reference's tree, shapes and
    (after the one cast) dtypes, and the reference's constant initial values."""
    cfg = get_smoke_config(ARCH)
    tp = get_model(cfg).init(0, "cpu")
    (_, _, fp), _ = _models("bfloat16", False)
    flat_t, flat_f = dict(_flatten(tp)), dict(_flatten(fp))
    assert flat_t.keys() == flat_f.keys()
    for key, t in flat_t.items():
        assert (tuple(t.shape), t.dtype) == (tuple(flat_f[key].shape), flat_f[key].dtype), key
    for key in ("A_log", "dt_bias", "conv_b"):
        assert not tp["mamba_groups"][key].any()
    assert (tp["mamba_groups"]["D"] == 1).all() and (tp["mamba_ln"] == 1).all()


def test_init_decode_state_matches_reference():
    cfg, jcfg = get_smoke_config(ARCH), j_get_smoke_config(ARCH)
    want = jhybrid.init_decode_state(jcfg, 3, 16)
    got = hybrid.init_decode_state(cfg, 3, 16, "cpu")
    for g, w in zip(list(got.caches) + list(got.mamba), list(want.caches) + list(want.mamba)):
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[1] == str(w.dtype)
        np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32))


@pytest.mark.parametrize("use_pallas,S", [(False, 64), (True, 64), (False, 1536),
                                          (True, 1536)])
def test_forward_matches_reference(use_pallas, S):
    """float32.  With ``use_pallas`` the port takes the SSD kernel route (and
    flash attention at S = 1536) where the reference takes its plain SSD;
    both compute the same function."""
    (cfg, api, tp), (jcfg, japi, jp) = _models("float32", use_pallas)
    toks = np.random.default_rng(7).integers(1, cfg.vocab_size, (1, S)).astype(np.int32)
    want, _ = jax.jit(lambda p, b: japi.forward(p, b, jcfg))(jp, {"tokens": jnp.asarray(toks)})
    got, aux = api.forward(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    assert float(aux) == 0.0
    _check_logits(got, want, "float32", FWD_F32_TOL)


def test_forward_takes_the_ssd_kernel_route_only_with_use_pallas(monkeypatch):
    calls = []
    real = ops.ssd_chunked
    monkeypatch.setattr(ops, "ssd_chunked", lambda *a: calls.append(1) or real(*a))
    toks = torch.ones((1, 64), dtype=torch.long)
    for use_pallas in (False, True):
        cfg = get_smoke_config(ARCH).replace(dtype="float32", use_pallas=use_pallas)
        api = get_model(cfg)
        api.forward(api.init(0, "cpu"), {"tokens": toks}, cfg)
        ng, g, _ = hybrid.group_shape(cfg)
        assert len(calls) == (ng * g if use_pallas else 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_decode_steps_match_reference(dtype, use_pallas):
    """8 steps from an empty state; caches and Mamba states carried."""
    (cfg, api, tp), (jcfg, japi, jp) = _models(dtype, use_pallas)
    B, C, steps = 2, 8, 8
    toks = np.random.default_rng(8).integers(1, cfg.vocab_size, (B, steps)).astype(np.int32)
    jstate = japi.init_decode_state(B, C)
    tstate = api.init_decode_state(B, C, "cpu")
    jdec = jax.jit(japi.decode)
    for t in range(steps):
        want, jstate = jdec(jp, jstate, jnp.asarray(toks[:, t:t + 1]))
        got, tstate = api.decode(tp, tstate, torch.from_numpy(toks[:, t:t + 1]))
        _check_logits(got, want, dtype)
    np.testing.assert_array_equal(tstate.caches.pos.numpy(), np.asarray(jstate.caches.pos))
    np.testing.assert_array_equal(tstate.caches.positions.numpy(),
                                  np.asarray(jstate.caches.positions))
    if dtype == "float32":
        _close(tstate.mamba.ssm, jstate.mamba.ssm, 1e-4)
        _close(tstate.mamba.conv, jstate.mamba.conv, 1e-4)


def test_serve_pool_matches_reference(monkeypatch):
    """zamba2's smoke config in float32, kernels on, both sides on the
    reference's parameters: the same requests, the same steps, the same
    token ids (a near-tie of the top two logits would be reported, and the
    logits still compared).  The reference's ``jnp`` gets a host copy of its
    token buffer, as in ``tests/test_torch_model.py``."""
    jcfg = j_get_smoke_config(ARCH).replace(dtype="float32", use_pallas=True)
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    monkeypatch.setattr(jserve, "jnp", types.SimpleNamespace(
        asarray=lambda x: jnp.asarray(np.array(x))))
    monkeypatch.setattr(jserve, "get_smoke_config", lambda arch: jcfg)
    monkeypatch.setattr(tserve, "get_smoke_config", lambda arch: cfg)
    seen = {"jax": [], "torch": []}

    def recorder(side, fn):
        def sample(logits, *a, **kw):
            out = fn(logits, *a, **kw)
            seen[side].append((np.array(logits, np.float32), np.array(out)))
            return out
        return sample

    monkeypatch.setattr(jserve, "sample_tokens", recorder("jax", jserve.sample_tokens))
    monkeypatch.setattr(tserve, "sample_tokens", recorder("torch", tserve.sample_tokens))
    kw = dict(arch=ARCH, n_requests=4, batch=2, prompt_len=4, max_new=4, capacity=32, seed=0)
    want = jserve.serve_pool(**kw)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = hybrid.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    got = tserve.serve_pool(**kw, device="cpu", params=params)
    for key in ("requests", "decode_steps", "tokens_generated", "all_done"):
        assert got[key] == want[key], key
    assert got["all_done"] and len(seen["torch"]) == len(seen["jax"]) == got["decode_steps"]
    for step, ((tl, tt), (jl, jt)) in enumerate(zip(seen["torch"], seen["jax"])):
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        tie = (top2[:, 1] - top2[:, 0]) < 1e-4
        if tie.any():
            warnings.warn(f"step {step}: top-two logits within 1e-4; logits compared")
        assert (tt == jt)[~tie].all(), step
