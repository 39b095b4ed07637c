"""The port's dense-LM serving slice against the JAX reference, on the CPU.

Same inputs, made with numpy from a seed, go through the reference function
and its counterpart in ``repro_torch``.  The reference's kernels run as its
own tests run them (``repro.kernels.ops`` in interpret mode, the model under
``cfg.replace(use_pallas=True)``); the port's kernel wrappers run their plain
PyTorch versions on CPU tensors.  Model parameters are the reference's own,
carried across with ``params_from_numpy``.

Tolerances: kernels and layers atol 2e-5 in float32 and 0.08 in bfloat16
(``tests/test_kernels.py``); model logits atol 1e-4 in float32 and, in
bfloat16, max error < 0.35 with mean relative error < 0.05
(``tests/test_models_smoke.py``).  Both frameworks round bf16 products and
float32 transcendental functions at slightly different places, so nothing
here is ``==`` except the configs and the served token ids.
"""

import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import get_model as j_get_model
from repro.models import layers as jlayers
from repro.models.common import ModelConfig as JModelConfig

import repro_torch.launch.serve as tserve
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import ModelConfig, get_model, layers
from repro_torch.models.attention import attention, init_cache
from repro_torch.models.transformer import params_from_numpy

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype: str) -> float:
    return 0.08 if dtype == "bfloat16" else 2e-5


def _pair(a: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a CPU torch tensor of ``dtype``."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _close_bf16_logits(got, want):
    got, want = _np(got), _np(want)
    err = np.abs(got - want)
    rel = err.mean() / (np.abs(want).mean() + 1e-9)
    assert err.max() < 0.35, f"max err {err.max()}"
    assert rel < 0.05, f"mean relative err {rel}"


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

def test_model_config_fields_and_defaults_match_reference():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert spec(ModelConfig) == spec(JModelConfig)


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_configs_match_reference(arch):
    assert ARCH_IDS == J_ARCH_IDS
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
    assert (dataclasses.asdict(get_smoke_config(arch))
            == dataclasses.asdict(j_get_smoke_config(arch)))


def test_torch_dtypes_of_config():
    cfg = get_config("qwen3-4b")
    assert (cfg.torch_dtype, cfg.torch_param_dtype) == (torch.bfloat16, torch.float32)
    assert cfg.head_dim == 80


# ---------------------------------------------------------------------------
# Kernel functions: plain port versions against repro.kernels.ops (interpret)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 256), (2, 128, 256), (3, 7, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference_kernel(shape, dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.normal(size=shape) * 0.5, dtype)
    jsc, tsc = _pair(rng.normal(size=shape[-1]) * 0.5)
    _close(ops.rmsnorm(tx, tsc), jops.rmsnorm(jx, jsc), _tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_residual_matches_reference_kernel(dtype):
    """Held against the TPU kernel's own formula (the norm of the float32
    sum); the reference oracle normalizes the rounded sum instead."""
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.normal(size=(4, 64, 256)) * 0.5, dtype)
    jr, tr = _pair(rng.normal(size=(4, 64, 256)) * 0.5, dtype)
    jsc, tsc = _pair(rng.normal(size=256) * 0.5)
    got = ops.rmsnorm_residual(tx, tr, tsc)
    want = jops.rmsnorm_residual(jx, jr, jsc)
    for g, w in zip(got, want):
        _close(g, w, _tol(dtype))
    assert got[0].dtype == TDT[dtype] and got[1].dtype == TDT[dtype]
    _close(got[1], (tx.float() + tr.float()).to(TDT[dtype]), 0)
    if dtype == "float32":  # rounding the sum is then exact: the formulas agree
        for g, w in zip(got, jref.rmsnorm_residual_ref(jx, jr, jsc)):
            _close(g, w, _tol(dtype))


@pytest.mark.parametrize("B,S,H,K,hd,causal,window", [
    (1, 256, 4, 2, 16, True, None),
    (2, 256, 8, 2, 80, True, None),
    (1, 384, 6, 3, 80, False, None),
    (1, 256, 4, 2, 16, True, 96),
    (1, 256, 8, 2, 80, True, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference_kernel(B, S, H, K, hd, causal, window, dtype):
    rng = np.random.default_rng(2)
    jq, tq = _pair(rng.normal(size=(B, S, H, hd)) * 0.5, dtype)
    jk, tk = _pair(rng.normal(size=(B, S, K, hd)) * 0.5, dtype)
    jv, tv = _pair(rng.normal(size=(B, S, K, hd)) * 0.5, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                block_q=128, block_k=128)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TDT[dtype]
    _close(got, want, _tol(dtype))


def _cache_positions(kind: str, B: int, C: int, rng):
    """(positions (B, C), pos (B,)) of a cache: some slots never written,
    a ring that has wrapped, or a plain prefix."""
    if kind == "empty_slots":
        pos = rng.integers(C // 4, C // 2, B)
        positions = np.where(np.arange(C)[None, :] <= pos[:, None], np.arange(C)[None, :], -1)
        positions[:, 1] = -1
    elif kind == "wrapped":
        pos = rng.integers(C + 3, 3 * C, B)
        # slot s holds the newest absolute position p <= pos with p % C == s
        s = np.arange(C)[None, :]
        positions = pos[:, None] - ((pos[:, None] - s) % C)
    else:
        pos = np.full(B, C - 1)
        positions = np.broadcast_to(np.arange(C), (B, C)).copy()
    return positions.astype(np.int32), pos.astype(np.int32)


@pytest.mark.parametrize("B,C,H,K,hd,kind,window", [
    (2, 64, 8, 2, 16, "empty_slots", None),
    (2, 128, 8, 2, 80, "wrapped", None),
    (1, 128, 4, 4, 64, "wrapped", 40),
    (2, 256, 8, 2, 80, "prefix", 100),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_reference_kernel(B, C, H, K, hd, kind, window, dtype):
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng.normal(size=(B, H, hd)) * 0.5, dtype)
    jk, tk = _pair(rng.normal(size=(B, C, K, hd)) * 0.5, dtype)
    jv, tv = _pair(rng.normal(size=(B, C, K, hd)) * 0.5, dtype)
    positions, pos = _cache_positions(kind, B, C, rng)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(positions), jnp.asarray(pos),
                                 window=window)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(positions),
                               torch.from_numpy(pos), window=window)
    _close(got, want, _tol(dtype))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_layer_matches_reference(use_pallas, dtype):
    """Both formulas: the plain one rounds x*rsqrt before the scale, the
    kernel's rounds once at the end."""
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng.normal(size=(2, 9, 128)), dtype)
    jsc, tsc = _pair(1.0 + 0.1 * rng.normal(size=128))
    got = layers.rms_norm(tx, tsc, 1e-6, use_pallas)
    want = jlayers.rms_norm(jx, jsc, 1e-6, use_pallas)
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_reference(dtype):
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng.normal(size=(2, 40, 4, 80)), dtype)
    pos = np.arange(1000, 1040, dtype=np.int32)[None, :]
    got = layers.apply_rope(tx, torch.from_numpy(pos), 1e6)
    want = jlayers.apply_rope(jx, jnp.asarray(pos), 1e6)
    # float32 angles up to 1e3 rad: cos/sin of XLA and torch differ by ULPs
    _close(got, want, 1e-4 if dtype == "float32" else _tol(dtype))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_reference(act, dtype):
    cfg = get_smoke_config("qwen3-4b").replace(act=act, dtype=dtype)
    jcfg = j_get_smoke_config("qwen3-4b").replace(act=act, dtype=dtype)
    rng = np.random.default_rng(6)
    w = {k: rng.normal(size=s) / np.sqrt(s[0]) for k, s in
         (("wi", (128, 256)), ("wg", (128, 256)), ("wo", (256, 128)))}
    if act == "gelu":
        del w["wg"]
    jx, tx = _pair(rng.normal(size=(2, 5, 128)), dtype)
    got = layers.mlp({k: torch.from_numpy(v).float() for k, v in w.items()}, tx, cfg)
    want = jlayers.mlp({k: jnp.asarray(v, jnp.float32) for k, v in w.items()}, jx, jcfg)
    _close(got, want, 1e-4 if dtype == "float32" else _tol(dtype))


# ---------------------------------------------------------------------------
# The slice at the smoke config, with the reference's parameters
# ---------------------------------------------------------------------------

def _models(dtype: str, use_pallas: bool, seed: int = 0):
    cfg = get_smoke_config("qwen3-4b").replace(dtype=dtype, use_pallas=use_pallas)
    jcfg = j_get_smoke_config("qwen3-4b").replace(dtype=dtype, use_pallas=use_pallas)
    japi = j_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return (cfg, get_model(cfg), tparams), (jcfg, japi, jparams)


def test_init_cache_matches_reference():
    from repro.models.attention import init_cache as j_init_cache

    cfg = get_smoke_config("qwen3-4b")
    want = j_init_cache(j_get_smoke_config("qwen3-4b"), 3, 16)
    got = init_cache(cfg, 3, 16, "cpu")
    assert got.capacity == want.capacity == 16
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[1] == str(w.dtype)
        np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32))


def _check_logits(got, want, dtype):
    assert got.shape == want.shape
    assert np.isfinite(_np(got)).all()
    if dtype == "float32":
        _close(got, want, 1e-4)
    else:
        _close_bf16_logits(got, want)


def test_params_from_numpy_keeps_layout_and_casts_matrices_once():
    (cfg, _, tp), (_, _, jp) = _models("bfloat16", False)
    flat_t = dict(_flatten(tp))
    flat_j = dict(_flatten(jax.tree.map(np.asarray, jp)))
    assert flat_t.keys() == flat_j.keys()
    for key, t in flat_t.items():
        assert tuple(t.shape) == flat_j[key].shape, key
        own_axes = t.dim() - (1 if key[0] == "layers" else 0)
        assert t.dtype == (torch.bfloat16 if own_axes >= 2 else torch.float32), key
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(jnp.asarray(flat_j[key]).astype(
                jnp.bfloat16 if own_axes >= 2 else jnp.float32), np.float32))


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("dtype,use_pallas,S", [
    ("float32", True, 1536), ("float32", False, 64),
    ("bfloat16", True, 1536), ("bfloat16", False, 64),
])
def test_forward_matches_reference(dtype, use_pallas, S):
    (cfg, api, tp), (jcfg, japi, jp) = _models(dtype, use_pallas)
    toks = np.random.default_rng(7).integers(1, cfg.vocab_size, (1, S)).astype(np.int32)
    want, _ = jax.jit(lambda p, b: japi.forward(p, b, jcfg))(jp, {"tokens": jnp.asarray(toks)})
    got, aux = api.forward(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    assert float(aux) == 0.0
    _check_logits(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_decode_steps_match_reference(dtype, use_pallas):
    """12 steps into a capacity-8 cache: the ring wraps after step 8."""
    (cfg, api, tp), (jcfg, japi, jp) = _models(dtype, use_pallas)
    B, C, steps = 2, 8, 12
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


def test_serve_pool_matches_reference(monkeypatch):
    """float32, kernels on, both sides on the reference's parameters: the same
    requests, the same steps, the same token ids (a near-tie of the top two
    logits would be reported, and the logits still compared).

    The reference hands ``jnp.asarray(cur_tokens)`` to an asynchronous decode
    and then writes the next prompt token into ``cur_tokens``; on the CPU,
    ``jnp.asarray`` may alias a suitably aligned numpy buffer, so the step can
    read the later token.  Its ``jnp`` gets a host copy here, which is what
    the reference means to feed."""
    jcfg = j_get_smoke_config("qwen3-4b").replace(dtype="float32", use_pallas=True)
    cfg = get_smoke_config("qwen3-4b").replace(dtype="float32")
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
    kw = dict(n_requests=4, batch=2, prompt_len=4, max_new=4, capacity=32, seed=0)
    want = jserve.serve_pool(**kw)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
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


# ---------------------------------------------------------------------------
# What the slice did not take (every family is ported now:
# tests/test_torch_families.py)
# ---------------------------------------------------------------------------

def test_blocked_attention_branch_is_not_ported():
    """The name is historical: the branch is ported.  ``attention`` at
    S = 2560 without kernels takes the blocked branch (blocks of
    ``min(attn_chunk, 512)``), within the float32 kernel tolerance of the
    reference's (``tests/test_torch_prefill.py`` holds it at S = 4096)."""
    from repro.models.attention import attention as j_attention

    (cfg, _, tp), (jcfg, _, jp) = _models("float32", False)
    attn = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    x = np.random.default_rng(10).normal(size=(1, 2560, cfg.d_model)).astype(np.float32)
    got = attention(attn, torch.from_numpy(x), cfg)
    want = jax.jit(lambda p, x: j_attention(p, x, jcfg))(jattn, jnp.asarray(x))
    _close(got, want, _tol("float32"))


def test_serve_pool_pods_and_replan_raise():
    """The name is historical: neither raises now.  ``pods`` adds the plan
    digest and ``replan`` without pods is the plain result, with the
    reference's keys (``tests/test_torch_serve_plan.py`` holds the digests
    ``==``)."""
    kw = dict(n_requests=1, batch=1, prompt_len=2, max_new=1, capacity=8)
    for extra in ({"pods": 2}, {"replan": True}):
        got = tserve.serve_pool(**kw, device="cpu", **extra)
        want = jserve.serve_pool(**kw, **extra)
        assert sorted(got) == sorted(want), extra
        assert got["all_done"]


def test_sample_tokens_matches_reference():
    logits = np.random.default_rng(9).normal(size=(3, 50)).astype(np.float32)
    for greedy in (True, False):
        want = jserve.sample_tokens(logits, np.random.default_rng(1), greedy, 0.7)
        got = tserve.sample_tokens(logits, np.random.default_rng(1), greedy, 0.7)
        np.testing.assert_array_equal(got, want)


def test_serve_profile_breakdown_reads_a_profile():
    """The serving profiler's summary of a (CPU-only) profile of one decode
    step: no device time, host operators ranked by self time."""
    from repro_torch.launch.serve_profile import _breakdown

    cfg = get_smoke_config("qwen3-4b").replace(use_pallas=True)
    api = get_model(cfg)
    params, state = api.init(0, "cpu"), api.init_decode_state(2, 8, "cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        api.decode(params, state, torch.ones((2, 1), dtype=torch.long))
    out = _breakdown(prof, 1.0)
    assert out["device_busy_s"] is None and out["kernel_launches"] == 0
    assert out["top_host_self"] and all(e["self_cpu_s"] > 0 for e in out["top_host_self"])
