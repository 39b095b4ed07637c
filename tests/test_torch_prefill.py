"""The port's prefill path against the JAX reference, on the CPU: the static
block-pair schedule, blocked attention (the long-sequence branch of
``attention`` without kernels), ``cache_from_prefill``, ``prefill`` and
decode steps after it.

Inputs are made with numpy from a seed; model parameters are the
reference's own, carried across with ``params_from_numpy``.  Tolerances:
attention atol 2e-5 in float32 (``kernels/ref.py``'s, as
``tests/test_kernels.py`` applies it); prefill logits and caches, and the
logits of decode steps after a prefill, atol 1e-4 (float32,
``tests/test_models_smoke.py``'s logit tolerance); decoded tokens ``==``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import attention as jattn
from repro.models import get_model as j_get_model
from repro.models import transformer as jtf

from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, transformer
from repro_torch.models.transformer import params_from_numpy

ATTN_TOL = 2e-5
LOGIT_TOL = 1e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(S, T, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(1, n, h, hd)).astype(np.float32) * 0.5
            for n, h in ((S, H), (T, K), (T, K))]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("nq,nk,bq,bk,causal,window", [
    (8, 8, 512, 512, True, None),
    (8, 8, 512, 512, False, 700),
    (8, 8, 512, 512, True, 700),
    (6, 12, 256, 128, True, 300),
    (4, 4, 128, 128, False, None),
])
def test_block_pairs_match_reference(nq, nk, bq, bk, causal, window):
    assert (attention._block_pairs(nq, nk, bq, bk, causal, window)
            == jattn._block_pairs(nq, nk, bq, bk, causal, window))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 1000), (False, 1500)])
def test_blocked_attention_matches_reference(causal, window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(4096, 4096, 4, 2, 16, seed=1)
    want = jax.jit(lambda q, k, v: jattn.blocked_attention(q, k, v, causal=causal,
                                                           window=window))(jq, jk, jv)
    got = attention.blocked_attention(tq, tk, tv, causal=causal, window=window)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_TOL, rtol=0)


def test_blocked_attention_falls_back_to_plain_off_the_block_grid():
    (jq, jk, jv), (tq, tk, tv) = _qkv(600, 600, 4, 2, 16, seed=2)
    got = attention.blocked_attention(tq, tk, tv, causal=True, window=None)
    plain = attention.plain_attention(tq, tk, tv, causal=True, window=None)
    assert torch.equal(got, plain)
    want = jattn.blocked_attention(jq, jk, jv, causal=True, window=None)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_TOL, rtol=0)


def _models(cfg_kw=None, seed=0):
    kw = dict(dtype="float32") | (cfg_kw or {})
    cfg = get_smoke_config("qwen3-4b").replace(**kw)
    jcfg = j_get_smoke_config("qwen3-4b").replace(**kw)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return cfg, tparams, jcfg, jparams


def test_attention_without_kernels_at_4096_matches_reference():
    """S > 2048 without kernels: the blocked branch (``attn_chunk``-sized
    blocks, at most 512), not the raise it was."""
    cfg, tparams, jcfg, jparams = _models()
    attn_t = {k: v[0] for k, v in tparams["layers"]["attn"].items()}
    attn_j = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    x = np.random.default_rng(3).normal(size=(1, 4096, cfg.d_model)).astype(np.float32)
    got = attention.attention(attn_t, torch.from_numpy(x), cfg)
    want = jax.jit(lambda p, x: jattn.attention(p, x, jcfg))(attn_j, jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_TOL, rtol=0)


def test_cache_from_prefill_matches_reference():
    cfg = get_smoke_config("qwen3-4b")
    jcfg = j_get_smoke_config("qwen3-4b")
    rng = np.random.default_rng(4)
    k, v = (rng.normal(size=(2, 40, 2, 16)).astype(np.float32) for _ in range(2))
    for window in (None, 16, 64):
        got = attention.cache_from_prefill(cfg, torch.from_numpy(k), torch.from_numpy(v),
                                           window)
        want = jattn.cache_from_prefill(jcfg, jnp.asarray(k), jnp.asarray(v), window)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[1] == str(w.dtype)
            np.testing.assert_array_equal(_np(g), _np(w))


def _run_reference(jcfg, jparams, tokens, n_decode):
    """The reference's prefill, then ``n_decode`` greedy decode steps."""
    logits, state = jax.jit(lambda p, t: jtf.prefill(p, t, jcfg))(jparams, jnp.asarray(tokens))
    step = jax.jit(lambda p, s, t: jtf.decode_step(p, s, t, jcfg))
    out = [(np.asarray(logits, np.float32), jax.tree.map(np.asarray, state))]
    tok = np.asarray(logits[:, -1].argmax(-1), np.int32)[:, None]
    for _ in range(n_decode):
        logits, state = step(jparams, state, jnp.asarray(tok))
        out.append((np.asarray(logits, np.float32), tok))
        tok = np.asarray(logits[:, -1].argmax(-1), np.int32)[:, None]
    return out


def _run_port(cfg, tparams, tokens, n_decode):
    """As :func:`_run_reference`; the prefill's state is copied before the
    decode steps write into it, and the last state is returned beside."""
    logits, state = transformer.prefill(tparams, torch.from_numpy(tokens), cfg)
    assert all(t.is_contiguous() for t in state.caches)  # decode writes into them
    out = [(logits.float().numpy(), [t.clone() for t in state.caches])]
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    for _ in range(n_decode):
        logits, state = transformer.decode_step(tparams, state, tok, cfg)
        out.append((logits.float().numpy(), tok.numpy()))
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    return out, state


@pytest.mark.parametrize("S,window", [(4096, None), (40, 16)],
                         ids=["blocked-4096", "plain-window-ring-offset"])
def test_prefill_then_decode_matches_reference(S, window):
    """Prefill (blocked attention at S = 4096; plain attention under a
    window at S = 40, where S % W != 0 leaves the ring's slots off
    ``pos % W``), then 4 greedy decode steps from the returned state.  The
    first step after the unwindowed prefill evicts position 0 (capacity S):
    the reference does, and so does the port."""
    cfg, tparams, jcfg, jparams = _models({"sliding_window": window})
    B = 1 if S > 2048 else 2
    tokens = np.random.default_rng(5).integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    want = _run_reference(jcfg, jparams, tokens, 4)
    got, last = _run_port(cfg, tparams, tokens, 4)
    (gl, gcaches), (wl, wstate) = got[0], want[0]
    assert gl.shape == wl.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(gl, wl, atol=LOGIT_TOL, rtol=0)
    for g, w in zip(gcaches, wstate.caches):
        assert tuple(g.shape) == w.shape
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(_np(g), w, atol=LOGIT_TOL, rtol=0)
    for step, ((gl, gt), (wl, wt)) in enumerate(zip(got[1:], want[1:])):
        np.testing.assert_array_equal(gt, wt, err_msg=f"step {step}")
        np.testing.assert_allclose(gl, wl, atol=LOGIT_TOL, rtol=0, err_msg=f"step {step}")
    if window is None:  # the first decode step wrote slot 0: position 0 is gone
        assert (last.caches.positions[:, :, 0] == S).all()


def test_prefill_takes_no_flash_kernel_and_the_rmsnorm_one_with_use_pallas(monkeypatch):
    """``use_pallas``: every block RMSNorm and the final one go through the
    kernel wrapper (2 per layer + 1), attention never through flash, even
    at a length where ``forward`` takes it."""
    from repro_torch.kernels import ops

    cfg, tparams, _, _ = _models({"use_pallas": True})
    calls = {"rmsnorm": 0, "flash_attention": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    tokens = torch.randint(1, cfg.vocab_size, (1, 1536), generator=torch.Generator().manual_seed(6))
    transformer.prefill(tparams, tokens, cfg)    # forward would take flash here (S > 1024)
    assert calls == {"rmsnorm": 2 * cfg.n_layers + 1, "flash_attention": 0}


def test_prefill_prefix_embeds_are_prepended():
    cfg, tparams, jcfg, jparams = _models()
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, cfg.vocab_size, (1, 12)).astype(np.int32)
    prefix = rng.normal(size=(1, 5, cfg.d_model)).astype(np.float32) * 0.02
    got, gstate = transformer.prefill(tparams, torch.from_numpy(tokens), cfg,
                                      prefix_embeds=torch.from_numpy(prefix))
    want, wstate = jtf.prefill(jparams, jnp.asarray(tokens), jcfg,
                               prefix_embeds=jnp.asarray(prefix))
    np.testing.assert_allclose(_np(got), _np(want), atol=LOGIT_TOL, rtol=0)
    assert gstate.caches.k.shape[2] == wstate.caches.k.shape[2] == 17
