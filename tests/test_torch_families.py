"""The port's MoE, VLM, enc-dec and xLSTM families against the JAX reference,
on the CPU, at the smoke configs of mixtral-8x7b, arctic-480b (moe),
internvl2-26b (vlm), whisper-large-v3 (encdec) and xlstm-350m (xlstm).

Same inputs, made with numpy from a seed, go through the reference function
and its counterpart in ``repro_torch``; the reference runs jitted on the
CPU, its kernels in interpret mode, as its own tests run it.  Model
parameters are the reference's own, carried across with each family's
``params_from_numpy``.  Patch embeddings and frames are ``normal * 0.02``
(``tests/test_models_smoke.py``).

Tolerances (those of ``tests/test_torch_model.py`` and
``tests/test_torch_train.py``):
  - logits atol 1e-4 in float32; in bfloat16 the reference's model
    criterion, max error < 0.35 and mean relative error < 0.05
    (``tests/test_models_smoke.py``), which also holds decode against the
    teacher-forced forward;
  - the encoder output, cross K/V, caches and the xLSTM cores atol 2e-5 in
    float32 (the reference's kernel tolerance), scaled to the output's size
    where that is O(10) (the mLSTM's chunked h);
  - one train step's loss, its parts and gradients atol 1e-5 + rtol 1e-3;
  - the served token ids ``==``.
"""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import encdec as jencdec
from repro.models import get_model as j_get_model
from repro.models import transformer as jtf
from repro.models import xlstm as jxlstm
from repro.models.train import make_loss_fn as j_make_loss_fn

import repro_torch.launch.serve as tserve
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import encdec, get_model, transformer, xlstm
from repro_torch.models.train import make_loss_fn, value_and_grad
from repro_torch.optim.tree import tree_leaves

NEW_ARCHS = ["mixtral-8x7b", "arctic-480b", "internvl2-26b", "whisper-large-v3", "xlstm-350m"]
MODULE = {"moe": transformer, "vlm": transformer, "encdec": encdec, "xlstm": xlstm}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_TOL, LOGIT_TOL = 2e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _check_logits(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= LOGIT_TOL, f"max err {err.max()}"
    else:
        rel = err.mean() / (np.abs(want).mean() + 1e-9)
        assert err.max() < 0.35, f"max err {err.max()}"
        assert rel < 0.05, f"mean relative err {rel}"


def _models(arch, dtype="float32", use_pallas=False, seed=0, master=False, **kw):
    cfg = get_smoke_config(arch).replace(dtype=dtype, use_pallas=use_pallas, **kw)
    jcfg = j_get_smoke_config(arch).replace(dtype=dtype, use_pallas=use_pallas, **kw)
    japi = j_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(seed))
    tparams = MODULE[cfg.family].params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu", master=master)
    return (cfg, get_model(cfg), tparams), (jcfg, japi, jparams)


def _batch(cfg, B, S, seed=0, labels=False):
    """(reference batch, port batch): tokens, and the family's stub inputs."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)}
    if labels:
        arrays["labels"] = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        arrays["patch_embeds"] = (rng.normal(size=(B, cfg.n_vis_tokens, cfg.d_model))
                                  * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        arrays["frames"] = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model))
                            * 0.02).astype(np.float32)
    jb, tb = {}, {}
    for k, a in arrays.items():
        if a.dtype == np.int32:
            jb[k], tb[k] = jnp.asarray(a), torch.from_numpy(a)
        else:
            jb[k] = jnp.asarray(a, JDT[cfg.dtype])
            tb[k] = torch.from_numpy(a).to(TDT[cfg.dtype])
    return jb, tb


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_get_model_returns_an_api_for_every_arch(arch):
    """All ten architectures: the API's parts, the params' leaves in the
    reference's layout, and one forward of the smoke config."""
    cfg = get_smoke_config(arch)
    api = get_model(cfg)
    params = api.init(0, "cpu")
    jparams = jax.eval_shape(j_get_model(j_get_smoke_config(arch)).init,
                             jax.random.PRNGKey(0))
    assert [tuple(p.shape) for p in tree_leaves(params)] == [
        tuple(p.shape) for p in jax.tree.leaves(jparams)]
    _, tb = _batch(cfg, 1, 8)
    logits, aux = api.forward(params, tb, cfg)
    assert logits.shape == (1, 8, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    assert aux.shape == () and bool(torch.isfinite(aux))


def test_unknown_family_raises():
    with pytest.raises(KeyError, match="unknown family"):
        get_model(get_smoke_config("qwen3-4b").replace(family="rnn"))


# ---------------------------------------------------------------------------
# Forward and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_matches_reference(arch, dtype):
    (cfg, api, tp), (jcfg, japi, jp) = _models(arch, dtype)
    jb, tb = _batch(cfg, 2, 32)
    want, jaux = jax.jit(lambda p, b: japi.forward(p, b, jcfg))(jp, jb)
    got, aux = api.forward(tp, tb, cfg)
    assert got.shape == (2, 32, cfg.vocab_size)       # the VLM's text positions only
    _check_logits(got, want, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5, rtol=0)
    assert (float(aux) > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "internvl2-26b"])
def test_forward_with_kernels_matches_reference(arch):
    """S = 1536 (+ the VLM's prefix): flash attention on both sides (the
    reference's in interpret mode, mixtral's under its window of 32), the
    RMSNorm kernel's formula."""
    (cfg, api, tp), (jcfg, japi, jp) = _models(arch, "float32", use_pallas=True)
    S = 1536 - cfg.n_vis_tokens
    jb, tb = _batch(cfg, 1, S, seed=1)
    want, _ = jax.jit(lambda p, b: japi.forward(p, b, jcfg))(jp, jb)
    got, _ = api.forward(tp, tb, cfg)
    _check_logits(got, want, "float32")


def _decode(api, params, state, toks, step):
    return api.decode(params, state, toks[:, step:step + 1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_steps_match_reference(arch, dtype):
    """4 steps with kernels on (decode attention's plain version here),
    into a capacity-8 cache."""
    (cfg, api, tp), (jcfg, japi, jp) = _models(arch, dtype, use_pallas=True)
    toks = np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 4)).astype(np.int32)
    jst, tst = japi.init_decode_state(2, 8), api.init_decode_state(2, 8, "cpu")
    jdec = jax.jit(japi.decode)
    for t in range(4):
        want, jst = jdec(jp, jst, jnp.asarray(toks[:, t:t + 1]))
        got, tst = api.decode(tp, tst, torch.from_numpy(toks[:, t:t + 1]))
        _check_logits(got, want, dtype)
    _check_state(tst, jst, dtype)


def _state_leaves(state) -> list:
    if isinstance(state, torch.Tensor):
        return [state]
    return [leaf for field in state for leaf in _state_leaves(field)]


def _check_state(got, want, dtype):
    """Every field of a decode state, in the reference's order: positions
    ``==``, values within the layers' tolerance (scaled to their size)."""
    g, w = _state_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape
        if a.dtype == torch.int32:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            scale = max(1.0, float(np.abs(_np(b)).max()))
            _close(a, b, (F32_TOL if dtype == "float32" else 0.08) * scale)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_matches_forward(arch):
    """Incremental decode reproduces the teacher-forced forward (the
    reference's own consistency test, ``tests/test_models_smoke.py``: MoE
    capacity at 8 so the forward drops no more than decode; the VLM without
    a prefix, the enc-dec model against the zero frames its decode state
    attends to)."""
    kw = {"capacity_factor": 8.0} if arch in ("mixtral-8x7b", "arctic-480b") else {}
    cfg = get_smoke_config(arch).replace(**kw)
    api = get_model(cfg)
    params = api.init(1, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(1, cfg.vocab_size, (1, 12)))
    if cfg.family == "encdec":
        frames = torch.zeros((1, cfg.enc_seq, cfg.d_model), dtype=cfg.torch_dtype)
        want, _ = encdec.forward(params, toks, cfg, frames)
        state = api.init_decode_state(1, 32, "cpu")
        k, v = encdec.precompute_cross(params, encdec.encode(params, frames, cfg), cfg)
        state = state._replace(cross_k=k, cross_v=v)
    else:
        want, _ = MODULE[cfg.family].forward(params, toks, cfg)
        state = api.init_decode_state(1, 32, "cpu")
    outs = []
    for t in range(12):
        lg, state = _decode(api, params, state, toks, t)
        outs.append(lg[:, 0])
    _check_logits(torch.stack(outs, dim=1), want, "bfloat16")


# ---------------------------------------------------------------------------
# MoE and VLM: prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b", "internvl2-26b"])
def test_prefill_matches_reference(arch):
    """Prefill (with the VLM's prefix) against the reference's: the last
    logits and every cache field, then 2 decode steps from each state."""
    (cfg, api, tp), (jcfg, japi, jp) = _models(arch, "float32", use_pallas=True)
    jb, tb = _batch(cfg, 2, 24, seed=4)
    want, jst = jax.jit(lambda p, t, e: jtf.prefill(p, t, jcfg, prefix_embeds=e))(
        jp, jb["tokens"], jb.get("patch_embeds"))
    got, tst = transformer.prefill(tp, tb["tokens"], cfg, prefix_embeds=tb.get("patch_embeds"))
    _check_logits(got, want, "float32")
    for name, g, w in zip(tst.caches._fields, tst.caches, jst.caches):
        assert tuple(g.shape) == w.shape, name
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        else:
            _close(g, w, F32_TOL)
    # the forward's last logits are the prefill's
    fwd, _ = api.forward(tp, tb, cfg)
    _check_logits(fwd[:, -1:], want, "float32")
    jdec = jax.jit(japi.decode)
    tok = np.array(want[:, -1].argmax(-1), np.int32)[:, None]
    for _ in range(2):
        w, jst = jdec(jp, jst, jnp.asarray(tok))
        g, tst = api.decode(tp, tst, torch.from_numpy(tok))
        _check_logits(g, w, "float32")
        tok = np.array(w[:, -1].argmax(-1), np.int32)[:, None]


def test_vlm_logits_are_the_text_positions():
    """The VLM forward prepends the patch embeddings and returns the logits
    of the text positions only: those of the same model run on the
    concatenated sequence, sliced after the prefix."""
    (cfg, api, tp), _ = _models("internvl2-26b", "float32")
    _, tb = _batch(cfg, 1, 10, seed=5)
    got, _ = api.forward(tp, tb, cfg)
    assert got.shape == (1, 10, cfg.vocab_size)
    pe = tb["patch_embeds"]
    plain, _ = transformer.forward(tp, tb["tokens"], cfg)
    whole, _ = transformer.forward(tp, tb["tokens"], cfg, prefix_embeds=pe)
    assert torch.equal(got, whole) and not torch.allclose(got, plain)


# ---------------------------------------------------------------------------
# enc-dec
# ---------------------------------------------------------------------------

def test_encdec_encode_cross_and_decode_match_reference():
    """``encode``, ``precompute_cross`` and 4 decode steps against a state
    holding the precomputed cross K/V (serving leaves them at zero; see
    ``test_serve_pool_matches_reference``)."""
    (cfg, api, tp), (jcfg, japi, jp) = _models("whisper-large-v3", "float32",
                                               use_pallas=True)
    jb, tb = _batch(cfg, 2, 4, seed=6)
    jenc = jax.jit(lambda p, f: jencdec.encode(p, f, jcfg))(jp, jb["frames"])
    with torch.inference_mode():
        tenc = encdec.encode(tp, tb["frames"], cfg)
    _close(tenc, jenc, F32_TOL)
    jk, jv = jax.jit(lambda p, e: jencdec.precompute_cross(p, e, jcfg))(jp, jenc)
    tk, tv = encdec.precompute_cross(tp, tenc, cfg)
    assert tuple(tk.shape) == jk.shape == (cfg.n_layers, 2, cfg.enc_seq, cfg.n_kv_heads,
                                            cfg.head_dim)
    _close(tk, jk, F32_TOL)
    _close(tv, jv, F32_TOL)
    jst = japi.init_decode_state(2, 8)._replace(cross_k=jk, cross_v=jv)
    tst = api.init_decode_state(2, 8, "cpu")._replace(cross_k=tk, cross_v=tv)
    jdec = jax.jit(japi.decode)
    toks = jb["tokens"]
    for t in range(4):
        want, jst = jdec(jp, jst, toks[:, t:t + 1])
        got, tst = api.decode(tp, tst, tb["tokens"][:, t:t + 1])
        _check_logits(got, want, "float32")
    zero = api.init_decode_state(2, 8, "cpu")
    assert not bool(zero.cross_k.any()) and not bool(zero.cross_v.any())


def test_layer_norm_matches_reference():
    from repro.models import layers as jlayers

    from repro_torch.models import layers

    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 128)).astype(np.float32) * 3 + 1
    sc, b = (1 + 0.1 * rng.normal(size=128)).astype(np.float32), rng.normal(size=128).astype(
        np.float32)
    for dt in ("float32", "bfloat16"):
        got = layers.layer_norm(torch.from_numpy(x).to(TDT[dt]), torch.from_numpy(sc),
                                torch.from_numpy(b), 1e-5)
        want = jlayers.layer_norm(jnp.asarray(x, JDT[dt]), jnp.asarray(sc), jnp.asarray(b),
                                  1e-5)
        assert got.dtype == TDT[dt]
        if dt == "float32":
            _close(got, want, F32_TOL)
        else:   # the same rounding points: the products and sums agree to the bit
            np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

def test_mlstm_chunked_matches_reference():
    rng = np.random.default_rng(8)
    B, S, H, P, chunk = 2, 96, 4, 16, 32
    q, k, v = (rng.normal(size=(B, S, H, P)).astype(np.float32) for _ in range(3))
    gi, gf = (rng.normal(size=(B, S, H)).astype(np.float32) * 2 for _ in range(2))
    li, lf = -np.logaddexp(0, -gi), -np.logaddexp(0, -gf)
    args = [q, k, v, li.astype(np.float32), lf.astype(np.float32)]
    want = jxlstm._mlstm_chunked(*(jnp.asarray(a) for a in args), chunk)
    got = xlstm._mlstm_chunked(*(torch.from_numpy(a) for a in args), chunk)
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    _close(got, want, F32_TOL * scale)


def test_slstm_cell_over_many_steps_matches_reference():
    """120 recurrent steps from the -1e30 stabilizer: m, c, n and h follow
    the reference's (m moves from -1e30 to the gates' scale at step 1)."""
    cfg = get_smoke_config("xlstm-350m")
    jcfg = j_get_smoke_config("xlstm-350m")
    jp = jax.tree.map(lambda a: a[0], j_get_model(jcfg).init(jax.random.PRNGKey(0))["slstm"])
    tp = xlstm.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    assert tp["r"].dtype == torch.float32
    xs = np.random.default_rng(9).normal(size=(120, 2, 4 * cfg.d_model)).astype(np.float32)
    js = jxlstm.init_slstm_state(jcfg, 2)
    ts = xlstm.init_slstm_state(cfg, 2, "cpu")
    assert float(ts.m[0, 0]) == float(js.m[0, 0]) == np.float32(-1e30)
    jcell = jax.jit(lambda s, x: jxlstm._slstm_cell(jp, x, s, jcfg))
    for t in range(120):
        js = jcell(js, jnp.asarray(xs[t]))
        ts = xlstm._slstm_cell(tp, torch.from_numpy(xs[t]), ts, cfg)
    for name, g, w in zip(ts._fields, ts, js):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=F32_TOL * scale, rtol=0,
                                   err_msg=name)
    assert float(np.asarray(js.m).min()) > -1e3


def test_xlstm_decode_state_matches_reference():
    (cfg, api, tp), (jcfg, japi, jp) = _models("xlstm-350m", "float32")
    toks = np.random.default_rng(10).integers(1, cfg.vocab_size, (2, 6)).astype(np.int32)
    jst, tst = japi.init_decode_state(2, 0), api.init_decode_state(2, 0, "cpu")
    jdec = jax.jit(japi.decode)
    for t in range(6):
        want, jst = jdec(jp, jst, jnp.asarray(toks[:, t:t + 1]))
        got, tst = api.decode(tp, tst, torch.from_numpy(toks[:, t:t + 1]))
        _check_logits(got, want, "float32")
    _check_state(tst, jst, "float32")


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_loss_and_gradients_match_reference(arch):
    """One step's loss (with the MoE load-balance term at weight 0.01) and
    its gradient with respect to every float32 master weight, against
    ``jax.value_and_grad`` of the reference's loss."""
    (cfg, api, tp), (jcfg, japi, jp) = _models(arch, "float32", master=True)
    jb, tb = _batch(cfg, 2, 16, seed=11, labels=True)
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        j_make_loss_fn(japi.forward, jcfg), has_aux=True))(jp, jb)
    (loss, parts), grads = value_and_grad(make_loss_fn(api.train_forward, cfg), tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=k)
    g, w = tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_loop_runs_each_family(arch, capsys):
    """``launch.train.train_loop`` on the CPU: the family's stub inputs
    (zero patch embeddings, zero frames) join the batch, and the MoE
    configs accumulate over 2 microbatches, as their full configs do."""
    from repro_torch.launch import train as ttrain

    kw = {"accum_steps": 2} if arch in ("mixtral-8x7b", "arctic-480b") else {}
    cfg = get_smoke_config(arch).replace(**kw)
    real = ttrain.get_smoke_config
    ttrain.get_smoke_config = lambda a: cfg
    try:
        out = ttrain.train_loop(arch=arch, steps=2, batch=2, seq=16, device="cpu")
    finally:
        ttrain.get_smoke_config = real
    assert out["steps_run"] == 2 and all(np.isfinite(out["losses"]))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_pool_matches_reference(arch, monkeypatch):
    """float32, kernels on, both sides on the reference's parameters: the
    same steps and the same token ids (a near-tie of the top two logits
    would be reported, and the logits still compared).  The reference gets
    a host copy of its token buffer (``tests/test_torch_model.py``)."""
    jcfg = j_get_smoke_config(arch).replace(dtype="float32", use_pallas=True)
    cfg = get_smoke_config(arch).replace(dtype="float32")
    monkeypatch.setattr(jserve, "jnp", types.SimpleNamespace(
        asarray=lambda x: jnp.asarray(np.array(x))))
    monkeypatch.setattr(jserve, "get_smoke_config", lambda a: jcfg)
    monkeypatch.setattr(tserve, "get_smoke_config", lambda a: cfg)
    seen = {"jax": [], "torch": []}

    def recorder(side, fn):
        def sample(logits, *a, **kw):
            out = fn(logits, *a, **kw)
            seen[side].append((np.array(logits, np.float32), np.array(out)))
            return out
        return sample

    monkeypatch.setattr(jserve, "sample_tokens", recorder("jax", jserve.sample_tokens))
    monkeypatch.setattr(tserve, "sample_tokens", recorder("torch", tserve.sample_tokens))
    kw = dict(arch=arch, n_requests=3, batch=2, prompt_len=3, max_new=3, capacity=16, seed=0)
    want = jserve.serve_pool(**kw)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = MODULE[cfg.family].params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                                  device="cpu")
    got = tserve.serve_pool(**kw, device="cpu", params=params)
    for key in ("requests", "decode_steps", "tokens_generated", "all_done"):
        assert got[key] == want[key], key
    assert got["all_done"] and len(seen["torch"]) == len(seen["jax"]) == got["decode_steps"]
    for step, ((tl, tt), (jl, jt)) in enumerate(zip(seen["torch"], seen["jax"])):
        np.testing.assert_allclose(tl, jl, atol=LOGIT_TOL, rtol=0)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        tie = (top2[:, 1] - top2[:, 0]) < LOGIT_TOL
        if tie.any():
            warnings.warn(f"step {step}: top-two logits within {LOGIT_TOL}; logits compared")
        assert (tt == jt)[~tie].all(), step
