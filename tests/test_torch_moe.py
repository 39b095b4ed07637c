"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX reference,
on the CPU: mixtral-8x7b's and arctic-480b's smoke configs in float32 and
bfloat16.

Same inputs, made with numpy from a seed, and the reference's own
parameters go through ``repro.models.moe`` and its port.  The reference's
routing is read off its own calls (its ``top_k``, its stable ``argsort``
and the rank it clamps to the capacity), run eagerly; the port's off
``moe.route``.

Tolerances: the routing (top-k ids, the sort order, the keep mask, the
capacity) ``==``, where the router's inputs are the same arrays (both sides
take the router products in float32, and a near-tie that float32 rounding
could flip does not occur at these seeds); outputs atol 2e-5 in float32 and
0.08 in bfloat16 (``tests/test_kernels.py``, the reference's kernel
tolerances); the load-balance loss atol 1e-6 (float32 sums of ~E terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import get_model as j_get_model
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer

from repro_torch.configs import get_smoke_config
from repro_torch.models import moe, transformer
from repro_torch.models.layers import cast_matrices, tree_from_numpy

ARCHS = ["mixtral-8x7b", "arctic-480b"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
AUX_TOL = 1e-6


def _tol(dtype: str) -> float:
    return 0.08 if dtype == "bfloat16" else 2e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _configs(arch, dtype, **kw):
    return (get_smoke_config(arch).replace(dtype=dtype, **kw),
            j_get_smoke_config(arch).replace(dtype=dtype, **kw))


def _layer0_moe(jcfg, seed=0):
    """The reference's first layer's MoE parameters: (jax tree, numpy tree)."""
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(seed))
    jm = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    return jm, jax.tree.map(lambda a: np.asarray(a, np.float32), jm)


def _port_moe(np_tree, cfg):
    """The port's serving form of the same tree (matrices cast, the router
    kept in float32), as ``transformer.params_from_numpy`` loads it."""
    tree = tree_from_numpy(np_tree, cfg.torch_param_dtype, "cpu")
    return cast_matrices(tree, cfg.torch_dtype, {}, moe.KEEP_FLOAT32)


class _Spy:
    """A module stand-in: every attribute is the real module's but those given."""

    def __init__(self, real, **override):
        self._real = real
        self.__dict__.update(override)

    def __getattr__(self, name):
        return getattr(self._real, name)


def _reference_routing(monkeypatch, fn, *args):
    """Run the reference's ``fn(*args)`` eagerly and read its routing off
    its own calls: the first ``top_k`` (ids), the first stable ``argsort``
    (the sort order) and the rank it clamps to ``C - 1`` (keep = rank < C)."""
    seen = {}

    def top_k(x, k):
        out = jax.lax.top_k(x, k)
        seen.setdefault("top_ids", np.asarray(out[1]))
        return out

    def argsort(a, *args, **kw):
        out = jnp.argsort(a, *args, **kw)
        seen.setdefault("order", np.asarray(out))
        return out

    def minimum(a, b):
        seen.setdefault("rank", np.asarray(a))
        seen.setdefault("capacity", int(b) + 1)
        return jnp.minimum(a, b)

    monkeypatch.setattr(jmoe, "jax", _Spy(jax, lax=_Spy(jax.lax, top_k=top_k)))
    monkeypatch.setattr(jmoe, "jnp", _Spy(jnp, argsort=argsort, minimum=minimum))
    out = fn(*args)
    monkeypatch.undo()
    if "rank" in seen:
        seen["keep"] = seen.pop("rank") < seen["capacity"]
    return out, seen


def _port_routing(monkeypatch, fn, *args):
    seen = []
    real = moe.route

    def record(*a, **kw):
        r = real(*a, **kw)
        seen.append(r)
        return r

    monkeypatch.setattr(moe, "route", record)
    out = fn(*args)
    monkeypatch.undo()
    return out, seen


def _check_routing(port: list, ref: dict):
    assert len(port) == 1
    r = port[0]
    np.testing.assert_array_equal(r.top_ids.numpy(), ref["top_ids"])
    np.testing.assert_array_equal(r.order.numpy(), ref["order"])
    np.testing.assert_array_equal(r.keep.numpy(), ref["keep"])
    assert r.capacity == ref["capacity"]


def _x(cfg, shape, seed=1, dtype="float32"):
    a = (np.random.default_rng(seed).normal(size=shape) * 0.5).astype(np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


# ---------------------------------------------------------------------------
# Top-k order
# ---------------------------------------------------------------------------

def test_top_k_breaks_ties_by_the_lower_index():
    """``jax.lax.top_k`` takes the lower index first on a tie, and so must
    the port (``torch.topk`` does not promise it)."""
    _, ids = moe.top_k(torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]]), 2)
    assert ids.tolist() == [[1, 2]]
    _, ids = moe.top_k(torch.zeros((1, 8)), 2)
    assert ids.tolist() == [[0, 1]]
    rows = np.random.default_rng(0).integers(-2, 3, (500, 8)).astype(np.float32)
    for k in (1, 2, 3):
        vals, ids = moe.top_k(torch.from_numpy(rows), k)
        jvals, jids = jax.lax.top_k(jnp.asarray(rows), k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


# ---------------------------------------------------------------------------
# moe_ffn against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, dtype, monkeypatch):
    cfg, jcfg = _configs(arch, dtype)
    jm, nm = _layer0_moe(jcfg)
    tm = _port_moe(nm, cfg)
    assert tm["router"].dtype == torch.float32
    assert tm["wi"].dtype == TDT[dtype]
    jx, tx = _x(cfg, (2, 24, cfg.d_model), dtype=dtype)
    (want, jaux), ref = _reference_routing(monkeypatch, jmoe.moe_ffn, jm, jx, jcfg)
    (got, aux), port = _port_routing(monkeypatch, moe.moe_ffn, tm, tx, cfg)
    _check_routing(port, ref)
    assert got.dtype == TDT[dtype] and got.shape == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype), rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=AUX_TOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_drops_match_reference(arch, monkeypatch):
    """A capacity factor of 0.5 drops pairs: the same pairs are kept, a
    dropped pair still lands on slot C - 1 (so the buffer fill has
    duplicate indices, which must add, not overwrite), and the outputs
    agree."""
    cfg, jcfg = _configs(arch, "float32", capacity_factor=0.5)
    jm, nm = _layer0_moe(jcfg)
    tm = _port_moe(nm, cfg)
    jx, tx = _x(cfg, (2, 24, cfg.d_model), seed=2)
    (want, jaux), ref = _reference_routing(monkeypatch, jmoe.moe_ffn, jm, jx, jcfg)
    (got, aux), port = _port_routing(monkeypatch, moe.moe_ffn, tm, tx, cfg)
    _check_routing(port, ref)
    r = port[0]
    assert r.capacity == 12 and not bool(r.keep.all())    # ceil(48 * 2 / 4 * 0.5)
    e_sorted = torch.gather(r.top_ids.reshape(1, -1), -1, r.order)
    slots = (e_sorted * r.capacity + r.r_idx).reshape(-1)
    assert len(torch.unique(slots)) < len(slots)          # dropped pairs share C - 1
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol("float32"), rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=AUX_TOL, rtol=0)
    # the same fill with overwrites in place of sums loses the kept pairs on C - 1
    real = torch.Tensor.index_add_
    monkeypatch.setattr(torch.Tensor, "index_add_",
                        lambda self, dim, idx, src: self.index_copy_(dim, idx, src))
    wrong, _ = moe.moe_ffn(tm, tx, cfg)
    monkeypatch.setattr(torch.Tensor, "index_add_", real)
    assert float((wrong - got).abs().max()) > 1e-2


def test_decode_capacity_matches_reference_at_one_slot(monkeypatch):
    """Decode takes ``capacity_factor = max(cf, 8)``: on the arctic smoke
    config with 128 experts, B = 4 tokens give C = ceil(4 * 2 / 128 * 8)
    = 1, so a second pair on one expert is dropped; the routing and output
    match the reference's at that capacity, and so do 3 decode steps of the
    whole model (where the boost is applied)."""
    cfg, jcfg = _configs("arctic-480b", "float32", n_experts=128)
    dcfg = cfg.replace(capacity_factor=max(cfg.capacity_factor, 8.0))
    jdcfg = jcfg.replace(capacity_factor=max(jcfg.capacity_factor, 8.0))
    jm, nm = _layer0_moe(jcfg)
    tm = _port_moe(nm, cfg)
    jx, tx = _x(cfg, (4, 1, cfg.d_model), seed=3)
    (want, _), ref = _reference_routing(monkeypatch, jmoe.moe_ffn, jm, jx, jdcfg)
    (got, _), port = _port_routing(monkeypatch, moe.moe_ffn, tm, tx, dcfg)
    _check_routing(port, ref)
    assert port[0].capacity == 1
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol("float32"), rtol=0)

    japi = j_get_model(jcfg)
    jp = japi.init(jax.random.PRNGKey(0))
    tp = transformer.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (4, 3)).astype(np.int32)
    jst = jtransformer.init_decode_state(jcfg, 4, 8)
    tst = transformer.init_decode_state(cfg, 4, 8, "cpu")
    jdec = jax.jit(lambda p, s, t: jtransformer.decode_step(p, s, t, jcfg))
    for t in range(3):
        w, jst = jdec(jp, jst, jnp.asarray(toks[:, t:t + 1]))
        (g, tst), port = _port_routing(monkeypatch, transformer.decode_step, tp, tst,
                                       torch.from_numpy(toks[:, t:t + 1]), cfg)
        assert [r.capacity for r in port] == [1] * cfg.n_layers
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=0)
    assert any(not bool(r.keep.all()) for r in port)


def test_planted_router_ties_route_as_the_reference(monkeypatch):
    """Router columns 1, 2 and 3 equal (their logits tie exactly for every
    token) and some all-zero tokens (every logit 0): the lower expert wins
    each tie on both sides, and every stage of the routing agrees."""
    cfg, jcfg = _configs("mixtral-8x7b", "float32")
    jm, nm = _layer0_moe(jcfg)
    nm = dict(nm, router=nm["router"].copy())
    nm["router"][:, 2] = nm["router"][:, 1]
    nm["router"][:, 3] = nm["router"][:, 1]
    jm = dict(jm, router=jnp.asarray(nm["router"]))
    tm = _port_moe(nm, cfg)
    x = (np.random.default_rng(5).normal(size=(1, 16, cfg.d_model)) * 0.5).astype(np.float32)
    x[0, ::3] = 0.0
    (want, _), ref = _reference_routing(monkeypatch, jmoe.moe_ffn, jm, jnp.asarray(x), jcfg)
    (got, _), port = _port_routing(monkeypatch, moe.moe_ffn, tm, torch.from_numpy(x), cfg)
    _check_routing(port, ref)
    ids = port[0].top_ids.numpy()[0]
    assert (ids[::3] == [0, 1]).all()                     # all-zero tokens: experts 0, 1
    # a tie between 1 and 2 (or 3) always keeps the lower expert
    assert not ((ids == 2).any(-1) & ~(ids == 1).any(-1)).any()
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol("float32"), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_tokens_matches_reference(arch, dtype):
    """The per-token gather variant (no caller in the reference or the port)."""
    cfg, jcfg = _configs(arch, dtype)
    jm, nm = _layer0_moe(jcfg)
    tm = _port_moe(nm, cfg)
    jx, tx = _x(cfg, (3, 2, cfg.d_model), seed=6, dtype=dtype)
    want = jmoe.moe_ffn_tokens(jm, jx, jcfg)
    got = moe.moe_ffn_tokens(tm, tx, cfg)
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype), rtol=0)


def test_moe_ffn_is_differentiable_with_master_weights():
    """Training reads float32 master weights cast at use: the gradient
    reaches the router and every expert weight."""
    cfg, jcfg = _configs("arctic-480b", "float32")
    _, nm = _layer0_moe(jcfg)
    tm = {k: (torch.from_numpy(np.array(v)).requires_grad_(True) if not isinstance(v, dict)
              else {kk: torch.from_numpy(np.array(vv)).requires_grad_(True)
                    for kk, vv in v.items()})
          for k, v in nm.items()}
    _, tx = _x(cfg, (2, 8, cfg.d_model), seed=7)
    y, aux = moe.moe_ffn(tm, tx, cfg)
    (y.square().mean() + 0.01 * aux).backward()
    for name in ("router", "wi", "wg", "wo"):
        assert tm[name].grad is not None and float(tm[name].grad.abs().sum()) > 0, name
    assert tm["dense"]["wi"].grad is not None


def test_bf16_parameters_load_from_the_reference():
    """arctic-480b keeps its parameters in bfloat16: the reference's tree,
    as numpy arrays of bfloat16 (``ml_dtypes``), loads into the port
    unchanged, the router still read in float32 at use."""
    cfg, jcfg = _configs("arctic-480b", "bfloat16", param_dtype="bfloat16")
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    assert tree["layers"]["moe"]["wi"].dtype.name == "bfloat16"
    tp = transformer.params_from_numpy(tree, cfg, device="cpu")
    for name in ("router", "wi"):
        got, want = tp["layers"]["moe"][name], jp["layers"]["moe"][name]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
