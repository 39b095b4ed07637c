"""The mesh's data and model axes in execution (``repro_torch.launch.mesh``
``use_mesh``, ``launch.collectives``, ``models.layers.shard_spec``,
``models.sharding.place``/``gather``, sequence-parallel attention, the MoE's
mesh branch, the forward and prefill under a mesh, ``ShardedLoader(mesh=)``)
against the JAX reference, on meshes of CPU slots.

The reference proves these paths on 8 forced host devices
(``tests/test_distributed_numerics.py``); here its single-device functions
run in this process at that test's sizes and bounds, on the same inputs
made with numpy from a seed: sequence-parallel attention within 1e-5 of
``plain_attention`` (float32, causal and with a window of 200), the MoE mesh
branch within 1e-4 of ``moe_ffn_tokens`` at capacity factor 16 and its
gradients within 2e-3, and at capacity factor 1.0 the port's per-slot
dispatch against the reference's ``_grouped_dispatch`` over the same G
groups: the kept pairs ``==`` and the outputs within 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data import SyntheticLMDataset as JDataset
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import moe as jmoe

from repro_torch.configs import get_smoke_config
from repro_torch.data import ShardedLoader, SyntheticLMDataset
from repro_torch.launch import collectives
from repro_torch.launch.mesh import data_slot_scope, make_mesh, use_mesh
from repro_torch.models import attention, get_model, layers, moe, sharding, transformer
from repro_torch.models.common import abstract_mesh, data_slot
from repro_torch.models.layers import tree_from_numpy

SEQPAR_TOL, MOE_TOL, MOE_GRAD_TOL, DISPATCH_TOL = 1e-5, 1e-4, 2e-3, 1e-5
# the port's mesh forward against its own single-device forward, float32
# (the same products on fewer rows; a row's arithmetic does not change)
SELF_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: the tier-1 run gives each
    of its workers a share of the cores, and these tests' many small
    products lose far more to oversubscribed threads than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape=(2, 4), axes=("data", "model")):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# The ambient mesh and the collectives
# ---------------------------------------------------------------------------

def test_use_mesh_is_ambient_nests_and_clears():
    m, m2 = _mesh(), _mesh((4, 2))
    assert abstract_mesh() is None
    with use_mesh(m):
        assert abstract_mesh() is m and data_slot() == 0
        with data_slot_scope(1):
            assert data_slot() == 1
        with use_mesh(m2):
            assert abstract_mesh() is m2
        with use_mesh(None):
            assert abstract_mesh() is None
        assert abstract_mesh() is m
    assert abstract_mesh() is None
    with pytest.raises(ValueError, match="concrete"):
        with use_mesh(sharding_mesh_abstract()):
            pass


def sharding_mesh_abstract():
    from repro_torch.launch.mesh import Mesh
    return Mesh(("data", "model"), (2, 4))


def test_mesh_slot_devices_are_row_major():
    m = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=[f"cpu:{i}" for i in range(8)])
    assert [d.index for d in m.data_devices()] == [0, 2, 4, 6]
    assert [d.index for d in m.model_devices(2)] == [4, 5]
    assert m.coords(5) == {"pod": 1, "data": 0, "model": 1}
    assert m.slot(pod=1, model=1) == 5
    assert collectives.axis_index(m, "data", 6) == 1


def test_collectives_values_and_gradients():
    xs = [torch.arange(6.).reshape(2, 3) + 10 * i for i in range(4)]
    for x in xs:
        x.requires_grad_(True)
    devs = ["cpu"] * 4
    g = collectives.all_gather(xs, 0, devs)
    assert all(t is g[0] for t in g)                 # one device: one shared tensor
    assert torch.equal(g[0], torch.cat(xs, 0))
    (g[0] * torch.arange(24.).reshape(8, 3)).sum().backward()
    assert torch.equal(xs[1].grad, torch.arange(6., 12.).reshape(2, 3))   # the slice
    s = collectives.psum(xs, "cpu")
    assert torch.equal(s, xs[0] + xs[1] + xs[2] + xs[3])
    rs = collectives.reduce_scatter([x.detach() for x in xs], 1, ["cpu"] * 3)
    assert torch.equal(torch.cat(rs, 1), s.detach())
    parts = collectives.scatter(torch.arange(8.), 0, ["cpu"] * 4)
    assert [p.tolist() for p in parts] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    w = torch.ones(3, requires_grad=True)
    b = collectives.broadcast(w, ["cpu"] * 3)
    collectives.psum([t * (i + 1) for i, t in enumerate(b)], "cpu").sum().backward()
    assert torch.equal(w.grad, torch.full((3,), 6.))  # the broadcast's gradient: the sum
    with pytest.raises(ValueError, match="does not split"):
        collectives.scatter(torch.arange(6.), 0, ["cpu"] * 4)


# ---------------------------------------------------------------------------
# Logical sharding and placement
# ---------------------------------------------------------------------------

RULE_MESHES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
               ((16, 16), ("data", "model")), ((4,), ("stage",))]


@pytest.mark.parametrize("shape, axes", RULE_MESHES, ids=["2x4", "2x2x2", "16x16", "stage4"])
def test_logical_resolution_equals_the_references(shape, axes, monkeypatch):
    assert layers.LOGICAL_RULES == jlayers.LOGICAL_RULES
    names = list(jlayers.LOGICAL_RULES) + [None, "unknown"]
    for a in names:
        assert layers._resolve(a, set(axes)) == jlayers._resolve(a, set(axes)), a
    am = AbstractMesh(shape, axes)
    pm = sharding_mesh_of(shape, axes)
    for combo in ([a, b] for a in names for b in names):
        try:
            want = NamedSharding(am, jax.sharding.PartitionSpec(
                *(jlayers._resolve(a, set(axes)) for a in combo))).spec
        except Exception as e:                        # a mesh axis named twice
            assert "duplicate" in str(e)
            with pytest.raises(ValueError, match="twice"):
                layers.logical_sharding(combo, pm)
            continue
        assert layers.logical_sharding(combo, pm) == tuple(want), combo
    # ``shard``'s spec, uneven axes dropped and each mesh axis used once, as
    # the reference's constraint reads it
    seen = []
    monkeypatch.setattr(jlayers, "abstract_mesh", lambda: am)
    monkeypatch.setattr(jlayers.jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(spec) or x)
    for dims in ((8, 12, 16, 6), (6, 4, 3, 16), (1, 16, 7, 2)):
        for combo in (("batch", "seq", "d_model", "heads"), ("batch", "experts", "ff", "vocab"),
                      ("heads", "kv_heads", "moe_cap", "seq_kv"), ("stage", "batch", None,
                                                                   "seq_sp")):
            seen.clear()
            jlayers.shard(jnp.zeros(dims), *combo)
            assert layers.shard_spec(dims, *combo, mesh=pm) == tuple(seen[0]), (dims, combo)
    x = torch.ones(3)
    assert layers.shard(x, "batch") is x            # changes no value


def sharding_mesh_of(shape, axes):
    from repro_torch.launch.mesh import Mesh
    return Mesh(axes, shape, ("cpu",) * int(np.prod(shape)))


@pytest.mark.parametrize("shape, axes", RULE_MESHES[:2], ids=["2x4", "2x2x2"])
@pytest.mark.parametrize("rule", ["param_specs", "zero1_specs"])
def test_place_and_gather_round_trip_with_the_references_shard_shapes(shape, axes, rule):
    cfg = get_smoke_config("qwen1.5-110b")
    params = get_model(cfg).init(0, "cpu", master=True)
    mesh = make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))
    specs = getattr(sharding, rule)(params, cfg, mesh)
    placed = sharding.place(params, specs, mesh)
    back = sharding.gather(placed)
    am = AbstractMesh(shape, axes)
    n_split = 0
    for (path, x), (_, st), (_, y) in zip(_leaves(params), _leaves(placed), _leaves(back)):
        assert torch.equal(x, y) and y is not x, path
        want = NamedSharding(am, jax.sharding.PartitionSpec(*st.spec)).shard_shape(x.shape)
        assert all(tuple(t.shape) == tuple(want) for t in st.shards), path
        for s, t in enumerate(st.shards):
            assert torch.equal(t, x[st.region(s)])
            assert t.data_ptr() != x.data_ptr()       # copies, not views
        n_split += any(c > 1 for c in st.counts())
    assert n_split > 0
    held = [sum(t.numel() * 4 for t in (st.shards[s] for _, st in _leaves(placed)))
            for s in range(mesh.size)]
    assert held == [sharding.slot_bytes(params, specs, mesh)] * mesh.size


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


@pytest.mark.parametrize("batch", [8, 3])
def test_loader_on_a_mesh_puts_each_slots_rows_on_it(batch):
    mesh = _mesh()
    ds = SyntheticLMDataset(512, 16, batch, seed=5)
    loader = ShardedLoader(ds, mesh=mesh, start_step=2)
    it = iter(loader)
    got = [next(it) for _ in range(2)]
    loader.close()
    for step, b in got:
        want = JDataset(512, 16, batch, seed=5).batch(step)
        for k in ("tokens", "labels"):
            st = b[k]
            assert isinstance(st, sharding.ShardedTensor)
            for s in range(mesh.size):
                rows = slice(None) if batch % 2 else slice(4 * mesh.coords(s)["data"],
                                                           4 * mesh.coords(s)["data"] + 4)
                np.testing.assert_array_equal(st.shards[s].numpy(), want[k][rows])
            assert len(st.unique()) == (1 if batch % 2 else 2)


# ---------------------------------------------------------------------------
# Sequence-parallel attention
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seqpar_inputs():
    """The reference test's inputs and its ``plain_attention`` outputs
    (causal; causal with a window of 200)."""
    rng = np.random.default_rng(0)
    B, S, H, K, hd = 2, 512, 6, 2, 32
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32) * 0.5
    k = rng.normal(size=(B, S, K, hd)).astype(np.float32) * 0.5
    v = rng.normal(size=(B, S, K, hd)).astype(np.float32) * 0.5
    want = {w: np.asarray(jax.jit(lambda q, k, v: jattention.plain_attention(
        q, k, v, causal=True, window=w))(q, k, v)) for w in (None, 200)}
    return (q, k, v), want


@pytest.mark.parametrize("route", ["seq_parallel_attention", "blocked_attention"])
@pytest.mark.parametrize("window", [None, 200], ids=["causal", "window200"])
def test_seq_parallel_attention_matches_reference_plain(seqpar_inputs, window, route,
                                                        monkeypatch):
    (q, k, v), want = seqpar_inputs
    calls = []
    real = attention.seq_parallel_attention
    monkeypatch.setattr(attention, "seq_parallel_attention",
                        lambda *a, **kw: calls.append(kw["block_q"]) or real(*a, **kw))
    with use_mesh(_mesh()):
        got = getattr(attention, route)(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                                        window=window, block_q=128, block_k=128)
    assert calls == [128]            # H = 6 on a 4-way model axis: sequence-parallel
    err = float(np.abs(_np(got) - want[window]).max())
    assert err <= SEQPAR_TOL, err


def test_seq_parallel_dispatch_follows_the_references_condition(monkeypatch):
    """Only where the heads do not divide the model axis, S == T, and each
    slot's chunk is a multiple of 128; block_q shrinks to the chunk."""
    calls = []
    real = attention.seq_parallel_attention
    monkeypatch.setattr(attention, "seq_parallel_attention",
                        lambda *a, **kw: calls.append(kw["block_q"]) or real(*a, **kw))
    g = torch.Generator().manual_seed(1)
    cases = [((2, 4), 6, 1024, 512, True), ((2, 4), 8, 1024, 512, False),
             ((2, 4), 6, 256, 128, False), ((2, 4), 6, 1024, 256, True),
             ((4, 2), 6, 512, 512, False), ((2, 16), 40, 2048, 512, True)]
    for shape, H, S, bq, taken in cases:
        calls.clear()
        q = torch.randn(1, S, H, 8, generator=g)
        kv = torch.randn(1, S, 2, 8, generator=g)
        with use_mesh(_mesh(shape)):
            attention.blocked_attention(q, kv, kv, causal=True, window=None, block_q=bq,
                                        block_k=bq)
        assert calls == ([min(bq, S // shape[1])] if taken else []), (shape, H, S, bq)


def test_seq_parallel_slot_uses_its_query_offset(seqpar_inputs):
    """Each model slot's chunk is masked at its absolute offset: a slot
    that took offset 0 would let its queries see the future."""
    (q, k, v), want = seqpar_inputs
    real = attention._slot_attention
    try:
        attention._slot_attention = lambda *a, **kw: real(*a[:3], 0, **kw)
        with use_mesh(_mesh()):
            got = attention.seq_parallel_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                                   causal=True, window=None, block_q=128,
                                                   block_k=128)
    finally:
        attention._slot_attention = real
    assert float(np.abs(_np(got) - want[None]).max()) > 1e-2


# ---------------------------------------------------------------------------
# The MoE's mesh branch
# ---------------------------------------------------------------------------

def _moe_setup(cf: float):
    jcfg = j_get_smoke_config("mixtral-8x7b").replace(capacity_factor=cf)
    cfg = get_smoke_config("mixtral-8x7b").replace(capacity_factor=cf)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 32, cfg.d_model)) * 0.3).astype(np.float32)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), torch.float32, "cpu")
    return cfg, jcfg, jp, tp, x


@pytest.fixture(scope="module")
def moe_tokens_reference():
    """The reference test's oracle at capacity factor 16: ``moe_ffn_tokens``
    and the gradient of its sum."""
    _, jcfg, jp, _, x = _moe_setup(16.0)
    y = jax.jit(lambda p, x: jmoe.moe_ffn_tokens(p, x, jcfg))(jp, x)
    g = jax.jit(jax.grad(lambda p, x: jmoe.moe_ffn_tokens(p, x, jcfg).sum()))(jp, x)
    return np.asarray(y), jax.tree.map(np.asarray, g)


def _count_dispatches(monkeypatch):
    shapes = []
    real = moe._grouped_dispatch
    monkeypatch.setattr(moe, "_grouped_dispatch",
                        lambda p, flat, cfg: shapes.append(tuple(flat.shape)) or real(p, flat, cfg))
    return shapes


def test_moe_mesh_branch_matches_reference_oracle_and_gradients(moe_tokens_reference,
                                                                monkeypatch):
    y_ref, g_ref = moe_tokens_reference
    cfg, _, _, tp, x = _moe_setup(16.0)
    shapes = _count_dispatches(monkeypatch)
    for p in tp.values():
        p.requires_grad_(True)
    with use_mesh(_mesh()):
        y, aux = moe.moe_ffn(tp, torch.from_numpy(x), cfg)
        y.sum().backward()
    assert shapes == [(1, 64, cfg.d_model)] * 2      # G = 2: one group per data slot
    err = float(np.abs(_np(y) - y_ref).max())
    assert err < MOE_TOL, err
    for name in ("router", "wi", "wg", "wo"):
        gerr = float(np.abs(_np(tp[name].grad) - g_ref[name]).max())
        assert gerr < MOE_GRAD_TOL, (name, gerr)


def _reference_grouped(jcfg, jp, flat, monkeypatch):
    """The reference's ``_grouped_dispatch`` over ``flat`` (G, n, d),
    jitted, with the ranks it clamps to the capacity read off its own
    ``jnp.minimum`` call (a host callback carries them out)."""
    seen = {}

    class _Jnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        def minimum(self, a, b):
            seen.setdefault("capacity", int(b) + 1)
            jax.debug.callback(lambda r: seen.setdefault("rank", np.asarray(r)), a)
            return jnp.minimum(a, b)

    monkeypatch.setattr(jmoe, "jnp", _Jnp())
    y, aux = jax.jit(lambda p, f: jmoe._grouped_dispatch(p, f, jcfg))(jp, jnp.asarray(flat))
    jax.effects_barrier()
    monkeypatch.undo()
    return np.asarray(y), float(aux), seen["rank"] < seen["capacity"]


@pytest.mark.parametrize("shard_map", [True, False], ids=["per-slot", "global"])
def test_moe_at_capacity_one_drops_as_the_references_grouped_dispatch(shard_map, monkeypatch):
    cfg, jcfg, jp, tp, x = _moe_setup(1.0)
    cfg = cfg.replace(moe_shard_map=shard_map)
    G, n, d = 2, 64, cfg.d_model
    y_ref, aux_ref, keep_ref = _reference_grouped(jcfg, jp, x.reshape(G, n, d), monkeypatch)
    routes = []
    real = moe.route
    monkeypatch.setattr(moe, "route", lambda *a: routes.append(real(*a)) or routes[-1])
    with use_mesh(_mesh()):
        y, aux = moe.moe_ffn(tp, torch.from_numpy(x), cfg)
    keep = np.concatenate([r.keep.numpy() for r in routes], axis=0)
    assert keep.shape == keep_ref.shape == (G, n * cfg.top_k)
    assert (~keep_ref).sum() > 0                      # capacity 1.0 drops pairs
    np.testing.assert_array_equal(keep, keep_ref)
    err = float(np.abs(_np(y).reshape(G, n, d) - y_ref).max())
    assert err <= DISPATCH_TOL, err
    # the aux loss: the reference's over the G groups, or per slot (each
    # group's own, as ``route`` gives it; ``tests/test_torch_moe.py`` holds
    # that to the reference's) summed over the slots over their count
    flat = torch.from_numpy(x.reshape(G, n, d))
    want_aux = aux_ref if not shard_map else np.mean(
        [float(real(flat[g:g + 1], tp["router"], cfg).aux) for g in range(G)])
    assert abs(float(aux) - want_aux) < 1e-6


def test_moe_groups_follow_the_data_slots():
    with use_mesh(_mesh((4, 2))):
        assert moe._moe_groups(8192, 8, 4) == 4
        assert moe._moe_groups(8192, 8, 2) == 2        # halved until it divides the batch
        assert moe._moe_groups(40, 8, 4) == 2          # halved until each group feeds 2E
    assert moe._moe_groups(8192, 8, 4) == 1


# ---------------------------------------------------------------------------
# The forward and prefill under a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch, mesh_shape, seq", [("qwen3-4b", (2, 2), 512),
                                                   ("mixtral-8x7b", (2, 2), 512)])
def test_forward_and_prefill_under_a_mesh_match_one_device(arch, mesh_shape, seq, monkeypatch):
    """float32, kernels' plain versions on; mixtral at capacity factor 4
    (four times an expert's mean load), where no pair drops, so the groups
    do not change the output.  (Sequence-parallel attention inside prefill,
    and flash per slot in a forward: ``tests/test_torch_chip_smoke_mesh.py``.)"""
    cfg = get_smoke_config(arch).replace(dtype="float32", use_pallas=True, capacity_factor=4.0,
                                         n_layers=2)
    api = get_model(cfg)
    params = api.init(0, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, seq), generator=torch.Generator().manual_seed(1))
    logits, state = transformer.prefill(params, toks, cfg)
    fwd, _ = api.forward(params, {"tokens": toks}, cfg)
    rms, seqpar = [], []
    from repro_torch.kernels import ops
    real, real_sp = ops.rmsnorm, attention.seq_parallel_attention
    monkeypatch.setattr(ops, "rmsnorm", lambda *a, **kw: rms.append(a[0].shape[0]) or real(*a, **kw))
    monkeypatch.setattr(attention, "seq_parallel_attention",
                        lambda *a, **kw: seqpar.append(a[0].shape) or real_sp(*a, **kw))
    mesh = _mesh(mesh_shape)
    with use_mesh(mesh):
        m_logits, m_state = transformer.prefill(params, toks, cfg)
        n_prefill = len(rms)
        m_fwd, _ = api.forward(params, {"tokens": toks}, cfg)
    dsize, msize = mesh_shape
    # per model slot of each data slot: each normalizes its copy of the rows
    assert n_prefill == dsize * msize * (2 * cfg.n_layers + 1)
    assert seqpar == []                                       # heads divide the model axis
    assert set(rms) == {2 // dsize}                           # each on its slot's rows
    for a, b in ((m_logits, logits), (m_fwd, fwd), (m_state.caches.k, state.caches.k),
                 (m_state.caches.v, state.caches.v)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float((a - b).abs().max()) <= SELF_TOL
    assert torch.equal(m_state.caches.positions, state.caches.positions)
    assert torch.equal(m_state.caches.pos, state.caches.pos)


def test_no_mesh_paths_are_unchanged_bit_for_bit():
    """Outside ``use_mesh`` (and inside ``use_mesh(None)``) the forward is
    the single-device path."""
    cfg = get_smoke_config("mixtral-8x7b").replace(dtype="float32")
    api = get_model(cfg)
    params = api.init(0, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(2))
    a, aux_a = api.forward(params, {"tokens": toks}, cfg)
    with use_mesh(None):
        b, aux_b = api.forward(params, {"tokens": toks}, cfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
