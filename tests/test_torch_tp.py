"""Tensor parallelism over the mesh's ``model`` axis for the transformer
families (``repro_torch.models``: ``sharding.SlotViews`` and the per-slot
``reduce_to_placement``, ``layers.embed_row``/``mlp_row``/``unembed_row``,
``attention.attention_row``, ``moe.moe_ffn_grid``, the vocabulary-split
cross-entropy, the grid forward, prefill and train step; the dry run's
symmetric data-slot shortcut) against the JAX reference and the port's
own one-device forms, on meshes of CPU slots.

Bounds: the reference's FSDP check (``tests/test_distributed_numerics.py``:
loss and every parameter within 5e-3 of its unsharded step), the smoke
forwards' float32 logits within 1e-4 of the reference's
(``tests/test_torch_families.py``) and prefill caches within 2e-5, the
float32 train step within ``tests/test_torch_fsdp.py``'s bounds of the
port's unsharded one.  Planted faults (a model-axis sum that drops a slot,
a replicated leaf's gradient taken M times, a vocabulary offset one row
off) each break one of these checks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import get_model as j_get_model
from repro.models import transformer as jtransformer
from repro.models.train import init_optimizer as j_init_optimizer
from repro.models.train import make_train_step as j_make_train_step

from repro_torch.configs import get_smoke_config
from repro_torch.launch import collectives, dryrun
from repro_torch.launch.mesh import make_mesh, use_mesh
from repro_torch.models import get_model, layers, moe, sharding, transformer
from repro_torch.models.common import ShapeSpec
from repro_torch.models.train import (_nll_sums, _nll_sums_row, init_optimizer, make_train_step,
                                      place_train_state)
from repro_torch.optim.tree import tree_leaves

REF_TOL, LOGIT_TOL, CACHE_TOL = 5e-3, 1e-4, 2e-5
SELF = {"loss_rel": 1e-6, "grad_norm_rel": 1e-6, "moment_rel": 1e-5, "param": 1e-4}
KW = dict(base_lr=1e-3, warmup=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other mesh test files use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape=(2, 4)):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * int(np.prod(shape)))


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture
def model_psums(monkeypatch):
    """Counts the all-reduces over a data slot's model slots (``psum`` to a
    list of devices)."""
    calls = []
    real = collectives.psum

    def counted(xs, device):
        if isinstance(device, (list, tuple)):
            calls.append(len(xs))
        return real(xs, device)

    monkeypatch.setattr(collectives, "psum", counted)
    return calls


# ---------------------------------------------------------------------------
# The reference's FSDP step
# ---------------------------------------------------------------------------

def test_tp_fsdp_step_matches_the_references_unsharded_step(model_psums):
    """The reference's own state (qwen1.5-110b smoke, ``fsdp_params``, two
    microbatches, 8 x 64): two tensor-parallel steps on (2, 4), each model
    slot computing from its block, within 5e-3 of the reference's unsharded
    jitted steps (loss and every parameter)."""
    jcfg = j_get_smoke_config("qwen1.5-110b").replace(fsdp_params=True, accum_steps=2)
    cfg = get_smoke_config("qwen1.5-110b").replace(fsdp_params=True, accum_steps=2)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(1))
    tparams = transformer.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                            device="cpu", master=True)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(1, cfg.vocab_size, (8, 64)).astype(np.int32)
             for k in ("tokens", "labels")}
    step = jax.jit(j_make_train_step(j_get_model(jcfg).forward, jcfg, **KW))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    p, opt = jparams, j_init_optimizer(jparams)
    for _ in range(2):
        p, opt, jm = step(p, opt, jb)
    want = [np.asarray(x, np.float32) for x in jax.tree.leaves(p)]
    mesh = _mesh()
    placed, popt = place_train_state(tparams, init_optimizer(tparams), cfg, mesh)
    tstep = make_train_step(get_model(cfg).train_forward, cfg, **KW)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with use_mesh(mesh):
        for _ in range(2):
            placed, popt, m = tstep(placed, popt, tb)
    # the model slots' partial sums (the 2-way ones: the loss's weight over
    # the data slots)
    assert 4 in model_psums and set(model_psums) <= {2, 4}
    assert abs(float(m["loss"]) - float(jm["loss"])) < REF_TOL
    got = [_np(x) for x in tree_leaves(sharding.gather(placed))]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert float(np.abs(g - w).max()) < REF_TOL, i


# ---------------------------------------------------------------------------
# Forward and prefill per family against the reference
# ---------------------------------------------------------------------------

FAMILY_CASES = [("qwen3-4b", (2, 4)), ("mixtral-8x7b", (2, 4)), ("internvl2-26b", (2, 4)),
                ("mixtral-8x7b", (1, 8))]


def _family(arch, **kw):
    kw = dict(dtype="float32", n_layers=2, **kw)
    if arch.startswith("mixtral"):
        kw["capacity_factor"] = 4.0      # no pair drops: the groups do not change the output
    cfg = get_smoke_config(arch).replace(**kw)
    jcfg = j_get_smoke_config(arch).replace(**kw)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = transformer.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (2, 64)).astype(np.int32)
    pe = None
    if cfg.family == "vlm":
        pe = (rng.normal(size=(2, cfg.n_vis_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return cfg, jcfg, jparams, tparams, toks, pe


@pytest.fixture(scope="module")
def references():
    """Per family case: the reference's forward logits, prefill logits and
    caches on the same weights and tokens."""
    out = {}
    for arch, _ in FAMILY_CASES:
        if arch in out:
            continue
        cfg, jcfg, jparams, _, toks, pe = _family(arch)
        jpe = None if pe is None else jnp.asarray(pe)
        fwd = jax.jit(lambda p, t: jtransformer.forward(p, t, jcfg, prefix_embeds=jpe)[0])
        pre = jax.jit(lambda p, t: jtransformer.prefill(p, t, jcfg, prefix_embeds=jpe))
        logits, state = pre(jparams, jnp.asarray(toks))
        out[arch] = (np.asarray(fwd(jparams, jnp.asarray(toks))), np.asarray(logits),
                     np.asarray(state.caches.k), np.asarray(state.caches.v))
    return out


def _port_forward(arch, shape):
    cfg, _, _, tparams, toks, pe = _family(arch)
    api = get_model(cfg)
    batch = {"tokens": torch.from_numpy(toks)}
    if pe is not None:
        batch["patch_embeds"] = torch.from_numpy(pe)
    with use_mesh(_mesh(shape)):
        logits, _ = api.forward(tparams, batch, cfg)
        pl, state = transformer.prefill(tparams, batch["tokens"], cfg, batch.get("patch_embeds"))
    return cfg, logits, pl, state


@pytest.mark.parametrize("arch, shape", FAMILY_CASES,
                         ids=["dense-2x4", "moe-experts-2x4", "vlm-2x4", "moe-ff-1x8"])
def test_forward_and_prefill_match_the_reference(arch, shape, references, model_psums,
                                                 monkeypatch):
    """Dense (8 heads, 2 K/V heads on a 4-way axis: the K/V head_dim split),
    MoE (4 experts on 4 slots: the experts split; on 8: each expert's ff
    split), VLM: the tensor-parallel forward and prefill against the
    reference's forward and prefill on the same weights."""
    seen = []
    real = moe._grouped_dispatch
    monkeypatch.setattr(moe, "_grouped_dispatch", lambda p, flat, c, *e: seen.append(
        (tuple(p["wi"].shape), e[0] if e else None)) or real(p, flat, c, *e))
    cfg, logits, pl, state = _port_forward(arch, shape)
    want_fwd, want_pl, want_k, want_v = references[arch]
    assert shape[1] in model_psums
    assert float(np.abs(_np(logits) - want_fwd).max()) <= LOGIT_TOL
    assert float(np.abs(_np(pl) - want_pl).max()) <= LOGIT_TOL
    assert float(np.abs(_np(state.caches.k) - want_k).max()) <= CACHE_TOL
    assert float(np.abs(_np(state.caches.v) - want_v).max()) <= CACHE_TOL
    if cfg.family == "moe":
        E, f, M = cfg.n_experts, cfg.expert_d_ff, shape[1]
        split = sharding.model_split_dim(["layers", "moe", "wi"], (2, E, cfg.d_model, f), M)
        if split == 1:                    # each slot its block of experts
            want = {((E // M, cfg.d_model, f), m * (E // M)) for m in range(M)}
        else:                             # each slot every expert on its ff columns
            assert split == 3
            want = {((E, cfg.d_model, f // M), None)}
        assert set(seen) == want


def test_a_model_psum_that_drops_a_slot_breaks_the_forward(references, monkeypatch):
    real = collectives.psum
    monkeypatch.setattr(collectives, "psum", lambda xs, device: real(
        xs[:-1] if isinstance(device, (list, tuple)) else xs, device))
    _, logits, _, _ = _port_forward("qwen3-4b", (2, 4))
    assert float(np.abs(_np(logits) - references["qwen3-4b"][0]).max()) > 1e-2


def test_an_embedding_split_over_d_model_and_a_vocabulary_the_axis_does_not_divide():
    """A 509-row vocabulary on a 4-way axis: the table splits over
    ``d_model`` (an all-gather) and the unembedding's partial logits are
    reduce-scattered over the positions; the forward equals one device's."""
    cfg = get_smoke_config("internvl2-26b").replace(dtype="float32", n_layers=1, vocab_size=509)
    api = get_model(cfg)
    params = api.init(2, "cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 509, (2, 48)).astype(np.int32)),
             "patch_embeds": torch.from_numpy(
                 (rng.normal(size=(2, cfg.n_vis_tokens, cfg.d_model)) * 0.02).astype(np.float32))}
    mesh = _mesh()
    specs = sharding.param_specs(params, cfg, mesh)
    assert specs["embed"]["tok"] == (None, "model") and specs["embed"]["unembed"] == ("model", None)
    want, _ = api.forward(params, batch, cfg)
    collectives.TRAFFIC.clear()
    with use_mesh(mesh):
        got, _ = api.forward(params, batch, cfg)
    assert "reduce_scatter" in collectives.TRAFFIC and "all_gather" in collectives.TRAFFIC
    assert float((got - want).abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# The vocabulary-split cross-entropy
# ---------------------------------------------------------------------------

def _ce_inputs():
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(2, 16, 512, generator=g) * 3
    labels = torch.randint(0, 512, (2, 16), generator=g)
    weights = (torch.rand(2, 16, generator=g) > 0.3).float()
    return logits, labels, weights


@pytest.mark.parametrize("kind", ["vocab", "seq"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_split_cross_entropy_equals_the_gathered_one(kind, masked):
    logits, labels, weights = _ce_inputs()
    w = weights if masked else None
    devs = ["cpu"] * 4
    lg = layers.SlotLogits(kind, list(torch.chunk(logits, 4, dim=-1 if kind == "vocab" else 1)))
    got = _nll_sums_row(lg, labels, w, devs)
    want = _nll_sums(logits, labels, w)[0]
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def test_a_vocabulary_offset_one_row_off_breaks_the_cross_entropy(monkeypatch):
    logits, labels, weights = _ce_inputs()
    monkeypatch.setattr(layers, "vocab_offset", lambda m, block: m * block + 1)
    lg = layers.SlotLogits("vocab", list(torch.chunk(logits, 4, dim=-1)))
    got = _nll_sums_row(lg, labels, weights, ["cpu"] * 4)
    want = _nll_sums(logits, labels, weights)[0]
    assert abs(float(got) - float(want)) > 1.0


# ---------------------------------------------------------------------------
# The train step: no whole weight, replicated leaves summed once per slot
# ---------------------------------------------------------------------------

def _float32_state(fsdp=True, **kw):
    cfg = get_smoke_config("qwen3-4b").replace(dtype="float32", n_layers=2, fsdp_params=fsdp,
                                               accum_steps=2, **kw)
    params = get_model(cfg).init(5, "cpu", master=True)
    g = torch.Generator().manual_seed(6)
    batch = {k: torch.randint(1, cfg.vocab_size, (4, 32), generator=g)
             for k in ("tokens", "labels")}
    return cfg, params, batch


def _mesh_vs_one_device(cfg, params, batch):
    """(the mesh step's metrics, the unsharded step's, each leaf's first
    moment relative error and parameter error)."""
    mesh = _mesh()
    placed, popt = place_train_state(params, init_optimizer(params), cfg, mesh)
    step = make_train_step(get_model(cfg).train_forward, cfg, **KW)
    with use_mesh(mesh):
        placed, popt, m = step(placed, popt, batch)
    p1, o1, m1 = step(params, init_optimizer(params), batch)
    leaves = []
    for st, a, b, x, y in zip(tree_leaves(placed), tree_leaves(sharding.gather(popt.m)),
                              tree_leaves(o1.m), tree_leaves(sharding.gather(placed)),
                              tree_leaves(p1)):
        leaves.append((sharding.model_dim(st.spec) is None,
                       float((a - b).norm() / b.norm().clamp(min=1e-30)),
                       float((x - y).abs().max())))
    return m, m1, leaves


def test_tp_step_matches_the_unsharded_step_in_float32():
    cfg, params, batch = _float32_state()
    m, m1, leaves = _mesh_vs_one_device(cfg, params, batch)
    assert abs(float(m["loss"]) - float(m1["loss"])) <= SELF["loss_rel"] * float(m1["loss"])
    assert abs(float(m["grad_norm"]) - float(m1["grad_norm"])) <= \
        SELF["grad_norm_rel"] * float(m1["grad_norm"])
    assert any(rep for rep, _, _ in leaves) and not all(rep for rep, _, _ in leaves)
    assert max(r for _, r, _ in leaves) <= SELF["moment_rel"]
    assert max(e for _, _, e in leaves) <= SELF["param"]


def test_a_replicated_leafs_gradient_taken_m_times_breaks_the_step(monkeypatch):
    real = sharding.reduce_to_placement

    def planted(grads, like, into=None):
        if sharding.model_dim(like.spec) is None:
            grads = [[row[0]] * len(row) for row in grads]
        return real(grads, like, into)

    monkeypatch.setattr(sharding, "reduce_to_placement", planted)
    cfg, params, batch = _float32_state()
    _, _, leaves = _mesh_vs_one_device(cfg, params, batch)
    assert max(r for rep, r, _ in leaves if rep) > 0.1


def test_no_slot_makes_or_reads_a_whole_split_weight():
    """A (2, 4) step on placed state makes no tensor of a split leaf's whole
    shape (nor of one layer of it), and a forward from the whole tree reads
    at most one model slot's block of each split leaf
    (``chip_smoke.param_guard``)."""
    import pathlib
    import sys

    from torch.utils._python_dispatch import TorchDispatchMode

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    # 16 query heads of 8 on 2 K/V heads: no slot's block of one leaf has
    # another leaf's whole shape (with 8 heads a slot's wq is wk's shape)
    cfg, params, batch = _float32_state(fsdp=True, n_heads=16)
    mesh = _mesh()
    whole = set()

    def note(sp, x):
        if sharding.model_dim(sp) is not None:
            whole.update({tuple(x.shape), tuple(x.shape[1:])} if x.dim() > 2 else
                         {tuple(x.shape)})
    sharding._map2(note, sharding.param_specs(params, cfg, mesh), params)
    made = []

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (list, tuple)) else [out]):
                if isinstance(t, torch.Tensor) and tuple(t.shape) in whole:
                    made.append((func.overloadpacket.__name__, tuple(t.shape)))
            return out

    placed, popt = place_train_state(params, init_optimizer(params), cfg, mesh)
    step = make_train_step(get_model(cfg).train_forward, cfg, **KW)
    with use_mesh(mesh), Shapes():
        step(placed, popt, batch)
    assert made == []
    fcfg = cfg.replace(fsdp_params=False)
    fparams = get_model(fcfg).init(5, "cpu")
    with chip_smoke.param_guard(torch, fparams, fcfg, mesh) as guard, use_mesh(mesh):
        get_model(fcfg).forward(fparams, {"tokens": batch["tokens"]}, fcfg)
    assert guard["over_block"] == [] and guard["whole_made"] == []
    tok = fparams["embed"]["tok"]
    assert 0 < guard["max_read"] <= tok.numel() // 4


# ---------------------------------------------------------------------------
# The dry run's symmetric data-slot shortcut
# ---------------------------------------------------------------------------

SHORTCUT_CASES = [("qwen3-4b", ShapeSpec("train_32_b4", "train", 32, 4), {}),
                  ("qwen3-4b", ShapeSpec("prefill_32_b4", "prefill", 32, 4), {}),
                  ("mixtral-8x7b", ShapeSpec("train_32_b4", "train", 32, 4),
                   {"fsdp_params": True, "accum_steps": 2}),
                  ("internvl2-26b", ShapeSpec("prefill_32_b4", "prefill", 32, 4), {})]


@pytest.mark.parametrize("arch, shape, overrides", SHORTCUT_CASES,
                         ids=["dense-train", "dense-prefill", "moe-fsdp-train", "vlm-prefill"])
def test_symmetric_shortcut_equals_the_full_simulation(arch, shape, overrides):
    """Data slot 0's model slots alone, counted once per data slot, give
    the whole (2, 4) step's flops, bytes by kind, collectives and launches."""
    kw = dict(shape=shape, mesh=((2, 4), ("data", "model")), smoke=True, overrides=overrides,
              detail=False)
    short = dryrun.run_cell(arch, shape.name, symmetric=True, **kw)
    full = dryrun.run_cell(arch, shape.name, symmetric=False, **kw)
    assert short["symmetric_data_slots"] and not full["symmetric_data_slots"]
    keys = ("dot_flops", "bytes_accessed", "bytes_by_kind", "collectives", "collective_counts",
            "launches")
    assert {k: short["hlo"][k] for k in keys} == {k: full["hlo"][k] for k in keys}
    assert short["hlo"]["computing_devices"] == full["hlo"]["computing_devices"] == 8
    assert short["memory"]["simulated_slots"] == 4 and full["memory"]["simulated_slots"] == 8


def test_bf16_first_moments_move_a_percent_from_one_split_contraction_alone():
    """Why chip_smoke gates the mesh step's first moments on a float32 pair:
    on one device, in bf16, computing only the MLP's down projection as two
    halves summed in float32 (one rounding, as the model slots' all-reduce
    does) moves this model's first moments by over 0.5 % of their norm
    (1.13 % here), a reordering tensor parallelism cannot avoid."""
    import copy

    import torch.nn.functional as F

    cfg = get_smoke_config("qwen3-4b").replace(n_layers=2, accum_steps=2, d_model=256, d_ff=512,
                                               n_heads=8, n_kv_heads=2)
    api = get_model(cfg)
    params = api.init(23, "cpu", master=True)
    g = torch.Generator().manual_seed(23)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 256), generator=g)
             for k in ("tokens", "labels")}
    step = make_train_step(api.train_forward, cfg, base_lr=1e-3, warmup=0)

    def halves(p, x, c):
        dt = x.dtype
        parts = [(F.silu(x @ p["wg"][:, s].to(dt)) * (x @ p["wi"][:, s].to(dt))) @ p["wo"][s].to(dt)
                 for s in (slice(0, 256), slice(256, 512))]
        return (parts[0].float() + parts[1].float()).to(dt)

    _, o1, _ = step(copy.deepcopy(params), init_optimizer(params), batch)
    real = transformer.mlp
    try:
        transformer.mlp = halves
        _, o2, _ = step(copy.deepcopy(params), init_optimizer(params), batch)
    finally:
        transformer.mlp = real
    diff = sum(float(((a - b).double() ** 2).sum()) for a, b in zip(tree_leaves(o2.m),
                                                                   tree_leaves(o1.m)))
    norm = sum(float((b.double() ** 2).sum()) for b in tree_leaves(o1.m))
    assert (diff / norm) ** 0.5 > 5e-3
