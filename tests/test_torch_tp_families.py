"""Tensor parallelism over the mesh's ``model`` axis for the hybrid, enc-dec
and xLSTM families (``repro_torch.models``: ``ssm.mamba2_row``, the
hybrid's, enc-dec model's and xLSTM's grid forwards, ``xlstm.mlstm_row`` /
``slstm_row``, ``attention.attention_row``'s cross and bidirectional forms,
the registry's per-slot extras) against the JAX reference and the port's own
one-device forms, on meshes of CPU slots at the smoke configs.

The meshes cover the layouts ``param_specs`` gives these leaves: zamba2-smoke
(8 SSM heads, 4 attention heads) on (2, 4) splits everything, on (1, 8) the
attention's head_dim (model slot 0 runs it whole) while each slot owns one
SSM head, on (2, 3) only ``in_proj`` / ``conv_w`` (the SSM heads do not
divide: slot 0 runs the mixer whole); whisper-smoke splits the heads on
(2, 4) and (2, 2), the head_dim on (1, 8), nothing on (2, 3); xlstm-smoke
holds one mLSTM head a slot on (2, 4), half a head on (1, 8) (q and k
all-gathered per head), nothing on (2, 3).

Bounds: the smoke forwards' float32 logits within 1e-4 of the reference's
(``tests/test_torch_families.py``); the reference's FSDP check
(``tests/test_distributed_numerics.py``: loss and every parameter within
5e-3 of its unsharded step); the float32 mesh step within
``tests/test_torch_fsdp.py``'s bounds of the port's unsharded one.  Planted
faults (the gated RMSNorm over a slot's own columns, B and C from the wrong
slot's block, an ``out_proj`` sum that drops a slot, an mLSTM head's k
gathered from the wrong slots, the sLSTM's ``r`` re-laid to the wrong head)
each break the forward.
"""

from __future__ import annotations

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import get_model as j_get_model
from repro.models.train import init_optimizer as j_init_optimizer
from repro.models.train import make_train_step as j_make_train_step

from repro_torch.configs import get_smoke_config
from repro_torch.launch import collectives, dryrun
from repro_torch.launch.mesh import make_mesh, use_mesh
from repro_torch.models import encdec, get_model, hybrid, sharding, ssm, xlstm
from repro_torch.models.common import ShapeSpec
from repro_torch.models.train import init_optimizer, make_train_step, place_train_state
from repro_torch.optim.tree import tree_leaves

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

REF_TOL, LOGIT_TOL = 5e-3, 1e-4
SELF = {"loss_rel": 1e-6, "grad_norm_rel": 1e-6, "moment_rel": 1e-5, "param": 1e-4}
# The hybrid's float32 step carries more rounding than the transformer's
# that SELF was found on (on the states tried here, one row a data slot):
# the port's own unsharded step parts from the reference's by up to 1.25e-5
# of a leaf's largest first moment (mamba_groups/D: its gradient sums every
# token's SSD skip term, which cancel), and the (2, 4) step from the
# unsharded one by 1.5e-5 (the model slots' partial sums, the SSD's and the
# gated norm's reductions in another order), its grad norm by 6e-7 to
# 1.3e-6 of itself, its parameters by 1.7e-4 (AdamW's normalized first step
# moves a weight whose gradient rounds near 0 by up to the learning rate,
# 1e-3).  One layer's gradients agree within 2e-6 of their largest
# (test_one_layer_per_slot_matches_one_device), and a wrong sum moves a
# moment or a weight by O(1) of its largest.
STEP_SELF = {"hybrid": dict(SELF, grad_norm_rel=5e-6, moment_rel=3e-5, param=5e-4),
             "encdec": SELF, "xlstm": SELF}
KW = dict(base_lr=1e-3, warmup=0, total_steps=10)     # the first step moves the weights
MODULE = {"hybrid": hybrid, "encdec": encdec, "xlstm": xlstm}
ARCHS = ("zamba2-7b", "whisper-large-v3", "xlstm-350m")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other mesh test files use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * int(np.prod(shape)))


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _models(arch, master=False, **kw):
    kw = dict(dtype="float32", **kw)
    cfg = get_smoke_config(arch).replace(**kw)
    jcfg = j_get_smoke_config(arch).replace(**kw)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = MODULE[cfg.family].params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                                   device="cpu", master=master)
    return cfg, jcfg, jparams, tparams


def _batch(cfg, B, S, labels=False):
    """(reference batch, port batch) from numpy: tokens, the frames
    (``normal * 0.02``) of the enc-dec model, labels for a train step."""
    rng = np.random.default_rng(0)
    arrays = {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)}
    if labels:
        arrays["labels"] = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "encdec":
        arrays["frames"] = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model)) * 0.02).astype(
            np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


# xlstm-smoke runs S = 96: with B = 2 its products' (B S, d) = (192, 128)
# outputs are no weight's shape (at S = 64 the sLSTM's (d, d) = (128, 128)
# ``out`` would be, which the dispatch guard would count as a whole weight)
SEQ = {"zamba2-7b": 64, "whisper-large-v3": 64, "xlstm-350m": 96}


@pytest.fixture(scope="module")
def references():
    """Per family: the reference's forward logits on its own weights and the
    same tokens (and frames)."""
    out = {}
    for arch in ARCHS:
        cfg, jcfg, jparams, _ = _models(arch)
        jb, _ = _batch(cfg, 2, SEQ[arch])
        japi = j_get_model(jcfg)
        out[arch] = np.asarray(jax.jit(lambda p, b: japi.forward(p, b, jcfg)[0])(jparams, jb))
    return out


def _port_forward(arch, shape):
    cfg, _, _, tparams = _models(arch)
    _, tb = _batch(cfg, 2, SEQ[arch])
    with use_mesh(_mesh(shape)):
        logits, _ = get_model(cfg).forward(tparams, tb, cfg)
    return cfg, logits


FORWARD_CASES = [("zamba2-7b", (2, 4)), ("zamba2-7b", (1, 8)), ("zamba2-7b", (2, 3)),
                 ("whisper-large-v3", (2, 4)), ("whisper-large-v3", (1, 8)),
                 ("whisper-large-v3", (2, 3)), ("whisper-large-v3", (2, 2)),
                 ("xlstm-350m", (2, 4)), ("xlstm-350m", (1, 8)), ("xlstm-350m", (2, 3))]


def _layout(cfg, M) -> dict:
    """Which route each split layer takes on a model axis of ``M``."""
    named = chip_smoke._split_dims(cfg, M)
    out = {"attn_heads": M > 1 and cfg.n_heads % M == 0}
    if cfg.family == "hybrid":
        out["mixer_heads"] = ssm.heads_parallel(cfg, chip_smoke._sub_dims(named, "mamba_groups/",
                                                                          2), M)
        out["in_proj_split"] = named["mamba_groups/in_proj"] is not None
    if cfg.family == "xlstm":
        out["mlstm_cols"] = xlstm.mlstm_parallel(cfg, chip_smoke._sub_dims(named, "mlstm/", 2), M)
    return out


@pytest.mark.parametrize("arch, shape", FORWARD_CASES,
                         ids=[f"{a.split('-')[0]}-{s[0]}x{s[1]}" for a, s in FORWARD_CASES])
def test_forward_matches_the_reference(arch, shape, references):
    """Each family's tensor-parallel forward against the reference's forward
    on the same weights, in float32, on every layout above."""
    cfg, logits = _port_forward(arch, shape)
    M = shape[1]
    layout = _layout(cfg, M)
    if arch == "zamba2-7b":
        assert layout["mixer_heads"] == (M != 3) and layout["in_proj_split"]
        assert layout["attn_heads"] == (M in (2, 4))
    if arch == "xlstm-350m":
        assert layout["mlstm_cols"] == (M != 3)
    assert float(np.abs(_np(logits) - references[arch]).max()) <= LOGIT_TOL


# ---------------------------------------------------------------------------
# Planted faults
# ---------------------------------------------------------------------------

def _caller() -> str:
    return sys._getframe(2).f_code.co_name


def _plant_norm_own_columns(monkeypatch):
    """The gated RMSNorm over each slot's own columns: its sum of squares
    not all-reduced, scaled as if it were the whole d_in's."""
    real = collectives.psum

    def planted(xs, device):
        if _caller() == "_gated_norm_row":
            return [x * len(xs) for x in xs]
        return real(xs, device)
    monkeypatch.setattr(collectives, "psum", planted)


def _plant_bc_wrong_slot(monkeypatch):
    """B and C read from the previous slot's block of ``in_proj``'s output."""
    real = ssm.in_proj_spans

    def planted(cfg, msize, m):
        spans = real(cfg, msize, m)
        d_in, H, P, N = ssm.ssm_dims(cfg)
        width = (2 * d_in + 2 * N + H) // msize
        lo, hi = spans[2]
        spans[2] = (lo - width, hi - width)
        return spans
    monkeypatch.setattr(ssm, "in_proj_spans", planted)


def _plant_out_proj_drops_a_slot(monkeypatch):
    real = collectives.psum

    def planted(xs, device):
        return real(xs[:-1] if _caller() == "mamba2_row" else xs, device)
    monkeypatch.setattr(collectives, "psum", planted)


def _plant_k_wrong_slots(monkeypatch):
    """Each mLSTM layer's second head gather (k) takes its columns from the
    next slots' blocks."""
    real, seen = xlstm._head_cols, []

    def planted(qs, group, devs):
        seen.append(1)
        if len(seen) % 2 == 0:
            qs = qs[1:] + qs[:1]
        return real(qs, group, devs)
    monkeypatch.setattr(xlstm, "_head_cols", planted)


def _plant_r_wrong_head(monkeypatch):
    real = xlstm.whole_r
    monkeypatch.setattr(xlstm, "whole_r",
                        lambda leaves, dim, device: torch.roll(real(leaves, dim, device), 1, 0))


PLANTS = [(_plant_norm_own_columns, "zamba2-7b", (2, 4)),
          (_plant_bc_wrong_slot, "zamba2-7b", (2, 4)),
          (_plant_out_proj_drops_a_slot, "zamba2-7b", (1, 8)),
          (_plant_k_wrong_slots, "xlstm-350m", (1, 8)),
          (_plant_r_wrong_head, "xlstm-350m", (2, 4))]


@pytest.mark.parametrize("plant, arch, shape", PLANTS,
                         ids=["gated-norm-own-columns", "bc-wrong-slot", "out-proj-drops-a-slot",
                              "mlstm-k-wrong-slots", "slstm-r-wrong-head"])
def test_a_planted_fault_breaks_the_forward(plant, arch, shape, references, monkeypatch):
    plant(monkeypatch)
    _, logits = _port_forward(arch, shape)
    assert float(np.abs(_np(logits) - references[arch]).max()) > 1e-2


# ---------------------------------------------------------------------------
# One layer per slot, and the train step
# ---------------------------------------------------------------------------

def _layer_case(kind):
    """(the layer's one-device function, its per-slot function, its weights
    for one layer (the smoke init plus noise, so no weight sits at its init
    value), the split dims of one layer, the config, the model slots)."""
    g = torch.Generator().manual_seed(1)
    if kind == "mamba2":
        cfg, M, key = get_smoke_config("zamba2-7b"), 4, "mamba_groups"
        p, fwd, row = ssm.init_mamba2(g, cfg.replace(dtype="float32")), ssm.mamba2_forward, \
            ssm.mamba2_row
    else:
        cfg, M, key = get_smoke_config("xlstm-350m"), 8, kind
        init = xlstm.init_mlstm if kind == "mlstm" else xlstm.init_slstm
        p = init(g, cfg.replace(dtype="float32"))
        fwd, row = (xlstm.mlstm_forward, xlstm.mlstm_row) if kind == "mlstm" else \
            (xlstm.slstm_forward, xlstm.slstm_row)
    cfg = cfg.replace(dtype="float32")

    def noisy(x):
        return {k: noisy(v) for k, v in x.items()} if isinstance(x, dict) else \
            x + 0.1 * torch.randn(x.shape, generator=g)
    lead = {"mamba_groups": 2, "mlstm": 2, "slstm": 1}[key]
    dims = {}
    sharding._map_with_path(lambda pth, x: dims.__setitem__(pth, sharding.model_split_dim(
        [key, *pth], (1,) * lead + tuple(x.shape), M)), p)
    dims = sharding._map_with_path(lambda pth, x: None if dims[pth] is None
                                   else dims[pth] - lead, p)
    return fwd, row, noisy(p), dims, cfg, M


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_one_layer_per_slot_matches_one_device(kind):
    """One Mamba2 layer on 4 model slots (2 SSM heads a slot, ``in_proj``'s
    blocks across its z | x B C | dt boundaries), one mLSTM layer on 8 (half
    a head a slot), one sLSTM layer on 8, in float32: the output, the
    input's gradient and every weight's gradient within 2e-6 of their
    largest value of the layer's one-device form."""
    fwd, row, p, dims, cfg, M = _layer_case(kind)
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator().manual_seed(2))
    w = torch.randn(2, 64, cfg.d_model, generator=torch.Generator().manual_seed(3))

    def run(split):
        leaves = sharding._map_with_path(lambda _, v: v.clone().requires_grad_(True), p)
        xx = x.clone().requires_grad_(True)
        if split:
            ps = [sharding._map_with_path(lambda pth, v: v if _at(dims, pth) is None else
                                          torch.chunk(v, M, _at(dims, pth))[m], leaves)
                  for m in range(M)]
            y = row(ps, dims, [xx] * M, cfg, ["cpu"] * M)[0]
        else:
            y = fwd(leaves, xx, cfg)
        (y * w).sum().backward()
        grads = []
        sharding._map_with_path(lambda _, v: grads.append(v.grad), leaves)
        return [y.detach(), xx.grad] + grads

    for a, b in zip(run(True), run(False)):
        assert float((a - b).abs().max()) <= 2e-6 * float(b.abs().max())


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# depth cut for the reference's compile: one encoder and one decoder block,
# one xLSTM group; the hybrid whole (its 5 layers: three groups, the last
# padded), the state :data:`STEP_SELF` was measured on
TRAIN_CUT = {"zamba2-7b": {}, "whisper-large-v3": {"n_layers": 1, "n_enc_layers": 1},
             "xlstm-350m": {"n_layers": 2}}


@pytest.mark.parametrize("arch", ARCHS, ids=["hybrid", "encdec", "xlstm"])
def test_train_step_matches_the_reference_and_the_unsharded_step(arch):
    """One step on (2, 4) from state placed by ``zero1_specs``, one row a
    data slot, each model slot computing from its block: loss and every
    parameter within 5e-3 of the reference's unsharded jitted step; in
    float32 within :data:`SELF` of the port's unsharded step (the hybrid
    within :data:`STEP_SELF`'s)."""
    cfg, jcfg, jparams, tparams = _models(arch, master=True, fsdp_params=True, **TRAIN_CUT[arch])
    jb, tb = _batch(cfg, 2, 32, labels=True)
    step = jax.jit(j_make_train_step(j_get_model(jcfg).forward, jcfg, **KW))
    jp, _, jm = step(jparams, j_init_optimizer(jparams), jb)
    want = [np.asarray(x, np.float32) for x in jax.tree.leaves(jp)]
    mesh = _mesh((2, 4))
    placed, popt = place_train_state(tparams, init_optimizer(tparams), cfg, mesh)
    tstep = make_train_step(get_model(cfg).train_forward, cfg, **KW)
    with use_mesh(mesh):
        placed, popt, m = tstep(placed, popt, tb)
    assert abs(float(m["loss"]) - float(jm["loss"])) < REF_TOL
    got = [_np(x) for x in tree_leaves(sharding.gather(placed))]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert float(np.abs(g - w).max()) < REF_TOL, i
    p1, o1, m1 = tstep(tparams, init_optimizer(tparams), tb)
    bound = STEP_SELF[cfg.family]
    assert abs(float(m["loss"]) - float(m1["loss"])) <= bound["loss_rel"] * abs(float(m1["loss"]))
    assert abs(float(m["grad_norm"]) - float(m1["grad_norm"])) <= \
        bound["grad_norm_rel"] * float(m1["grad_norm"])
    for a, b in zip(tree_leaves(sharding.gather(popt.m)), tree_leaves(o1.m)):
        assert float((a - b).abs().max()) <= bound["moment_rel"] * float(b.abs().max())
    for g, u in zip(tree_leaves(sharding.gather(placed)), tree_leaves(p1)):
        assert float((g - u).abs().max()) <= bound["param"]


# ---------------------------------------------------------------------------
# The dispatch guard
# ---------------------------------------------------------------------------

GUARD_CASES = [("zamba2-7b", (2, 4)), ("whisper-large-v3", (1, 8)), ("xlstm-350m", (1, 8))]


@pytest.mark.parametrize("arch, shape", GUARD_CASES, ids=["hybrid", "encdec", "xlstm"])
def test_no_op_reads_more_than_a_slots_block_outside_the_exceptions(arch, shape):
    """A forward from the whole tree reads at most one model slot's block of
    each split leaf and makes no whole one, but for the listed exceptions
    (``chip_smoke.family_tp_exceptions``: whisper's attention whole on slot
    0 where its heads do not divide the axis, the sLSTM's ``r``)."""
    cfg = get_smoke_config(arch).replace(dtype="float32")
    api = get_model(cfg)
    params = api.init(5, "cpu")
    _, tb = _batch(cfg, 2, SEQ[arch])
    mesh = _mesh(shape)
    allowed = chip_smoke.family_tp_exceptions(cfg, shape[1])
    assert allowed == {"zamba2-7b": (), "xlstm-350m": ("slstm/r",),
                       "whisper-large-v3": ("enc/attn/", "dec/self_attn/",
                                            "dec/cross_attn/")}[arch]
    with chip_smoke.param_guard(torch, params, cfg, mesh, allowed) as guard, use_mesh(mesh):
        api.forward(params, tb, cfg)
    assert guard["over_block"] == [] and guard["whole_made"] == []
    with chip_smoke.param_guard(torch, params, cfg, mesh) as strict, use_mesh(mesh):
        api.forward(params, tb, cfg)
    assert (strict["whole_made"] == []) == (allowed == ())


def test_the_hybrid_step_makes_no_whole_split_weight():
    """A (2, 4) step of the hybrid on placed state makes no tensor of a
    split leaf's whole shape, nor of one layer of it (d_ff 384: at the smoke
    config's 256 the shared MLP's replicated ``wo`` has ``out_proj``'s
    shape, and its gradient would count as a whole ``out_proj``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = get_smoke_config("zamba2-7b").replace(dtype="float32", fsdp_params=True, d_ff=384)
    params = get_model(cfg).init(5, "cpu", master=True)
    mesh = _mesh((2, 4))
    whole = set()

    def note(path, sp, x):
        if sharding.model_dim(sp) is not None:
            lead = chip_smoke.STACKED_AXES.get(path, 0)
            whole.update(tuple(x.shape[i:]) for i in range(lead + 1))
    specs = sharding.param_specs(params, cfg, mesh)
    for key in params:
        sharding._map2(lambda sp, x, key=key: note(key, sp, x), specs[key], params[key])
    made = []

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (list, tuple)) else [out]):
                if isinstance(t, torch.Tensor) and tuple(t.shape) in whole:
                    made.append((func.overloadpacket.__name__, tuple(t.shape)))
            return out

    _, tb = _batch(cfg, 2, 32, labels=True)
    placed, popt = place_train_state(params, init_optimizer(params), cfg, mesh)
    step = make_train_step(get_model(cfg).train_forward, cfg, **KW)
    with use_mesh(mesh), Shapes():
        step(placed, popt, tb)
    assert made == []


# ---------------------------------------------------------------------------
# The dry run's symmetric data-slot shortcut
# ---------------------------------------------------------------------------

SHORTCUT_CASES = [("zamba2-7b", ShapeSpec("train_32_b4", "train", 32, 4)),
                  ("whisper-large-v3", ShapeSpec("prefill_32_b4", "prefill", 32, 4)),
                  ("xlstm-350m", ShapeSpec("train_32_b4", "train", 32, 4))]


@pytest.mark.parametrize("arch, shape", SHORTCUT_CASES,
                         ids=["hybrid-train", "encdec-prefill", "xlstm-train"])
def test_symmetric_shortcut_equals_the_full_simulation(arch, shape):
    """The cell runs over the mesh (``placement: "mesh"``), and data slot 0's
    model slots alone, counted once per data slot, give the whole (2, 4)
    step's flops, bytes by kind, collectives and launches."""
    kw = dict(shape=shape, mesh=((2, 4), ("data", "model")), smoke=True, overrides={},
              detail=False)
    short = dryrun.run_cell(arch, shape.name, symmetric=True, **kw)
    full = dryrun.run_cell(arch, shape.name, symmetric=False, **kw)
    assert short["placement"] == full["placement"] == "mesh"
    assert short["symmetric_data_slots"] and not full["symmetric_data_slots"]
    keys = ("dot_flops", "bytes_accessed", "bytes_by_kind", "collectives", "collective_counts",
            "launches")
    assert {k: short["hlo"][k] for k in keys} == {k: full["hlo"][k] for k in keys}
    assert short["hlo"]["computing_devices"] == full["hlo"]["computing_devices"] == 8
