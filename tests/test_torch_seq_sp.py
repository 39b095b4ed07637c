"""Sequence parallelism at the transformer families' block edges
(``repro_torch.models.transformer``: between blocks each model slot holds
its block of the positions, where the model axis divides them; each half
normalizes the block, all-gathers the normalized rows over the model slots
and reduce-scatters its row-parallel partial sums), on meshes of CPU slots.

Checks: (d) the sequence-parallel forward's logits equal the replicated
form's bit for bit (the selector ``transformer.seq_parallel`` patched off),
dense, MoE (experts split, each expert's ff split), VLM, and where the heads
do not divide the model axis; every block's output is the slot's block of
the positions; a sequence the axis does not divide keeps the replicated
form; ``collectives.reduce_scatter`` rounds once from float32 as ``psum``
does.  (e) The sequence-parallel train step within
``tests/test_torch_fsdp.py``'s bounds of the port's unsharded step and
within 5e-3 of the reference's unsharded jitted step; the grid pipeline at
(4, 1, 2) within 1e-5 of the reference's pipeline under GSPMD (float32, loss
and every gradient leaf of its scale) and of its own replicated form.
"""

from __future__ import annotations

import copy
import os
import pathlib
import subprocess
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
from repro_torch.launch import collectives
from repro_torch.launch.mesh import make_mesh, use_mesh
from repro_torch.models import get_model, sharding, transformer
from repro_torch.models.train import init_optimizer, make_train_step, place_train_state
from repro_torch.optim.tree import tree_leaves
from repro_torch.pipeline import runtime

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_TOL = 5e-3
SELF = {"loss_rel": 1e-6, "grad_norm_rel": 1e-6, "moment_rel": 1e-5, "param": 1e-4}
KW = dict(base_lr=1e-3, warmup=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape=(2, 4)):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * int(np.prod(shape)))


@pytest.fixture
def replicated(monkeypatch):
    """The replicated form at any sequence length: every model slot holds
    the data slot's rows whole between blocks."""
    def off():
        for mod in (transformer, runtime):
            monkeypatch.setattr(mod, "seq_parallel", lambda cfg, msize, seq: False)
    return off


def _forward(arch, shape, S=64, **kw):
    cfg = get_smoke_config(arch).replace(n_layers=2, **kw)
    api = get_model(cfg)
    params = api.init(2, "cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(
            (rng.normal(size=(2, cfg.n_vis_tokens, cfg.d_model)) * 0.02).astype(np.float32))
    collectives.TRAFFIC.clear()
    chosen, select = [], transformer.seq_parallel
    transformer.seq_parallel = lambda *a: chosen.append(select(*a)) or chosen[-1]
    try:
        with use_mesh(_mesh(shape)):
            return api.forward(params, batch, cfg)[0], dict(collectives.TRAFFIC), chosen
    finally:
        transformer.seq_parallel = select


CASES = [("qwen3-4b", (2, 4), 64), ("mixtral-8x7b", (2, 4), 64), ("mixtral-8x7b", (1, 8), 64),
         ("internvl2-26b", (2, 4), 64), ("qwen3-4b", (2, 3), 48)]


@pytest.mark.parametrize("arch, shape, S", CASES,
                         ids=["dense-2x4", "moe-experts-2x4", "moe-ff-1x8", "vlm-2x4",
                              "heads-do-not-divide-2x3"])
def test_sequence_parallel_logits_equal_the_replicated_forms(arch, shape, S, replicated):
    got, traffic, chosen = _forward(arch, shape, S)
    assert chosen == [True]
    replicated()
    want, plain, chosen = _forward(arch, shape, S)
    assert chosen == [False] and traffic != plain
    assert torch.equal(got, want)


def test_each_blocks_output_is_the_slots_block_of_the_positions(monkeypatch):
    seen = []
    real = transformer._grid_block

    def rec(*a, **kw):
        out = real(*a, **kw)
        seen.append((kw.get("sp", a[8] if len(a) > 8 else False),
                     [[tuple(x.shape) for x in row] for row in out[0]]))
        return out

    monkeypatch.setattr(transformer, "_grid_block", rec)
    _forward("qwen3-4b", (2, 4), 64)
    assert len(seen) == 2 and all(sp for sp, _ in seen)
    assert all(shapes == [[(1, 16, 128)] * 4] * 2 for _, shapes in seen)


def test_a_sequence_the_model_axis_does_not_divide_stays_replicated(monkeypatch):
    _, traffic, chosen = _forward("qwen3-4b", (2, 4), 30)
    assert chosen == [False] and "reduce_scatter" not in traffic
    assert not transformer.seq_parallel(get_smoke_config("qwen3-4b"), 4, 30)
    assert transformer.seq_parallel(get_smoke_config("qwen3-4b"), 4, 32)


def test_reduce_scatter_rounds_once_as_psum_does():
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(2, 8, 16, generator=g).to(torch.bfloat16) for _ in range(4)]
    devs = ["cpu"] * 4
    whole = collectives.psum(xs, devs)[0]
    parts = collectives.reduce_scatter(xs, 1, devs)
    assert torch.equal(torch.cat(parts, 1), whole)
    # its gradient joins the parts' gradients; the all-gather's sums them as psum does
    ys = [x.float().requires_grad_(True) for x in xs]
    out = collectives.reduce_scatter(ys, 1, devs)
    torch.autograd.grad(sum((o * (i + 1)).sum() for i, o in enumerate(out)), ys)
    blocks = [torch.randn(2, 2, 16, generator=g).requires_grad_(True) for _ in range(4)]
    gathered = collectives.all_gather(blocks, 1, devs, grad32=True)
    assert all(torch.equal(t, torch.cat(blocks, 1)) for t in gathered)
    assert len({id(t) for t in gathered}) == 4          # each receiver its own copy
    grads = torch.autograd.grad(sum((t * (i + 1)).sum() for i, t in enumerate(gathered)), blocks)
    assert all(torch.equal(gr, torch.full_like(gr, 10.0)) for gr in grads)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _float32_state(**kw):
    cfg = get_smoke_config("qwen3-4b").replace(dtype="float32", n_layers=2, accum_steps=2, **kw)
    params = get_model(cfg).init(5, "cpu", master=True)
    g = torch.Generator().manual_seed(6)
    batch = {k: torch.randint(1, cfg.vocab_size, (4, 32), generator=g)
             for k in ("tokens", "labels")}
    return cfg, params, batch


@pytest.mark.parametrize("fsdp", [False, True], ids=["data-parallel", "zero1"])
def test_sequence_parallel_step_matches_the_unsharded_step(fsdp):
    cfg, params, batch = _float32_state(fsdp_params=fsdp)
    step = make_train_step(get_model(cfg).train_forward, cfg, **KW)
    p1 = copy.deepcopy(params)
    p1, o1, m1 = step(p1, init_optimizer(p1), batch)
    mesh = _mesh()
    placed, popt = place_train_state(params, init_optimizer(params), cfg, mesh)
    collectives.TRAFFIC.clear()
    with use_mesh(mesh):
        placed, popt, m = step(placed, popt, batch)
    assert collectives.TRAFFIC["reduce_scatter"][0] > 0
    assert abs(float(m["loss"]) - float(m1["loss"])) <= SELF["loss_rel"] * abs(float(m1["loss"]))
    assert abs(float(m["grad_norm"]) - float(m1["grad_norm"])) \
        <= SELF["grad_norm_rel"] * float(m1["grad_norm"])
    for g, w in zip(tree_leaves(sharding.gather(placed)), tree_leaves(p1)):
        assert float((g - w).abs().max()) <= SELF["param"]
    for g, w in zip(tree_leaves(sharding.gather(popt.m)), tree_leaves(o1.m)):
        assert float((g - w).abs().max()) <= SELF["moment_rel"] * max(float(w.abs().max()), 1e-30)


def test_sequence_parallel_step_matches_the_references_unsharded_step():
    """qwen3-4b smoke at its bf16 compute, 8 x 64 over (2, 4) (16 positions
    a model slot), two steps against the reference's unsharded jitted steps:
    loss and every parameter within 5e-3."""
    jcfg = j_get_smoke_config("qwen3-4b").replace(accum_steps=2)
    cfg = get_smoke_config("qwen3-4b").replace(accum_steps=2)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(1))
    tparams = transformer.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                            device="cpu", master=True)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(1, cfg.vocab_size, (8, 64)).astype(np.int32)
             for k in ("tokens", "labels")}
    step = jax.jit(j_make_train_step(j_get_model(jcfg).forward, jcfg, **KW))
    p, opt = jparams, j_init_optimizer(jparams)
    for _ in range(2):
        p, opt, jm = step(p, opt, {k: jnp.asarray(v) for k, v in batch.items()})
    mesh = _mesh()
    placed, popt = place_train_state(tparams, init_optimizer(tparams), cfg, mesh)
    tstep = make_train_step(get_model(cfg).train_forward, cfg, **KW)
    collectives.TRAFFIC.clear()
    with use_mesh(mesh):
        for _ in range(2):
            placed, popt, m = tstep(placed, popt, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()})
    assert collectives.TRAFFIC["reduce_scatter"][0] > 0
    assert abs(float(m["loss"]) - float(jm["loss"])) < REF_TOL
    got = [x.float().numpy() for x in tree_leaves(sharding.gather(placed))]
    want = [np.asarray(x, np.float32) for x in jax.tree.leaves(p)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert float(np.abs(g - w).max()) < REF_TOL, i


def test_grid_pipeline_at_4x1x2_matches_the_reference_and_its_replicated_form(tmp_path,
                                                                              replicated):
    """``tests/test_torch_pipeline_grid.py``'s float32 check at (4, 1, 2)
    (the reference's pipeline under GSPMD in a child on 8 forced host
    devices), its pods' blocks sequence-parallel over the 2 model slots;
    then the same pipeline with the selector off."""
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_pipeline_grid as pg

    shape = (4, 1, 2)
    path = tmp_path / "ref.npz"
    child = pg._CHILD.replace(repr(pg.REF_MESHES), repr((shape,)))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", child, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = dict(np.load(path))
    cfg, params, pl, pipe, mask, batch = pg._setup(ref, "float32")
    mesh = pg._mesh(shape)

    def loss_and_grads():
        placed = dict(pipe, stages=pg._placed(params, pl, mesh, cfg))
        collectives.TRAFFIC.clear()
        out = pg._loss_and_grads(pg.pipelined_loss_fn(cfg, pl, pg.M, mask, mesh=mesh), placed,
                                 batch)
        return out, "reduce_scatter" in collectives.TRAFFIC

    got, sp = loss_and_grads()
    assert sp
    pg._close(got, (float(ref["4x1x2/float32/loss"]),
                    pg._flat(pg._tree(ref, "4x1x2/float32/grad"))))
    replicated()
    want, sp = loss_and_grads()
    assert not sp
    pg._close(got, want)
