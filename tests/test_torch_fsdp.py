"""The train step under a mesh (``repro_torch.models.train``: placed state,
each data slot's rows with the weights gathered at use, the global-mean
loss, gradients summed into the placement in float32, the global clip norm,
AdamW on each block) against the reference's unsharded jitted step, on a
(2, 4) mesh of CPU slots.

The reference's own check (``tests/test_distributed_numerics.py``): the
smoke qwen1.5-110b with ``fsdp_params=True, accum_steps=2``, a batch of 8 x
64, its FSDP step against its unsharded step, loss and every parameter
within 5e-3.  Here the port's mesh step is held to the reference's
unsharded step at that bound after one step (step 0 of a one-step warm-up:
learning rate 0, the reference test's case) and after two (the second at a
learning rate that moves the weights); and, in float32, to the port's own
unsharded step at the tighter bounds that the slots' summation order leaves
(:data:`SELF`).
"""

from __future__ import annotations

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
from repro_torch.launch.mesh import make_mesh, use_mesh
from repro_torch.models import get_model, moe, sharding, transformer
from repro_torch.models.train import init_optimizer, make_train_step, place_train_state
from repro_torch.optim.tree import tree_leaves

REF_TOL = 5e-3
# the port's mesh step against its own unsharded step in float32 (the same
# products on fewer rows, the gradients summed over the slots in another
# order; the loss a sum over the slots' tokens divided by their count, not
# a mean).  Found on these tests' states: the loss 2.1e-7 of itself apart
# (the VLM's), the grad norm equal, the first moment 1.9e-6 of its largest
# entry apart, the
# parameters 4.3e-5 apart (AdamW's normalized step turns a gradient's
# rounding near 0 into a move of up to the learning rate, 1e-3).  In the
# reference test's bf16 compute the parameters part by up to 2.0e-3 the
# same way, inside its 5e-3.
SELF = {"loss_rel": 1e-6, "grad_norm_rel": 1e-6, "moment_rel": 1e-5, "param": 1e-4}
KW = dict(base_lr=1e-3, warmup=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: the tier-1 run gives each
    of its workers a share of the cores, and these tests' many small
    products lose far more to oversubscribed threads than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape=(2, 4)):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * int(np.prod(shape)))


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _state(arch="qwen1.5-110b", **kw):
    jcfg = j_get_smoke_config(arch).replace(**kw)
    cfg = get_smoke_config(arch).replace(**kw)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(1))
    tparams = transformer.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                            device="cpu", master=True)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(1, cfg.vocab_size, (8, 64)).astype(np.int32)
             for k in ("tokens", "labels")}
    return cfg, jcfg, jparams, tparams, batch


def _steps(step, params, opt, batches):
    out = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        out.append({k: float(v) for k, v in m.items()})
    return params, opt, out


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's unsharded jitted step from its test's state, two
    steps: each step's parameters and metrics."""
    cfg, jcfg, jparams, _, batch = _state(fsdp_params=True, accum_steps=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(j_make_train_step(j_get_model(jcfg).forward, jcfg, **KW))
    p, opt, out = jparams, j_init_optimizer(jparams), []
    for _ in range(2):
        p, opt, m = step(p, opt, jb)
        out.append(([np.asarray(x, np.float32) for x in jax.tree.leaves(p)],
                    {k: float(v) for k, v in m.items()}))
    return out


@pytest.mark.parametrize("n", [1, 2], ids=["lr0", "moving"])
def test_fsdp_step_matches_the_references_unsharded_step(reference_runs, n):
    cfg, _, _, tparams, batch = _state(fsdp_params=True, accum_steps=2)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    mesh = _mesh()
    placed, popt = place_train_state(tparams, init_optimizer(tparams), cfg, mesh)
    step = make_train_step(get_model(cfg).train_forward, cfg, **KW)
    with use_mesh(mesh):
        placed, popt, ms = _steps(step, placed, popt, [tb] * n)
    want_p, want_m = reference_runs[n - 1]
    assert ms[-1]["lr"] == want_m["lr"] and (want_m["lr"] == 0.0) == (n == 1)
    got_p = [_np(x) for x in tree_leaves(sharding.gather(placed))]
    assert len(got_p) == len(want_p)
    assert abs(ms[-1]["loss"] - want_m["loss"]) < REF_TOL, (ms[-1], want_m)
    for i, (g, w) in enumerate(zip(got_p, want_p)):
        assert float(np.abs(g - w).max()) < REF_TOL, i
    moved = max(float(np.abs(g - _np(x)).max()) for g, x in zip(got_p, tree_leaves(tparams)))
    assert (moved > 1e-4) == (n == 2)                 # the weights move at step 2 only
    assert popt.step.item() == n
    # the moments stay in the placement
    assert all(isinstance(x, sharding.ShardedTensor) for x in tree_leaves(popt.m))


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "data-parallel"])
def test_mesh_step_matches_the_ports_unsharded_step_in_float32(fsdp):
    """Under ``fsdp_params`` the state is placed by ``zero1_specs``, else by
    ``param_specs`` (the weights replicated over 'data'); two steps equal
    the unsharded ones within :data:`SELF`."""
    cfg, _, _, tparams, batch = _state(fsdp_params=fsdp, accum_steps=2, dtype="float32")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    mesh = _mesh()
    placed, popt = place_train_state(tparams, init_optimizer(tparams), cfg, mesh)
    step = make_train_step(get_model(cfg).train_forward, cfg, **KW)
    with use_mesh(mesh):
        placed, popt, ms = _steps(step, placed, popt, [tb] * 2)
    p1, o1, ms1 = _steps(step, tparams, init_optimizer(tparams), [tb] * 2)
    for m, m1 in zip(ms, ms1):
        assert abs(m["loss"] - m1["loss"]) <= SELF["loss_rel"] * abs(m1["loss"]), (m, m1)
        assert abs(m["grad_norm"] - m1["grad_norm"]) <= SELF["grad_norm_rel"] * m1["grad_norm"]
    for a, b in zip(tree_leaves(sharding.gather(popt.m)), tree_leaves(o1.m)):
        assert float((a - b).abs().max()) <= SELF["moment_rel"] * float(b.abs().max())
    for g, u in zip(tree_leaves(sharding.gather(placed)), tree_leaves(p1)):
        assert float((g - u).abs().max()) <= SELF["param"]


def test_bytes_per_slot():
    """One slot of the FSDP placement holds a fraction of the bytes that of
    the data-parallel one does, which holds less than the whole tree."""
    cfg, _, _, tparams, _ = _state()
    mesh = _mesh()
    full = sum(x.numel() * 4 for x in tree_leaves(tparams))
    dp = sharding.slot_bytes(tparams, sharding.param_specs(tparams, cfg, mesh), mesh)
    fsdp = sharding.slot_bytes(tparams, sharding.zero1_specs(tparams, cfg, mesh), mesh)
    assert fsdp < dp < full
    placed, _ = place_train_state(tparams, init_optimizer(tparams),
                                  cfg.replace(fsdp_params=True), mesh)
    assert fsdp == sum(st.shards[5].numel() * 4 for st in tree_leaves(placed))


def test_masked_loss_is_the_global_mean_not_a_mean_of_slot_means():
    """With token weights that leave the two data slots different counts,
    the mesh loss is the unsharded loss (the global weighted mean)."""
    cfg, _, _, tparams, batch = _state()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    w = torch.ones(8, 64)
    w[:4, 16:] = 0.0                                  # slot 0 keeps a quarter of its tokens
    tb["weights"] = w
    mesh = _mesh()
    placed, popt = place_train_state(tparams, init_optimizer(tparams), cfg, mesh)
    step = make_train_step(get_model(cfg).train_forward, cfg)
    with use_mesh(mesh):
        _, _, (m,) = _steps(step, placed, popt, [tb])
    _, _, (m1,) = _steps(step, tparams, init_optimizer(tparams), [tb])
    # the reference's bound: the model slots' partial sums round apart in
    # bf16 (the same step in float32 agrees to 5e-7)
    assert abs(m["ce"] - m1["ce"]) <= REF_TOL
    from repro_torch.models.train import cross_entropy
    logits, _ = get_model(cfg).forward(tparams, tb, cfg)
    per_slot = [float(cross_entropy(logits[i:i + 4], tb["labels"][i:i + 4], w[i:i + 4]))
                for i in (0, 4)]
    assert abs(np.mean(per_slot) - m["ce"]) > 1e-3


def test_moe_mesh_step_dispatches_per_slot(monkeypatch):
    """The smoke mixtral trains under the mesh with one dispatch group per
    data slot; at capacity factor 16 (no drops) its cross-entropy is the
    unsharded step's."""
    cfg = get_smoke_config("mixtral-8x7b").replace(capacity_factor=16.0, dtype="float32",
                                                   n_layers=1)
    tparams = get_model(cfg).init(3, "cpu", master=True)
    gen = torch.Generator().manual_seed(0)
    tb = {k: torch.randint(1, cfg.vocab_size, (8, 64), generator=gen)
          for k in ("tokens", "labels")}
    mesh = _mesh()
    placed, popt = place_train_state(tparams, init_optimizer(tparams), cfg, mesh)
    shapes = []
    real = moe._grouped_dispatch
    monkeypatch.setattr(moe, "_grouped_dispatch",
                        lambda p, flat, c, *e: shapes.append(tuple(flat.shape)) or real(p, flat, c,
                                                                                          *e))
    step = make_train_step(get_model(cfg).train_forward, cfg)
    with use_mesh(mesh):
        _, _, (m,) = _steps(step, placed, popt, [tb])
    n_mesh = len(shapes)
    _, _, (m1,) = _steps(step, tparams, init_optimizer(tparams), [tb])
    assert shapes[:n_mesh] == [(1, 4 * 64, cfg.d_model)] * n_mesh   # G = 2, one per slot
    assert n_mesh >= 2 * cfg.n_layers
    assert abs(m["ce"] - m1["ce"]) <= 1e-5


def test_unplaced_state_under_a_mesh_is_refused():
    cfg, _, _, tparams, batch = _state()
    step = make_train_step(get_model(cfg).train_forward, cfg)
    with use_mesh(_mesh()), pytest.raises(ValueError, match="placed state"):
        step(tparams, init_optimizer(tparams), {k: torch.from_numpy(v) for k, v in batch.items()})


def test_vlm_steps_on_a_loader_batch_under_a_mesh():
    """The VLM's patch embeddings split over the data slots with its tokens
    (the registry's per-slot forward), and a batch placed by
    ``ShardedLoader(mesh=)`` feeds the step as its global rows do."""
    from repro_torch.data import ShardedLoader, SyntheticLMDataset
    from repro_torch.models import stub_inputs

    cfg = get_smoke_config("internvl2-26b").replace(dtype="float32")
    api = get_model(cfg)
    params = api.init(4, "cpu", master=True)
    mesh = _mesh()
    loader = ShardedLoader(SyntheticLMDataset(cfg.vocab_size, 32, 4, seed=3), mesh=mesh)
    _, placed_batch = next(iter(loader))
    loader.close()
    extra = stub_inputs(cfg, 4, "cpu", torch.Generator().manual_seed(5))
    batch = {k: sharding.gather(v) for k, v in placed_batch.items()} | extra
    step = make_train_step(api.train_forward, cfg, **KW)
    placed, popt = place_train_state(params, init_optimizer(params), cfg, mesh)
    with use_mesh(mesh):
        fwd, _ = api.forward(params, batch, cfg)
        placed, popt, (m,) = _steps(step, placed, popt, [placed_batch | extra])
    want, _ = api.forward(params, batch, cfg)
    assert float((fwd - want).abs().max()) <= 1e-5
    _, _, (m1,) = _steps(step, params, init_optimizer(params), [batch])
    assert abs(m["loss"] - m1["loss"]) <= SELF["loss_rel"] * abs(m1["loss"])
    assert abs(m["grad_norm"] - m1["grad_norm"]) <= SELF["grad_norm_rel"] * m1["grad_norm"]
