"""Zero1 weights gathered per layer (``repro_torch.models.sharding``:
``SlotViews`` keeps each ``zero1_specs`` block as placed, ``gather_blocks``
all-gathers one layer's or one entry's blocks over the data slots where the
layer runs, inside its checkpoint; ``reduce_to_placement`` sums each block's
gradients into the placement), on meshes of CPU slots.

Checks: (a) a ``zero1_specs`` step equals a ``param_specs`` (data-parallel)
step bit for bit where the data slots compute independently (the loss,
every updated leaf and both moments ``==``, the clip set above the
gradient norm; the norm itself sums squares over differently partitioned
blocks and is held to float32 rounding), and within
``tests/test_torch_fsdp.py``'s bounds where one backward runs over every
data slot (an MoE whose dispatch joins them); (b) the ``zero1_specs`` step
within ``tests/test_distributed_numerics.py``'s 5e-3 of the reference's
unsharded jitted step; (c) no slot holds more than one layer's gathered
zero1 blocks at a time, in the train step (forward and the backward's
recomputation) and in the forward, and every gather is one layer's or the
embedding's or a final norm's.
"""

from __future__ import annotations

import weakref

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
SELF = {"loss_rel": 1e-6, "grad_norm_rel": 1e-6, "moment_rel": 1e-5, "param": 1e-4}
# the clip above any gradient norm of these states: clipping scales nothing
NO_CLIP = 1e9
KW = dict(base_lr=1e-3, warmup=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape=(2, 4)):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * int(np.prod(shape)))


def _state(arch, **kw):
    cfg = get_smoke_config(arch).replace(**{"dtype": "float32", "n_layers": 2, "accum_steps": 2,
                                            **kw})
    params = get_model(cfg).init(5, "cpu", master=True)
    g = torch.Generator().manual_seed(6)
    batch = {k: torch.randint(1, cfg.vocab_size, (4, 32), generator=g)
             for k in ("tokens", "labels")}
    return cfg, params, batch


def _spec_list(specs) -> list:
    out = []
    sharding._map_with_path(lambda _, s: out.append(s), specs)
    return out


def _steps(cfg, params, batch, fsdp: bool, n: int = 2, shape=(2, 4), clip: float = NO_CLIP):
    cfg = cfg.replace(fsdp_params=fsdp)
    mesh = _mesh(shape)
    placed, popt = place_train_state(params, init_optimizer(params), cfg, mesh)
    step = make_train_step(get_model(cfg).train_forward, cfg, clip=clip, **KW)
    with use_mesh(mesh):
        for _ in range(n):
            placed, popt, m = step(placed, popt, batch)
    return m, [[sharding.gather(x) for x in tree_leaves(t)] for t in (placed, popt.m, popt.v)]


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen1.5-110b", "mixtral-8x7b"])
def test_zero1_step_equals_the_data_parallel_step_bit_for_bit(arch):
    cfg, params, batch = _state(arch)
    with use_mesh(_mesh()):
        assert get_model(cfg).train_forward.independent(cfg, 2, 32)
    specs = sharding.zero1_specs(params, cfg, _mesh())
    assert any(sharding._data_dim(s) is not None for s in _spec_list(specs))
    zm, zero1 = _steps(cfg, params, batch, True)
    pm, plain = _steps(cfg, params, batch, False)
    assert float(zm["loss"]) == float(pm["loss"])
    assert float(pm["grad_norm"]) < NO_CLIP
    assert abs(float(zm["grad_norm"]) - float(pm["grad_norm"])) \
        <= 4 * torch.finfo(torch.float32).eps * float(pm["grad_norm"])
    for got, want in zip(zero1, plain):          # parameters, first and second moments
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_zero1_step_over_a_joint_moe_dispatch_stays_within_bounds(monkeypatch):
    """Without ``moe_shard_map`` the MoE gathers every data slot's rows into
    one dispatch, so one backward runs over all the data slots and their
    block gradients arrive interleaved: each waits for its data slot's
    turn."""
    cfg, params, batch = _state("mixtral-8x7b", moe_shard_map=False)
    with use_mesh(_mesh()):
        assert not get_model(cfg).train_forward.independent(cfg, 2, 32)
    zm, zero1 = _steps(cfg, params, batch, True)
    pm, plain = _steps(cfg, params, batch, False)
    assert abs(float(zm["loss"]) - float(pm["loss"])) <= SELF["loss_rel"] * abs(float(pm["loss"]))
    assert abs(float(zm["grad_norm"]) - float(pm["grad_norm"])) \
        <= SELF["grad_norm_rel"] * float(pm["grad_norm"])
    for g, w in zip(zero1[0], plain[0]):
        assert float((g - w).abs().max()) <= SELF["param"]
    for g, w in zip(zero1[1], plain[1]):
        assert float((g - w).abs().max()) <= SELF["moment_rel"] * max(float(w.abs().max()), 1e-30)


def test_zero1_step_matches_the_references_unsharded_step():
    """The reference's own FSDP check: qwen1.5-110b smoke, ``fsdp_params``,
    two microbatches, 8 x 64, two steps (the second at a moving learning
    rate), the per-layer gathers within 5e-3 of the reference's unsharded
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
    p, opt = jparams, j_init_optimizer(jparams)
    for _ in range(2):
        p, opt, jm = step(p, opt, {k: jnp.asarray(v) for k, v in batch.items()})
    want = [np.asarray(x, np.float32) for x in jax.tree.leaves(p)]
    gathers = []
    real = sharding.gather_blocks
    sharding.gather_blocks = lambda c, idx=(): gathers.append(len(idx)) or real(c, idx)
    try:
        m, (got, _, _) = _steps(cfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                                True, clip=1.0)
    finally:
        sharding.gather_blocks = real
    assert gathers and 1 in gathers                   # per layer
    assert abs(float(m["loss"]) - float(jm["loss"])) < REF_TOL
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert float(np.abs(g.float().numpy() - w).max()) < REF_TOL, i


class _Held:
    """Every tensor ``sharding.gather_blocks`` returns, tracked by its
    storage until freed: the most layers whose gathered blocks were alive
    at once, and the most bytes of them."""

    def __init__(self):
        self.live, self.layers, self.bytes, self.calls = {}, 0, 0, []

    def __call__(self, real):
        def tracked(c, idx=()):
            out = real(c, idx)
            st = out.untyped_storage()
            key = id(st)
            if key not in self.live:
                self.live[key] = (idx[:1], st.nbytes(),
                                  weakref.ref(st, lambda _r, k=key: self.live.pop(k, None)))
            self.calls.append(idx[:1])
            layer = {k for k, _, _ in self.live.values() if k}
            self.layers = max(self.layers, len(layer))
            self.bytes = max(self.bytes, sum(n for k, n, _ in self.live.values() if k))
            return out
        return tracked


def _layer_bytes(cfg, params, mesh) -> int:
    """One layer's zero1-split leaves whole over the data slots, a slot's
    model block of each (float32 master weights)."""
    specs = sharding.zero1_specs(params, cfg, mesh)
    M, total = mesh.shape["model"], []

    def one(spec, leaf):
        if sharding._data_dim(spec) is not None:
            split = sharding.model_dim(spec) is not None
            total.append(leaf[0].numel() * leaf.element_size() // (M if split else 1))
    sharding._map2(one, specs["layers"], params["layers"])
    return sum(total)


@pytest.mark.parametrize("path", ["train", "forward"])
def test_no_slot_holds_more_than_one_layers_gathered_blocks(path, monkeypatch):
    cfg, params, batch = _state("qwen3-4b", fsdp_params=True, n_layers=4)
    held = _Held()
    monkeypatch.setattr(sharding, "gather_blocks", held(sharding.gather_blocks))
    mesh = _mesh()
    if path == "train":
        _steps(cfg, params, batch, True, n=1)
    else:
        placed = sharding.place(params, sharding.zero1_specs(params, cfg, mesh), mesh)
        with use_mesh(mesh):
            transformer.forward(placed, batch["tokens"], cfg)
    layers = [k[0] for k in held.calls if k]
    # every layer gathered where it runs: each computing slot once per layer
    # in the forward (twice a microbatch in the train step: the backward's
    # recomputation gathers again)
    passes = 2 * 2 if path == "train" else 1
    n_leaves = sum(sharding._data_dim(s) is not None
                   for s in _spec_list(sharding.zero1_specs(params, cfg, mesh)["layers"]))
    assert sorted(set(layers)) == list(range(cfg.n_layers))
    assert len(layers) == passes * 2 * 4 * cfg.n_layers * n_leaves
    assert held.layers == 1
    # one layer's blocks per computing slot: 2 data x 4 model slots on this process
    assert held.bytes <= 2 * 4 * _layer_bytes(cfg, params, mesh)
