"""The port's pipeline over each pod's data and model slots
(``repro_torch.pipeline.runtime`` on a mesh with ``data`` / ``model`` axes
beside the stage axis) against the reference's pipeline under GSPMD, on the
CPU.

One module-scoped child process runs the reference's ``pipelined_loss_fn``
on 8 forced host devices for the 6-layer ``pipe-test`` config of
``tests/test_pipeline_runtime.py``, the stage stacks sharded
``P("stage", *param_specs)`` and the batch ``P("data")`` as
``repro/launch/dryrun.py`` shards them, on a ``(4, 2, 1)`` and a ``(4, 1,
2)`` ``("stage", "data", "model")`` mesh, in float32 and in bfloat16.  (XLA's
SPMD partitioner of the installed JAX aborts on a ``(4, 2, 2)`` mesh, a data
and a model axis both auto beside the manual stage axis; the port's ``(4, 2,
2)`` is held to its stage-only form, which the first two hold to the
reference.)  The port runs its grid pipeline on CPU slots from the
reference's parameters, its stacks placed by ``make_stage_params(...,
mesh=)``: float32 loss within 1e-5 and each gradient leaf within 1e-5 of its
scale; bfloat16 loss within 2e-3 (``tests/test_torch_pipeline_runtime.py``'s
bounds)."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.core import Objective, Platform, plan  # noqa: E402
from repro_torch.launch import collectives  # noqa: E402
from repro_torch.launch.mesh import make_mesh, symmetric_data_slots  # noqa: E402
from repro_torch.models import ModelConfig, common, sharding  # noqa: E402
from repro_torch.models.transformer import params_from_numpy  # noqa: E402
from repro_torch.pipeline import runtime  # noqa: E402
from repro_torch.pipeline.runtime import make_stage_params, pipelined_loss_fn  # noqa: E402

CFG = ModelConfig(arch_id="pipe-test", family="dense", n_layers=6, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab_size=256, remat="none")
SPEEDS, BANDWIDTH, PODS, M = [4.0, 4.0, 2.0, 4.0], 1e9, 4, 4
AXES = ("stage", "data", "model")
REF_MESHES = ((4, 2, 1), (4, 1, 2))

_CHILD = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    import warnings; warnings.filterwarnings("ignore")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core import Objective, Platform, plan
    from repro.launch.mesh import make_mesh
    from repro.models import ModelConfig
    from repro.models.common import ShapeSpec
    from repro.models.registry import lm_workload
    from repro.models.sharding import param_specs
    from repro.models.transformer import init_params
    from repro.pipeline.runtime import make_stage_params, pipelined_loss_fn

    out = {}
    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            out[f"{prefix}/{key}"] = np.asarray(leaf.astype(jnp.float32)
                                                if leaf.dtype == jnp.bfloat16 else leaf)

    cfg = ModelConfig(arch_id="pipe-test", family="dense", n_layers=6, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, remat="none")
    params = init_params(jax.random.PRNGKey(0), cfg)
    put("params", params)
    wl = lm_workload(cfg, ShapeSpec("t", "train", 64, 8))
    pl = plan(wl, Platform(np.array(%(speeds)r), b=%(b)r), Objective("period"),
              mode="auto")
    out["plan/sizes"] = np.asarray(pl.stage_sizes)
    out["plan/alloc"] = np.asarray(pl.mapping.alloc)
    stages, mask = make_stage_params(params["layers"], pl, num_pods=%(pods)d)
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(0, 256, (8, 64)), jnp.int32),
             "labels": jnp.asarray(rng.integers(0, 256, (8, 64)), jnp.int32)}
    out["tokens"], out["labels"] = np.asarray(batch["tokens"]), np.asarray(batch["labels"])
    pipe = {"embed": params["embed"], "stages": stages, "ln_f": params["ln_f"]}
    isp = lambda x: isinstance(x, P)
    for shape in %(meshes)r:
        mesh = make_mesh(shape, ("stage", "data", "model"))
        tag = "x".join(map(str, shape))
        for dtype in ("bfloat16", "float32"):
            c = cfg.replace(dtype=dtype)
            with jax.set_mesh(mesh):
                base = param_specs({"embed": params["embed"], "layers": params["layers"],
                                    "ln_f": params["ln_f"]}, c, mesh)
                pn = {"embed": jax.tree.map(lambda s: NamedSharding(mesh, s), base["embed"],
                                            is_leaf=isp),
                      "stages": jax.tree.map(lambda s: NamedSharding(mesh, P("stage", *s)),
                                             base["layers"], is_leaf=isp),
                      "ln_f": NamedSharding(mesh, P(None))}
                bn = {k: NamedSharding(mesh, P("data")) for k in batch}
                lf = pipelined_loss_fn(c, pl, num_microbatches=%(M)d, mask=mask, mesh=mesh)
                loss, g = jax.jit(jax.value_and_grad(lf), in_shardings=(pn, bn))(
                    jax.device_put(pipe, pn), jax.device_put(batch, bn))
            out[f"{tag}/{dtype}/loss"] = np.asarray(loss)
            put(f"{tag}/{dtype}/grad", g)
    np.savez(sys.argv[1], **out)
""") % {"speeds": SPEEDS, "b": BANDWIDTH, "pods": PODS, "M": M, "meshes": REF_MESHES}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("pipeline_grid_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", _CHILD, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(path))


def _tree(ref, prefix):
    out = {}
    for key, v in ref.items():
        if key.startswith(prefix + "/"):
            *parents, name = key[len(prefix) + 1:].split("/")
            cur = out
            for p in parents:
                cur = cur.setdefault(p, {})
            cur[name] = v
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{prefix}/{i}").items()}
    if isinstance(tree, dict):
        return {k: v for name in sorted(tree) for k, v in _flat(tree[name],
                                                                 f"{prefix}/{name}").items()}
    return {prefix: tree}


def _plan():
    from repro_torch.models.common import ShapeSpec
    from repro_torch.models.registry import lm_workload

    wl = lm_workload(CFG, ShapeSpec("t", "train", 64, 8))
    return plan(wl, Platform(np.array(SPEEDS), b=BANDWIDTH), Objective("period"),
                mode="auto", device="cpu")


def _mesh(shape):
    return make_mesh(shape, AXES[-len(shape):] if len(shape) < 3 else AXES,
                     devices=["cpu"] * int(np.prod(shape)))


def _setup(ref, dtype="float32"):
    cfg = CFG.replace(dtype=dtype)
    params = params_from_numpy(_tree(ref, "params"), cfg, device="cpu", master=True)
    pl = _plan()
    stages, mask = make_stage_params(params["layers"], pl, PODS)
    pipe = {"embed": params["embed"], "stages": stages, "ln_f": params["ln_f"]}
    batch = {k: torch.from_numpy(ref[k]) for k in ("tokens", "labels")}
    return cfg, params, pl, pipe, mask, batch


def _placed(params, pl, mesh, cfg):
    stages, _ = make_stage_params(params["layers"], pl, PODS, mesh=mesh, cfg=cfg)
    return stages


def _global_grads(pipe, grads: dict) -> dict:
    """The gradients of ``pipe`` as the packed tree's: per placed leaf, the
    blocks' gradients (summed where several tensors hold one block) joined
    into the (L_max, ...) stack, the pods stacked into (num_pods, L_max,
    ...)."""
    def one(x):
        if not isinstance(x, sharding.ShardedTensor):
            return grads[id(x)]
        out = torch.zeros(x.shape, dtype=x.shards[0].dtype)
        for s, t in x.unique():
            out[x.region(s)] += grads[id(t)]
        return out
    tree = sharding._map_leaves(one, pipe)
    if isinstance(tree["stages"], list):
        pods = [_flat(p) for p in tree["stages"]]
        tree["stages"] = _unflat({k: torch.stack([p[k] for p in pods]) for k in pods[0]})
    return tree


def _unflat(flat: dict) -> dict:
    out = {}
    for key, v in flat.items():
        *parents, name = key.strip("/").split("/")
        cur = out
        for p in parents:
            cur = cur.setdefault(p, {})
        cur[name] = v
    return out


def _loss_and_grads(loss_fn, pipe, batch):
    leaves = sharding.tensors(pipe)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = loss_fn(pipe, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return float(loss.detach()), _flat(_global_grads(pipe, {id(t): g for t, g in
                                                             zip(leaves, grads)}))


def _close(got, want, tol=1e-5):
    assert abs(got[0] - want[0]) <= tol, (got[0], want[0])
    assert sorted(got[1]) == sorted(want[1])
    for k, w in want[1].items():
        g = np.asarray(got[1][k], dtype=np.float64)
        w = np.asarray(w, dtype=np.float64)
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= tol * scale, (k, np.abs(g - w).max(), scale)


@pytest.mark.parametrize("shape", REF_MESHES)
def test_float32_grid_matches_the_reference(ref, shape):
    cfg, params, pl, pipe, mask, batch = _setup(ref, "float32")
    assert pl.stage_sizes == tuple(ref["plan/sizes"]) and pl.mapping.alloc == tuple(
        ref["plan/alloc"])
    mesh = _mesh(shape)
    placed = dict(pipe, stages=_placed(params, pl, mesh, cfg))
    got = _loss_and_grads(pipelined_loss_fn(cfg, pl, M, mask, mesh=mesh), placed, batch)
    tag = "x".join(map(str, shape))
    _close(got, (float(ref[f"{tag}/float32/loss"]), _flat(_tree(ref, f"{tag}/float32/grad"))))


@pytest.mark.parametrize("shape", REF_MESHES)
def test_bfloat16_grid_loss_matches_the_reference(ref, shape):
    cfg, params, pl, pipe, mask, batch = _setup(ref, "bfloat16")
    mesh = _mesh(shape)
    placed = dict(pipe, stages=_placed(params, pl, mesh, cfg))
    loss, grads = _loss_and_grads(pipelined_loss_fn(cfg, pl, M, mask, mesh=mesh), placed, batch)
    tag = "x".join(map(str, shape))
    assert abs(loss - float(ref[f"{tag}/bfloat16/loss"])) <= 2e-3
    for k, g in grads.items():
        if k.startswith("/stages/"):
            assert not g[~mask].any(), k


@pytest.mark.parametrize("shape", [(4, 2, 2), (4, 2, 1), (4, 1, 2), (4, 4, 1)])
def test_grid_matches_the_stage_only_form(ref, shape):
    """Every grid, (4, 4, 1) with 2 rows a microbatch on 4 data slots (data
    slot 0 takes them), from placed stacks and from the packed ones, within
    the float32 bounds of the stage-only form; (4, 2, 2) also of the
    reference's float32 pipeline on (4, 2, 1)."""
    cfg, params, pl, pipe, mask, batch = _setup(ref, "float32")
    base = _loss_and_grads(pipelined_loss_fn(cfg, pl, M, mask), pipe, batch)
    mesh = _mesh(shape)
    lf = pipelined_loss_fn(cfg, pl, M, mask, mesh=mesh)
    _close(_loss_and_grads(lf, pipe, batch), base)
    placed = _loss_and_grads(lf, dict(pipe, stages=_placed(params, pl, mesh, cfg)), batch)
    _close(placed, base)
    if shape == (4, 2, 2):
        _close(placed, (float(ref["4x2x1/float32/loss"]),
                        _flat(_tree(ref, "4x2x1/float32/grad"))))


@pytest.mark.parametrize("shape, axes", [((4,), ("stage",)), ((4, 1, 1), AXES),
                                         ((1, 4), ("data", "stage"))])
def test_a_stage_only_mesh_gives_the_floats_of_no_mesh(ref, shape, axes):
    cfg, _, pl, pipe, mask, batch = _setup(ref, "float32")
    base = _loss_and_grads(pipelined_loss_fn(cfg, pl, M, mask), pipe, batch)
    mesh = make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))
    assert not runtime.on_grid(mesh)
    got = _loss_and_grads(pipelined_loss_fn(cfg, pl, M, mask, mesh=mesh), pipe, batch)
    assert got[0] == base[0]
    for k in base[1]:
        assert torch.equal(got[1][k], base[1][k]), k


def test_placed_stacks_hold_one_block_a_model_slot(ref):
    """``make_stage_params(..., mesh=)``: each pod's stack placed over its
    sub-mesh by ``param_specs``, each model slot's block a copy of its part
    of the packed stack; the data slots of a card share one tensor."""
    cfg, params, pl, pipe, mask, _ = _setup(ref, "float32")
    mesh = _mesh((4, 2, 2))
    placed = _placed(params, pl, mesh, cfg)
    assert len(placed) == PODS
    packed = _flat(pipe["stages"])
    for p, tree in enumerate(placed):
        sub = mesh.submesh("stage", p)
        assert sub.axis_names == ("data", "model") and sub.devices == mesh.axis_devices("stage", p)
        for k, x in _flat(tree).items():
            assert isinstance(x, sharding.ShardedTensor) and x.mesh == sub
            want = packed[k][p]
            for s, t in x.unique():
                assert torch.equal(t, want[x.region(s)])
                assert t.data_ptr() != want.data_ptr()
            split = sharding.model_dim(x.spec) is not None
            assert len(x.unique()) == (2 if split else 1), k
            if split:
                assert x.shards[0].numel() * 2 == want.numel()


def test_masked_slots_and_the_unenrolled_pod_get_zero_gradients(ref):
    cfg, params, pl, pipe, mask, batch = _setup(ref, "float32")
    mesh = _mesh((4, 2, 2))
    placed = dict(pipe, stages=_placed(params, pl, mesh, cfg))
    _, grads = _loss_and_grads(pipelined_loss_fn(cfg, pl, M, mask, mesh=mesh), placed, batch)
    for k, g in grads.items():
        if k.startswith("/stages/"):
            assert not g[~mask].any(), k
            assert not g[2].any(), k
            assert g[mask].any(), k
    assert grads["/embed/tok"].any() and grads["/ln_f"].any()


def test_the_moe_runs_over_each_pods_grid():
    """mixtral's smoke config (MoE, 2 layers) over 2 pods on (2, 2, 2):
    within the float32 bounds of the stage-only form (the aux loss dropped
    by both, as in the reference).  Its capacity is every token (factor E /
    k): the grid dispatches in one group a data slot (the reference's rule
    under a mesh), the stage-only form in one, and at the config's 1.25 the
    groups drop different pairs."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import Mapping
    from repro_torch.core.planner import _realize
    from repro_torch.models import get_model

    cfg = get_smoke_config("mixtral-8x7b").replace(dtype="float32")
    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    params = get_model(cfg).init(3, "cpu", master=True)
    pl = _realize(Mapping(((1, 1), (2, 2)), (1, 0)), 1.0, 2.0, "test")
    stages, mask = make_stage_params(params["layers"], pl, 2)
    pipe = {"embed": params["embed"], "stages": stages, "ln_f": params["ln_f"]}
    gen = torch.Generator().manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)
             for k in ("tokens", "labels")}
    base = _loss_and_grads(pipelined_loss_fn(cfg, pl, 2, mask), pipe, batch)
    mesh = make_mesh((2, 2, 2), AXES, devices=["cpu"] * 8)
    placed = dict(pipe, stages=make_stage_params(params["layers"], pl, 2, mesh=mesh,
                                                 cfg=cfg)[0])
    _close(_loss_and_grads(pipelined_loss_fn(cfg, pl, 2, mask, mesh=mesh), placed, batch), base)


def test_no_slot_reads_a_whole_stage_weight(ref):
    """Under ``chip_smoke.param_guard`` (as ``tests/test_torch_tp.py`` uses
    it, each read held to one layer's block) the grid's loss from the whole
    packed stacks reads at most one model slot's block of one layer of
    each split stage weight at a time and makes no whole one.  (48
    positions: a (1 x 64, 128) product would have one layer's ``wi``
    shape, which the guard would read as a whole weight made.)"""
    cfg, params, pl, pipe, mask, _ = _setup(ref, "float32")
    gen = torch.Generator().manual_seed(3)
    batch = {k: torch.randint(0, 256, (8, 48), generator=gen) for k in ("tokens", "labels")}
    mesh = _mesh((4, 2, 2))
    packed = pipe["stages"]
    layer_block = packed["mlp"]["wi"][0, 0].numel() // 2
    with torch.no_grad(), chip_smoke.param_guard(torch, pipe, cfg, mesh.submesh("stage", 0),
                                                 per_layer=True) as guard:
        pipelined_loss_fn(cfg, pl, M, mask, mesh=mesh)(pipe, batch)
    chip_smoke.check_param_guard("grid pipeline", guard)
    assert guard["reads"]["stages/mlp/wi"] == layer_block
    # a whole layer of a stage weight read at once is a fault
    with pytest.raises(SystemExit), chip_smoke.param_guard(
            torch, pipe, cfg, mesh.submesh("stage", 0), per_layer=True) as guard:
        packed["mlp"]["wi"][0, 0].sum()
        chip_smoke.check_param_guard("a whole read", guard)


@pytest.mark.parametrize("remat", ["none", "block"])
def test_the_recomputation_runs_under_the_pods_sub_mesh(ref, monkeypatch, remat):
    """Each stage step is recomputed in the backward pass, after the
    forward's blocks have closed: every layer it recomputes runs under its
    pod's sub-mesh (found by the pod whose placed blocks it computes with),
    as the forward's did, never under the whole mesh or none.  With
    ``remat="block"`` each layer is checkpointed inside its step as well:
    its own recomputation, later in the backward pass, enters the sub-mesh
    again, and the last pod's step reruns its layers once more."""
    cfg, params, pl, pipe, mask, batch = _setup(ref, "float32")
    cfg = cfg.replace(remat=remat)
    mesh = _mesh((4, 2, 2))
    placed = dict(pipe, stages=_placed(params, pl, mesh, cfg))
    owner = {t.untyped_storage().data_ptr(): p for p, tree in enumerate(placed["stages"])
             for t in sharding.tensors(tree)}
    seen = []
    real = runtime._grid_block

    def rec(lrows, ldims, xs, *a, **k):
        pods = {owner.get(t.untyped_storage().data_ptr()) for t in sharding.tensors(lrows)
                if t is not None} - {None}
        seen.append((common.abstract_mesh(), pods))
        return real(lrows, ldims, xs, *a, **k)

    monkeypatch.setattr(runtime, "_grid_block", rec)
    leaves = sharding.tensors(placed)
    for t in leaves:
        t.requires_grad_(True)
    loss = pipelined_loss_fn(cfg, pl, M, mask, mesh=mesh)(placed, batch)
    forward = list(seen)
    seen.clear()
    torch.autograd.grad(loss, leaves, allow_unused=True)
    assert common.abstract_mesh() is None
    assert len(forward) == M * sum(pl.stage_sizes)
    for got in (forward, seen):
        for sub, pods in got:
            assert len(pods) == 1 and sub == mesh.submesh("stage", next(iter(pods)))
    # the step's recomputation stops once it has what the backward needs
    # (``checkpoint``'s early stop): with nested checkpoints an earlier pod's
    # step reruns nothing and each layer's own checkpoint reruns it once; the
    # last pod's step holds the head's activations, so it reruns every layer
    # of the step before each layer's checkpoint reruns it again
    last = len(pl.stage_sizes) - 1
    for j, p in enumerate(pl.mapping.alloc):
        runs = 2 if remat == "block" and j == last else 1
        assert sum(pods == {p} for _, pods in forward) == pl.stage_sizes[j] * M
        assert sum(pods == {p} for _, pods in seen) == runs * pl.stage_sizes[j] * M


def test_hand_offs_are_ppermutes_exactly_derived(ref):
    """(intervals - 1) x M hand-offs, each one ``ppermute`` a data slot of
    its model slots' sends of a slot's (rows / D, S / Mm, d) block of the
    residual rows (sequence-parallel block edges); the symmetric shortcut
    counts every collective as the full grid does."""
    cfg, params, pl, pipe, mask, batch = _setup(ref, "float32")
    mesh = _mesh((4, 2, 2))
    placed = dict(pipe, stages=_placed(params, pl, mesh, cfg))
    lf = pipelined_loss_fn(cfg, pl, M, mask, mesh=mesh)
    traffic = {}
    for sym in (False, True):
        collectives.TRAFFIC.clear()
        with torch.no_grad(), symmetric_data_slots(sym):
            lf(placed, batch)
        traffic[sym] = {k: list(v) for k, v in collectives.TRAFFIC.items()}
    m, (B, S) = pl.num_stages, batch["tokens"].shape
    D, Mm = 2, 2
    assert traffic[False]["ppermute"] == [
        (m - 1) * M * D, (m - 1) * M * D * Mm * (B // M // D) * (S // Mm) * 64 * 4]
    assert traffic[True] == traffic[False]


def test_use_pallas_under_autograd_raises_on_the_grid_and_inference_takes_the_kernels(ref):
    cfg, params, pl, pipe, mask, batch = _setup(ref, "float32")
    mesh = _mesh((4, 2, 2))
    lf = pipelined_loss_fn(cfg.replace(use_pallas=True), pl, M, mask, mesh=mesh)
    with pytest.raises(ValueError, match="use_pallas"):
        lf(pipe, batch)
    with torch.inference_mode():
        got = float(lf(pipe, batch))
        want = float(pipelined_loss_fn(cfg, pl, M, mask, mesh=mesh)(pipe, batch))
    assert abs(got - want) <= 1e-5
