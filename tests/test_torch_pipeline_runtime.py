"""The port's pipeline runtime (``repro_torch.pipeline.runtime``) against
the reference's (``repro.pipeline.runtime``) on the CPU.

One module-scoped child process runs the reference's ``pipelined_loss_fn``
on 4 forced host devices (mesh ``("stage",)``) for the 6-layer ``pipe-test``
config of ``tests/test_pipeline_runtime.py``, in bfloat16 and in float32,
and saves its parameters, packings, plans, losses and every gradient leaf.
The port starts from those parameters (float32 master weights) and the same
batch: packing and mask ``==``; float32 loss within 1e-5 and each gradient
leaf within 1e-5 of its scale; bfloat16 loss within 2e-3 (the reference's
own pipelined-vs-sequential bound); masked slots and the unenrolled pod get
zero gradients."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import Mapping, Objective, Platform, plan
from repro_torch.core.planner import _realize
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import ModelConfig
from repro_torch.models.transformer import params_from_numpy
from repro_torch.pipeline import runtime
from repro_torch.pipeline.runtime import (make_stage_mask, make_stage_params,
                                          pipelined_loss_fn, sequential_loss_fn)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = ModelConfig(arch_id="pipe-test", family="dense", n_layers=6, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab_size=256, remat="none")
SPEEDS, BANDWIDTH, PODS, M = [4.0, 4.0, 2.0, 4.0], 1e9, 4, 4
HAND = (((1, 2), (3, 3), (4, 5)), (1, 0, 3))     # tests/test_pipeline_runtime.py:35

_CHILD = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    import warnings; warnings.filterwarnings("ignore")
    import jax, jax.numpy as jnp, numpy as np
    from repro.core import Mapping, Objective, Platform, plan
    from repro.core.planner import _realize
    from repro.launch.mesh import make_mesh
    from repro.models import ModelConfig
    from repro.models.common import ShapeSpec
    from repro.models.registry import lm_workload
    from repro.models.transformer import init_params
    from repro.pipeline.runtime import (make_stage_params, pipelined_loss_fn,
                                        sequential_loss_fn)

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
    put("packed", stages)
    out["mask"] = np.asarray(mask)
    hand = _realize(Mapping(*%(hand)r), 1.0, 2.0, "test")
    hstages, hmask = make_stage_params(params["layers"], hand, num_pods=%(pods)d)
    put("hand_packed", hstages)
    out["hand_mask"] = np.asarray(hmask)
    mesh = make_mesh((%(pods)d,), ("stage",))
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(0, 256, (8, 64)), jnp.int32),
             "labels": jnp.asarray(rng.integers(0, 256, (8, 64)), jnp.int32)}
    out["tokens"], out["labels"] = np.asarray(batch["tokens"]), np.asarray(batch["labels"])
    pipe_params = {"embed": params["embed"], "stages": stages, "ln_f": params["ln_f"]}
    for dtype in ("bfloat16", "float32"):
        c = cfg.replace(dtype=dtype)
        with jax.set_mesh(mesh):
            lf = pipelined_loss_fn(c, pl, num_microbatches=%(M)d, mask=mask, mesh=mesh)
            loss, g = jax.jit(jax.value_and_grad(lf))(pipe_params, batch)
        out[f"{dtype}/loss"] = np.asarray(loss)
        out[f"{dtype}/seq_loss"] = np.asarray(jax.jit(sequential_loss_fn(c))(params, batch))
        put(f"{dtype}/grad", g)
    np.savez(sys.argv[1], **out)
""") % {"speeds": SPEEDS, "b": BANDWIDTH, "pods": PODS, "hand": HAND, "M": M}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("pipeline_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", _CHILD, str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(path))


def _tree(ref, prefix):
    """The nested dict of numpy arrays saved under ``prefix``."""
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
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{prefix}/{i}").items()}
    if isinstance(tree, dict):
        return {k: v for name in sorted(tree) for k, v in _flat(tree[name],
                                                                 f"{prefix}/{name}").items()}
    return {prefix: tree}


def _setup(ref, dtype="float32"):
    cfg = CFG.replace(dtype=dtype)
    params = params_from_numpy(_tree(ref, "params"), cfg, device="cpu", master=True)
    pl = _plan()
    stages, mask = make_stage_params(params["layers"], pl, PODS)
    pipe = {"embed": params["embed"], "stages": stages, "ln_f": params["ln_f"]}
    batch = {k: torch.from_numpy(ref[k]) for k in ("tokens", "labels")}
    return cfg, params, pl, pipe, mask, batch


def _plan():
    from repro_torch.models.common import ShapeSpec
    from repro_torch.models.registry import lm_workload

    wl = lm_workload(CFG, ShapeSpec("t", "train", 64, 8))
    return plan(wl, Platform(np.array(SPEEDS), b=BANDWIDTH), Objective("period"),
                mode="auto", device="cpu")


def _loss_and_grads(loss_fn, params, batch):
    leaves = _flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                    materialize_grads=True)
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    return float(loss.detach()), dict(zip(leaves, grads))


def test_plan_and_packing_equal_the_references(ref):
    pl = _plan()
    assert pl.stage_sizes == tuple(ref["plan/sizes"]) == (2, 2, 2)
    assert pl.mapping.alloc == tuple(ref["plan/alloc"]) == (0, 1, 3)    # pod 2 idles
    params = params_from_numpy(_tree(ref, "params"), CFG, device="cpu", master=True)
    hand = _realize(Mapping(*HAND), 1.0, 2.0, "test")
    for p, prefix, mask_key in ((pl, "packed", "mask"), (hand, "hand_packed", "hand_mask")):
        stages, mask = make_stage_params(params["layers"], p, PODS)
        assert torch.equal(mask, make_stage_mask(p, PODS))
        np.testing.assert_array_equal(mask.numpy(), ref[mask_key])
        want = _flat(_tree(ref, prefix))
        got = _flat(stages)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the packing copies: writing a stack leaves the layers as they were
    stages, _ = make_stage_params(params["layers"], hand, PODS)
    before = params["layers"]["mlp"]["wi"].clone()
    stages["mlp"]["wi"].add_(1.0)
    assert torch.equal(params["layers"]["mlp"]["wi"], before)


def test_float32_loss_and_gradients_match_the_reference(ref):
    cfg, params, pl, pipe, mask, batch = _setup(ref, "float32")
    loss, grads = _loss_and_grads(pipelined_loss_fn(cfg, pl, M, mask), pipe, batch)
    assert abs(loss - float(ref["float32/loss"])) <= 1e-5
    want = _flat(_tree(ref, "float32/grad"))
    assert sorted(grads) == sorted(want)
    for k, w in want.items():
        g = grads[k].numpy()
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= 1e-5 * scale, (k, np.abs(g - w).max(), scale)
    # masked slots and the unenrolled pod (2) carry no gradient
    for k, g in grads.items():
        if k.startswith("/stages/"):
            assert not g[~mask].any(), k
            assert not g[2].any(), k
    seq_loss, _ = _loss_and_grads(sequential_loss_fn(cfg), params, batch)
    assert abs(loss - seq_loss) <= 1e-5
    assert abs(seq_loss - float(ref["float32/seq_loss"])) <= 1e-5


def test_bfloat16_loss_matches_the_reference(ref):
    cfg, params, pl, pipe, mask, batch = _setup(ref, "bfloat16")
    loss, grads = _loss_and_grads(pipelined_loss_fn(cfg, pl, M, mask), pipe, batch)
    assert abs(loss - float(ref["bfloat16/loss"])) <= 2e-3
    assert abs(float(ref["bfloat16/loss"]) - float(ref["bfloat16/seq_loss"])) <= 2e-3
    for k, g in grads.items():
        if k.startswith("/stages/"):
            assert not g[~mask].any(), k
    want = _flat(_tree(ref, "bfloat16/grad"))
    for k in ("/embed/tok", "/ln_f", "/stages/mlp/wi"):
        ratio = float(grads[k].abs().sum()) / float(np.abs(want[k]).sum())
        assert abs(ratio - 1.0) <= 1e-2, (k, ratio)


@pytest.mark.parametrize("shape, axes", [((4,), ("stage",)), ((4, 2), ("stage", "data")),
                                         ((2, 4), ("data", "stage"))])
def test_a_mesh_of_cpu_devices_gives_the_same_floats(ref, shape, axes):
    """A stage-only mesh gives the floats of no mesh, bit for bit; a mesh
    with a data axis runs each pod's stage over its pod's data slots (one
    row of each 2-row microbatch a slot), within the float32 bounds of the
    stage-only form."""
    cfg, _, pl, pipe, mask, batch = _setup(ref, "float32")
    base = _loss_and_grads(pipelined_loss_fn(cfg, pl, M, mask), pipe, batch)
    mesh = make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))
    assert runtime.pod_devices(PODS, "cuda", mesh) == [torch.device("cpu")] * PODS
    got = _loss_and_grads(pipelined_loss_fn(cfg, pl, M, mask, mesh=mesh), pipe, batch)
    if axes == ("stage",):
        assert got[0] == base[0]
        for k in base[1]:
            assert torch.equal(got[1][k], base[1][k]), k
        return
    assert runtime.on_grid(mesh)
    assert abs(got[0] - base[0]) <= 1e-5
    for k, w in base[1].items():
        scale = max(1.0, float(w.abs().max()))
        assert float((got[1][k] - w).abs().max()) <= 1e-5 * scale, k


def test_stacks_placed_once_per_pod_give_the_same_floats(ref):
    """``make_stage_params(..., devices=)`` gives each pod its own copy of its
    slice of the packed stacks, on the pod's mesh device; the loss and the
    gradients are those of the packed stacks."""
    cfg, params, pl, pipe, mask, batch = _setup(ref, "float32")
    mesh = make_mesh((PODS,), ("stage",), devices=["cpu"] * PODS)
    placed, placed_mask = make_stage_params(params["layers"], pl, PODS,
                                            devices=runtime.pod_devices(PODS, "cpu", mesh))
    assert torch.equal(placed_mask, mask) and len(placed) == PODS
    packed = _flat(pipe["stages"])
    for p in range(PODS):
        for k, t in _flat(placed[p]).items():
            assert torch.equal(t, packed[k][p]) and t.data_ptr() != packed[k][p].data_ptr()
    lf = pipelined_loss_fn(cfg, pl, M, mask, mesh=mesh)
    loss, grads = _loss_and_grads(lf, pipe, batch)
    got_loss, got = _loss_and_grads(lf, dict(pipe, stages=placed), batch)
    assert abs(got_loss - loss) <= 1e-6
    for k, g in grads.items():
        if k.startswith("/stages/"):
            g_placed = torch.stack([got[f"/stages/{p}{k[len('/stages'):]}"] for p in range(PODS)])
        else:
            g_placed = got[k]
        scale = max(1.0, float(g.abs().max()))
        assert float((g_placed - g).abs().max()) <= 1e-6 * scale, k


def test_mesh_slices_place_the_pods():
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh(("data", "stage"), (2, 4), tuple(f"cpu:{i}" for i in range(8)))
    assert [str(d) for d in mesh.axis_devices("stage", 1)] == ["cpu:1", "cpu:5"]
    assert [str(d) for d in runtime.pod_devices(4, "cpu", mesh)] == [
        "cpu:0", "cpu:1", "cpu:2", "cpu:3"]
    with pytest.raises(ValueError, match="slices for 3 pods"):
        runtime.pod_devices(3, "cpu", mesh)


def test_use_pallas_under_autograd_raises_and_inference_takes_the_kernels(ref):
    cfg, _, pl, pipe, mask, batch = _setup(ref, "float32")
    lf = pipelined_loss_fn(cfg.replace(use_pallas=True), pl, M, mask)
    with pytest.raises(ValueError, match="use_pallas"):
        lf(pipe, batch)
    with torch.inference_mode():
        got = float(lf(pipe, batch))
        want = float(pipelined_loss_fn(cfg, pl, M, mask)(pipe, batch))
    assert abs(got - want) <= 1e-5


def test_every_live_step_is_recomputed_and_only_live_steps_run(ref, monkeypatch):
    """The executor runs each enrolled pod once per microbatch (M x 3 stage
    steps for the 3-interval plan), each under ``checkpoint`` with autograd
    on; masked slots and the unenrolled pod never run a block."""
    cfg, _, pl, pipe, mask, batch = _setup(ref, "float32")
    calls, blocks = [], []
    real_ckpt, real_block = runtime.checkpoint, runtime.block_forward
    monkeypatch.setattr(runtime, "checkpoint",
                        lambda fn, *a, **k: calls.append(a[0]) or real_ckpt(fn, *a, **k))
    monkeypatch.setattr(runtime, "block_forward",
                        lambda p, *a: blocks.append(p["ln1"].data_ptr()) or real_block(p, *a))
    _loss_and_grads(pipelined_loss_fn(cfg, pl, M, mask), pipe, batch)
    assert sorted(calls[:M * 3]) == sorted(list(range(3)) * M)
    assert len(blocks) >= M * sum(pl.stage_sizes)
    with torch.no_grad():
        calls.clear()
        blocks.clear()
        pipelined_loss_fn(cfg, pl, M, mask)(pipe, batch)
    assert calls == [] and len(blocks) == M * sum(pl.stage_sizes)
