"""The port's training path against the JAX reference, on the CPU: the data
pipeline, the optimizer (schedule, clipping, AdamW, compression), the loss,
gradients and train steps of the dense (qwen3-4b) and hybrid (zamba2-7b)
smoke configs in float32, the checkpoint format in both directions, and
crash-and-resume.

Inputs are made with numpy from a seed; model parameters are the
reference's own, carried across as float32 master weights
(``params_from_numpy(..., master=True)``).  Tolerances:
  - dataset batches, decompressed top-k and int8 codes: ``==``;
  - schedule, clipping and AdamW updates on the same trees: float32
    rounding, rtol 1e-6 (atol 1e-12 for the values that start at 0);
  - cross-entropy, losses and step-0 gradients: atol 1e-5 + rtol 1e-3;
    the hybrid's gradients atol 3e-5: its float32 embedding gradient sums
    rounding over every use of a token, and the reference's own gradient
    there lies 2.6e-5 from the same model's float64 gradient (the port's
    2.7e-5; ``zamba2-7b`` smoke, seed 0, batch 2 x 32), as its forward
    logits carry 3e-4 where the dense model's carry 1e-4;
  - three train steps: losses atol 1e-4, parameters within the sum of the
    steps' learning rates (an Adam step moves a weight by about lr at most,
    and a gradient that rounds to the other sign flips that step), and each
    leaf's change from its initial value within 1e-2 of the reference's,
    relative to the norm of that change (an update that never happened
    gives 1; measured 1.0e-5 dense and 2.1e-4 hybrid);
  - crash and resume within one package: ``==`` (in a process with MKL's
    conditional numerical reproducibility on: see that test).
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data import SyntheticLMDataset as JDataset
from repro.models import get_model as j_get_model
from repro.models.train import cross_entropy as j_cross_entropy
from repro.models.train import init_optimizer as j_init_optimizer
from repro.models.train import make_train_step as j_make_train_step
from repro import optim as joptim

from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager, Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.data import ShardedLoader, SyntheticLMDataset
from repro_torch.launch import train as ttrain
from repro_torch.models import get_model, hybrid, transformer
from repro_torch.models.train import cross_entropy, init_optimizer, make_train_step
from repro_torch.optim.tree import tree_leaves

GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3
GRAD_ATOL_ARCH = {"qwen3-4b": GRAD_ATOL, "zamba2-7b": 3e-5}
OPT_RTOL, OPT_ATOL = 1e-6, 1e-12
LOSS_TOL = 1e-4
UPDATE_RTOL = 1e-2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tree_close(got, want, atol, rtol, what=""):
    """Leaf by leaf, in the reference's flatten order (which
    :func:`tree_leaves` shares)."""
    g, w = [_np(x) for x in tree_leaves(got)], [_np(x) for x in jax.tree.leaves(want)]
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape, (what, i)
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 32, 2, 0), (151936, 129, 3, 7)])
def test_synthetic_dataset_batches_equal_reference(vocab, seq, batch, seed):
    got, want = SyntheticLMDataset(vocab, seq, batch, seed), JDataset(vocab, seq, batch, seed)
    np.testing.assert_array_equal(got.motifs, want.motifs)
    for step in (0, 1, 5, 1000):
        g, w = got.batch(step), want.batch(step)
        assert sorted(g) == sorted(w) == ["labels", "tokens"]
        for k in g:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])


def test_loader_prefetches_on_the_device_in_order_and_closes():
    ds = SyntheticLMDataset(512, 16, 2, seed=3)
    loader = ShardedLoader(ds, device="cpu", start_step=4, prefetch=2)
    seen = []
    for step, batch in loader:
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v in batch.values())
        for k, v in batch.items():
            np.testing.assert_array_equal(v.numpy(), ds.batch(step)[k])
        seen.append(step)
        if len(seen) == 3:
            break
    assert seen == [4, 5, 6] and loader.step == 7
    loader.close()
    assert not loader._thread.is_alive()


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def test_schedules_match_reference():
    steps = np.arange(0, 140, dtype=np.int32)
    for kw in (dict(base_lr=3e-4, warmup_steps=100, total_steps=120),
               dict(base_lr=1e-3, warmup_steps=1, total_steps=10, min_ratio=0.0)):
        got = optim.linear_warmup_cosine(torch.from_numpy(steps), **kw)
        want = joptim.linear_warmup_cosine(jnp.asarray(steps), **kw)
        np.testing.assert_allclose(_np(got), _np(want), rtol=OPT_RTOL, atol=OPT_ATOL)
    got = optim.cosine_schedule(torch.from_numpy(steps), base_lr=2e-4, total_steps=100)
    want = joptim.cosine_schedule(jnp.asarray(steps), base_lr=2e-4, total_steps=100)
    np.testing.assert_allclose(_np(got), _np(want), rtol=OPT_RTOL, atol=OPT_ATOL)


def _trees(seed, scale=1.0):
    """The same nested tree as numpy, a JAX tree and a torch tree."""
    rng = np.random.default_rng(seed)
    t = {"b": {"w": rng.normal(size=(4, 6)), "s": rng.normal(size=(6,))},
         "a": rng.normal(size=(3, 2, 5))}
    t = jax.tree.map(lambda a: (a * scale).astype(np.float32), t)
    return t, jax.tree.map(jnp.asarray, t), jax.tree.map(torch.from_numpy, t)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, jt, tt = _trees(1, 0.3)
    got, gnorm = optim.clip_by_global_norm(tt, max_norm)
    want, wnorm = joptim.clip_by_global_norm(jt, max_norm)
    np.testing.assert_allclose(_np(gnorm), _np(wnorm), rtol=OPT_RTOL)
    _tree_close(got, want, OPT_ATOL, OPT_RTOL, "clipped")


def test_adamw_updates_match_reference():
    _, jp, tp = _trees(2)
    jstate, tstate = joptim.adamw_init(jp), optim.adamw_init(tp)
    for i in range(3):
        _, jg, tg = _trees(10 + i, 0.1)
        lr = [1e-3, 5e-4, 2.5e-4][i]
        jp, jstate = joptim.adamw_update(jp, jg, jstate, lr)
        tp, tstate = optim.adamw_update(tp, tg, tstate, lr)
        assert int(tstate.step) == int(jstate.step) == i + 1
        assert tstate.step.dtype == torch.int32
        for name, g, w in (("params", tp, jp), ("m", tstate.m, jstate.m),
                           ("v", tstate.v, jstate.v)):
            _tree_close(g, w, OPT_ATOL, OPT_RTOL, f"step {i} {name}")


def test_adamw_state_carries_across():
    _, jp, _ = _trees(3)
    jstate = joptim.adamw_update(jp, _trees(4)[1], joptim.adamw_init(jp), 1e-3)[1]
    got = optim.adamw_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    assert got.step.dtype == torch.int32 and int(got.step) == 1
    _tree_close(got.m, jstate.m, 0, 0, "m")
    _tree_close(got.v, jstate.v, 0, 0, "v")


def test_compression_round_trips_equal_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(16, 25)).astype(np.float32)     # no ties in magnitude
    for frac in (0.01, 0.1, 0.5):
        got = optim.topk_decompress(*optim.topk_compress(torch.from_numpy(x), frac))
        want = joptim.topk_decompress(*joptim.topk_compress(jnp.asarray(x), frac))
        np.testing.assert_array_equal(_np(got), _np(want))
    q, scale = optim.int8_compress(torch.from_numpy(x))
    jq, jscale = joptim.int8_compress(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(_np(optim.int8_decompress(q, scale)),
                                  _np(joptim.int8_decompress(jq, jscale)))
    grads, jgrads, tgrads = _trees(6)
    tstate, jstate = optim.ef_init(tgrads), joptim.ef_init(jgrads)
    for _ in range(2):
        tcomp, tstate = optim.ef_compress_update(tgrads, tstate, frac=0.2)
        jcomp, jstate = joptim.ef_compress_update(jgrads, jstate, frac=0.2)
        _tree_close(tstate.residual, jstate.residual, 0, 0, "residual")
    for key in ("a",):
        np.testing.assert_array_equal(_np(optim.topk_decompress(*tcomp[key])),
                                      _np(joptim.topk_decompress(*jcomp[key])))


# ---------------------------------------------------------------------------
# Loss, gradients, train steps
# ---------------------------------------------------------------------------

def test_cross_entropy_and_its_gradient_match_reference():
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(2, 9, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    weights = (rng.random((2, 9)) < 0.7).astype(np.float32)
    for w in (None, weights):
        tl = torch.from_numpy(logits).requires_grad_(True)
        got = cross_entropy(tl, torch.from_numpy(labels),
                            None if w is None else torch.from_numpy(w))
        got.backward()
        jw = None if w is None else jnp.asarray(w)
        want, jgrad = jax.value_and_grad(
            lambda x: j_cross_entropy(x, jnp.asarray(labels), jw))(jnp.asarray(logits))
        np.testing.assert_allclose(_np(got), _np(want), atol=GRAD_ATOL, rtol=GRAD_RTOL)
        np.testing.assert_allclose(_np(tl.grad), _np(jgrad), atol=GRAD_ATOL, rtol=GRAD_RTOL)


_FAMILY = {"qwen3-4b": transformer, "zamba2-7b": hybrid}


def _train_models(arch, accum=1, seed=0):
    cfg = get_smoke_config(arch).replace(dtype="float32", accum_steps=accum)
    jcfg = j_get_smoke_config(arch).replace(dtype="float32", accum_steps=accum)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(seed))
    tparams = _FAMILY[arch].params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                              device="cpu", master=True)
    return cfg, tparams, jcfg, jparams


def _batch(cfg, step=0, batch=2, seq=32):
    b = SyntheticLMDataset(cfg.vocab_size, seq, batch, seed=11).batch(step)
    return b, {k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v)
                                                          for k, v in b.items()}


def test_master_params_stay_float32():
    cfg, tparams, _, jparams = _train_models("qwen3-4b")
    assert all(p.dtype == torch.float32 for p in tree_leaves(tparams))
    assert len(tree_leaves(tparams)) == len(jax.tree.leaves(jparams))
    served = transformer.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           cfg.replace(dtype="bfloat16"), device="cpu")
    assert served["layers"]["attn"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-7b"])
def test_step0_loss_and_gradients_match_reference(arch, accum):
    """One train step at step 0, where the warm-up learning rate is 0 and
    clipping is off (max norm 1e9): the parameters stay, and AdamW's first
    moment is (1 - b1) times the gradient, through each package's own
    gradient accumulation."""
    cfg, tparams, jcfg, jparams = _train_models(arch, accum)
    _, jb, tb = _batch(cfg, batch=2)
    jstep = jax.jit(j_make_train_step(j_get_model(jcfg).forward, jcfg, clip=1e9))
    jparams2, jstate, jm = jstep(jparams, j_init_optimizer(jparams), jb)
    tstep = make_train_step(get_model(cfg).train_forward, cfg, clip=1e9)
    tparams2, tstate, tm = tstep(tparams, init_optimizer(tparams), tb)
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=k)
    assert float(tm["lr"]) == float(jm["lr"]) == 0.0
    _tree_close(tstate.m, jstate.m, GRAD_ATOL_ARCH[arch] * 0.1, GRAD_RTOL, "(1 - b1) grad")
    _tree_close(tparams2, jparams2, 0, 0, "params at lr 0")


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-7b"])
def test_three_train_steps_match_reference(arch):
    cfg, tparams, jcfg, jparams = _train_models(arch)
    jinit = jparams
    kw = dict(base_lr=1e-3, warmup=1, total_steps=10)
    jstep = jax.jit(j_make_train_step(j_get_model(jcfg).forward, jcfg, **kw))
    tstep = make_train_step(get_model(cfg).train_forward, cfg, **kw)
    jstate, tstate = j_init_optimizer(jparams), init_optimizer(tparams)
    lr_sum = 0.0
    for step in range(3):
        _, jb, tb = _batch(cfg, step)
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        tparams, tstate, tm = tstep(tparams, tstate, tb)
        lr_sum += float(jm["lr"])
        np.testing.assert_allclose(_np(tm["loss"]), _np(jm["loss"]), atol=LOSS_TOL, rtol=0,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(_np(tm["lr"]), _np(jm["lr"]), rtol=OPT_RTOL)
    assert lr_sum > 1e-3
    _tree_close(tparams, jparams, lr_sum, 0, "params after 3 steps")
    for i, (t, j, j0) in enumerate(zip(tree_leaves(tparams), jax.tree.leaves(jparams),
                                       jax.tree.leaves(jinit))):
        t, j, j0 = (np.asarray(_np(x), np.float64) for x in (t, j, j0))
        assert np.linalg.norm(t - j) <= UPDATE_RTOL * np.linalg.norm(j - j0), f"leaf {i}"


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-7b"])
def test_training_refuses_a_kernel_config(arch):
    """The kernels' outputs carry no gradient, so a config with
    ``use_pallas`` set is refused by ``make_train_step`` and by the loss
    under autograd; the loss without autograd still evaluates."""
    from repro_torch.models.train import make_loss_fn, value_and_grad

    cfg, tparams, _, _ = _train_models(arch)
    kcfg = cfg.replace(use_pallas=True)
    api = get_model(kcfg)
    _, _, tb = _batch(cfg)
    with pytest.raises(ValueError, match="use_pallas"):
        make_train_step(api.train_forward, kcfg)
    loss_fn = make_loss_fn(api.train_forward, kcfg)
    with pytest.raises(ValueError, match="use_pallas"):
        value_and_grad(loss_fn, tparams, tb)
    with torch.no_grad():
        got, _ = loss_fn(tparams, tb)
        want, _ = make_loss_fn(get_model(cfg).train_forward, cfg)(tparams, tb)
    assert abs(float(got) - float(want)) <= LOSS_TOL


def test_hybrid_gradient_rounding_floor():
    """Why the hybrid's gradients are held at atol 3e-5: against the same
    model's float64 gradient (the port's, in float64 end to end), the
    reference's own float32 gradient of the token embedding is off by more
    than the dense model's 1e-5 (2.6e-5 at this seed and batch), and the
    port's float32 gradient by no more than half as much again."""
    from repro.models.train import make_loss_fn as j_make_loss_fn
    from repro_torch.models.train import make_loss_fn, value_and_grad

    cfg, tparams, jcfg, jparams = _train_models("zamba2-7b")
    _, jb, tb = _batch(cfg)
    _, jgrads = jax.jit(jax.value_and_grad(j_make_loss_fn(j_get_model(jcfg).forward, jcfg),
                                           has_aux=True))(jparams, jb)
    c64 = cfg.replace(dtype="float64", param_dtype="float64")
    p64 = hybrid.params_from_numpy(jax.tree.map(np.asarray, jparams), c64, device="cpu",
                                   master=True)
    grads = {}
    for name, c, p in (("f32", cfg, tparams), ("f64", c64, p64)):
        _, grads[name] = value_and_grad(make_loss_fn(get_model(c).train_forward, c), p, tb)
    emb = {"ref": np.asarray(jgrads["embed"]["tok"], np.float64),
           "port": grads["f32"]["embed"]["tok"].double().numpy()}
    truth = grads["f64"]["embed"]["tok"].numpy()
    ref_err = np.abs(emb["ref"] - truth).max()
    port_err = np.abs(emb["port"] - truth).max()
    assert GRAD_ATOL < ref_err < GRAD_ATOL_ARCH["zamba2-7b"]
    assert port_err <= 1.5 * ref_err


def test_block_remat_keeps_the_gradients():
    """``remat="block"`` (torch checkpointing per block) changes memory, not
    the numbers: the same gradients bit for bit as without it."""
    from repro_torch.models.train import make_loss_fn, value_and_grad

    for arch in ("qwen3-4b", "zamba2-7b"):
        cfg, tparams, _, _ = _train_models(arch)
        _, _, tb = _batch(cfg)
        out = []
        for remat in ("block", "none"):
            c = cfg.replace(remat=remat)
            out.append(value_and_grad(make_loss_fn(get_model(c).train_forward, c),
                                      tparams, tb))
        assert torch.equal(out[0][0][0], out[1][0][0])
        for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _ckpt_trees():
    rng = np.random.default_rng(8)
    a = rng.normal(size=(2, 3)).astype(np.float32)
    c = np.arange(4, dtype=np.int32)
    d = rng.normal(size=(2, 2)).astype(np.float32)
    jtree = {"params": {"a": jnp.asarray(a), "b": {"c": jnp.asarray(c),
                                                   "d": jnp.asarray(d, jnp.bfloat16)}},
             "opt": joptim.AdamWState(jnp.asarray(3, jnp.int32), {"a": jnp.asarray(a)},
                                      {"a": jnp.asarray(d.sum() * a)})}
    ttree = {"params": {"a": torch.from_numpy(a), "b": {"c": torch.from_numpy(c),
                                                        "d": torch.from_numpy(d).bfloat16()}},
             "opt": optim.AdamWState(torch.tensor(3, dtype=torch.int32),
                                     {"a": torch.from_numpy(a)},
                                     {"a": torch.from_numpy(d.sum() * a)})}
    return jtree, ttree


def _zeros_like(tree):
    from repro_torch.optim.tree import tree_map

    return tree_map(torch.zeros_like, tree)


def test_reference_checkpoint_restores_in_port(tmp_path):
    jtree, ttree = _ckpt_trees()
    JCheckpointer().save(tmp_path / "c", jtree, step=7, extras={"loss": 1.5})
    got, manifest = Checkpointer().restore(tmp_path / "c", _zeros_like(ttree))
    assert manifest["step"] == 7 and manifest["extras"] == {"loss": 1.5}
    assert got["params"]["b"]["d"].dtype == torch.bfloat16
    assert isinstance(got["opt"], optim.AdamWState)
    for g, w in zip(tree_leaves(got), tree_leaves(ttree)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_port_checkpoint_restores_in_reference(tmp_path):
    jtree, ttree = _ckpt_trees()
    Checkpointer().save(tmp_path / "c", ttree, step=9, extras={"loss": 2.5})
    like = jax.tree.map(jnp.zeros_like, jtree)
    got, manifest = JCheckpointer().restore(tmp_path / "c", like)
    assert manifest["step"] == 9 and manifest["dtypes"] == ["int32", "float32", "float32",
                                                            "float32", "int32", "bfloat16"]
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g, np.float32), np.asarray(w, np.float32))


def test_a_corrupt_leaf_is_refused(tmp_path):
    """The restore reads each leaf in one call at its offset in the archive
    and checks it against the archive's CRC-32: the leaves equal
    ``np.load``'s, and one flipped byte in a leaf's data is refused."""
    _, ttree = _ckpt_trees()
    Checkpointer().save(tmp_path / "c", ttree, step=1)
    shard = tmp_path / "c" / "shard_00000.npz"
    with np.load(shard) as data:
        want = [data[f"leaf_{i}"] for i in range(6)]
    got, _ = Checkpointer().restore(tmp_path / "c", _zeros_like(ttree))
    for g, w in zip(tree_leaves(got), want):
        assert g.reshape(-1).view(torch.uint8).numpy().tobytes() == w.tobytes()
    raw = bytearray(shard.read_bytes())
    at = raw.index(np.asarray(ttree["opt"].v["a"]).tobytes()) + 5
    raw[at] ^= 0x40
    shard.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="corrupt"):
        Checkpointer().restore(tmp_path / "c", _zeros_like(ttree))


def test_a_compressed_archive_is_refused(tmp_path):
    """Both packages write every leaf uncompressed (``np.savez``); an archive
    whose leaves are deflated is refused rather than read another way."""
    _, ttree = _ckpt_trees()
    Checkpointer().save(tmp_path / "c", ttree, step=1)
    shard = tmp_path / "c" / "shard_00000.npz"
    with np.load(shard) as data:
        leaves = {k: data[k] for k in data.files}
    np.savez_compressed(shard, **leaves)
    with pytest.raises(ValueError, match="not an uncompressed"):
        Checkpointer().restore(tmp_path / "c", _zeros_like(ttree))


def test_manager_retention_torn_and_async(tmp_path):
    _, ttree = _ckpt_trees()
    mgr = CheckpointManager(tmp_path, max_to_keep=2, async_save=True)
    for s in (1, 2, 3):
        mgr.save(s, ttree)
    mgr.wait()
    assert mgr.steps() == [2, 3]
    torn = tmp_path / "step_00000009"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    _, manifest = mgr.restore_latest(_zeros_like(ttree))
    assert manifest["step"] == 3


def test_async_save_copies_before_the_caller_updates_in_place(tmp_path):
    _, ttree = _ckpt_trees()
    mgr = CheckpointManager(tmp_path)
    want = ttree["params"]["a"].clone()
    mgr.save(1, ttree)
    ttree["params"]["a"].add_(1.0)
    mgr.wait()
    got, _ = mgr.restore(1, _zeros_like(ttree))
    assert torch.equal(got["params"]["a"], want)


_RESUME = """
import contextlib, io, json, sys, tempfile
from repro_torch.launch.train import train_loop
kw = dict(arch="qwen3-4b", smoke=True, steps=12, batch=2, seq=32, ckpt_every=5,
          log_every=100, seed=0, device="cpu")
with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()):
    ref = train_loop(ckpt_dir=None, **kw)
    try:
        train_loop(ckpt_dir=d, fail_at_step=7, **kw)
        crashed = None
    except RuntimeError as e:
        crashed = str(e)
    resumed = train_loop(ckpt_dir=d, **kw)
print(json.dumps({"ref": ref, "resumed": resumed, "crashed": crashed}))
"""


def test_crash_and_resume_training_is_exact():
    """The reference's crash-and-resume test (``tests/test_checkpoint.py``)
    through the port: the loop dies at step 7, after the step-5 checkpoint;
    the restart resumes at step 6, and every loss from there on is the
    uninterrupted run's, bit for bit.

    It runs in a process of its own with ``MKL_CBWR=COMPATIBLE``: on the
    CPU, MKL's float32 products otherwise depend on the alignment of their
    buffers, so the same train step can round differently from one
    allocation to the next in one process (the same 3 smoke steps run 6
    times in a row gave two loss sequences, 4.8e-7 apart; with the variable
    set, one).  The card does not go through MKL.  One thread: the steps are
    small, and the child then does not compete with the test workers."""
    env = dict(os.environ, MKL_CBWR="COMPATIBLE", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    run = subprocess.run([sys.executable, "-c", _RESUME], env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    out = json.loads(run.stdout.strip().splitlines()[-1])
    ref, resumed = out["ref"], out["resumed"]
    assert out["crashed"] == "simulated failure at step 7"
    assert resumed["start_step"] == 6 and resumed["steps_run"] == 6
    assert resumed["losses"] == ref["losses"][6:]
    assert resumed["final_loss"] == ref["final_loss"]
    assert ref["losses"][-1] < ref["losses"][0]


def test_port_resumes_the_reference_training_checkpoint(tmp_path, monkeypatch):
    """The reference trains the float32 smoke model and crashes after its
    step-1 checkpoint; the port restores that checkpoint (parameters and
    AdamW state) and trains on: its step-2 loss is the reference's
    uninterrupted one within the loss tolerance."""
    import repro.launch.train as jtrain

    jcfg = j_get_smoke_config("qwen3-4b").replace(dtype="float32")
    cfg = get_smoke_config("qwen3-4b").replace(dtype="float32")
    monkeypatch.setattr(jtrain, "get_smoke_config", lambda arch: jcfg)
    monkeypatch.setattr(ttrain, "get_smoke_config", lambda arch: cfg)
    kw = dict(arch="qwen3-4b", smoke=True, steps=3, batch=2, seq=32, ckpt_every=1,
              log_every=100, seed=0)
    losses = []   # the reference's per-step losses, read where its loop reads them

    def recording_float(x):
        losses.append(float(x))
        return losses[-1]
    monkeypatch.setattr(jtrain, "float", recording_float, raising=False)
    jtrain.train_loop(ckpt_dir=None, **kw)
    with pytest.raises(RuntimeError, match="simulated failure"):
        jtrain.train_loop(ckpt_dir=str(tmp_path), fail_at_step=1, **kw)
    resumed = ttrain.train_loop(ckpt_dir=str(tmp_path), device="cpu", **kw)
    assert resumed["start_step"] == 2
    np.testing.assert_allclose(resumed["losses"][0], losses[2], atol=LOSS_TOL, rtol=0)
