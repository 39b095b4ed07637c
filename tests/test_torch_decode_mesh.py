"""Decode over the mesh for the transformer families (``repro_torch.models``:
``transformer.decode_slots`` / ``decode_step`` under an ambient mesh,
``attention.decode_attention_row``, ``sharding.StateBlocks``; the decode
kernel's log-sum-exp; the dry run's decode cells) against the JAX
reference's prefill and decode, on meshes of CPU slots.

The decode state stays where ``state_specs`` puts it: the smoke configs'
2 K/V heads of 16 split their ``head_dim`` over a 4-way model axis (the
head-dim layout) and their heads over a 2-way one (the heads layout); a
batch of one splits the cache length over the data slots.  Bounds: logits
within 1e-4 and caches within 2e-5 of the reference's, in float32, as
``tests/test_torch_tp.py`` holds the prefill.  Planted faults (a score
all-reduce that drops a model slot, a cache-length merge that drops a data
slot, the new token written by the wrong data slot) each break one of them.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import get_model as j_get_model
from repro.models import transformer as jtransformer

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.launch import collectives, dryrun
from repro_torch.launch.mesh import make_mesh, use_mesh
from repro_torch.models import attention, get_model, sharding, transformer
from repro_torch.models.common import ShapeSpec

LOGIT_TOL, CACHE_TOL = 1e-4, 2e-5
STEPS = 4
# (arch, rows, prompt, window): a batch the data axes divide; a batch of one
# whose 32-slot window the prompt and the steps wrap
SETUPS = {"dense": ("qwen3-4b", 4, 16, None), "moe": ("mixtral-8x7b", 4, 16, None),
          "vlm": ("internvl2-26b", 4, 16, None), "dense-b1": ("qwen3-4b", 1, 40, 32),
          "moe-b1": ("mixtral-8x7b", 1, 40, 32)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other mesh test files use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * int(np.prod(shape)))


def _setup(name):
    arch, B, S, window = SETUPS[name]
    kw = dict(dtype="float32", n_layers=2)
    if arch.startswith("mixtral"):
        kw["capacity_factor"] = 4.0
    if window:
        kw["sliding_window"] = window
    cfg = get_smoke_config(arch).replace(**kw)
    jcfg = j_get_smoke_config(arch).replace(**kw)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = transformer.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    pe = None
    if cfg.family == "vlm":
        pe = (rng.normal(size=(B, cfg.n_vis_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return cfg, jcfg, jparams, tparams, toks, pe


@pytest.fixture(scope="module")
def references():
    """Per setup: the reference's prefill of the prompt, then ``STEPS``
    jitted decode steps of the next tokens: each step's logits and the
    final caches."""
    out = {}
    for name in SETUPS:
        cfg, jcfg, jparams, _, toks, pe = _setup(name)
        S = SETUPS[name][2]
        jpe = None if pe is None else jnp.asarray(pe)
        _, state = jax.jit(lambda p, t: jtransformer.prefill(p, t, jcfg, prefix_embeds=jpe))(
            jparams, jnp.asarray(toks[:, :S]))
        dec = jax.jit(j_get_model(jcfg).decode)
        logits = []
        for t in range(STEPS):
            lg, state = dec(jparams, state, jnp.asarray(toks[:, S + t:S + t + 1]))
            logits.append(np.asarray(lg))
        c = state.caches
        out[name] = (logits, {f: np.asarray(getattr(c, f)) for f in ("k", "v", "pos",
                                                                     "positions")})
    return out


def _port_decode(name, shape, place=True, guard=None):
    """The port's prefill, then ``STEPS`` decode steps over a ``shape``
    mesh of CPU slots from the state placed by ``state_specs`` (or whole);
    returns (each step's logits, the caches gathered)."""
    cfg, _, _, tparams, toks, pe = _setup(name)
    S = SETUPS[name][2]
    mesh = _mesh(shape)
    with use_mesh(mesh):
        _, state = transformer.prefill(tparams, torch.from_numpy(toks[:, :S]), cfg,
                                       None if pe is None else torch.from_numpy(pe))
    B = toks.shape[0]
    st = sharding.place(state, sharding.state_specs(state, cfg, mesh, B), mesh) if place \
        else state
    logits = []
    with use_mesh(mesh), (guard(state) if guard else contextlib.nullcontext()):
        for t in range(STEPS):
            lg, st = transformer.decode_step(tparams, st, torch.from_numpy(
                toks[:, S + t:S + t + 1]), cfg)
            logits.append(lg.numpy())
    c = (sharding.gather(st) if place else st).caches
    return logits, {f: getattr(c, f).numpy() for f in ("k", "v", "pos", "positions")}


def _errors(got, want):
    lg = max(float(np.abs(g - w).max()) for g, w in zip(got[0], want[0]))
    cache = max(float(np.abs(got[1][f] - want[1][f]).max()) for f in ("k", "v"))
    exact = all(np.array_equal(got[1][f], want[1][f]) for f in ("pos", "positions"))
    return lg, cache, exact


CASES = [("dense", (2, 4)), ("moe", (2, 4)), ("vlm", (2, 4)), ("dense", (2, 2)),
         ("dense", (2, 3)), ("dense-b1", (4, 2)), ("dense-b1", (4, 4)), ("moe-b1", (4, 2)),
         ("moe-b1", (4, 4))]


@pytest.mark.parametrize("name, shape", CASES,
                         ids=["dense-cols-2x4", "moe-cols-2x4", "vlm-cols-2x4", "dense-heads-2x2",
                              "dense-whole-2x3", "dense-length-heads-4x2",
                              "dense-length-cols-4x4", "moe-length-heads-4x2",
                              "moe-length-cols-4x4"])
def test_mesh_decode_matches_the_reference(name, shape, references):
    """The reference's prefill and 4 decode steps against the port's
    prefill and decode over the mesh, the state in its ``state_specs``
    blocks throughout: logits, caches, positions.  On a 3-way model axis
    neither the 2 K/V heads nor their 16 columns divide it, so every model
    slot holds the cache whole (the ``whole`` layout)."""
    cfg = _setup(name)[0]
    mesh = _mesh(shape)
    B = SETUPS[name][1]
    layout = attention.decode_layout(
        sharding.StateBlocks(transformer.init_decode_state(cfg, B, 8, "cpu").caches, cfg, mesh,
                             B), shape[1])
    assert layout == {2: "heads", 3: "whole", 4: "cols"}[shape[1]]
    lg, cache, exact = _errors(_port_decode(name, shape), references[name])
    assert lg <= LOGIT_TOL and cache <= CACHE_TOL and exact


def test_a_whole_state_decodes_in_place_through_its_blocks(references):
    """A state that is not placed is read and written through views of the
    blocks ``state_specs`` gives each slot: the same answer, in place."""
    lg, cache, exact = _errors(_port_decode("dense", (2, 4), place=False), references["dense"])
    assert lg <= LOGIT_TOL and cache <= CACHE_TOL and exact


def test_a_score_psum_that_drops_a_model_slot_breaks_the_decode(references, monkeypatch):
    real = collectives.psum
    monkeypatch.setattr(collectives, "psum", lambda xs, device: real(
        xs[:-1] if isinstance(device, (list, tuple)) and xs[0].dim() == 4 else xs, device))
    lg, _, _ = _errors(_port_decode("dense", (2, 4)), references["dense"])
    assert lg > 1e-2


def test_a_merge_that_drops_a_data_slot_breaks_the_decode(references, monkeypatch):
    real = attention.merge_partials
    monkeypatch.setattr(attention, "merge_partials", lambda parts: real(parts[:-1]))
    lg, _, _ = _errors(_port_decode("dense-b1", (4, 2)), references["dense-b1"])
    assert lg > 1e-2


def test_the_token_written_by_the_wrong_data_slot_breaks_the_cache(references, monkeypatch):
    real = attention._ring_write

    def wrong(sl, m, k_new, v_new, pos, C, done):
        real(sl._replace(c0=(sl.c0 + sl.k[m].shape[1]) % C), m, k_new, v_new, pos, C, done)
    monkeypatch.setattr(attention, "_ring_write", wrong)
    lg, cache, exact = _errors(_port_decode("dense-b1", (4, 2)), references["dense-b1"])
    assert cache > 1e-2 and not exact


def _kv_guard(mesh, cfg, B, reads):
    """A dispatch mode that records, for every op reading the memory of a
    whole state's K, V or positions leaf, how many elements it read against
    one slot's block of that leaf (views read nothing)."""
    def make(state):
        specs = sharding.state_specs(state, cfg, mesh, B)
        spans = []
        for f in ("k", "v", "positions"):
            x, sp = getattr(state.caches, f), getattr(specs.caches, f)
            counts = sharding._counts(sp, mesh, x.dim())
            spans.append((x.data_ptr(), x.data_ptr() + x.numel() * x.element_size(),
                          x.numel() // int(np.prod(counts)), f))

        class Guard(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                # an op may take its tensors in a list (einsum under
                # inference mode reaches the mode whole)
                ins = [t for a in list(args) + list((kwargs or {}).values())
                       for t in (a if isinstance(a, (list, tuple)) else [a])
                       if isinstance(t, torch.Tensor)]
                outs = [t for t in (out if isinstance(out, (list, tuple)) else [out])
                        if isinstance(t, torch.Tensor)]
                held = {t.untyped_storage().data_ptr() for t in ins}
                if outs and all(t.untyped_storage().data_ptr() in held for t in outs) \
                        and func.overloadpacket.__name__ not in ("index_put_", "copy_"):
                    return out          # a view: it reads nothing
                for t in ins:
                    for lo, hi, block, f in spans:
                        if lo <= t.data_ptr() < hi:
                            reads.append((func.overloadpacket.__name__, f, t.numel(), block))
                return out
        return Guard()
    return make


@pytest.mark.parametrize("name, shape", [("dense", (2, 4)), ("dense-b1", (4, 2))],
                         ids=["batch-split-2x4", "length-split-4x2"])
def test_no_op_reads_more_of_a_kv_leaf_than_one_slots_block(name, shape, references):
    """A whole state decoded through its blocks' views: every op that reads
    the K, V or positions memory reads at most one slot's block of it (and
    the answer is the reference's)."""
    cfg = _setup(name)[0]
    reads = []
    got = _port_decode(name, shape, place=False,
                       guard=_kv_guard(_mesh(shape), cfg, SETUPS[name][1], reads))
    assert reads and {f for _, f, _, _ in reads} == {"k", "v", "positions"}
    assert [r for r in reads if r[2] > r[3]] == []
    lg, cache, exact = _errors(got, references[name])
    assert lg <= LOGIT_TOL and cache <= CACHE_TOL and exact


def test_decode_over_the_mesh_never_gathers_the_state_or_the_weights(monkeypatch):
    """``decode_step`` under a mesh never calls ``sharding.gather``, and
    every state block is the placed tensor before and after the step."""
    monkeypatch.setattr(sharding, "gather", lambda *a, **k: pytest.fail("gathered"))
    cfg = get_smoke_config("qwen3-4b").replace(dtype="float32", n_layers=2)
    api = get_model(cfg)
    mesh = _mesh((2, 4))
    params = api.init(3, "cpu")
    state = api.init_decode_state(4, 16, "cpu")
    pparams = sharding.place(params, sharding.param_specs(params, cfg, mesh), mesh)
    pstate = sharding.place(state, sharding.state_specs(state, cfg, mesh, 4), mesh)
    ptrs = [[t.data_ptr() for t in x.shards] for x in pstate.caches]
    with use_mesh(mesh):
        for _ in range(2):
            lg, pstate = api.decode(pparams, pstate, torch.ones((4, 1), dtype=torch.int32))
    assert lg.shape == (4, 1, cfg.vocab_size)
    assert [[t.data_ptr() for t in x.shards] for x in pstate.caches] == ptrs
    assert all(int(b.max()) == 2 for b in pstate.caches.pos.shards)


# ---------------------------------------------------------------------------
# The decode kernel's log-sum-exp, and the merge of partial attentions
# ---------------------------------------------------------------------------

def _lse_inputs():
    g = torch.Generator().manual_seed(4)
    B, H, K, hd, C = 3, 4, 2, 16, 64
    q = torch.randn(B, H, hd, generator=g)
    k, v = torch.randn(B, C, K, hd, generator=g), torch.randn(B, C, K, hd, generator=g)
    mask = torch.rand(B, C, generator=g) < 0.3
    mask[1] = False
    mask[1, 50] = True          # row 1: one valid slot, in the last quarter only
    mask[2] = False             # row 2: none anywhere (the mean of V)
    return q, k, v, mask


def test_lse_slices_merge_to_the_whole():
    """``decode_attention_ref(..., return_lse=True)`` over four slices of
    the cache, merged by ``merge_partials``, equals the whole: a slice with
    no valid slot adds nothing beside one that has one, and a row with none
    anywhere gets the mean of V; the log-sum-exps combine to the whole's."""
    q, k, v, mask = _lse_inputs()
    want, want_lse = decode_attention_ref(q, k, v, mask, return_lse=True)
    parts = [decode_attention_ref(q, k[:, s:s + 16], v[:, s:s + 16], mask[:, s:s + 16], True)
             for s in range(0, 64, 16)]
    got = attention.merge_partials(parts)
    assert float((got - want).abs().max()) <= 1e-6
    assert float((got[2] - v.repeat_interleave(2, dim=2).mean(1)[2]).abs().max()) <= 1e-6
    lse = torch.logsumexp(torch.stack([p[1] for p in parts]), dim=0)
    assert float((lse[:2] - want_lse[:2]).abs().max()) <= 1e-5
    assert bool((want_lse[2] == -1e30).all()) and bool((parts[0][1][1] == -1e30).all())
    assert torch.equal(decode_attention_ref(q, k, v, mask), want)


def test_the_kernels_meta_route_returns_the_lse():
    q, k, v, mask = (t.to("meta") for t in _lse_inputs())
    out, lse = kdec.decode_attention(q, k, v, mask, return_lse=True)
    assert out.shape == q.shape and lse.shape == (3, 4) and lse.dtype == torch.float32
    nb, fl = kdec.decode_cost(3, 4, 2, 16, 64, 4, lse=True)
    assert nb == kdec.decode_cost(3, 4, 2, 16, 64, 4)[0] + 4 * 3 * 4 and fl > 0


# ---------------------------------------------------------------------------
# The dry run's decode cells
# ---------------------------------------------------------------------------

def test_symmetric_shortcut_equals_the_full_simulation_for_a_decode_cell():
    """Data slot 0's model slots alone, counted once per data slot, give the
    whole (2, 4) decode step's flops, bytes by kind, collectives and
    launches."""
    shape = ShapeSpec("decode_32_b4", "decode", 32, 4)
    kw = dict(shape=shape, mesh=((2, 4), ("data", "model")), smoke=True, detail=False)
    short = dryrun.run_cell("qwen3-4b", shape.name, symmetric=True, **kw)
    full = dryrun.run_cell("qwen3-4b", shape.name, symmetric=False, **kw)
    assert short["symmetric_data_slots"] and not full["symmetric_data_slots"]
    assert short["placement"] == full["placement"] == "mesh"
    keys = ("dot_flops", "bytes_accessed", "bytes_by_kind", "collectives", "collective_counts",
            "launches")
    assert {k: short["hlo"][k] for k in keys} == {k: full["hlo"][k] for k in keys}
    assert short["hlo"]["computing_devices"] == full["hlo"]["computing_devices"] == 8
    assert short["memory"]["simulated_slots"] == 4 and full["memory"]["simulated_slots"] == 8


@pytest.mark.parametrize("arch, kind, placement",
                         [("qwen3-4b", "decode", "mesh"), ("zamba2-7b", "decode", "mesh"),
                          ("whisper-large-v3", "decode", "mesh"), ("xlstm-350m", "decode", "mesh"),
                          ("zamba2-7b", "prefill", "mesh")])
def test_a_gathered_cell_is_labelled_one_device(arch, kind, placement, monkeypatch):
    """Every family's decode cell (the transformer's, the hybrid's, the
    enc-dec model's and the xLSTM's) and the hybrid's prefill cell say they
    ran over the mesh, and none gathers the placed state onto one slot: the
    dry run has no one-device step left."""
    calls = []
    real = sharding.gather
    monkeypatch.setattr(sharding, "gather", lambda *a, **k: calls.append(1) or real(*a, **k))
    shape = ShapeSpec(f"{kind}_32_b4", kind, 32, 4)
    rec = dryrun.run_cell(arch, shape.name, shape=shape, mesh=((2, 2), ("data", "model")),
                          smoke=True, detail=False)
    assert rec["placement"] == placement == "mesh"
    assert not calls
