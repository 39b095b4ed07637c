"""Decode over the mesh for the hybrid, enc-dec and xLSTM families
(``repro_torch.models``: ``hybrid.decode_slots`` with ``ssm.mamba2_decode_row``,
``encdec.decode_slots`` with ``attention.cross_attention_row``,
``xlstm.decode_slots`` with ``mlstm_decode_row`` / ``slstm_decode_row``,
``sharding.StateBlocks`` keyed by path) against the JAX reference's
``decode_step``, on meshes of CPU slots at the smoke configs in float32.

Every case starts from a random state drawn from a seed with numpy, the same
in both packages: K/V with the ring filled to 40 positions (``pos`` and the
positions to match), random conv windows, SSM states, mLSTM ``C`` and ``n``,
sLSTM ``c``, ``n`` (positive), ``m`` and ``h``, and random cross K/V (a zero
or fresh state would hide a fault in reading the old one); 4 steps, so that
the conv window turns over.  The layouts are ``state_specs``'s: zamba2-smoke
(8 SSM heads of 32, N 16) splits its SSM state over the head dim P on a
4-way model axis, over the heads once ``ssm_head_dim`` 8 makes them the
largest dim (the full config's split), and its attention's head_dim on an
8-way one; a batch of one splits the K/V cache length (and whisper's 48
frames) over the data slots and replicates the Mamba states over them;
xlstm-smoke at a batch of 2 splits the group axis over ``data`` (the
reference's rule takes the first dim whose size is the batch).

Bounds: logits within 1e-4 and each float state leaf within 2e-5 of the
reference's, as ``tests/test_torch_decode_mesh.py``; a recurrent leaf's
bound is relative to its largest value (the SSM state grows to ~34 over the
4 steps from its random start, and 2e-5 of that is the same float32
rounding); positions and ``pos`` exact.  Planted faults (the gated norm's
sum of squares dropping a model slot, the conv window written to the next
model slot's block, an update applied once per replica of a replicated
block, the mLSTM ``den`` all-reduce dropping a slot, the xLSTM's ``ml.n``
shadowed by ``sl.n``) each break a case.
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

from repro_torch.configs import get_smoke_config
from repro_torch.launch import collectives
from repro_torch.launch.mesh import make_mesh, use_mesh
from repro_torch.models import attention, encdec, get_model, hybrid, sharding, ssm, xlstm

LOGIT_TOL, STATE_TOL = 1e-4, 2e-5
STEPS, CAPACITY, FILLED = 4, 64, 40
# name -> (arch, rows, config overrides)
SETUPS = {"hybrid": ("zamba2-7b", 4, {}), "hybrid-h": ("zamba2-7b", 4, {"ssm_head_dim": 8}),
          "hybrid-b1": ("zamba2-7b", 1, {}), "whisper": ("whisper-large-v3", 4, {}),
          "whisper-b1": ("whisper-large-v3", 1, {}), "xlstm": ("xlstm-350m", 4, {}),
          "xlstm-b2": ("xlstm-350m", 2, {})}
MODULES = {"hybrid": hybrid, "encdec": encdec, "xlstm": xlstm}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other mesh test files use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * int(np.prod(shape)))


def _leaves(state) -> dict:
    out = {}
    sharding._map_with_path(lambda p, x: out.__setitem__("/".join(p), x), state)
    return out


def random_state(api, B: int, seed: int) -> dict:
    """Path -> numpy array of a random decode state of ``api``'s shapes."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, x in _leaves(api.init_decode_state(B, CAPACITY, "cpu")).items():
        name = path.split("/")[-1]
        if name == "pos":
            out[path] = np.full(tuple(x.shape), FILLED, np.int32)
        elif name == "positions":
            slot = np.arange(x.shape[-1])
            p = (FILLED - 1) - (FILLED - 1 - slot) % x.shape[-1]
            out[path] = np.broadcast_to(np.where(p >= 0, p, -1), tuple(x.shape)).astype(np.int32)
        elif path == "sl/n":
            out[path] = (rng.random(tuple(x.shape)) + 0.5).astype(np.float32)
        else:
            out[path] = (rng.normal(size=tuple(x.shape)) * 0.5).astype(np.float32)
    return out


def _setup(name):
    arch, B, over = SETUPS[name]
    kw = dict(dtype="float32", **over)
    cfg, jcfg = get_smoke_config(arch).replace(**kw), j_get_smoke_config(arch).replace(**kw)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = MODULES[cfg.family].params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                                    device="cpu")
    api = get_model(cfg)
    state = random_state(api, B, 7)
    toks = np.random.default_rng(8).integers(1, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    return cfg, jcfg, jparams, tparams, state, toks


@pytest.fixture(scope="module")
def references():
    """Per setup: the reference's ``STEPS`` jitted decode steps from the
    random state: each step's logits and the final state's leaves."""
    out = {}
    for name, (arch, B, _) in SETUPS.items():
        cfg, jcfg, jparams, _, state, toks = _setup(name)
        jstate = j_get_model(jcfg).init_decode_state(B, CAPACITY)
        flat, tree = jax.tree_util.tree_flatten(jstate)
        arrays = list(state.values())
        assert [a.shape for a in flat] == [a.shape for a in arrays]
        jstate = jax.tree_util.tree_unflatten(tree, [jnp.asarray(a) for a in arrays])
        dec = jax.jit(j_get_model(jcfg).decode)
        logits = []
        for t in range(STEPS):
            lg, jstate = dec(jparams, jstate, jnp.asarray(toks[:, t:t + 1]))
            logits.append(np.asarray(lg))
        out[name] = (logits, dict(zip(state, (np.asarray(a)
                                              for a in jax.tree_util.tree_leaves(jstate)))))
    return out


def _torch_state(api, state: dict, B: int):
    st = api.init_decode_state(B, CAPACITY, "cpu")
    for path, x in _leaves(st).items():
        x.copy_(torch.from_numpy(np.ascontiguousarray(state[path])))
    return st


def _port_decode(name, shape, place=True, guard=None, pallas=False):
    """The port's ``STEPS`` decode steps over a ``shape`` mesh of CPU slots
    from the random state, placed by ``state_specs`` (or whole; with
    ``pallas`` through the kernels' wrappers); returns (each step's logits,
    the final state's leaves, gathered in the test)."""
    cfg, _, _, tparams, state, toks = _setup(name)
    cfg = cfg.replace(use_pallas=pallas)
    api = get_model(cfg)
    mesh = _mesh(shape)
    B = toks.shape[0]
    st = _torch_state(api, state, B)
    whole = st
    if place:
        st = sharding.place(st, sharding.state_specs(st, cfg, mesh, B), mesh)
    logits = []
    with use_mesh(mesh), (guard(whole) if guard else contextlib.nullcontext()):
        for t in range(STEPS):
            lg, st = api.decode(tparams, st, torch.from_numpy(toks[:, t:t + 1]))
            logits.append(lg.numpy())
    final = sharding.gather(st) if place else st
    return logits, {k: v.numpy() for k, v in _leaves(final).items()}


def _errors(got, want) -> tuple:
    """(logits' max abs error, each float leaf's max error over its largest
    value (at least 1), whether every integer leaf is equal)."""
    lg = max(float(np.abs(g - w).max()) for g, w in zip(got[0], want[0]))
    rel, exact = {}, True
    for k, w in want[1].items():
        g = got[1][k]
        if np.issubdtype(w.dtype, np.integer):
            exact = exact and np.array_equal(g, w)
        else:
            rel[k] = float(np.abs(g - w).max()) / max(1.0, float(np.abs(w).max()))
    return lg, rel, exact


def _ok(errs) -> bool:
    lg, rel, exact = errs
    return lg <= LOGIT_TOL and max(rel.values()) <= STATE_TOL and exact


def _broken(fn) -> bool:
    """Whether the decode under a planted fault raises or misses a bound."""
    try:
        return not _ok(fn())
    except (ValueError, RuntimeError, IndexError, KeyError):
        return True


def _specs(name, shape):
    cfg = _setup(name)[0]
    B = SETUPS[name][1]
    st = get_model(cfg).init_decode_state(B, CAPACITY, "cpu")
    return {k: tuple(v) for k, v in _leaves(sharding.state_specs(st, cfg, _mesh(shape),
                                                                  B)).items()}


CASES = [("hybrid", (2, 4)), ("hybrid-h", (2, 4)), ("hybrid", (1, 8)), ("hybrid-b1", (4, 2)),
         ("whisper", (2, 4)), ("whisper", (1, 8)), ("whisper-b1", (4, 2)), ("xlstm", (2, 4)),
         ("xlstm-b2", (2, 2))]
# each case's layout, read off state_specs: the leaf and the entry it must hold
LAYOUTS = {
    "hybrid-2x4": {"mamba/ssm": (None, None, "data", None, "model", None),
                   "caches/k": (None, "data", None, "model", None)},
    "hybrid-h-2x4": {"mamba/ssm": (None, None, "data", "model", None, None)},
    "hybrid-1x8": {"caches/k": (None, None, None, None, "model"),
                   "mamba/conv": (None, None, None, "model", None)},
    "hybrid-b1-4x2": {"caches/k": (None, None, "data", "model", None),
                      "mamba/ssm": (None, None, None, None, "model", None)},
    "whisper-2x4": {"cross_k": (None, "data", None, "model", None)},
    "whisper-1x8": {"cross_k": (None, None, None, None, "model")},
    "whisper-b1-4x2": {"cross_k": (None, None, "data", "model", None)},
    "xlstm-2x4": {"ml/C": (None, None, "data", None, None, "model"),
                  "ml/n": (None, None, "data", None, "model"), "sl/n": (None, "data", "model")},
    "xlstm-b2-2x2": {"ml/C": ("data", None, None, None, None, "model"),
                     "sl/c": ("data", None, "model")},
}
IDS = [f"{n}-{s[0]}x{s[1]}" for n, s in CASES]


@pytest.mark.parametrize("name, shape", CASES, ids=IDS)
def test_mesh_decode_matches_the_reference(name, shape, references):
    """The reference's 4 decode steps from a random state against the
    port's over the mesh, the state in its ``state_specs`` blocks
    throughout: logits, every state leaf."""
    got = _specs(name, shape)
    for leaf, spec in LAYOUTS[f"{name}-{shape[0]}x{shape[1]}"].items():
        assert got[leaf] == spec, (leaf, got[leaf])
    errs = _errors(_port_decode(name, shape), references[name])
    assert _ok(errs), errs


@pytest.mark.parametrize("name, shape", [("hybrid", (2, 4)), ("xlstm-b2", (2, 2))],
                         ids=["hybrid-2x4", "xlstm-b2-2x2"])
def test_a_whole_state_decodes_in_place_through_its_blocks(name, shape, references):
    """A state that is not placed is read and written through views of the
    blocks ``state_specs`` gives each slot: the same answer, in place."""
    errs = _errors(_port_decode(name, shape, place=False), references[name])
    assert _ok(errs), errs


def test_the_kernel_reads_packed_blocks_of_a_whole_state(references, monkeypatch):
    """A whole state's K/V blocks are strided views of it; the decode
    kernel's wrapper (which on the card takes packed rows only) gets each
    slot's block packed, and the answer is the reference's."""
    from repro_torch.kernels import ops

    real, seen = ops.decode_attention, []

    def packed(q, k, v, *a, **kw):
        seen.append(k.is_contiguous() and v.is_contiguous())
        return real(q, k, v, *a, **kw)
    monkeypatch.setattr(ops, "decode_attention", packed)
    errs = _errors(_port_decode("hybrid", (2, 4), place=False, pallas=True),
                   references["hybrid"])
    assert seen and all(seen) and _ok(errs), errs


def test_independence_follows_the_state_layout():
    """The batch split over the data slots on its batch dim: each data slot
    decodes on its own; a group axis split over ``data`` (xlstm-smoke at a
    batch of 2) or a cache length split (a batch of one): not."""
    want = {("hybrid", (2, 4)): True, ("hybrid-b1", (4, 2)): False, ("whisper", (2, 4)): True,
            ("whisper-b1", (4, 2)): False, ("xlstm", (2, 4)): True, ("xlstm-b2", (2, 2)): False}
    for (name, shape), ind in want.items():
        cfg = _setup(name)[0]
        B = SETUPS[name][1]
        st = get_model(cfg).init_decode_state(B, CAPACITY, "cpu")
        with use_mesh(_mesh(shape)):
            assert get_model(cfg).decode.independent(st, B) == ind, name


# ---------------------------------------------------------------------------
# Planted faults
# ---------------------------------------------------------------------------

def test_a_gated_norm_psum_that_drops_a_model_slot_breaks_the_decode(references, monkeypatch):
    real_norm, real_psum = ssm._gated_norm_row, collectives.psum

    def norm(*a):
        monkeypatch.setattr(collectives, "psum", lambda xs, device: real_psum(xs[:-1], device))
        try:
            return real_norm(*a)
        finally:
            monkeypatch.setattr(collectives, "psum", real_psum)
    monkeypatch.setattr(ssm, "_gated_norm_row", norm)
    assert _broken(lambda: _errors(_port_decode("hybrid-h", (2, 4)), references["hybrid-h"]))


def test_the_conv_window_written_to_the_wrong_block_breaks_the_state(references, monkeypatch):
    real = sharding.StateBlocks.piece

    def piece(self, key, index, j, m, device):
        out = real(self, key, index, j, m, device)
        if key != "conv":
            return out
        other = real(self, key, index, j, (m + 1) % self.mesh.shape["model"], device)
        return out._replace(holders=other.holders)
    monkeypatch.setattr(sharding.StateBlocks, "piece", piece)
    got = _port_decode("hybrid", (2, 4))
    errs = _errors(got, references["hybrid"])
    assert errs[1]["mamba/conv"] > 1e-2 and not _ok(errs)


def test_an_update_applied_once_per_replica_breaks_a_replicated_state(references, monkeypatch):
    """At a batch of one the Mamba states are replicated over the 4 data
    slots, one storage on one device: writing the update into every
    replica (not every distinct storage once) applies it four times."""
    def every_replica(piece, new):
        delta = new - piece.old
        for view in piece.replicas:
            view.add_(delta)
    monkeypatch.setattr(sharding, "write_piece", every_replica)
    errs = _errors(_port_decode("hybrid-b1", (4, 2)), references["hybrid-b1"])
    assert errs[1]["mamba/ssm"] > 1e-2 and not _ok(errs)


def test_an_mlstm_den_psum_that_drops_a_slot_breaks_the_decode(references, monkeypatch):
    real = collectives.psum
    H = _setup("xlstm")[0].n_heads
    monkeypatch.setattr(collectives, "psum", lambda xs, device: real(
        xs[:-1] if xs[0].dim() == 2 and xs[0].shape[-1] == H else xs, device))
    assert _broken(lambda: _errors(_port_decode("xlstm", (2, 4)), references["xlstm"]))


def test_ml_n_shadowed_by_sl_n_breaks_the_decode(references, monkeypatch):
    """Leaves keyed by their last name: the sLSTM's ``n`` stands for the
    mLSTM's."""
    real = sharding.StateBlocks.piece
    monkeypatch.setattr(sharding, "_leaf_key", lambda path: path[-1])
    monkeypatch.setattr(sharding.StateBlocks, "piece", lambda self, key, *a: real(
        self, key.split("/")[-1], *a))
    assert _broken(lambda: _errors(_port_decode("xlstm", (2, 4)), references["xlstm"]))


# ---------------------------------------------------------------------------
# What a slot reads, and no gather
# ---------------------------------------------------------------------------

def _state_guard(mesh, cfg, B, reads):
    """A dispatch mode that records, for every op reading the memory of a
    whole state's leaf, how many elements it read against one slot's block
    of that leaf (views read nothing)."""
    def make(state):
        specs = _leaves(sharding.state_specs(state, cfg, mesh, B))
        spans = []
        for f, x in _leaves(state).items():
            counts = sharding._counts(specs[f], mesh, x.dim())
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


@pytest.mark.parametrize("name, shape", [("hybrid", (2, 4)), ("hybrid-b1", (4, 2)),
                                         ("whisper-b1", (4, 2)), ("xlstm", (2, 4))],
                         ids=["hybrid-2x4", "hybrid-b1-4x2", "whisper-b1-4x2", "xlstm-2x4"])
def test_no_op_reads_more_of_a_state_leaf_than_one_slots_block(name, shape, references):
    """A whole state decoded through its blocks' views: every op that reads
    a state leaf's memory reads at most one slot's block of it, and every
    leaf is read."""
    cfg = _setup(name)[0]
    reads = []
    got = _port_decode(name, shape, place=False,
                       guard=_state_guard(_mesh(shape), cfg, SETUPS[name][1], reads))
    leaves = set(_leaves(get_model(cfg).init_decode_state(1, CAPACITY, "cpu")))
    assert {f for _, f, _, _ in reads} == leaves
    assert [r for r in reads if r[2] > r[3]] == []
    errs = _errors(got, references[name])
    assert _ok(errs), errs


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-large-v3", "xlstm-350m"])
def test_decode_over_the_mesh_never_gathers_the_state_or_the_weights(arch, monkeypatch):
    """``decode_step`` under a mesh never calls ``sharding.gather``, and
    every state block is the placed tensor before and after the step."""
    monkeypatch.setattr(sharding, "gather", lambda *a, **k: pytest.fail("gathered"))
    cfg = get_smoke_config(arch).replace(dtype="float32")
    api = get_model(cfg)
    mesh = _mesh((2, 4))
    params = api.init(3, "cpu")
    state = api.init_decode_state(4, 16, "cpu")
    pparams = sharding.place(params, sharding.param_specs(params, cfg, mesh), mesh)
    pstate = sharding.place(state, sharding.state_specs(state, cfg, mesh, 4), mesh)
    ptrs = [[t.data_ptr() for t in x.shards] for x in _leaves(pstate).values()]
    with use_mesh(mesh):
        for _ in range(2):
            lg, pstate = api.decode(pparams, pstate, torch.ones((4, 1), dtype=torch.int32))
    assert lg.shape == (4, 1, cfg.vocab_size) and bool(lg.isfinite().all())
    assert [[t.data_ptr() for t in x.shards] for x in _leaves(pstate).values()] == ptrs


def test_a_layout_the_decode_cannot_run_raises():
    """No fallback: a Mamba2 decode whose in_proj is not split by columns
    raises rather than gathering the weights."""
    cfg = get_smoke_config("zamba2-7b").replace(dtype="float32")
    with pytest.raises(ValueError, match="in_proj split by columns"):
        ssm.mamba2_decode_row([None, None], {"in_proj": 0, "out_proj": 0}, [None, None], cfg,
                              ["cpu", "cpu"], None, (0, 0), slice(0, 1), 0)


def test_cross_attention_over_frame_slices_merges_to_the_whole():
    """The cross attention's partials over four frame slices, merged by
    their log-sum-exps, equal the attention over every frame."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 4, 16, generator=g)
    k, v = torch.randn(2, 48, 4, 16, generator=g), torch.randn(2, 48, 4, 16, generator=g)
    want = attention._cross_partial(q, k, v, False)
    parts = [attention._cross_partial(q, k[:, s:s + 12], v[:, s:s + 12], True)
             for s in range(0, 48, 12)]
    assert float((attention.merge_partials(parts) - want).abs().max()) <= 1e-6
