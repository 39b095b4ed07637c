"""The port's dry run and perf probe (``repro_torch.launch.dryrun``,
``hlo_analysis``, ``perf_probe.probe``, ``ModelAPI.input_specs``) against
the reference and against real runs on the CPU.

The reference's ``launch/dryrun.py`` and ``launch/perf_probe.py`` set
``XLA_FLAGS`` when imported, so this file never imports them: it recomputes
their formulas from the reference's ``models`` and ``core``, and reads its
``launch/hlo_analysis.py`` (which sets nothing).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, cells, get_config, get_smoke_config
from repro_torch.launch import dryrun, perf_probe
from repro_torch.launch.hlo_analysis import OpAnalysis
from repro_torch.models import get_model
from repro_torch.models.common import ShapeSpec
from repro_torch.optim.tree import tree_leaves

CELLS = [(a, s.name) for a, s, _ in cells(include_skipped=True)]
FAMILIES = ("qwen3-4b", "mixtral-8x7b", "internvl2-26b", "zamba2-7b", "whisper-large-v3",
            "xlstm-350m")
SMALL = {"train": ShapeSpec("train_32", "train", 32, 2),
         "prefill": ShapeSpec("prefill_32", "prefill", 32, 2),
         "decode": ShapeSpec("decode_32", "decode", 32, 2)}
MESHES = {"one-slot": ((1, 1), ("data", "model")), "2x4": ((2, 4), ("data", "model"))}
# what a meta run must count as a real run does
EXACT = ("dot_flops", "bytes_accessed", "bytes_by_kind", "collective_bytes", "collectives",
         "collective_counts", "launches", "peak_bytes")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run gives each worker a share of the
    cores, and these small products lose more to threads than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec_dict(specs: dict) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in specs.items()}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    from repro.configs import SHAPES as RSHAPES, get_config as rget
    from repro.models import get_model as rmodel

    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in rmodel(rget(arch)).input_specs(RSHAPES[shape]).items()}
    assert _spec_dict(get_model(get_config(arch)).input_specs(SHAPES[shape])) == want


@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_trees_match_a_real_init(arch):
    """Parameters (serving and master), AdamW state and decode state built
    on meta: the leaves, shapes and dtypes of a real CPU init, no number
    drawn."""
    from repro_torch.models.train import init_optimizer

    cfg = get_smoke_config(arch)
    api = get_model(cfg)
    for master in (False, True):
        meta, real = api.init(0, "meta", master=master), api.init(0, "cpu", master=master)
        trees = [(meta, real)]
        if master:
            trees.append((init_optimizer(meta), init_optimizer(real)))
        for a, b in trees:
            la, lb = tree_leaves(a), tree_leaves(b)
            assert len(la) == len(lb)
            assert all(x.is_meta for x in la)
            assert [(x.shape, x.dtype) for x in la] == [(y.shape, y.dtype) for y in lb]
    a = tree_leaves(api.init_decode_state(2, 16, device="meta"))
    b = tree_leaves(api.init_decode_state(2, 16, device="cpu"))
    assert [(x.shape, x.dtype) for x in a] == [(y.shape, y.dtype) for y in b]


@pytest.mark.parametrize("arch", sorted({a for a, _ in CELLS}))
def test_model_flops_match_the_reference_formula(arch):
    """``model_flops`` / ``model_flops_6nd`` ``==`` the reference's formula
    (``dryrun.py:147-157``) on the reference's ``workload`` and
    ``active_param_count``."""
    from repro.configs import SHAPES as RSHAPES, get_config as rget
    from repro.models import get_model as rmodel
    from repro.models.common import active_param_count

    rcfg = rget(arch)
    cfg = get_config(arch)
    for name in SHAPES:
        shape = RSHAPES[name]
        B, S = shape.global_batch, shape.seq_len
        unembed = 2.0 * B * (S if shape.kind != "decode" else 1) * rcfg.d_model * rcfg.vocab_size
        fwd = rmodel(rcfg).workload(shape).total_work + unembed
        tokens = B * (S if shape.kind != "decode" else 1)
        want = (float(fwd * (3.0 if shape.kind == "train" else 1.0)),
                float((6.0 if shape.kind == "train" else 2.0) * active_param_count(rcfg)
                      * tokens))
        assert dryrun.model_flops(cfg, get_model(cfg), SHAPES[name]) == want


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", SMALL)
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_analysis_equals_a_real_cpu_run(arch, kind, mesh):
    """The same step on meta and on CPU tensors: every count ``==``, and so
    the memory record."""
    kw = dict(shape=SMALL[kind], mesh=MESHES[mesh], smoke=True)
    meta = dryrun.run_cell(arch, kind, device="meta", **kw)
    real = dryrun.run_cell(arch, kind, device="cpu", **kw)
    assert meta["ok"] and real["ok"]
    assert {k: meta["hlo"][k] for k in EXACT} == {k: real["hlo"][k] for k in EXACT}
    assert meta["memory"] == real["memory"]
    assert meta["hlo"]["dot_flops"] > 0 and meta["hlo"]["bytes_accessed"] > 0
    if mesh == "2x4" and real["placement"] == "mesh":
        assert real["hlo"]["collective_bytes"] > 0


def test_dense_prefill_dot_flops_equal_the_reference_hlo():
    """The smoke qwen3-4b forward: the port's dot flops ``==`` the
    reference's HLO analysis of its jitted forward on one CPU device."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as rsmoke
    from repro.launch.hlo_analysis import analyze
    from repro.models import get_model as rmodel

    rcfg = rsmoke("qwen3-4b")
    rapi = rmodel(rcfg)
    params = jax.eval_shape(rapi.init, jax.random.key(0))
    tokens = jax.ShapeDtypeStruct((2, 64), jnp.int32)
    text = jax.jit(lambda p, t: rapi.forward(p, {"tokens": t}, rcfg)[0]).lower(
        params, tokens).compile().as_text()
    want = analyze(text)["dot_flops"]
    cfg = get_smoke_config("qwen3-4b")
    api = get_model(cfg)
    p = api.init(0, "meta")
    with OpAnalysis() as mode:
        api.forward(p, {"tokens": torch.empty((2, 64), dtype=torch.int32, device="meta")}, cfg)
    got = mode.result()
    assert got["dot_flops"] == want, got["dot_detail"]


@pytest.mark.parametrize("straggler", [1.0, 2.0])
def test_pipeline_plan_equals_the_reference(straggler):
    """qwen3-4b at train_4k over two pods: the port's plan ``==`` the
    reference's ``plan`` on its own inputs (``dryrun.py:193-197``); the
    pipeline cell's record carries the plan it ran."""
    from repro.configs import SHAPES as RSHAPES, get_config as rget
    from repro.core import Objective, Platform, plan
    from repro.models.registry import lm_workload

    rcfg = rget("qwen3-4b")
    speeds = np.array([256 * 197e12 * 0.4, 256 * 197e12 * 0.4 / straggler])
    want = plan(lm_workload(rcfg, RSHAPES["train_4k"]), Platform(speeds, b=25e9),
                Objective("period"), mode="auto")
    got = dryrun.pipeline_plan(get_config("qwen3-4b"), SHAPES["train_4k"], straggler,
                               device="cpu")
    assert (got.planner, tuple(got.stage_sizes), tuple(got.mapping.alloc)) == \
        (want.planner, tuple(want.stage_sizes), tuple(want.mapping.alloc))
    assert (got.period, got.latency, got.padding_overhead) == \
        (want.period, want.latency, want.padding_overhead)
    shape = ShapeSpec("train_64", "train", 64, 8)
    rec = dryrun.run_pipeline_cell("qwen3-4b", 4, straggler, smoke=True, shape=shape)
    small = dryrun.pipeline_plan(get_smoke_config("qwen3-4b"), shape, straggler, device="cpu")
    assert rec["ok"] and rec["plan"]["stage_sizes"] == list(small.stage_sizes)
    assert rec["hlo"]["dot_flops"] > 0 and rec["memory"]["temp_size_in_bytes"] > 0
    # each pod's stage over its (data, model) slots: the hand-offs are
    # ppermutes, one a data slot that takes rows (2 rows a microbatch on 16
    # data slots: data slot 0 alone), each model slot sending its block of
    # the positions (64 / 16), and a slot holds less than the stack
    assert rec["placement"] == "mesh"
    cfg = get_smoke_config("qwen3-4b")
    calls = (len(small.stage_sizes) - 1) * 4
    item = torch.empty((), dtype=cfg.torch_dtype).element_size()
    assert rec["hlo"]["collective_counts"]["ppermute"] == calls
    assert rec["hlo"]["collectives"]["ppermute"] \
        == calls * 16 * 2 * (64 // 16) * cfg.d_model * item
    stack = sum(t.numel() * 4 for t in tree_leaves(
        get_model(cfg).init(0, "meta", master=True)["layers"]))
    assert 0 < rec["memory"]["argument_size_in_bytes"] < stack


def test_probe_round_trips_through_the_planner(capsys):
    """``probe`` -> ``probe_to_workload``: the workload's total work is the
    probe's per-device dot flops times the devices that compute (all 256
    slots of the mesh for a decode step, which runs over the 16 data slots'
    16 model slots each), the analysis' total; the terms are in seconds at
    one H100's peaks."""
    out = perf_probe.probe("qwen3-4b", "decode_32k", top=4)
    printed = capsys.readouterr().out
    assert perf_probe.CARD in printed and "989 TFLOP/s" in printed
    total = out["res"]["dot_flops"] * out["devices"]
    assert out["devices"] == 256 and out["mesh_devices"] == 256 and total > 0
    wl = perf_probe.probe_to_workload(out, "qwen3-4b", "decode_32k")
    assert float(wl.w.sum()) == pytest.approx(total, rel=1e-12)
    assert out["terms"]["compute"] == out["res"]["dot_flops"] / perf_probe.PEAK_FLOPS
    req = perf_probe.probe_to_request(out, "qwen3-4b", "decode_32k", pods=2)
    from repro_torch.core import plan_request

    assert plan_request(req, device="cpu").feasible


def test_record_keeps_the_reference_keys():
    rec = dryrun.run_cell("qwen3-4b", "decode_32k", smoke=True)
    for key in ("arch", "shape", "kind", "mesh", "devices", "seq_len", "global_batch",
                "memory", "hlo", "model_flops", "model_flops_6nd", "ok"):
        assert key in rec, key
    assert rec["mesh"] == "pod16x16" and rec["devices"] == 256
    for key in ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes", "fits"):
        assert key in rec["memory"], key
    for key in ("dot_flops", "bytes_accessed", "bytes_by_kind", "collective_bytes",
                "collectives", "collective_counts", "detail", "launches", "per_device"):
        assert key in rec["hlo"], key


def test_per_device_values_divide_by_the_computing_slots():
    """A prefill over the 16 data slots of pod16x16, each tensor-parallel
    over its 16 model slots: the per-device values are the totals over the
    256 slots that compute; the peak holds data slot 0's 16 model slots
    (the symmetric shortcut)."""
    shape = ShapeSpec("prefill_64_b32", "prefill", 64, 32)
    rec = dryrun.run_cell("qwen3-4b", shape.name, smoke=True, shape=shape, detail=False)
    an = rec["hlo"]
    assert an["devices"] == 256 and an["computing_devices"] == 256
    assert rec["memory"]["computing_slots"] == 256 and rec["memory"]["simulated_slots"] == 16
    for key in ("dot_flops", "bytes_accessed", "collective_bytes"):
        assert an["per_device"][key] == an[key] / 256, key


def test_kernel_meta_routes_record_their_launches():
    """With ``use_pallas`` the meta forward reaches the kernels' meta routes:
    one launch each, with the bytes and operations of the row's bound, and
    no plain version's ops."""
    from repro_torch.kernels.flash_attention import flash_cost
    from repro_torch.kernels.rmsnorm import rmsnorm_cost

    cfg = get_smoke_config("qwen3-4b").replace(use_pallas=True)
    api = get_model(cfg)
    p = api.init(0, "meta")
    S = 2048
    with OpAnalysis() as mode:
        api.forward(p, {"tokens": torch.empty((1, S), dtype=torch.int32, device="meta")}, cfg)
    res = mode.result()
    L = cfg.n_layers
    assert res["launches"] == {"flash_attention": L, "rmsnorm": 2 * L + 1}
    d, es = cfg.d_model, torch.tensor([], dtype=cfg.torch_dtype).element_size()
    assert res["bytes_by_kind"]["rmsnorm"] == (2 * L + 1) * rmsnorm_cost(S, d, es)[0]
    fb, ff = flash_cost(1, S, S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, es, True, None)
    assert res["bytes_by_kind"]["flash_attention"] == L * fb
    # the plain RMSNorm's rsqrt only in qk-norm (2 a layer), none from the layer norms
    assert sum(r[1] for r in res["detail"] if r[2] == "rsqrt") == 2 * L
    assert res["dot_flops"] >= L * ff


def test_cli_records_a_failure_and_lists_cells(tmp_path, capsys):
    dryrun.main(["--list"])
    assert len(capsys.readouterr().out.splitlines()) == len(list(cells()))
    with pytest.raises(KeyError):
        dryrun.main(["--arch", "qwen3-4b", "--shape", "no_such_shape", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen3-4b__no_such_shape__pod16x16.json").read_text())
    assert rec["ok"] is False and rec["error"].startswith("KeyError")
