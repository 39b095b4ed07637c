"""The port's boundaries: what it imports, and where it runs.

``repro_torch`` imports torch and numpy, never JAX and nothing of the JAX
package ``repro`` (it keeps its own copies of the host modules it needs).
Its entry points run on CUDA unless the caller passes ``device="cpu"``;
without a CUDA device the default raises instead of running on the host.
The dry run (``launch.dryrun.run_cell``, ``run_pipeline_cell`` and
``launch.perf_probe.probe`` on it) is the one exception: its default is
``device="meta"``, because a dry run allocates nothing.
"""
import inspect

import dataclasses
import os
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import core, fleet, sim
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.core import sharded
from repro_torch.core.batched import ProblemBatch, batched_min_period, stack_instances
from repro_torch.fleet import worker_main
from repro_torch.data import ShardedLoader, SyntheticLMDataset
from repro_torch.launch import first_forward_probe, rounding_probe
from repro_torch.launch import collectives, dryrun, perf_probe
from repro_torch.launch.mesh import Mesh, make_mesh, use_mesh
from repro_torch.models import moe, sharding
from repro_torch.models.train import init_optimizer, place_train_state
from repro_torch.launch.serve import plan_serving, serve_pool
from repro_torch.launch.train import train_loop
from repro_torch.models import encdec, get_model, hybrid, ssm, transformer, xlstm
from repro_torch.models.transformer import init_decode_state, params_from_numpy
from repro_torch.pipeline import StragglerMonitor, elastic_replan, replan_stages
from repro_torch.sim import (experiments, failure_thresholds, paper_sim, run_campaign,
                             run_experiment, run_replicated)

_QWEN = get_smoke_config("qwen3-4b")
_ZAMBA = get_smoke_config("zamba2-7b")
_MIXTRAL = get_smoke_config("mixtral-8x7b")
_WHISPER = get_smoke_config("whisper-large-v3")
_XLSTM = get_smoke_config("xlstm-350m")
_WL = core.make_workload([3.0, 1.0, 4.0, 1.0, 5.0], [1.0, 2.0, 3.0, 2.0, 1.0, 1.0])
_PF = core.make_platform([2.0, 5.0, 3.0], 10.0)
_PLAN = core.StagePlan(core.Mapping(((1, 5),), (1,)), 1.0, 1.0, "single", (5,), 5, 0.0)


# a mesh whose slots name the card, built without checking for one (as a
# caller on another host could): every entry point that places or moves a
# tensor onto its slots must raise here
_CARD_MESH = Mesh(("data", "model"), (2, 2), ("cuda",) * 4)
_X = torch.ones((2, 4))


def _under_card_mesh(fn):
    def run():
        with use_mesh(_CARD_MESH):
            return fn()
    return run


def _card_mesh_train_step():
    params = get_model(_QWEN).init(0, "cpu", master=True)
    return place_train_state(params, init_optimizer(params), _QWEN, _CARD_MESH)


def _card_batch():
    """A batch that names the card (its tensors stay on the host, as this
    machine has none): every engine step on it is a device step."""
    pb = stack_instances([(_WL, _PF)], device="cpu")
    return dataclasses.replace(pb, device=torch.device("cuda"))


def _card_worker_error_frame():
    """A subprocess worker on the card whose split scoring fails as the
    calling test's does (the fault is re-created in the child): its solve
    comes back as an error frame of kind ``ScoringDeviceError``, which
    ``SubprocessWorker`` raises as itself."""
    from repro_torch.kernels import build

    try:
        build.load("split_score")
        fault = "launch"
    except RuntimeError:
        fault = "build"
    child = (
        "import sys, torch\n"
        "from repro_torch.kernels import build\n"
        "torch.cuda.is_available = lambda: True\n"
        "def refuse(*args):\n"
        f"    raise RuntimeError('{fault} refused')\n"
        f"if '{fault}' == 'build':\n"
        "    build.load = refuse\n"
        "else:\n"
        "    build.load = lambda name: None\n"
        "    build.launch = refuse\n"
        "from repro_torch.fleet import worker_main\n"
        "sys.exit(worker_main.main(sys.argv[3:]))\n")
    with tempfile.TemporaryDirectory() as d:
        python = pathlib.Path(d) / "python"
        python.write_text(f"#!/bin/sh\nexec {sys.executable} -c \"$CHILD\" \"$@\"\n")
        python.chmod(0o755)
        os.environ["CHILD"] = child
        try:
            worker = fleet.SubprocessWorker(device="cuda", python=str(python))
        finally:
            del os.environ["CHILD"]
        try:
            worker.solve(stack_instances([(_WL, _PF)], device="cpu"), timeout=120.0)
        finally:
            worker.close()


def _straggling():
    """A monitor that flags the plan's one stage (observed far slower than
    predicted), so ``replan_stages`` re-plans."""
    mon = StragglerMonitor(num_stages=1)
    mon.observe([1e9])
    return mon

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|jaxlib|repro|benchmarks)\b"
                       r"|from\s+(jax|jaxlib|repro|benchmarks)\b(?!_))", re.M)


def test_import_and_campaign_load_no_jax_or_reference():
    code = (
        "import sys\n"
        "import repro_torch\n"
        "from repro_torch.sim import run_campaign\n"
        "from repro_torch.sim.paper_sim import run\n"
        "res = run_campaign(['E1', 'I3'], 6, 10, n_pairs=2, n_bounds=3, device='cpu')\n"
        "assert sorted(res) == ['E1', 'I3']\n"
        "for engine in ('fused', 'sharded'):\n"
        "    assert sorted(run_campaign(['E1'], 6, 10, n_pairs=2, n_bounds=3, engine=engine,\n"
        "                               device='cpu')) == ['E1']\n"
        "from repro_torch.launch.serve import serve_pool\n"
        "for arch in ('qwen3-4b', 'zamba2-7b'):\n"
        "    out = serve_pool(arch=arch, n_requests=2, batch=2, prompt_len=3, max_new=2,\n"
        "                     capacity=8, device='cpu')\n"
        "    assert out['all_done']\n"
        "from repro_torch.core import Objective, make_platform, make_workload, plan\n"
        "sp = plan(make_workload([3, 1, 4, 1, 5], [1] * 6), make_platform([2, 5, 3], 10.0),\n"
        "          Objective('period'), mode='auto', device='cpu')\n"
        "assert sp.planner.startswith('auto(')\n"
        "from repro_torch.launch.serve import plan_serving\n"
        "assert plan_serving('qwen3-4b', 4, device='cpu')['feasible']\n"
        "from repro_torch.launch.train import train_loop\n"
        "import contextlib, io, tempfile\n"
        "with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()):\n"
        "    out = train_loop(steps=2, batch=2, seq=16, ckpt_dir=d, ckpt_every=1, device='cpu')\n"
        "    assert out['steps_run'] == 2\n"
        "import torch\n"
        "from repro_torch.models import get_model\n"
        "from repro_torch.models.transformer import prefill\n"
        "from repro_torch.configs import get_smoke_config\n"
        "cfg = get_smoke_config('qwen3-4b')\n"
        "logits, _ = prefill(get_model(cfg).init(0, 'cpu'), torch.ones((1, 8), dtype=torch.int32), cfg)\n"
        "assert logits.shape == (1, 1, cfg.vocab_size)\n"
        "from repro_torch.launch.mesh import make_mesh, use_mesh\n"
        "with use_mesh(make_mesh((2, 2), ('data', 'model'), devices=['cpu'] * 4)):\n"
        "    logits, _ = prefill(get_model(cfg).init(0, 'cpu'), torch.ones((2, 8), dtype=torch.int32), cfg)\n"
        "assert logits.shape == (2, 1, cfg.vocab_size)\n"
        "from repro_torch.launch import dryrun, hlo_analysis, perf_probe\n"
        "rec = dryrun.run_cell('qwen3-4b', 'decode_32k', smoke=True)\n"
        "assert rec['ok'] and rec['device'] == 'meta'\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_no_jax_or_reference(path):
    assert path.exists(), path
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, (path, hits)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _example(name: str, *argv):
    """An example's ``main`` with its default device (the card)."""
    import importlib

    return importlib.import_module(f"repro_torch.examples.{name}").main(list(argv))


@pytest.mark.parametrize("entry", [
    lambda: repro_torch.resolve_device(),
    lambda: repro_torch.resolve_device("cuda"),
    lambda: run_campaign(["E1"], 5, 10, n_pairs=1, n_bounds=2),
    lambda: run_experiment("E1", 5, 10, n_pairs=1, n_bounds=2),
    lambda: ProblemBatch.from_arrays(np.ones((1, 3)), np.ones((1, 4)),
                                     np.ones((1, 2)), 10.0),
    lambda: serve_pool(n_requests=1, batch=1, prompt_len=2, max_new=1),
    lambda: get_model(_QWEN).init(0),
    lambda: init_decode_state(_QWEN, 1, 4),
    lambda: params_from_numpy({"ln_f": np.ones(4)}, _QWEN),
    lambda: serve_pool(arch="zamba2-7b", n_requests=1, batch=1, prompt_len=2, max_new=1),
    lambda: get_model(_ZAMBA).init(0),
    lambda: hybrid.init_decode_state(_ZAMBA, 1, 4),
    lambda: hybrid.params_from_numpy({"ln_f": np.ones(4)}, _ZAMBA),
    lambda: ssm.init_mamba_state(_ZAMBA, 1),
    lambda: rounding_probe.probe("zamba2-7b", seq=8),
    lambda: first_forward_probe.run_sequence(seq=8),
    lambda: first_forward_probe.probe(processes=1, seq=8),
    lambda: core.plan(_WL, _PF, core.Objective("period")),
    lambda: core.plan(_WL, _PF, core.Objective("period"), mode="exact"),
    lambda: core.plan_request(core.PlanRequest(_WL, _PF, core.Objective("latency"))),
    lambda: core.plan_pareto(_WL, _PF, k=2),
    lambda: core.run_heuristic("H2", _WL, _PF, 1.0),
    lambda: core.sp_bi_p(_WL, _PF, 1.0),
    lambda: core.min_period_exhaustive(_WL, _PF),
    lambda: core.heuristics.split_trajectory("H1", _WL, _PF),
    lambda: core.solve("single", _WL, _PF, core.Objective("period")),
    lambda: core.replan_for_straggler(_WL, _PF, _PLAN, [1.0]),
    lambda: core.sweep_heuristic("H5", _WL, _PF, [1.0]),
    lambda: core.sweep_solver("H5", _WL, _PF, [1.0]),
    lambda: core.tradeoff_curves(_WL, _PF, k=2),
    lambda: failure_thresholds(ns=(5,), n_pairs=1),
    lambda: failure_thresholds(ns=(5,), n_pairs=1, engine="scalar"),
    lambda: run_experiment("E1", 5, 10, n_pairs=1, n_bounds=2, engine="scalar"),
    lambda: run_replicated(["E1"], 5, 10, n_pairs=1, replications=2, n_bounds=2),
    lambda: core.plan_pareto_tri(_WL, _PF, k=2),
    lambda: core.plan_with_deal(_WL, _PF),
    lambda: core.solve("deal", _WL, _PF, core.Objective("period")),
    lambda: core.solve("H1-rel", _WL, _PF, core.Objective("latency", bound=2.0)),
    lambda: replan_stages(_WL, _PF, _PLAN, _straggling()),
    lambda: elastic_replan(_WL, _PF, 2),
    lambda: run_campaign(["E1"], 5, 10, n_pairs=1, n_bounds=2, engine="fused"),
    lambda: run_experiment("E1", 5, 10, n_pairs=1, n_bounds=2, engine="sharded"),
    lambda: run_experiment("E1", 5, 10, n_pairs=1, n_bounds=2, engine="auto"),
    lambda: failure_thresholds(ns=(5,), n_pairs=1, engine="fused"),
    lambda: run_replicated(["E1"], 5, 10, n_pairs=1, replications=2, n_bounds=2,
                           engine="sharded"),
    lambda: experiments.auto_engine(5, 10),
    lambda: sharded.default_devices(),
    lambda: sharded.device_count(),
    lambda: stack_instances([(_WL, _PF)]),
    lambda: fleet.ReplanService([(_WL, _PF)]),
    lambda: fleet.ReplanService([(_WL, _PF)], backend="fused"),
    lambda: fleet.subprocess_supervisor(),
    lambda: fleet.SubprocessWorker(),
    lambda: worker_main.main([]),
    lambda: plan_serving("qwen3-4b", 2),
    lambda: serve_pool(n_requests=1, batch=1, prompt_len=2, max_new=1, pods=2, replan=True),
    lambda: transformer.prefill(get_model(_QWEN).init(0), torch.ones((1, 4), dtype=torch.int32),
                                _QWEN),
    lambda: get_model(_QWEN).init(0, master=True),
    lambda: transformer.params_from_numpy({"ln_f": np.ones(4)}, _QWEN, master=True),
    lambda: train_loop(steps=1, batch=1, seq=8),
    lambda: train_loop(arch="zamba2-7b", steps=1, batch=1, seq=8),
    lambda: ShardedLoader(SyntheticLMDataset(16, 8, 1)),
    lambda: get_model(_MIXTRAL).init(0),
    lambda: get_model(get_smoke_config("internvl2-26b")).init(0),
    lambda: get_model(_WHISPER).init(0),
    lambda: get_model(_XLSTM).init(0, master=True),
    lambda: init_decode_state(_MIXTRAL, 1, 4),
    lambda: encdec.init_decode_state(_WHISPER, 1, 4),
    lambda: xlstm.init_decode_state(_XLSTM, 1),
    lambda: xlstm.init_mlstm_state(_XLSTM, 1),
    lambda: xlstm.init_slstm_state(_XLSTM, 1),
    lambda: params_from_numpy({"ln_f": np.ones(4)}, _MIXTRAL),
    lambda: encdec.params_from_numpy({"ln_f": np.ones(4)}, _WHISPER),
    lambda: xlstm.params_from_numpy({"ln_f": np.ones(4)}, _XLSTM, master=True),
    lambda: serve_pool(arch="mixtral-8x7b", n_requests=1, batch=1, prompt_len=2, max_new=1),
    lambda: serve_pool(arch="whisper-large-v3", n_requests=1, batch=1, prompt_len=2,
                       max_new=1),
    lambda: serve_pool(arch="xlstm-350m", n_requests=1, batch=1, prompt_len=2, max_new=1),
    lambda: train_loop(arch="internvl2-26b", steps=1, batch=1, seq=8),
    lambda: train_loop(arch="arctic-480b", steps=1, batch=1, seq=8),
    lambda: make_mesh((4,), ("stage",)),
    lambda: make_mesh((2, 2), ("stage", "data"), devices=["cuda"] * 4),
    lambda: make_mesh((2, 4), ("data", "model")),
    lambda: sharding.place({"w": _X}, {"w": sharding.P("data", None)}, _CARD_MESH),
    lambda: collectives.gather_to([_X, _X], 0, "cuda"),
    lambda: collectives.all_gather([_X, _X], 0, ["cuda"] * 2),
    lambda: collectives.scatter(_X, 0, ["cuda"] * 2),
    lambda: collectives.broadcast(_X, ["cuda"] * 2),
    lambda: collectives.psum([_X, _X], "cuda"),
    lambda: collectives.reduce_scatter([_X, _X], 0, ["cuda"] * 2),
    lambda: ShardedLoader(SyntheticLMDataset(16, 8, 2), mesh=_CARD_MESH),
    _card_mesh_train_step,
    _under_card_mesh(lambda: transformer.prefill(get_model(_QWEN).init(0, "cpu"),
                                                 torch.ones((2, 4), dtype=torch.int32), _QWEN)),
    _under_card_mesh(lambda: get_model(_MIXTRAL).forward(
        get_model(_MIXTRAL).init(0, "cpu"), {"tokens": torch.ones((2, 4), dtype=torch.int32)},
        _MIXTRAL)),
    _under_card_mesh(lambda: moe.moe_ffn(get_model(_MIXTRAL).init(0, "cpu")["layers"]["moe"],
                                         torch.ones((2, 4, _MIXTRAL.d_model)), _MIXTRAL)),
    lambda: dryrun.run_cell("qwen3-4b", "decode_32k", device="cuda", smoke=True),
    lambda: dryrun.run_pipeline_cell("qwen3-4b", device="cuda", smoke=True),
    lambda: perf_probe.probe("qwen3-4b", "decode_32k", device="cuda"),
    lambda: dryrun.make_inputs({}, None, 8),
    lambda: dryrun.pipeline_plan(_QWEN, SHAPES["train_4k"], 2.0),
    lambda: collectives.all_gather([_X, _X], 0, ["cuda"] * 2, grad32=True),
    lambda: _example("quickstart"),
    lambda: _example("replan_straggler"),
    lambda: _example("serve_batched", "--requests", "1", "--batch", "1", "--prompt-len", "2",
                     "--max-new", "1"),
    lambda: _example("train_pipeline", "--steps", "1", "--batch", "1", "--seq", "8"),
    lambda: sim.trajectory("H1", *sim.gen_instance("E1", n=4, p=3, seed=1)),
], ids=["resolve_device", "resolve_device-cuda", "run_campaign",
        "run_experiment", "from_arrays", "serve_pool", "model_init",
        "init_decode_state", "params_from_numpy", "serve_pool-hybrid", "hybrid_init",
        "hybrid_init_decode_state", "hybrid_params_from_numpy", "init_mamba_state",
        "rounding_probe", "first_forward_probe", "first_forward_probe-processes",
        "plan", "plan-exact", "plan_request", "plan_pareto", "run_heuristic", "sp_bi_p",
        "min_period_exhaustive", "split_trajectory", "solve", "replan_for_straggler",
        "sweep_heuristic", "sweep_solver", "tradeoff_curves", "failure_thresholds",
        "failure_thresholds-scalar", "run_experiment-scalar", "run_replicated",
        "plan_pareto_tri", "plan_with_deal", "solve-deal", "solve-H1-rel", "replan_stages",
        "elastic_replan", "run_campaign-fused", "run_experiment-sharded",
        "run_experiment-auto", "failure_thresholds-fused", "run_replicated-sharded",
        "auto_engine", "shard_devices", "shard_device_count", "stack_instances",
        "ReplanService", "ReplanService-fused", "subprocess_supervisor",
        "SubprocessWorker", "worker_main", "plan_serving", "serve_pool-replan", "prefill",
        "model_init-master", "params_from_numpy-master", "train_loop", "train_loop-hybrid",
        "ShardedLoader", "moe_init", "vlm_init", "encdec_init", "xlstm_init-master",
        "moe_init_decode_state", "encdec_init_decode_state", "xlstm_init_decode_state",
        "init_mlstm_state", "init_slstm_state", "moe_params_from_numpy",
        "encdec_params_from_numpy", "xlstm_params_from_numpy-master", "serve_pool-moe",
        "serve_pool-encdec", "serve_pool-xlstm", "train_loop-vlm", "train_loop-moe",
        "make_mesh", "make_mesh-named-card", "make_mesh-data-model", "place",
        "collectives.gather_to", "collectives.all_gather", "collectives.scatter",
        "collectives.broadcast", "collectives.psum", "collectives.reduce_scatter",
        "ShardedLoader-mesh", "place_train_state", "prefill-mesh", "forward-mesh",
        "moe_ffn-mesh", "run_cell-cuda", "run_pipeline_cell-cuda", "probe-cuda",
        "make_inputs", "pipeline_plan", "collectives.all_gather-grad32", "example-quickstart",
        "example-replan_straggler", "example-serve_batched", "example-train_pipeline",
        "sim.trajectory"])
def test_default_device_without_cuda_raises(entry, monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


@pytest.mark.parametrize("entry", [dryrun.run_cell, dryrun.run_pipeline_cell, perf_probe.probe])
def test_dry_run_defaults_to_meta(entry):
    """The one default that is not ``device=None``: a dry run builds every
    tensor on ``meta`` and allocates nothing, so it needs no card."""
    assert inspect.signature(entry).parameters["device"].default == "meta"


def test_dry_run_runs_without_a_card(monkeypatch):
    _no_cuda(monkeypatch)
    rec = dryrun.run_cell("qwen3-4b", "decode_32k", smoke=True)
    assert rec["ok"] and rec["device"] == "meta" and rec["hlo"]["dot_flops"] > 0


def test_checkpointed_training_default_device_without_cuda_raises(tmp_path, monkeypatch):
    """``train_loop`` with a checkpoint directory raises before it restores
    or writes anything."""
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(steps=2, batch=1, seq=8, ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=1)
    assert not (tmp_path / "ckpt").exists()


def test_paper_sim_default_device_without_cuda_raises(tmp_path, monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_sim.run(tmp_path / "out", ns=(5,), ps=(10,), n_pairs=1, n_bounds=2)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("engine", ["fused", "sharded", "auto"])
def test_paper_sim_engines_default_device_without_cuda_raises(engine, tmp_path,
                                                             monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_sim.run(tmp_path / "out", ns=(5,), ps=(10,), n_pairs=1, n_bounds=2,
                      engine=engine)
    assert not (tmp_path / "out").exists()


def test_fused_engine_modules_load_no_jax_and_report_no_card(monkeypatch):
    """The engines' modules import without JAX (the source scan above covers
    them) and, without a card, say that they can run on the CPU only."""
    from repro_torch.core import fused

    _no_cuda(monkeypatch)
    assert not fused.fused_available() and not sharded.sharded_available()
    assert fused.fused_available("cpu") and sharded.sharded_available("cpu")


def test_scoring_device_block_without_cuda_raises_and_cpu_nests(monkeypatch):
    """A heuristic called with no device inside a CPU block scores on the
    CPU; the default outside any block is CUDA, which raises here."""
    _no_cuda(monkeypatch)
    with core.scoring_device("cpu"):
        assert core.run_heuristic("H5", _WL, _PF, float("inf")).feasible
        with core.scoring_device() as dev:   # None: the enclosing block's device
            assert dev == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with core.scoring_device():
            pass


def test_nested_planner_calls_score_on_the_enclosing_cpu_block(monkeypatch):
    """The deal solver's ``plan_request`` and the ``-rel`` solvers'
    heuristics are called with no device from inside a portfolio job: they
    score on the enclosing block's device (here the CPU), never on a CUDA
    default of their own."""
    from repro_torch.core import heuristics

    _no_cuda(monkeypatch)
    seen = []
    real = heuristics._device_scores

    def record(dev, host, score):
        seen.append(str(dev))
        return real(dev, host, score)

    monkeypatch.setattr(heuristics, "_device_scores", record)
    with core.scoring_device("cpu"):
        rep = core.plan_request(core.auto_request(_WL, _PF, core.Objective("period")))
        assert rep.feasible
    n_outer = len(seen)
    rep = core.plan_request(core.PlanRequest(_WL, _PF, core.Objective("period"),
                                             include=("deal",), allow_groups=True),
                            device="cpu")
    assert rep.chosen.solver == "deal" and rep.chosen.groups is not None
    assert core.plan_pareto_tri(_WL, _PF, k=2, device="cpu").feasible
    assert core.solve("H2-rel", _WL, _PF, core.Objective("latency", bound=2.0),
                      device="cpu").feasible
    assert n_outer > 0 and len(seen) > 2 * n_outer and set(seen) == {"cpu"}


_ON_CARD = [
    lambda: core.plan(_WL, _PF, core.Objective("period"), device="cuda"),
    lambda: core.plan_request(core.auto_request(_WL, _PF, core.Objective("period")),
                              device="cuda"),
    lambda: core.plan_pareto(_WL, _PF, k=2, device="cuda"),
    lambda: core.solve("H5", _WL, _PF, core.Objective("period", bound=100.0), device="cuda"),
    lambda: core.replan_for_straggler(_WL, _PF, _PLAN, [1.0], device="cuda"),
    lambda: run_experiment("E1", 5, 10, n_pairs=1, n_bounds=2, engine="scalar",
                           device="cuda"),
    lambda: failure_thresholds(ns=(5,), n_pairs=1, engine="scalar", device="cuda"),
    lambda: core.plan_pareto_tri(_WL, _PF, k=2, device="cuda"),
    lambda: core.plan_with_deal(_WL, _PF, device="cuda"),
    lambda: core.solve("deal", _WL, _PF, core.Objective("period"), device="cuda"),
    lambda: core.solve("H1-rel", _WL, _PF, core.Objective("latency", bound=2.0),
                       device="cuda"),
    lambda: replan_stages(_WL, _PF, _PLAN, _straggling(), device="cuda"),
    lambda: elastic_replan(_WL, _PF, 3, device="cuda"),
    lambda: batched_min_period(_card_batch()),
    lambda: batched_min_period(_card_batch(), backend="fused"),
    lambda: fleet.ReplanService([(_WL, _PF)], device="cuda"),
    lambda: fleet.ReplanService([(_WL, _PF)], backend="fused", device="cuda"),
    _card_worker_error_frame,
]


@pytest.mark.parametrize("fault", ["build", "launch"])
@pytest.mark.parametrize("entry", _ON_CARD, ids=[
    "plan", "plan_request", "plan_pareto", "solve", "replan_for_straggler",
    "run_experiment-scalar", "failure_thresholds-scalar", "plan_pareto_tri",
    "plan_with_deal", "solve-deal", "solve-H1-rel", "replan_stages", "elastic_replan",
    "batched_min_period", "batched_min_period-fused", "ReplanService",
    "ReplanService-fused", "SubprocessWorker-error-frame"])
def test_scoring_fault_on_the_card_raises(entry, fault, monkeypatch):
    """A CUDA request scores on the card or raises: a split-score kernel that
    does not build, or scoring that fails on the card, is raised out of the
    portfolio and solver runs, never turned into an infeasible candidate
    while the host's solvers answer; out of the batched engines (lockstep
    and fused); and out of the fleet service and a subprocess worker's error
    frame, never turned into a retry, a scalar fallback or a quarantine."""
    from repro_torch.kernels import build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def refuse(*args):
        raise RuntimeError(f"{fault} refused")

    if fault == "build":
        monkeypatch.setattr(build, "load", refuse)
    else:
        monkeypatch.setattr(build, "load", lambda name: None)
        monkeypatch.setattr(build, "launch", refuse)
    with pytest.raises(core.ScoringDeviceError, match="split scoring on cuda failed"):
        entry()


def test_explicit_cpu_device_resolves():
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
