"""The port's examples (``python -m repro_torch.examples.<name>``) on the
CPU against the reference's ``examples/`` run in-process: ``quickstart``
and ``replan_straggler`` print the same lines (stage sizes, allocations,
periods, latencies, the Pareto front, the deal groups), ``==`` but for the
solvers' wall times; ``serve_batched`` reports ``all_done`` and
``train_pipeline`` takes a few steps and learns, each at a size cut for the
CPU.  Also the package surface the reference's benchmark scripts import:
``repro_torch.sim.trajectory``, the batched names of ``repro_torch.core``,
``param_specs`` / ``zero1_specs`` / ``batch_spec`` / ``named`` of
``repro_torch.models``."""

from __future__ import annotations

import pathlib
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ROW = re.compile(r"^(\S+\s+\S+\s+\S+\s+\S+\s+(?:True|False))\s+[\d.]+(.*)$")


def _without_walls(text: str) -> list:
    """The lines with every wall time dropped: ``wall=..`` fields and the
    last column of a plan report's rows."""
    out = []
    for line in text.splitlines():
        line = re.sub(r"wall=\S+", "wall=", line)
        m = _ROW.match(line)
        out.append(m.group(1) + m.group(2) if m else line)
    return out


def _reference(name: str, capsys) -> str:
    capsys.readouterr()
    runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("name", ["quickstart", "replan_straggler"])
def test_planner_examples_print_the_references_plans(name, capsys):
    import importlib

    want = _reference(name, capsys)
    importlib.import_module(f"repro_torch.examples.{name}").main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert "period=" in got and "stages=" in got
    assert _without_walls(got) == _without_walls(want)


def test_serve_batched_finishes_every_request(capsys):
    from repro_torch.examples import serve_batched

    out = serve_batched.main(["--device", "cpu", "--requests", "2", "--batch", "2",
                              "--prompt-len", "4", "--max-new", "4"])
    assert out["all_done"] and out["requests"] == 2
    assert '"all_done": true' in capsys.readouterr().out


def test_train_pipeline_takes_a_few_steps_and_learns(capsys):
    from repro_torch.examples import train_pipeline

    out = train_pipeline.main(["--device", "cpu", "--steps", "20", "--batch", "2",
                               "--seq", "32"])
    assert out["steps_run"] == 20 and out["final_loss"] < out["first_loss"]
    assert '"final_loss"' in capsys.readouterr().out


def test_examples_run_as_modules():
    run = subprocess.run([sys.executable, "-m", "repro_torch.examples.replan_straggler",
                          "--device", "cpu"], capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"})
    assert run.returncode == 0, run.stderr[-2000:]
    assert "re-plan:" in run.stdout


def test_the_package_surface_the_benchmark_scripts_import():
    from repro.core.heuristics import split_trajectory as j_trajectory
    from repro.sim import gen_instance as j_gen_instance

    import repro_torch.core as core
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import batch_spec, named, param_specs, sharding, zero1_specs
    from repro_torch.sim import gen_instance, trajectory

    for name in ("ProblemBatch", "batched_fixed_latency", "batched_min_period",
                 "batched_sp_bi_p", "batched_trajectories", "stack_instances"):
        assert name in core.__all__ and getattr(core, name).__module__ == "repro_torch.core.batched"
    wl, pf = gen_instance("E1", n=8, p=5, seed=3)
    jwl, jpf = j_gen_instance("E1", n=8, p=5, seed=3)
    for code in ("H1", "H2", "H3"):
        assert trajectory(code, wl, pf, device="cpu") == j_trajectory(code, jwl, jpf)
    assert (param_specs, zero1_specs, batch_spec, named) == (
        sharding.param_specs, sharding.zero1_specs, sharding.batch_spec, sharding.named)
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    assert batch_spec(mesh) == ("data",)
    assert np.asarray(trajectory("H1", wl, pf, device="cpu")).shape[1] == 2


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 28, rehearsed on the CPU
# ---------------------------------------------------------------------------

SMOKE_EXAMPLES = {"quickstart": [], "replan_straggler": [],
                  "serve_batched": ["--requests", "2", "--batch", "2", "--prompt-len", "4",
                                    "--max-new", "4"],
                  "train_pipeline": ["--steps", "20", "--batch", "2", "--seq", "32"]}


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def _counters():
    from repro_torch.kernels import decode_attention, flash_attention, mamba2_ssd, rmsnorm

    return [rmsnorm.rmsnorm, rmsnorm.rmsnorm_residual, flash_attention.flash_attention,
            decode_attention.decode_attention, mamba2_ssd.ssd_intra_chunk]


def test_examples_phase_passes_on_the_cpu():
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import split_score

    cs = _chip_smoke()
    out = cs.examples_phase(torch, _counters(), "cpu", device="cpu", examples=SMOKE_EXAMPLES,
                            score_counters=(split_score.score_2way_cuda,
                                            split_score.score_3way_cuda))
    assert set(out["by_path"]) == {f"example {n}" for n in SMOKE_EXAMPLES}
    assert out["serve_batched"]["requests"] == 2
    assert out["serve_batched"]["checked_calls"] == cs.decode_calls(2, 2, 4, 4) * \
        get_smoke_config("qwen3-4b").n_layers
    assert out["train_pipeline"]["final_loss"] < out["train_pipeline"]["first_loss"]


def test_examples_phase_refuses_a_plan_that_differs(monkeypatch):
    cs = _chip_smoke()
    real, calls = cs.run_example, []

    def planted(name, argv):            # the first run (the card's) one period off
        ret, text, wall = real(name, argv)
        calls.append(name)
        return ret, text.replace("period=", "period=1", 1) if len(calls) == 1 else text, wall

    monkeypatch.setattr(cs, "run_example", planted)
    with pytest.raises(SystemExit):
        cs.examples_phase(torch, _counters(), "cpu", device="cpu",
                          examples={"replan_straggler": []})


def test_examples_phase_refuses_a_decode_attention_that_scales_its_output(monkeypatch):
    from repro_torch.kernels import ops

    cs = _chip_smoke()
    real = ops.decode_attention
    monkeypatch.setattr(ops, "decode_attention", lambda *a, **kw: real(*a, **kw) * 1.1)
    with pytest.raises(SystemExit):
        cs.examples_phase(torch, _counters(), "cpu", device="cpu",
                          examples={"serve_batched": SMOKE_EXAMPLES["serve_batched"]})
