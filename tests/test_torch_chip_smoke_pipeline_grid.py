"""chip_smoke.py's phase 27 (the planner's pipeline stages over each pod's
data and model slots), run here on a (2, 2, 2) mesh of CPU slots at the
smoke config in float32, and three planted faults, each of which the phase
must refuse: a hand-off sent to the wrong model slot, a slot that reads a
whole stage weight, and a microbatch whose rows are split one row off."""

from __future__ import annotations

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import collectives  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.pipeline import runtime  # noqa: E402

RUNS = chip_smoke.PIPELINE_GRID_RUNS
# (a) past the flash gate (S = 1536), one row a data slot in 2 microbatches;
# (b) and (c) short
SMOKE_RUNS = {"full": dict(RUNS["full"], dtype="float32", batch=4, seq=1536, microbatches=2),
              "pair": dict(RUNS["pair"], layers=None, seq=64),
              "smoke": dict(RUNS["smoke"], seq=64)}
# the kernel pass alone, for the planted faults
FAULT_RUN = dict(RUNS["full"], dtype="float32", batch=4, seq=64, microbatches=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counters():
    from repro_torch.kernels import decode_attention, flash_attention, mamba2_ssd, rmsnorm

    return [rmsnorm.rmsnorm, rmsnorm.rmsnorm_residual, flash_attention.flash_attention,
            decode_attention.decode_attention, mamba2_ssd.ssd_intra_chunk]


def test_pipeline_grid_phase_passes_on_cpu_slots(tmp_path):
    out = chip_smoke.pipeline_grid_phase(torch, _counters(), "cpu", device="cpu",
                                         runs=SMOKE_RUNS, smoke=True, work=tmp_path / "ref")
    a, b, c = out["full"], out["pair"], out["smoke_cpu_vs_card"]
    assert a["plan"]["stage_sizes"] == [1, 2] and a["plan"]["pods"] == [1, 0]
    assert a["loss_err"] <= chip_smoke.PIPELINE_LOSS_TOL
    # each model slot sends its block of the positions (1536 / 2: the block
    # edges are sequence-parallel)
    assert a["ppermute"] == [1 * 2 * 2, 1 * 2 * 2 * 2 * 1 * (1536 // 2) * 128 * 4]
    assert a["collectives"]["ppermute"] == a["ppermute"]
    kp = a["kernel_pass"]
    assert kp["flash_heads"] == [(4, 1)]                   # 8 / 2 query heads, 2 / 2 K/V
    assert kp["sends_checked"] == 1 * 2 * 2 * 2 and kp["rows_checked"] == 2 * 2 * 2
    assert kp["kernel_vs_plain_max_err"]["flash_attention"] is not None
    assert 0 < kp["largest_param_read"]
    assert all(x["ok"] for x in kp["logits"]) and len(kp["logits"]) == 2 * 2
    assert b["worst_leaf"][1] <= chip_smoke.F32_PAIR_REL and b["loss_rel_err"] <= 1e-5
    assert c["loss_err"] <= chip_smoke.PIPELINE_SMOKE_TOL
    assert c["grad_err"] <= chip_smoke.PIPELINE_SMOKE_TOL
    assert sorted(out["by_path"]) == ["pipeline grid kernel pass", "pipeline grid plan",
                                      "pipeline grid train"]


def test_the_full_configs_launches_and_hand_offs_are_derived():
    """qwen3-4b at full width on (2, 2, 2), planned (12, 24): RMSNorm
    2 x 36 x 4 x 2 x 2 and flash 36 x 4 x 2 x 2 launches, all at 16 / 4
    heads; (2 - 1) x 4 hand-offs a data slot, each of 2 sends of one row's
    block of 2,048 / 2 positions x 2,560 bf16 (sequence-parallel edges)."""
    cfg = get_config("qwen3-4b")
    pl = chip_smoke.grid_plan(cfg, RUNS["full"], "cpu")
    assert (tuple(pl.stage_sizes), tuple(pl.mapping.alloc)) == ((12, 24), (1, 0))
    want = chip_smoke.grid_launches(cfg, pl, RUNS["full"])
    assert (want["rmsnorm"], want["flash_attention"]) == (1152, 576)
    assert chip_smoke.flash_heads(cfg, 2) == (16, 4)
    assert chip_smoke.grid_ppermute(cfg, pl, RUNS["full"]) == [8, 8 * 2 * 1024 * 2560 * 2]
    pair = chip_smoke.grid_plan(cfg.replace(n_layers=8), RUNS["pair"], "cpu")
    assert pair.num_stages == 2 and sum(pair.stage_sizes) == 8


def _kernel_pass(tmp_path):
    """Phase 27(a)'s kernel passes at a short length, from the smoke
    weights."""
    run = FAULT_RUN
    cfg, pl, mesh, mask, pipe, whole, batch = chip_smoke.grid_setup(torch, run, "cpu", True,
                                                                    False)
    return lambda: chip_smoke.grid_kernel_pass(torch, _counters(), cfg, pl, run, mask, mesh,
                                               pipe, whole, batch, "cpu")


def test_the_kernel_pass_passes_unplanted(tmp_path):
    out = _kernel_pass(tmp_path)()
    assert out["sends_checked"] == 8 and out["rows_checked"] == 8


def _wrong_model_slot(monkeypatch):
    real = collectives.ppermute
    monkeypatch.setattr(collectives, "ppermute",
                        lambda xs, devices: real(list(xs)[::-1], devices))


def _whole_weight(monkeypatch):
    """Every model slot's view of a stage's MLP is its pod's whole stack
    (the specs of its MLP leaves replicated): model slot 0 computes the
    FFN from the whole weights."""
    real = sharding.param_specs

    def specs(tree, cfg, mesh):
        out = real(tree, cfg, mesh)
        if "layers" in out:
            out["layers"]["mlp"] = {k: sharding.P(*([None] * len(v)))
                                    for k, v in out["layers"]["mlp"].items()}
        return out
    monkeypatch.setattr(sharding, "param_specs", specs)


def _rows_one_off(monkeypatch):
    real = runtime._split_rows
    monkeypatch.setattr(runtime, "_split_rows",
                        lambda x, devices: real(torch.roll(x, 1, dims=0), devices))


@pytest.mark.parametrize("plant, says", [(_wrong_model_slot, "did not receive"),
                                         (_whole_weight, "read more than its block"),
                                         (_rows_one_off, "rows the data slots took")])
def test_the_kernel_pass_refuses_a_planted_fault(tmp_path, monkeypatch, capsys, plant, says):
    run = _kernel_pass(tmp_path)
    plant(monkeypatch)
    with pytest.raises(SystemExit):
        run()
    assert says in capsys.readouterr().err
