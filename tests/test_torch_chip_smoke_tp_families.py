"""chip_smoke.py's phase 25 (the hybrid, enc-dec and xLSTM families over the
model axis), run here on meshes of CPU slots at the smoke configs, and three
planted faults, each of which the phase must refuse: the Mamba2 mixer's
gated RMSNorm over a slot's own columns, the sLSTM's ``r`` re-laid to the
wrong head, and a model-axis sum that drops a slot."""

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
from repro_torch.models import xlstm  # noqa: E402

R = chip_smoke.FAMILY_TP_RUNS
# the phase's four parts at smoke sizes: (a) zamba2-smoke in bf16 (its
# float32 pair the gate) on (1, 4), B = 1, S = 1536, past the flash gate: 2
# of 8 SSM heads and 1 of 4 attention heads a slot; (b) whisper-smoke on (1,
# 8): the head_dim split, each attention whole on slot 0; (c) xlstm-smoke on
# (1, 8), S = 96: half an mLSTM head a slot (at S = 64 a (B S, d) product
# would have the sLSTM out's (d, d) shape, which the guard reads as a whole
# weight); (d) the step on (2, 4), cut to one group
SMOKE_RUNS = {
    "hybrid": dict(R["hybrid"], seq=1536, mesh=(1, 4)),
    "encdec": dict(R["encdec"], seq=64, mesh=(1, 8), dtype="float32"),
    "xlstm": dict(R["xlstm"], seq=96, mesh=(1, 8)),
    "train": dict(R["train"], layers=2, seq=64, dtype="float32"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other rehearsal files use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counters():
    from repro_torch.kernels import decode_attention, flash_attention, mamba2_ssd, rmsnorm

    return [rmsnorm.rmsnorm, rmsnorm.rmsnorm_residual, flash_attention.flash_attention,
            decode_attention.decode_attention, mamba2_ssd.ssd_intra_chunk]


def test_family_tp_phase_passes_on_cpu_slots():
    out = chip_smoke.family_tp_phase(torch, _counters(), "cpu", device="cpu", runs=SMOKE_RUNS,
                                     smoke=True)
    a, b, c, d = out["hybrid"], out["encdec"], out["xlstm"], out["train"]
    for r in (a, b, c):
        assert r["logits"]["ok"] and r["logits"]["mean_rel_err"] <= chip_smoke.F32_PAIR_REL
    assert a["bf16_logits"] is not None and a["bf16_one_device_from_float32"] is not None
    assert a["flash_heads"] == [(1, 1)] and a["ssd_heads"] == [2]
    assert a["kernel_vs_plain_max_err"]["ssd_intra_chunk"] is not None
    assert a["exceptions"] == [] and b["exceptions"] == ["enc/attn/", "dec/self_attn/",
                                                         "dec/cross_attn/"]
    assert c["exceptions"] == ["slstm/r"]
    assert c["slstm_layer_collectives"] == {"gather": 2, "scatter": 1, "psum": 2}
    assert d["loss_err"] <= 1e-5 and d["param_max_err"] <= chip_smoke.MESH_TRAIN_TOL
    assert d["float32"]["replicated_moment_max_rel_err"] <= 1e-4
    assert sorted(out["by_path"]) == ["tp family encdec", "tp family hybrid", "tp family train",
                                      "tp family xlstm"]
    # the full-width runs' figures, derived from param_specs
    za = chip_smoke.mesh_cfg(R["hybrid"], use_pallas=True)
    want = chip_smoke.family_tp_launches(za, 1, 16, R["hybrid"]["seq"])
    assert (want["ssd_intra_chunk"], want["flash_attention"]) == (84 * 16, 14 * 16)
    assert chip_smoke.ssd_heads(za, 16) == 7 and chip_smoke.flash_heads(za, 16) == (2, 2)
    assert chip_smoke.family_tp_exceptions(za, 16) == ()
    assert chip_smoke.family_tp_exceptions(get_config("whisper-large-v3"), 16) == \
        ("enc/attn/", "dec/self_attn/", "dec/cross_attn/")
    xl = get_config("xlstm-350m")
    assert chip_smoke.slstm_layer_calls(xl, 16) == {"gather": 2, "scatter": 1, "psum": 2}
    assert chip_smoke.family_tp_exceptions(xl, 16) == ("slstm/r",)


def _planted_norm_own_columns(monkeypatch):
    real = collectives.psum

    def planted(xs, device):
        if sys._getframe(1).f_code.co_name == "_gated_norm_row":
            return [x * len(xs) for x in xs]
        return real(xs, device)
    monkeypatch.setattr(collectives, "psum", planted)


def _planted_r_wrong_head(monkeypatch):
    real = xlstm.whole_r
    monkeypatch.setattr(xlstm, "whole_r",
                        lambda leaves, dim, device: torch.roll(real(leaves, dim, device), 1, 0))


def _planted_psum_drops_a_slot(monkeypatch):
    real = collectives.psum
    monkeypatch.setattr(collectives, "psum", lambda xs, device: real(
        xs[:-1] if isinstance(device, (list, tuple)) and len(xs) > 2 else xs, device))


@pytest.mark.parametrize("plant, part", [(_planted_norm_own_columns, "hybrid"),
                                         (_planted_r_wrong_head, "xlstm"),
                                         (_planted_psum_drops_a_slot, "encdec")],
                         ids=["gated-norm-own-columns", "slstm-r-wrong-head",
                              "psum-drops-a-slot"])
def test_a_planted_fault_is_refused(plant, part, monkeypatch):
    plant(monkeypatch)
    with pytest.raises(SystemExit):
        chip_smoke.family_tp_forward_run(torch, _counters(), SMOKE_RUNS[part], "cpu", smoke=True)
