"""chip_smoke.py's phase 23 (tensor parallelism over the model axis), run
here on meshes of CPU slots at the smoke configs in float32, and three
planted faults, each of which the phase must refuse: a model-axis sum that
drops a slot, a replicated leaf's gradient taken from one model slot M
times, and a vocabulary offset one row off."""

from __future__ import annotations

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.launch import collectives  # noqa: E402
from repro_torch.models import layers, sharding  # noqa: E402

# the phase's three parts at smoke sizes, cut to one layer: (a) qwen3-4b's 8
# heads and 2 K/V heads on a 4-way model axis (the K/V head_dim split) at
# S = 1536, past the flash gate; (b) mixtral's 4 experts on an 8-way axis
# (each expert's ff split); (c) the FSDP step on (2, 4)
SMOKE_RUNS = {
    "prefill": dict(chip_smoke.TP_RUNS["prefill"], layers=1, seq=1536, mesh=(2, 4),
                    dtype="float32"),
    "moe": dict(chip_smoke.TP_RUNS["moe"], layers=1, seq=1536, mesh=(1, 8), dtype="float32"),
    "train": dict(chip_smoke.TP_RUNS["train"], layers=1, seq=64, dtype="float32"),
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


def test_tp_phase_passes_on_cpu_slots():
    out = chip_smoke.tp_phase(torch, _counters(), "cpu", device="cpu", runs=SMOKE_RUNS,
                              smoke=True)
    a, b, c = out["prefill"], out["moe"], out["train"]
    for path in ("prefill", "forward"):
        assert a[f"{path}_logits"]["ok"]
        assert a[f"{path}_logits"]["max_err"] <= chip_smoke.LOGIT_F32_TOL
    assert a["flash_heads"] == [(2, 1)]                 # 8 / 4 query heads, one K/V head
    assert 0 < a["largest_param_read"] <= 512 * 128 // 4
    assert a["kernel_vs_plain_max_err"]["flash_attention"] is not None
    assert b["moe"]["split"] == "expert ff" and b["moe"]["flipped_tokens"] == 0
    assert b["flash_heads"] == [(1, 1)]
    assert c["loss_err"] <= 1e-5 and c["param_max_err"] <= chip_smoke.MESH_TRAIN_TOL
    assert c["replicated_moment_max_rel_err"] <= 1e-4
    assert 0 < c["slot_view_bytes"] < c["slot_peak_bytes"]
    assert sorted(out["by_path"]) == ["tp forward", "tp moe", "tp prefill", "tp train"]
    full = chip_smoke.mesh_cfg(chip_smoke.TP_RUNS["prefill"])
    want = chip_smoke.mesh_launches(full, "forward", 2, 4096, 16)
    assert (want["rmsnorm"], want["flash_attention"]) == (2 * 16 * 73, 2 * 16 * 36)
    assert chip_smoke.flash_heads(full, 16) == (2, 1)
    moe_full = chip_smoke.mesh_cfg(chip_smoke.TP_RUNS["moe"])
    assert chip_smoke.moe_split(moe_full, 16) == "expert ff"


def _planted_psum(monkeypatch):
    real = collectives.psum
    monkeypatch.setattr(collectives, "psum", lambda xs, device: real(
        xs[:-1] if isinstance(device, (list, tuple)) and len(xs) > 2 else xs, device))


def _planted_replicated(monkeypatch):
    real = sharding.reduce_to_placement

    def planted(grads, like):
        if sharding.model_dim(like.spec) is None:
            grads = [[row[0]] * len(row) for row in grads]
        return real(grads, like)
    monkeypatch.setattr(sharding, "reduce_to_placement", planted)


def _planted_offset(monkeypatch):
    monkeypatch.setattr(layers, "vocab_offset", lambda m, block: m * block + 1)


@pytest.mark.parametrize("plant, part", [(_planted_psum, "prefill"),
                                         (_planted_replicated, "train"),
                                         (_planted_offset, "prefill")],
                         ids=["psum-drops-a-slot", "replicated-grad-m-times",
                              "vocab-offset-one-off"])
def test_a_planted_fault_is_refused(plant, part, monkeypatch):
    plant(monkeypatch)
    fn = {"prefill": chip_smoke.tp_prefill_run,
          "train": lambda *a, **k: chip_smoke.mesh_train_run(*a, **k, analysis=True)}[part]
    with pytest.raises(SystemExit):
        fn(torch, _counters(), SMOKE_RUNS[part], "cpu", smoke=True)
