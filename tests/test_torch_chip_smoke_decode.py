"""chip_smoke.py's phase 24 (decode over the mesh, the decode state left
where ``state_specs`` puts it), run here on meshes of CPU slots at the smoke
configs in float32, and three planted faults, each of which the phase must
refuse: a score all-reduce that drops a model slot, a cache-length merge
that drops a data slot's partial, and the new token written by the wrong
data slot."""

from __future__ import annotations

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.launch import collectives  # noqa: E402
from repro_torch.models import attention  # noqa: E402

# the phase's three parts at smoke sizes: (a) qwen3-4b's 2 K/V heads of 16 on
# a 4-way model axis (the cache's head_dim split, 4 columns a slot), in bf16
# with its float32 pair, as on the card, (b) on a
# 2-way axis (one K/V head a slot, the kernel's route), (c) mixtral's 32-slot
# window filled to 45 positions (the ring wrapped) with B = 1 on (4, 2): the
# cache length split over the 4 data slots
SMOKE_RUNS = {
    "cols": dict(chip_smoke.DECODE_RUNS["cols"], batch=4, capacity=64, filled=60, steps=4,
                 mesh=(2, 4)),
    "heads": dict(chip_smoke.DECODE_RUNS["heads"], batch=4, capacity=64, filled=60, steps=4,
                  mesh=(2, 2), dtype="float32"),
    "length": dict(chip_smoke.DECODE_RUNS["length"], layers=3, capacity=32, filled=45, steps=4,
                   mesh=(4, 2), dtype="float32"),
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


def test_decode_phase_passes_on_cpu_slots():
    out = chip_smoke.decode_phase(torch, _counters(), "cpu", device="cpu", runs=SMOKE_RUNS,
                                  smoke=True)
    a, b, c = out["cols"], out["heads"], out["length"]
    assert (a["layout"], b["layout"], c["layout"]) == ("cols", "heads", "heads")
    for r in (b, c):
        assert r["logits"]["max_err"] <= chip_smoke.LOGIT_F32_TOL
        assert r["cache"]["k"]["max_err"] <= 2e-5 and r["cache"]["v"]["max_err"] <= 2e-5
    assert a["logits"]["mean_rel_err"] < 0.05 and a["cache"]["k"]["layer0_max_err"] is not None
    assert a["float32"]["logits"]["max_err"] <= chip_smoke.LOGIT_F32_TOL
    assert a["float32"]["cache_max_err"] <= 2e-5 and a["float32"]["cache_layer0_max_err"] <= 2e-5
    assert "kernel_vs_plain_max_err" not in a
    assert b["kernel_vs_plain_max_err"]["decode_attention"] is not None
    assert c["kernel_vs_plain_max_err"]["decode_attention_lse"] is not None
    assert c["routing"]["tokens"] > 0
    # (a): per layer per data slot, q and k all-gathered, the scores and the
    # output all-reduced, the output columns all-gathered (wo splits heads)
    assert a["collectives"]["all_gather"][0] == 4 * 2 * 3 * 3
    assert sorted(out["by_path"]) == sorted(f"decode {n}{s}" for n in SMOKE_RUNS
                                            for s in ("", " one device"))
    full = chip_smoke.mesh_cfg(chip_smoke.DECODE_RUNS["cols"], use_pallas=True)
    assert chip_smoke.decode_layout_of(full, 16) == "cols"
    assert chip_smoke.decode_layout_of(full, 8) == "heads"
    assert chip_smoke.decode_launches(full, 2, 8, 8, 4096, 8)["decode_attention"] == \
        8 * 36 * 2 * 8
    moe_full = chip_smoke.mesh_cfg(chip_smoke.DECODE_RUNS["length"], use_pallas=True)
    assert chip_smoke.decode_holders(moe_full, 4, 1, 4096) == (1, 4, True)
    assert chip_smoke.decode_launches(moe_full, 4, 8, 1, 4096, 8)["decode_attention"] == \
        8 * 4 * 4 * 8


def _planted_score_psum(monkeypatch):
    real = collectives.psum
    monkeypatch.setattr(collectives, "psum", lambda xs, device: real(
        xs[:-1] if isinstance(device, (list, tuple)) and xs[0].dim() == 4 else xs, device))


def _planted_merge(monkeypatch):
    real = attention.merge_partials
    monkeypatch.setattr(attention, "merge_partials", lambda parts: real(parts[:-1]))


def _planted_writer(monkeypatch):
    real = attention._ring_write

    def wrong(sl, m, k_new, v_new, pos, C, done):
        real(sl._replace(c0=(sl.c0 + sl.k[m].shape[1]) % C), m, k_new, v_new, pos, C, done)
    monkeypatch.setattr(attention, "_ring_write", wrong)


@pytest.mark.parametrize("plant, part", [(_planted_score_psum, "cols"),
                                         (_planted_merge, "length"),
                                         (_planted_writer, "length")],
                         ids=["score-psum-drops-a-slot", "merge-drops-a-data-slot",
                              "token-written-by-the-wrong-data-slot"])
def test_a_planted_fault_is_refused(plant, part, monkeypatch):
    from repro_torch.models import get_model

    plant(monkeypatch)
    run = SMOKE_RUNS[part]
    cfg = chip_smoke.mesh_cfg(run, True, use_pallas=True)
    params = get_model(cfg).init(run["seed"], "cpu")
    with pytest.raises(SystemExit):
        chip_smoke.decode_mesh_run(torch, _counters(), part, run, cfg, params, "cpu")
