"""chip_smoke.py's phase 21 (the mesh's data and model axes in execution,
tensor-parallel over the model axis), run here on meshes of CPU slots at
the smoke configs in float32, and three planted faults, each of which the
phase must refuse: a sequence-parallel slot that ignores its query offset,
an MoE slot that dispatches another slot's rows, and a gradient reduction
that drops a slot."""

from __future__ import annotations

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import attention, moe, sharding  # noqa: E402

# the phase's three parts at smoke sizes, cut to one layer: qwen2.5's 8
# heads on a 5-way model axis go sequence-parallel at S = 2560 (512 queries
# a slot); the mixtral forward passes the flash gate at S = 1536, one MoE
# group on each of 2 data slots
SMOKE_RUNS = {
    "prefill": dict(chip_smoke.MESH_RUNS["prefill"], layers=1, seq=2560, mesh=(2, 5),
                    dtype="float32"),
    "moe": dict(chip_smoke.MESH_RUNS["moe"], layers=1, batch=2, seq=1536, mesh=(2, 2),
                dtype="float32"),
    "train": dict(chip_smoke.MESH_RUNS["train"], layers=1, seq=64, dtype="float32"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: the tier-1 run gives each
    of its workers a share of the cores, and these tests' many small
    products lose far more to oversubscribed threads than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model_counters():
    from repro_torch.kernels import decode_attention, flash_attention, mamba2_ssd, rmsnorm

    return [rmsnorm.rmsnorm, rmsnorm.rmsnorm_residual, flash_attention.flash_attention,
            decode_attention.decode_attention, mamba2_ssd.ssd_intra_chunk]


def _run(part: str) -> dict:
    fn = {"prefill": chip_smoke.mesh_prefill_run, "moe": chip_smoke.mesh_moe_run,
          "train": chip_smoke.mesh_train_run}[part]
    return fn(torch, _model_counters(), SMOKE_RUNS[part], "cpu", smoke=True)


def test_mesh_phase_passes_on_cpu_slots():
    out = chip_smoke.mesh_phase(torch, _model_counters(), "cpu", device="cpu", runs=SMOKE_RUNS,
                                smoke=True)
    cfg = get_smoke_config("qwen2.5-14b")
    a, b, c = out["prefill"], out["moe"], out["train"]
    assert a["logits"]["ok"] and a["logits"]["max_err"] <= chip_smoke.LOGIT_F32_TOL
    assert a["kernel_vs_plain_max_err"]["seq_parallel_attention"] is not None
    assert b["moe"]["layers"] == 1
    assert b["moe"]["groups"] == 2 and b["moe"]["flipped_tokens"] == 0
    assert b["moe"]["dropped_pairs"] > 0            # capacity 1.25 per group drops pairs
    assert c["loss_err"] <= 1e-5 and c["param_max_err"] <= chip_smoke.MESH_TRAIN_TOL
    assert c["moment_rel_err"] <= 1e-4 and c["moment_leaf_max_rel_err"] <= 1e-4
    assert c["bytes_per_slot"] < c["bytes_unsharded"] / 4
    assert sorted(out["by_path"]) == ["mesh moe", "mesh prefill", "mesh train"]
    # per data slot: model slot 0 normalizes before the attention it runs
    # whole (the heads do not divide the model axis), every model slot
    # before its FFN block and at the end
    assert chip_smoke.mesh_launches(cfg, "prefill", 2, 4096, 5)["rmsnorm"] == 2 * (3 + 5 * 4)
    full = chip_smoke.mesh_cfg(chip_smoke.MESH_RUNS["prefill"])
    assert chip_smoke.mesh_launches(full, "prefill", 2, 4096, 16)["rmsnorm"] == 2 * (48 + 16 * 49)
    moe_full = chip_smoke.mesh_cfg(chip_smoke.MESH_RUNS["moe"])
    assert chip_smoke.mesh_launches(moe_full, "forward", 4, 2048, 2) == dict(
        dict.fromkeys(chip_smoke.KERNEL_NAMES, 0), rmsnorm=4 * 2 * 17, flash_attention=4 * 2 * 8)
    assert b["flash_heads"] == [chip_smoke.flash_heads(b_cfg(), 2)]


def b_cfg():
    return chip_smoke.mesh_cfg(SMOKE_RUNS["moe"], smoke=True)


def test_a_seq_parallel_slot_that_ignores_its_offset_is_refused(monkeypatch):
    real = attention._slot_attention
    monkeypatch.setattr(attention, "_slot_attention",
                        lambda q, k, v, q_off, **kw: real(q, k, v, 0, **kw))
    with pytest.raises(SystemExit):
        _run("prefill")


def test_an_moe_slot_that_dispatches_another_slots_rows_is_refused(monkeypatch):
    real = moe.moe_ffn_grid

    def shifted(ps, dims, hs, cfg, n_data, data_slots, **kw):
        return real(ps, dims, hs[1:] + hs[:1], cfg, n_data, data_slots, **kw)

    monkeypatch.setattr(moe, "moe_ffn_grid", shifted)
    with pytest.raises(SystemExit):
        _run("moe")


def test_a_gradient_reduction_that_drops_a_slot_is_refused(monkeypatch):
    real = sharding.reduce_to_placement
    monkeypatch.setattr(sharding, "reduce_to_placement",
                        lambda grads, like, into=None: real(grads[:-1], like, into))
    with pytest.raises(SystemExit):
        _run("train")
