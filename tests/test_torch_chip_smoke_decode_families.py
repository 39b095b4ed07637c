"""chip_smoke.py's phase 26 (decode over the mesh for the hybrid, enc-dec
and xLSTM families, each slot's blocks of a random decode state read and
written in place), run here on meshes of CPU slots at the smoke configs,
and four planted faults, each of which the phase must refuse: the conv
window written to the next model slot's block, an update applied once per
replica of the Mamba states replicated over the data slots (a batch of
one), the sLSTM's recurrent all-reduce dropping a model slot, and an extra
bf16 rounding on the mesh path that only (b)'s bf16 gate can see."""

from __future__ import annotations

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.launch import collectives  # noqa: E402
from repro_torch.models import sharding  # noqa: E402

R = chip_smoke.FAMILY_DECODE_RUNS
# the phase's parts at smoke sizes: (a) zamba2-smoke (5 layers in 3 groups,
# the last padded) on (1, 4): one K/V head a model slot (the kernel's
# route), its SSM state split over the head dim; (b) at B = 1 on (4, 2): the
# cache length over the data slots, the Mamba states replicated over them,
# bf16 (gated against one device rounded as the mesh) and its float32 pair
# (gated), the planted psum fault left out (over two model slots a bf16 add
# of the two partial sums rounds once, as the float32 sum does: no fault);
# (c) whisper-smoke's 4 heads on an 8-way axis:
# the head-dim layout; (d) on a 2-way one: 2 heads a slot, its 2 layers' pos
# split over model; (e) xlstm-smoke on (2, 4)
SMOKE_RUNS = {
    "hybrid": dict(R["hybrid"], capacity=64, filled=60, mesh=(1, 4)),
    "hybrid_b1": dict(R["hybrid_b1"], layers=None, capacity=64, filled=60, mesh=(4, 2),
                      rounding_faults=("merge", "state")),
    "encdec": dict(R["encdec"], capacity=64, filled=60, mesh=(2, 8)),
    "encdec_heads": dict(R["encdec_heads"], capacity=64, filled=60, mesh=(2, 2)),
    "xlstm": dict(R["xlstm"], batch=4, mesh=(2, 4)),
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


def _phase(names):
    return chip_smoke.family_decode_phase(torch, _counters(), "cpu", device="cpu",
                                          runs={n: SMOKE_RUNS[n] for n in names}, smoke=True)


def test_family_decode_phase_passes_on_cpu_slots():
    out = _phase(SMOKE_RUNS)
    a, b, c, d, e = (out[n] for n in SMOKE_RUNS)
    assert (a["layout"], b["layout"], c["layout"], d["layout"]) == ("heads", "heads", "cols",
                                                                    "heads")
    assert a["state_model_dims"]["mamba/ssm"] == 4       # the head dim P
    assert e["state_model_dims"]["ml/C"] == 5            # the value index r
    for r in (a, e):
        assert r["logits"]["mean_rel_err"] <= chip_smoke.F32_PAIR_REL
        assert all(v["gated"] and v["mean_rel_err"] <= 1e-5 for v in r["state"].values())
    assert b["float32"]["logits"]["mean_rel_err"] <= chip_smoke.F32_PAIR_REL
    assert all(v["mean_rel_err"] <= 1e-5 for v in b["float32"]["state"].values())
    for r in (c, d):
        assert r["logits"]["gated"] and r["logits"]["mean_rel_err"] < 0.05
    assert not b["logits"]["gated"]
    assert set(b["float32"]["bf16_mean_rel_err_from_float32"]) == {"one device", "mesh"}
    # (b)'s bf16: the mesh is one device rounded as the mesh rounds, bit for
    # bit in the logits, which each part of that rounding alone moves
    r = b["rounding"]
    assert r["mesh_from_emulated"]["logits"] == 0.0
    assert max(r["mesh_from_emulated"]["state"].values()) <= r["limit"]["state"]
    assert r["emulated_from_one_device"] == r["mesh_from_one_device"]
    assert r["rows_only_from_one_device"]["logits"] > 1e-2
    assert r["slices_only_from_one_device"]["logits"] > 1e-2
    assert min(r[f"planted_{k}_from_emulated"]["logits"] for k in ("merge", "state")) > 1e-2
    # every decode-kernel call held to its plain version: (a) 4 slots x 3
    # groups x 4 steps; (b) with its log-sum-exp on each of the 4 data slots;
    # (d) 2 data x 2 model slots x 2 layers x 4 steps; none in (c) and (e)
    assert a["kernel_vs_plain_max_err"]["decode_attention"] is not None
    assert set(b["kernel_vs_plain_max_err"]) == {"decode_attention", "decode_attention_lse"}
    assert "kernel_vs_plain_max_err" not in c and "kernel_vs_plain_max_err" not in e
    cfg = chip_smoke.mesh_cfg(SMOKE_RUNS["hybrid"], smoke=True, use_pallas=True)
    assert chip_smoke.family_decode_launches(cfg, 1, 4, 4, 64, 4)["decode_attention"] == \
        4 * 3 * 4
    cfg = chip_smoke.mesh_cfg(SMOKE_RUNS["encdec_heads"], smoke=True, use_pallas=True)
    assert chip_smoke.family_decode_launches(cfg, 2, 2, 4, 64, 4)["decode_attention"] == \
        2 * 2 * 2 * 4
    # (a) the guard read every state leaf and at most one slot's block of each
    assert set(a["guard"]["largest_state_read"]) == {
        f"state/{k}" for k in ("caches/k", "caches/v", "caches/pos", "caches/positions",
                               "mamba/conv", "mamba/ssm")}
    assert e["slstm_layer_collectives"] == {"all_gather": 1, "gather": 4, "psum": 3}
    assert sorted(out["by_path"]) == sorted(f"decode family {n}{s}" for n in SMOKE_RUNS
                                            for s in ("", " one device"))


def test_full_width_counts_are_derived_from_the_specs():
    """The phase's expectations at full width: (a) 16 x 14 decode launches a
    step, the SSM state split over heads; (b) the log-sum-exp route on 4 x 4
    slots a group; (e) each sLSTM layer's calls on 16 model slots."""
    a = chip_smoke.mesh_cfg(R["hybrid"], use_pallas=True)
    assert chip_smoke.family_decode_launches(a, 1, 16, 4, 1024, 1)["decode_attention"] == 16 * 14
    assert chip_smoke._state_model_dims(a, 1, 16, 4, 1024)["mamba/ssm"] == 3
    b = chip_smoke.mesh_cfg(R["hybrid_b1"], use_pallas=True)
    assert chip_smoke.family_decode_launches(b, 4, 4, 1, 1024, 1)["decode_attention"] == 2 * 16
    c = chip_smoke.mesh_cfg(R["encdec"], use_pallas=True)
    assert chip_smoke.decode_layout_of(c, 16) == "cols"
    assert chip_smoke.family_decode_launches(c, 2, 16, 4, 448, 1)["decode_attention"] == 0
    e = chip_smoke.mesh_cfg(R["xlstm"])
    assert chip_smoke.slstm_decode_layer_calls(e, 16) == {"all_gather": 1, "gather": 16,
                                                          "psum": 3}


def test_the_phase_refuses_a_conv_window_written_to_the_wrong_block(monkeypatch):
    real = sharding.StateBlocks.piece

    def piece(self, key, index, j, m, device):
        out = real(self, key, index, j, m, device)
        if key != "conv":
            return out
        other = real(self, key, index, j, (m + 1) % self.mesh.shape["model"], device)
        return out._replace(holders=other.holders)
    monkeypatch.setattr(sharding.StateBlocks, "piece", piece)
    with pytest.raises(SystemExit):
        _phase(["hybrid"])


def test_the_phase_refuses_an_update_applied_once_per_replica(monkeypatch):
    def every_replica(piece, new):
        delta = new - piece.old
        for view in piece.replicas:
            view.add_(delta)
    monkeypatch.setattr(sharding, "write_piece", every_replica)
    with pytest.raises(SystemExit):
        _phase(["hybrid_b1"])


def test_the_phase_refuses_an_slstm_recurrence_that_drops_a_model_slot(monkeypatch):
    from repro_torch.models import xlstm

    real_row, real_psum = xlstm.slstm_decode_row, collectives.psum

    def row(*a, **k):
        first = [True]

        def psum(xs, device):
            drop, first[0] = first[0], False      # the layer's first all-reduce: rec
            return real_psum(xs[:-1] if drop else xs, device)
        monkeypatch.setattr(collectives, "psum", psum)
        try:
            return real_row(*a, **k)
        finally:
            monkeypatch.setattr(collectives, "psum", real_psum)
    monkeypatch.setattr(xlstm, "slstm_decode_row", row)
    with pytest.raises(SystemExit):
        _phase(["xlstm"])


def test_the_phase_refuses_an_extra_bf16_rounding_on_the_mesh_path(monkeypatch, capsys):
    """The new conv windows and SSM states rounded to bf16 before they are
    written, in the bf16 run only: the float32 pair cannot see it, (b)'s
    bf16 gate refuses it."""
    from repro_torch.models import hybrid

    real = hybrid.mamba2_decode_row

    def row(ps, dims, hs, *a, **k):
        if hs[0].dtype != torch.bfloat16:
            return real(ps, dims, hs, *a, **k)
        with chip_smoke.rounding_fault(torch, "state", torch.bfloat16):
            return real(ps, dims, hs, *a, **k)
    monkeypatch.setattr(hybrid, "mamba2_decode_row", row)
    with pytest.raises(SystemExit):
        _phase(["hybrid_b1"])
    assert "rounded as the mesh rounds" in capsys.readouterr().err
