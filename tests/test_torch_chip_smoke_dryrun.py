"""chip_smoke.py's phase 22 (the dry run held against a real run), rehearsed
here on CPU slots at the smoke configs, and two planted faults that the
phase must refuse: a dropped op, and a meta route that runs the plain
version.  On the CPU a kernel wrapper runs its plain version, which is
another program than the card's launch, so the rehearsal's real side takes
the card route with the launch stood in for: the wrapper allocates its
result as on the card, computes it with the plain version outside the op
analysis (a launch's work is invisible to the dispatcher), and records the
launch."""

from __future__ import annotations

import pathlib
import sys

import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ops, rmsnorm  # noqa: E402
from repro_torch.kernels.ref import rmsnorm_ref  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402

# the phase's parts at smoke sizes: (a) a prefill of 128 tokens, (b) the
# FSDP step cut to one layer on the (2, 4) mesh, (c) a decode cell on
# pod16x16 and pipelines of 16 x 256 tokens
SMOKE_RUNS = {
    "validate": dict(chip_smoke.DRYRUN_RUNS["validate"], seq=128),
    "mesh": dict(chip_smoke.DRYRUN_RUNS["mesh"], seq=64,
                 overrides=dict(chip_smoke.DRYRUN_RUNS["mesh"]["overrides"], n_layers=1)),
    "production": dict(chip_smoke.DRYRUN_RUNS["production"], shape="decode_32k",
                       pipeline_shape=("train_256", "train", 256, 16)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other rehearsal files use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counters():
    from repro_torch.kernels import decode_attention, flash_attention, mamba2_ssd

    return [rmsnorm.rmsnorm, rmsnorm.rmsnorm_residual, flash_attention.flash_attention,
            decode_attention.decode_attention, mamba2_ssd.ssd_intra_chunk]


@pytest.fixture
def card_route(monkeypatch):
    """RMSNorm's card route on CPU tensors, the launch stood in for; meta
    tensors keep the wrapper's own meta route."""
    wrapper = rmsnorm.rmsnorm

    def on_card(x, scale, *, eps=1e-5):
        if x.device.type != "cpu":
            return wrapper(x, scale, eps=eps)
        out = torch.empty_like(x)
        with _disable_current_modes():
            out.copy_(rmsnorm_ref(x, scale, eps=eps))
        d = x.shape[-1]
        build.note_launch("rmsnorm", *rmsnorm.rmsnorm_cost(x.numel() // d, d, x.element_size()))
        return out

    monkeypatch.setattr(ops, "rmsnorm", on_card)
    return on_card


def _validate():
    return chip_smoke.dryrun_validate(torch, _counters(), SMOKE_RUNS["validate"], "cpu",
                                      smoke=True)


def test_phase_passes_on_cpu_slots(card_route):
    """The whole phase at smoke sizes, (c) in its child processes as on the
    card."""
    out = chip_smoke.dryrun_phase(torch, _counters(), "cpu", device="cpu", runs=SMOKE_RUNS,
                                  smoke=True)
    a, b, c = out["validate"], out["mesh"], out["production"]
    assert a["hlo_equal"] and a["analysis_launches"] == {"rmsnorm": 7}
    assert a["measured_peak_bytes"] is None and a["wall_over_roofline"] > 0
    # tensor-parallel: the zero1 blocks all-gathered over the data axes, the
    # rows broadcast to the model slots, the model slots' sums (reduce-
    # scattered over the positions at the sequence-parallel block edges)
    assert set(b["collectives"]) == {"all_gather", "broadcast", "gather", "psum",
                                     "reduce_scatter", "scatter"}
    assert b["collective_counts"]["psum"] > 0 and not any(b["launches"].values())
    assert set(c) == {"cell", "pipeline 1.0", "pipeline 2.0"}
    for what in ("pipeline 1.0", "pipeline 2.0"):
        assert sum(c[what]["plan"]["stage_sizes"]) == 3
    assert c["cell"]["argument_bytes"] > 0 and c["cell"]["fits"]


def test_dropped_op_fails_validation(card_route, monkeypatch):
    """The meta run's analysis loses one ``mul``: the counts differ."""
    made, dropped = [], []
    init, dispatch = hlo_analysis.OpAnalysis.__init__, hlo_analysis.OpAnalysis.__torch_dispatch__

    def planted_init(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    def planted(self, func, types, args=(), kwargs=None):
        if self is made[-1] and len(made) == 2 and not dropped \
                and func.overloadpacket.__name__ == "mul":     # the meta run, after the real one
            dropped.append(func)
            return func(*args, **(kwargs or {}))
        return dispatch(self, func, types, args, kwargs)

    monkeypatch.setattr(hlo_analysis.OpAnalysis, "__torch_dispatch__", planted)
    monkeypatch.setattr(hlo_analysis.OpAnalysis, "__init__", planted_init)
    with pytest.raises(SystemExit):
        _validate()
    assert dropped


def test_meta_route_running_the_plain_version_fails_validation(card_route, monkeypatch):
    """A meta route that computes the plain RMSNorm (and still records its
    launch) counts another program than the card's."""
    def plain_on_meta(x, scale, *, eps=1e-5):
        if x.device.type == "meta":
            d = x.shape[-1]
            build.note_launch("rmsnorm", *rmsnorm.rmsnorm_cost(x.numel() // d, d,
                                                               x.element_size()))
            return rmsnorm_ref(x, scale, eps=eps)
        return card_route(x, scale, eps=eps)

    monkeypatch.setattr(ops, "rmsnorm", plain_on_meta)
    with pytest.raises(SystemExit):
        _validate()


def test_mesh_part_refuses_differing_collectives(monkeypatch):
    """(b) compares the traffic between slots: a meta run that gathers one
    slot's tensors twice fails it."""
    from repro_torch.launch import collectives

    count, extra = collectives._count, []

    def planted(op, xs):
        count(op, xs)
        if op == "gather" and xs[0].is_meta and not extra:
            extra.append(op)
            count(op, xs)

    monkeypatch.setattr(collectives, "_count", planted)
    with pytest.raises(SystemExit):
        chip_smoke.dryrun_mesh(torch, _counters(), SMOKE_RUNS["mesh"], "cpu", smoke=True)
