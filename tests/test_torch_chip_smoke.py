"""chip_smoke.py's diagnosis of a cpu-vs-card forward that parts, run here
with both sides on the CPU: a fault planted in one weight of the second
copy is named, and so is the first layer whose residual stream it moves."""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


@pytest.mark.parametrize("fault", [None, ("mlp", "wo", 1)])
def test_diagnose_forward_names_the_faulty_weight_and_layer(fault):
    cfg = get_smoke_config("qwen3-4b").replace(dtype="float32", use_pallas=True)
    api = get_model(cfg)
    params = api.init(7, "cpu")
    other = _copy(params)
    if fault is not None:
        part, name, layer = fault
        other["layers"][part][name][layer, 3, 5] += 1e-3
    toks = torch.randint(1, cfg.vocab_size, (1, 1536), generator=torch.Generator().manual_seed(8))
    got, _ = api.forward(other, {"tokens": toks}, cfg)
    want, _ = api.forward(params, {"tokens": toks}, cfg)
    diag = chip_smoke.diagnose_forward(torch, api, cfg, params, other, toks, got, want)
    assert diag["card_repeats_bitwise"] and diag["cpu_repeats_bitwise"]
    # the head: each side's logits are its own input's product, to float32 rounding
    assert diag["head_card_vs_f64"] < 1e-5 and diag["head_cpu_vs_f64"] < 1e-5
    assert (diag["head_input_max_err"] == 0.0) == (fault is None)
    # 2 RMSNorms per layer and the final one; one flash call per layer (S > 1024)
    names = [n for n, _ in diag["kernel_vs_plain_max_err"]]
    assert names.count("rmsnorm") == 2 * cfg.n_layers + 1
    assert names.count("flash_attention") == cfg.n_layers
    assert all(e == 0.0 for _, e in diag["kernel_vs_plain_max_err"])
    assert len(diag["layer_max_err"]) == cfg.n_layers
    if fault is None:
        assert diag["params_differing"] == [] and diag["rows_over"] == 0
        assert all(e == 0.0 for e in diag["layer_max_err"])
    else:
        assert diag["params_differing"] == [f"/layers/{part}/{name}"]
        assert diag["rows_over"] > 0
        assert diag["layer_max_err"][:layer] == [0.0] * layer
        assert diag["layer_max_err"][layer] > chip_smoke.LOGIT_F32_TOL


def test_diagnose_forward_follows_the_hybrid_groups_and_the_ssd_kernel():
    """The same diagnosis on zamba2's smoke config: one residual stream per
    group, every SSD call (one per layer, padded ones included) and flash
    call (one per group at S > 1024) against its plain version."""
    from repro_torch.models.hybrid import group_shape

    cfg = get_smoke_config("zamba2-7b").replace(dtype="float32", use_pallas=True)
    api = get_model(cfg)
    params = api.init(7, "cpu")
    other = _copy(params)
    other["mamba_groups"]["in_proj"][1, 0, 3, 5] += 1e-2
    toks = torch.randint(1, cfg.vocab_size, (1, 1536), generator=torch.Generator().manual_seed(8))
    got, _ = api.forward(other, {"tokens": toks}, cfg)
    want, _ = api.forward(params, {"tokens": toks}, cfg)
    diag = chip_smoke.diagnose_forward(torch, api, cfg, params, other, toks, got, want,
                                       chip_smoke.HYBRID_FWD_F32_TOL)
    ng, g, _ = group_shape(cfg)
    names = [n for n, _ in diag["kernel_vs_plain_max_err"]]
    assert names.count("ssd_chunked") == ng * g and names.count("flash_attention") == ng
    assert "rmsnorm" not in names
    assert diag["card_repeats_bitwise"] and diag["params_differing"] == ["/mamba_groups/in_proj"]
    assert len(diag["layer_max_err"]) == ng
    assert diag["layer_max_err"][0] == 0.0 and diag["layer_max_err"][1] > 0.0
    assert diag["rows_over"] > 0


def test_ssd_wrong_answers_are_the_oracle_but_for_their_fault():
    """Without a fault ``ssd_wrong`` is the plain oracle bit for bit; each
    fault moves some output past the limit chip_smoke holds the kernel to."""
    from repro_torch.kernels import ref

    gen = torch.Generator().manual_seed(3)
    B, nc, Q, H, P, N = 1, 2, 64, 3, 16, 16

    def r(*shape):
        return torch.randn(shape, generator=gen) * 0.5

    ins = (r(B, nc, Q, H, P), r(B, nc, Q, H).abs() * 0.1, -r(H).abs() * 0.5,
           r(B, nc, Q, N), r(B, nc, Q, N))
    want = ref.ssd_intra_chunk_ref(*ins)
    same = chip_smoke.ssd_wrong(torch, *ins, exclusive=False, state_decay=True)
    assert all(torch.equal(a, b) for a, b in zip(same, want))
    for kw in (dict(exclusive=True, state_decay=True), dict(exclusive=False, state_decay=False)):
        wrong = chip_smoke.ssd_wrong(torch, *ins, **kw)
        assert any(bool(((a - b).abs() > chip_smoke.SSD_ATOL + chip_smoke.SSD_RTOL * b.abs())
                        .any()) for a, b in zip(wrong, want)), kw


def test_decode_calls_of_the_serve_runs():
    """qwen3-4b: 2 waves x (4 x 63 prompt steps + 32); zamba2-7b: 2 x (4 x 31 + 16)."""
    assert chip_smoke.decode_calls(**chip_smoke.SERVE) == 568
    assert chip_smoke.decode_calls(**chip_smoke.HYBRID_SERVE) == 280


@pytest.mark.parametrize("fault", [dict(exclusive=True, state_decay=True),
                                   dict(exclusive=False, state_decay=False)])
def test_a_planted_ssd_fault_moves_the_hybrid_far_past_its_limits(fault, monkeypatch):
    """The hybrid's float32 limits of phase 12 sit far below what a faulty
    SSD does to the logits: each wrong answer of ``ssd_wrong``, planted in
    the kernel route, moves the smoke config's logits by more than 1."""
    from repro_torch.kernels import mamba2_ssd

    cfg = get_smoke_config("zamba2-7b").replace(dtype="float32", use_pallas=True)
    api = get_model(cfg)
    params = api.init(7, "cpu")
    toks = torch.randint(1, cfg.vocab_size, (1, 1536), generator=torch.Generator().manual_seed(8))
    good, _ = api.forward(params, {"tokens": toks}, cfg)
    monkeypatch.setattr(mamba2_ssd, "ssd_intra_chunk",
                        lambda *a: chip_smoke.ssd_wrong(torch, *a, **fault))
    bad, _ = api.forward(params, {"tokens": toks}, cfg)
    err = float((bad - good).abs().max())
    assert err > 1.0 > chip_smoke.HYBRID_FULL_FWD_F32_TOL > chip_smoke.HYBRID_FWD_F32_TOL, err


def test_rounding_probe_measures_both_orders():
    from repro_torch.launch.rounding_probe import probe

    out = probe("zamba2-7b", dtype="float32", seq=64, device="cpu")
    assert out["arch"] == "zamba2-7b-smoke" and out["max_abs_logit"] > 0
    for key in ("threads", "ssd_route"):
        assert 0.0 <= out[key]["max"] < 1e-4 and out[key]["mean_rel"] >= 0.0


def test_first_forward_probe_names_the_first_op_that_differs(monkeypatch):
    """The probe's sequence on the CPU: two CPU forwards that repeat bit for
    bit report no differing op; with one weight moved in the first CPU
    forward only, the probe names the first op whose output differs."""
    from repro_torch.launch import first_forward_probe as ffp

    out = ffp.run_sequence(seq=32, device="cpu")
    assert out["cpu_repeats_bitwise"] and out["first_differing_op"] is None
    assert out["max_err_first"] == out["max_err_second"] == 0.0
    assert out["ops"][0] == out["ops"][1] > 100

    real = ffp.get_model

    def moved_once(cfg):  # the first CPU forward (the second call) sees a moved weight
        api, seen = real(cfg), {"calls": 0}

        def fwd(params, batch, c):
            seen["calls"] += 1
            if seen["calls"] == 1:  # the device forward, outside the recorder
                seen["moved"] = _copy(params)
                seen["moved"]["layers"]["mlp"]["wo"][1] += 1e-3
            return api.forward(seen["moved"] if seen["calls"] == 2 else params, batch, c)
        return dataclasses.replace(api, forward=fwd)

    monkeypatch.setattr(ffp, "get_model", moved_once)
    out = ffp.run_sequence(seq=32, device="cpu")
    first = out["first_differing_op"]
    assert not out["cpu_repeats_bitwise"] and first is not None
    assert first["index"] > 0 and first["op"][0] == first["op"][1]
    assert first["num_threads"] == [torch.get_num_threads()] * 2


def test_forward_route_check_refuses_a_flash_call_off_the_bf16_route():
    """Phases 8 and 10 count each route beside the launches: a bf16 forward
    passes only if every flash call took the tensor-core route."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rmsnorm as krn

    counters = [krn.rmsnorm, kfa.flash_attention]
    kfa.flash_attention.routes["tc_bf16"] += 3
    chip_smoke.zero_counters(counters)
    assert chip_smoke.route_counts(counters) == {
        "flash_attention": {"tc_bf16": 0, "cuda_f32": 0}}
    assert kfa.flash_attention.launches == 0 and krn.rmsnorm.launches == 0
    launches = {"flash_attention": 36}
    chip_smoke.check_flash_routes("forward", launches, {
        "flash_attention": {"tc_bf16": 36, "cuda_f32": 0}})
    for routes in ({"tc_bf16": 35, "cuda_f32": 1}, {"tc_bf16": 0, "cuda_f32": 36}):
        with pytest.raises(SystemExit):
            chip_smoke.check_flash_routes("forward", launches, {"flash_attention": routes})


@pytest.mark.parametrize("heads,window,want", [
    ((32, 8, 80), 512, {"mixed": 439, "serve_live": 96, "full": 1024}),
    ((32, 32, 112), None, {"serve_live": 96, "full": 1024})])
def test_decode_inputs_have_their_live_counts_and_bounds(heads, window, want):
    """Phase 7's decode inputs: about 440 live slots per row (qwen3-4b's
    window of 512, every 7th slot empty), the serve runs' 96, a full cache of
    1024; the bound counts the live slots' K/V bytes only."""
    H, K, hd = heads
    gen = torch.Generator().manual_seed(0)
    plans = {kind: chip_smoke.decode_plan(torch, kind, H, K, hd, window, gen, "cpu")
             for kind in chip_smoke.DECODE_INPUTS}
    for kind, live in want.items():
        per_row = plans[kind]["mask"].sum(1)
        assert int(per_row.min()) >= live - 1 and int(per_row.max()) <= live, (kind, per_row)
    B, C = chip_smoke.SERVE["batch"], chip_smoke.SERVE["capacity"]
    for plan in plans.values():
        kv = 2 * 2 * plan["live"] * K * hd
        assert plan["bytes"] == 2 * 2 * B * H * hd + kv + B * C
        assert chip_smoke.bound(plan["bytes"], 4 * hd * H * plan["live"],
                                chip_smoke.BF16_TENSOR_FLOPS_PER_S) == (
            plan["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3, "bytes")
    full, live = plans["full"]["bytes"], plans["serve_live"]["bytes"]
    assert 0.09 < live / full < 0.11  # 96 of 1024 slots
    if window is None:  # zamba2-7b's full cache: 58.7 MB, 17.5 us
        assert abs(chip_smoke.bound(full, 0)[0] - 0.0175) < 1e-4


@pytest.mark.parametrize("nbytes", [4096, 1.03e6, 5.6e6, 1.05e7, 4.2e7, 5.9e7])
def test_cold_ring_keeps_every_call_out_of_l2(nbytes):
    """The calls of one timing touch more than the 50 MB L2 cache, and
    between two uses of one buffer the others touch at least twice the L2."""
    ring = chip_smoke.cold_ring(nbytes)
    assert max(chip_smoke.REPS, ring) * nbytes > 50e6
    assert (ring - 1) * nbytes >= 2 * chip_smoke.L2_BYTES


class _FakeCuda:
    """Just enough of torch.cuda for device_time: the card is 'busy' until
    the sleep's end on a fake clock that the host's enqueueing advances."""

    def __init__(self, host_s_per_call):
        self.now = 0.0
        self.busy_until = 0.0
        self.per_call = host_s_per_call
        self.cuda = self

    def synchronize(self):
        self.now = max(self.now, self.busy_until)

    def _sleep(self, cycles):
        self.busy_until = self.now + cycles / 1e6 * 1e-3  # 1e6 cycles per ms

    def Event(self, enable_timing):
        fake = self

        class Ev:
            def record(self):
                self.t = max(fake.now, fake.busy_until)

            def query(self):
                return fake.now >= self.t

            def synchronize(self):
                fake.synchronize()

            def elapsed_time(self, other):
                return (other.t - self.t) * 1e3 + 0.5  # the calls' device work

        return Ev()

    def call(self):
        self.now += self.per_call


def test_device_time_reports_only_windows_whose_sleep_hid_the_host(monkeypatch):
    fake = _FakeCuda(1e-4)
    monkeypatch.setattr(chip_smoke, "_CYCLES_PER_MS", [1e6])
    monkeypatch.setattr(chip_smoke.time, "perf_counter", lambda: fake.now)
    got = chip_smoke.device_time(fake, fake.call, n=20)
    assert abs(got["host_us"] - 100.0) < 1e-6 and got["ms"] > 0
    # a host that slows down tenfold after the sizing pass outlasts every sleep
    calls = {"n": 0}

    def slowing():
        calls["n"] += 1
        fake.now += 1e-4 if calls["n"] <= 23 else 1e-1
    with pytest.raises(SystemExit):
        chip_smoke.device_time(fake, slowing, n=20)



def _planner_sets():
    from repro_torch.sim import gen_instance_batch

    return (chip_smoke.planner_instances(gen_instance_batch, ("E1", "E3"), 9, 7),
            chip_smoke.planner_instances(gen_instance_batch, ("E2",), 6, 5))


class _ReferenceCore:
    """The JAX package's planner API in the call shape phase 13 uses."""

    def __init__(self):
        import repro.core as ref

        self.ref = ref

    def __getattr__(self, name):
        return getattr(self.ref, name)

    def plan_pareto(self, wl, pf, k, device):
        return self.ref.plan_pareto(wl, pf, k=k)

    def plan(self, wl, pf, objective, mode, device):
        return self.ref.plan(wl, pf, objective, mode=mode)

    def plan_request(self, request, device):
        return self.ref.plan_request(request)


def test_planner_phase_rows_are_the_references_and_a_planted_difference_fails():
    """Phase 13's calls on the CPU give the reference's rows (the same
    instances rebuilt in the JAX package), and the comparison names a
    candidate one ulp off, a moved plan and a missing row."""
    import copy

    import numpy as np

    import repro.core as ref
    from repro_torch import core

    big, small = _planner_sets()
    got = chip_smoke.run_planner(core, big, small, "cpu", k=3)
    assert len(got["pareto_s"]) == len(got["pareto_launches"]) == 2
    assert got["pareto_launches"] == [[0, 0], [0, 0]]   # no kernel on the cpu

    def as_ref(pairs):
        return [(ref.make_workload(wl.w, wl.delta), ref.make_platform(pf.s, pf.b))
                for wl, pf in pairs]

    want = chip_smoke.run_planner(_ReferenceCore(), as_ref(big), as_ref(small), None, k=3)
    n = chip_smoke.compare_planner(got["rows"], want["rows"], "port vs reference")
    assert n > 60 and len(got["rows"]["plan_request"]) == 3
    solvers = {c[0] for rep in got["rows"]["plan_request"] for c in rep["candidates"]}
    assert {"exact", "exact-latency", "dp-speed-ordered", "H4"} <= solvers

    bad = copy.deepcopy(got["rows"])
    cand = bad["plan_pareto"][1]["candidates"][5]
    cand[4] = float(np.nextafter(cand[4], np.inf))
    with pytest.raises(SystemExit):
        chip_smoke.compare_planner(bad, got["rows"], "planted")
    bad = copy.deepcopy(got["rows"])
    bad["plan_period"][0][2] += 1.0
    with pytest.raises(SystemExit):
        chip_smoke.compare_planner(bad, got["rows"], "planted")
    bad = copy.deepcopy(got["rows"])
    bad["plan_request"].pop()
    with pytest.raises(SystemExit):
        chip_smoke.compare_planner(bad, got["rows"], "planted")


def test_planner_phase_checks_pass_on_cpu_and_fail_on_a_planted_fault(monkeypatch):
    """min_period_exhaustive against batched_min_period, and the scalar
    engine's golden CSV, on the CPU; a lockstep result moved one split
    off is refused."""
    import dataclasses

    from repro_torch import core
    from repro_torch.core import batched
    from repro_torch.sim import experiments

    big, _ = _planner_sets()
    chip_smoke.check_min_period(core, batched, big, "cpu")
    chip_smoke.check_scalar_golden(experiments, "cpu")
    real = batched.batched_min_period
    monkeypatch.setattr(batched, "batched_min_period", lambda pb: [
        dataclasses.replace(r, splits=r.splits + 1) for r in real(pb)])
    with pytest.raises(SystemExit):
        chip_smoke.check_min_period(core, batched, big, "cpu")


class _ReferenceReplan:
    """The JAX package's replanning in the call shape phase 14 uses."""

    def __init__(self):
        from repro.pipeline import replan

        self.StragglerMonitor = replan.StragglerMonitor
        self.ref = replan

    def replan_stages(self, wl, pf, current, monitor, device):
        return self.ref.replan_stages(wl, pf, current, monitor)

    def elastic_replan(self, wl, pf, pods, device):
        return self.ref.elastic_replan(wl, pf, pods)


class _ReferenceRelCore(_ReferenceCore):
    """Phase 14's planner calls of the JAX package (device dropped)."""

    def plan_pareto_tri(self, wl, pf, device, **kw):
        return self.ref.plan_pareto_tri(wl, pf, **kw)

    def plan_with_deal(self, wl, pf, objective, device):
        return self.ref.plan_with_deal(wl, pf, objective)


def test_reliability_phase_rows_are_the_references_and_a_planted_difference_fails():
    """Phase 14's calls on the CPU (R1 and R3, n = 9, p = 7, k = 3) give the
    reference's rows on the same seeded instances, each split-scoring call
    counted; the comparison refuses a candidate whose replica groups or
    reliability moved, and a moved deal or replanned plan."""
    import copy

    import numpy as np

    from repro.sim import gen_instance_batch as ref_batch
    from repro_torch import core, pipeline
    from repro_torch.core import heuristics
    from repro_torch.sim import gen_instance_batch

    fams = ("R1", "R3")
    mine = chip_smoke.planner_instances(gen_instance_batch, fams, 9, 7)
    with chip_smoke.counted_scoring(heuristics) as counts:
        got = chip_smoke.run_reliability(core, pipeline, mine, "cpu", k=3,
                                         launches=lambda: list(counts))
    assert heuristics.score_kernels.__name__ == "score_kernels"   # restored
    timed = got["timed"]
    in_timed = [sum(c[i] for kind in timed for c in timed[kind]["launches"]) for i in (0, 1)]
    # the replans' 2-way calls are the only ones outside the timed calls
    assert in_timed[0] < counts[0] and in_timed[1] == counts[1] > 0
    # each -rel solver reruns its heuristic at the same bound: twice plan_pareto's
    assert timed["pareto_tri"]["launches"] == [[2 * a, 2 * b] for a, b in
                                               timed["pareto"]["launches"]]

    theirs = chip_smoke.planner_instances(ref_batch, fams, 9, 7)
    for (wl, pf), (rwl, rpf) in zip(mine, theirs):
        assert pf.fail.tobytes() == rpf.fail.tobytes() and wl.w.tobytes() == rwl.w.tobytes()
    want = chip_smoke.run_reliability(_ReferenceRelCore(), _ReferenceReplan(), theirs, None,
                                      k=3)
    n = chip_smoke.compare_planner(got["rows"], want["rows"], "port vs reference")
    assert n > 100
    rows = got["rows"]
    assert any(g is not None and any(len(x) > 1 for x in g)
               for rep in rows["pareto_tri"] for *_, g, _e, _r in rep["candidates"])
    assert all(r[0] is not None for r in rows["replan"])

    def planted(edit):
        bad = copy.deepcopy(rows)
        edit(bad)
        with pytest.raises(SystemExit):
            chip_smoke.compare_planner(bad, rows, "planted")

    def first_grouped(bad):
        return next(c for c in bad["pareto_tri"][1]["candidates"]
                    if c[7] is not None and len(c[7]) > 1)

    def move_groups(bad):
        cand = first_grouped(bad)
        cand[7] = (cand[7][1], cand[7][0]) + tuple(cand[7][2:])

    def move_reliability(bad):
        cand = first_grouped(bad)
        cand[9] = float(np.nextafter(cand[9], 0.0))

    def move_deal(bad):
        bad["deal"][0][2] = float(np.nextafter(bad["deal"][0][2], np.inf))

    def move_replan(bad):
        bad["replan"][1][0][1] += 1.0

    for edit in (move_groups, move_reliability, move_deal, move_replan):
        planted(edit)


def test_fused_phase_helpers_pass_on_cpu_and_refuse_a_planted_difference(tmp_path):
    """Phase 15's helpers at a small size on the CPU: the fused campaign
    equals the batched one with its counters read; the fused, sharded and
    lockstep rows of stacked instances are equal; a curve moved one ulp, a
    threshold moved, and a golden file one byte off are refused."""
    import copy

    import numpy as np

    from repro_torch.core import batched, fused, sharded
    from repro_torch.kernels import split_score
    from repro_torch.sim import gen_instance_batch, paper_sim, run_campaign

    engines = (fused, sharded)
    fused.release_programs()      # programs an earlier test left count no capture
    kw = dict(n=12, p=10, n_pairs=2, n_bounds=4, h4_iters=4)
    want = chip_smoke.fused_campaign(torch, run_campaign, split_score, engines, "batched",
                                     "cpu", **kw)
    got = chip_smoke.fused_campaign(torch, run_campaign, split_score, engines, "fused",
                                    "cpu", **kw)
    assert want["replays"] == want["polls"] == want["captures"] == 0
    assert got["replays"] > 0 and got["polls"] > 0 and got["captures"] >= 2
    assert got["launches"] == {"score_2way_f64": 0, "score_3way_f64": 0}   # no card
    chip_smoke.compare_campaigns(got["result"], want["result"], "cpu")
    bad = copy.deepcopy(got["result"])
    mp = bad["E2"].curves["H3"][0]
    i = int(np.flatnonzero(np.isfinite(mp))[0])
    mp[i] = np.nextafter(mp[i], np.inf)
    with pytest.raises(SystemExit):
        chip_smoke.compare_campaigns(bad, want["result"], "planted")
    bad = copy.deepcopy(got["result"])
    bad["E4"].thresholds["H1"] = (0.0, 0.0)
    with pytest.raises(SystemExit):
        chip_smoke.compare_campaigns(bad, want["result"], "planted")

    parts = [gen_instance_batch(e, 14, 12, [1234, 1235]) for e in chip_smoke.FAMILIES]
    arrays = [np.concatenate([getattr(b, f) for b in parts])
              for f in ("w", "delta", "s", "prefix", "order")]
    lock = chip_smoke.engine_rows(batched, arrays, parts[0].b, "cpu", "lockstep")
    assert chip_smoke.engine_rows(batched, arrays, parts[0].b, "cpu", "fused") == lock
    with sharded.use_devices(["cpu", "cpu"]):
        assert chip_smoke.engine_rows(batched, arrays, parts[0].b, "cpu", "sharded") == lock
    assert any(not r[4] for r in lock[2]) and any(r[4] for r in lock[2])  # H4 both ways

    res = paper_sim.run(tmp_path, families="all", ns=(5,), ps=(10,), n_pairs=3, n_bounds=4,
                        engine="fused", device="cpu")
    chip_smoke.check_golden(res, tmp_path, "fused golden")
    f = tmp_path / "curves_E1_n5_p10.csv"
    f.write_bytes(f.read_bytes()[:-1] + b"?")
    with pytest.raises(SystemExit):
        chip_smoke.check_golden(res, tmp_path, "planted")


def test_fleet_phase_passes_on_cpu_and_refuses_a_planted_digest(tmp_path):
    """Phase 16 at a small size on the CPU (fleet_bench's QUICK trace as the
    standard one, a 64-instance full-size stand-in, one injected kill),
    against digests re-derived from a live reference run: every run, the
    crash/restart and the subprocess workers pass; a digest one character
    off is refused."""
    import repro.core as R
    import repro.fleet as RF
    from repro_torch.core import fused
    from repro_torch.kernels import split_score

    fused.release_programs()      # programs an earlier test left count no capture
    quick = dict(n_groups=6, replicas=8, n=8, p=4, fleet_seed=2007, num_ticks=12,
                 trace_seed=42, burst_prob=0.6)
    digests = {}
    for label, chaos in (("standard", False), ("chaos", True)):
        pairs, trace = chip_smoke.fleet_fixture(RF, R, quick, chaos)
        ref = RF.ReplanService(pairs, **({"reliability_floor": 0.98} if chaos else {}))
        ref.run_trace(trace)
        digests[label] = ref.fleet_digest()
    kw = dict(device="cpu", standard=quick, full=dict(quick, n_groups=8, n=10, p=12),
              remote=dict(chip_smoke.FLEET_REMOTE, max_kills=1), journal_dir=tmp_path / "j")
    out = chip_smoke.fleet_phase(torch, split_score, "cpu", digests=digests, **kw)
    assert out["remote"]["restarts"] == out["remote"]["faults"] == 1
    assert out["recovery"]["restarts"] == 2
    assert len(out["runs"]) == 9
    assert len({r["digest"] for k, r in out["runs"].items() if k.startswith("full")}) == 1
    assert out["runs"]["full fused cold"]["captures"] > 0
    bad = dict(digests, standard=digests["standard"][:-1] + "?")
    with pytest.raises(SystemExit):
        chip_smoke.fleet_phase(torch, split_score, "cpu", digests=bad, **kw)


def _model_counters():
    from repro_torch.kernels import decode_attention, flash_attention, mamba2_ssd, rmsnorm

    return [rmsnorm.rmsnorm, rmsnorm.rmsnorm_residual, flash_attention.flash_attention,
            decode_attention.decode_attention, mamba2_ssd.ssd_intra_chunk]


def test_serve_prefill_phase_passes_on_cpu_and_refuses_planted_faults():
    """Phase 17 at the smoke configs on the CPU (prefill at S = 512):
    plans equal across two runs, the replan serve run
    replans, prefill meets the forward; a plan one candidate off, a serve
    run that never replanned, and a decode-attention count one short are
    refused.  The launch expectations: 2 RMSNorms per layer and the final
    one, no flash attention."""
    from repro_torch.core import heuristics
    from repro_torch.kernels import split_score

    cfg = get_smoke_config("qwen3-4b").replace(dtype="float32", use_pallas=True)
    assert chip_smoke.prefill_launches(cfg) == {
        "rmsnorm": 7, "rmsnorm_residual": 0, "flash_attention": 0, "decode_attention": 0,
        "ssd_intra_chunk": 0}
    out = chip_smoke.serve_prefill_phase(
        torch, split_score, heuristics, _model_counters(), cfg, "cpu", {}, device="cpu",
        smoke_cfg=cfg, plan_smoke=True, serve_smoke=True, prefill_s=512)
    assert out["plans"]["candidates"] > 0 and len(out["plans"]["digests"]) == 6
    assert out["replan_serve"]["replan"]["replans"] >= 1
    assert out["prefill"]["capacity"] == 512 and out["prefill"]["vs_forward"]["ok"]
    assert max(out["prefill_cpu_vs_card"].values()) == 0.0      # cpu against itself
    assert sorted(out["by_path"]) == ["decode after prefill", "plan_serving", "prefill",
                                      "replan serve"]

    from repro_torch.launch import serve

    rows = chip_smoke.plan_rows(serve, "cpu", ("qwen3-4b",), pods=(2,), smoke=True)
    bad = {k: dict(v, candidates=v["candidates"][:-1]) for k, v in rows.items()}
    with pytest.raises(SystemExit):
        chip_smoke.compare_plans(bad, rows, "planted")
    timed = {k: dict(v, candidates=[dict(c, wall_ms=c["wall_ms"] + 1.0)
                                    for c in v["candidates"]]) for k, v in rows.items()}
    assert chip_smoke.compare_plans(timed, rows, "wall_ms only") == len(
        rows[("qwen3-4b", 2)]["candidates"])
    served = out["replan_serve"]
    calls = cfg.n_layers * chip_smoke.decode_calls(**chip_smoke.REPLAN_SERVE)
    chip_smoke.check_replan_serve(served, cfg, {"decode_attention": calls})
    with pytest.raises(SystemExit):
        chip_smoke.check_replan_serve(served, cfg, {"decode_attention": calls - 1})
    with pytest.raises(SystemExit):
        chip_smoke.check_replan_serve(
            dict(served, replan=dict(served["replan"], replans=0)), cfg, {})


def test_decode_after_prefill_holds_every_step_against_plain_decode(monkeypatch):
    """Phase 17's decode after prefill at the smoke config on the CPU: each
    step's logits against the plain decode attention's, from a copy of the
    prefill state and fed the same tokens; a decode attention 1 % off on the
    kernel route is refused."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    cfg = get_smoke_config("qwen3-4b").replace(dtype="float32", use_pallas=True)
    api = get_model(cfg)
    params = api.init(7, "cpu")
    toks = torch.randint(1, cfg.vocab_size, (1, 64), generator=torch.Generator().manual_seed(8))

    def run():
        logits, state = transformer.prefill(params, toks, cfg)
        return chip_smoke.decode_after_prefill(torch, api, params, state, logits, cfg,
                                               _model_counters(), 4, lambda: None)

    _, worst = run()
    assert worst["max_err"] <= chip_smoke.LOGIT_F32_TOL
    real = ops.decode_attention
    monkeypatch.setattr(ops, "decode_attention", lambda *a, **k: real(*a, **k) * 1.01)
    with pytest.raises(SystemExit):
        run()


def test_update_rel_err_is_one_for_an_update_that_never_happened():
    init = {"a": torch.zeros(3), "b": {"c": torch.ones(2, 2)}}
    want = {"a": torch.tensor([1e-3, -1e-3, 1e-3]), "b": {"c": torch.ones(2, 2) - 1e-3}}
    assert chip_smoke.update_rel_err(want, want, init) == 0.0
    assert chip_smoke.update_rel_err(init, want, init) == 1.0
    half = {"a": want["a"] / 2, "b": want["b"]}
    assert chip_smoke.update_rel_err(half, want, init) == pytest.approx(0.5)


_TRAIN_PHASE = """
import contextlib, io, json, pathlib, sys, tempfile
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import decode_attention, flash_attention, mamba2_ssd, rmsnorm

counters = [rmsnorm.rmsnorm, rmsnorm.rmsnorm_residual, flash_attention.flash_attention,
            decode_attention.decode_attention, mamba2_ssd.ssd_intra_chunk]
with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()):
    out = chip_smoke.train_phase(
        torch, counters, "cpu", device="cpu",
        train=dict(chip_smoke.TRAIN, smoke=True, seq=64, batch=2), n_layers=2,
        smoke_cfg=get_smoke_config("qwen3-4b").replace(dtype="float32"),
        ckpt_dir=pathlib.Path(d) / "ckpt")
    left = (pathlib.Path(d) / "ckpt").exists()
print(json.dumps({k: out[k] for k in ("losses", "resumed_losses", "launches", "cpu_vs_card")}
                 | {"left": left}))
"""


def test_train_phase_passes_on_cpu_and_refuses_a_resume_that_restarts(tmp_path, monkeypatch):
    """Phase 18 at the smoke config cut to 2 layers on the CPU: the crash
    and resume give the uninterrupted losses bit for bit, no kernel
    launched, the checkpoints removed, cpu against itself within the
    limits (in a process with ``MKL_CBWR=COMPATIBLE``, as
    ``tests/test_torch_train.py``'s crash-and-resume test: MKL's float32
    products otherwise depend on buffer alignment); a resume that finds no
    checkpoint (and so restarts at step 0) is refused."""
    import json
    import os
    import subprocess

    from repro_torch.checkpoint import CheckpointManager

    env = dict(os.environ, MKL_CBWR="COMPATIBLE", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", _TRAIN_PHASE, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["resumed_losses"] == out["losses"][2:] and len(out["losses"]) == 3
    assert out["cpu_vs_card"]["loss_err"] <= chip_smoke.TRAIN_LOSS_TOL
    assert out["cpu_vs_card"]["param_err"] <= out["cpu_vs_card"]["lr_sum"]
    assert out["cpu_vs_card"]["update_rel_err"] == 0.0      # cpu against itself
    assert not any(out["launches"].values()) and not out["left"]
    monkeypatch.setattr(CheckpointManager, "restore_latest", lambda self, like: None)
    with pytest.raises(SystemExit):
        chip_smoke.train_phase(torch, _model_counters(), "cpu", device="cpu",
                               train=dict(chip_smoke.TRAIN, smoke=True, seq=64, batch=2),
                               n_layers=2, ckpt_dir=tmp_path / "ckpt")


_SMOKE_PIPELINE = dict(chip_smoke.PIPELINE, smoke=True, seq=64)
_SMOKE_PLAN = ((1, 2), (0, 2))       # pods 1 and 3 idle; pod 0 pads one slot


def _score_counters():
    from repro_torch.kernels import split_score

    return (split_score.score_2way_cuda, split_score.score_3way_cuda)


def test_pipeline_phase_passes_on_cpu_and_refuses_a_plan_that_differs(tmp_path):
    """Phase 20 at the smoke config on the CPU (B = 4, S = 64, M = 4): the
    plan (1, 2) on pods (0, 2), the pipelined loss and gradients within their
    limits of the sequential ones, the 5 masked slots 0, the kernel pass
    within its limit of the plain pass, the smoke config cpu against itself
    in a child; a phase told to expect another plan stops there."""
    out = chip_smoke.pipeline_phase(torch, _model_counters(), "cpu", device="cpu",
                                    run=_SMOKE_PIPELINE, want_plan=_SMOKE_PLAN,
                                    score_counters=_score_counters(), work=tmp_path / "ref")
    assert (out["plan"]["stage_sizes"], out["plan"]["pods"]) == ([1, 2], [0, 2])
    assert out["plan"]["planner"].startswith("auto(")
    grad = out["grad"]
    assert grad["loss_err"] <= chip_smoke.PIPELINE_LOSS_TOL
    assert grad["worst_slot"][1] <= chip_smoke.PIPELINE_GRAD_RTOL
    assert grad["masked_slots"] == 5 and grad["masked_nonzero"] == []
    kp = out["kernel_pass"]
    assert abs(kp["kernel"]["loss"] - kp["plain"]["loss"]) <= chip_smoke.PIPELINE_KERNEL_TOL
    # 3 layers in 4 microbatches: 2 RMSNorms each, no flash at S = 64
    assert kp["checked_calls"] == {"flash_attention": 0, "rmsnorm": 24}
    assert len(kp["logits"]) == 4 and all(c["ok"] for c in kp["logits"])
    smoke = out["smoke_cpu_vs_card"]
    assert smoke["plan"] == [[1, 2], [0, 2]] and smoke["loss_err"] == 0.0
    assert smoke["grad_err"] <= chip_smoke.PIPELINE_SMOKE_TOL
    assert sorted(out["by_path"]) == ["pipeline kernel pass", "pipeline plan", "pipeline train"]
    assert not (tmp_path / "ref").exists()
    with pytest.raises(SystemExit):
        chip_smoke.pipeline_phase(torch, _model_counters(), "cpu", device="cpu",
                                  run=_SMOKE_PIPELINE, want_plan=((2, 1), (0, 2)),
                                  work=tmp_path / "ref")


def test_pipeline_gradient_check_refuses_a_masked_slot_that_learns():
    """The gradient gate at the smoke config in float32 (S = 32): the
    pipelined gradients pass against the sequential ones; a gradient in a
    slot of an unenrolled pod, or in a padding slot, is refused."""
    from repro_torch import core
    from repro_torch.pipeline import runtime

    inputs = chip_smoke.pipeline_smoke_inputs(torch, "qwen3-4b",
                                              {"batch": 4, "seq": 32, "microbatches": 4})
    cfg = get_smoke_config("qwen3-4b").replace(dtype="float32")
    pl = chip_smoke.pipeline_plan(core, cfg, dict(chip_smoke.PIPELINE, seq=32), "cpu")
    params = inputs["params"]
    batch = {k: inputs[k] for k in ("tokens", "labels")}
    stages, mask = runtime.make_stage_params(params["layers"], pl, 4)
    loss, grads = chip_smoke.pipeline_grads(
        torch, runtime.pipelined_loss_fn(cfg, pl, 4, mask),
        {"embed": params["embed"], "stages": stages, "ln_f": params["ln_f"]}, batch)
    seq_loss, seq_grads = chip_smoke.pipeline_grads(torch, runtime.sequential_loss_fn(cfg),
                                                    params, batch)
    res = chip_smoke.check_pipeline_grads(torch, loss, grads, seq_loss, seq_grads, pl, mask)
    assert res["loss_err"] <= 1e-5 and res["worst_slot"][1] <= 1e-5
    for pod, slot in ((1, 0), (0, 1)):       # an idle pod; pod 0's padding slot
        assert not mask[pod, slot]
        planted = dict(grads)
        planted["stages/mlp/wi"] = grads["stages/mlp/wi"].clone()
        planted["stages/mlp/wi"][pod, slot, 0, 0] = 1e-3
        with pytest.raises(SystemExit):
            chip_smoke.check_pipeline_grads(torch, loss, planted, seq_loss, seq_grads, pl, mask)


def _pipeline_kernel_inputs(seq: int = 1536, batch: int = 2):
    """The smoke qwen3-4b's pipeline over 4 pods at a length that takes the
    flash kernel: (cfg, plan, mask, mesh, packed params, batch)."""
    from repro_torch import core
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.pipeline import runtime

    cfg = get_smoke_config("qwen3-4b")
    pl = chip_smoke.pipeline_plan(core, cfg, dict(chip_smoke.PIPELINE, seq=seq, batch=batch),
                                  "cpu")
    params = get_model(cfg).init(7, "cpu")
    stages, mask = runtime.make_stage_params(params["layers"], pl, 4)
    gen = torch.Generator().manual_seed(8)
    data = {k: torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
            for k in ("tokens", "labels")}
    return (cfg, pl, mask, make_mesh((4,), ("stage",), devices=["cpu"] * 4),
            {"embed": params["embed"], "stages": stages, "ln_f": params["ln_f"]}, data)


@pytest.mark.parametrize("fault", [None, "causality dropped", "output scaled by 1.05"])
def test_pipeline_kernel_pass_checks_every_call_and_refuses_a_wrong_flash(fault, monkeypatch):
    """The kernel pass at S = 1536 in 2 microbatches holds each of its 6
    flash and 12 RMSNorm calls to the plain version on its own inputs and
    each microbatch's logits to the plain pass's; a flash kernel that drops
    causality, or scales its output by 1.05, is refused."""
    from repro_torch.kernels import ops, ref

    cfg, pl, mask, mesh, params, data = _pipeline_kernel_inputs()
    args = (torch, _model_counters(), cfg, pl, 2, mask, mesh, params, data, "cpu")
    if fault is None:
        out = chip_smoke.pipeline_kernel_pass(*args)
        assert out["checked_calls"] == {"flash_attention": 6, "rmsnorm": 12}
        assert len(out["logits"]) == 2 and all(c["ok"] for c in out["logits"])
        assert abs(out["kernel"]["loss"] - out["plain"]["loss"]) <= \
            chip_smoke.PIPELINE_KERNEL_TOL
        return
    flash = ops.flash_attention
    wrong = {"causality dropped": lambda q, k, v, **kw: ref.flash_attention_ref(
                 q, k, v, causal=False, window=kw.get("window")),
             "output scaled by 1.05": lambda q, k, v, **kw: flash(q, k, v, **kw) * 1.05}
    monkeypatch.setattr(ops, "flash_attention", wrong[fault])
    with pytest.raises(SystemExit):
        chip_smoke.pipeline_kernel_pass(*args)


def test_pipeline_kernel_pass_launches_and_a_flash_count_one_off():
    """The kernel pass of qwen3-4b's 36 layers at S = 2048 in 4 microbatches
    launches 2 RMSNorms and one flash attention per live layer step (none
    for the final norm); a flash count one off is refused."""
    from repro_torch.configs import get_config

    want = chip_smoke.pipeline_launches(get_config("qwen3-4b"), 4, 2048)
    assert want == {"rmsnorm": 288, "rmsnorm_residual": 0, "flash_attention": 144,
                    "decode_attention": 0, "ssd_intra_chunk": 0}
    assert chip_smoke.pipeline_launches(get_smoke_config("qwen3-4b"), 4, 64)[
        "flash_attention"] == 0
    chip_smoke.check_launches("pipeline kernel pass", dict(want), want)
    with pytest.raises(SystemExit):
        chip_smoke.check_launches("pipeline kernel pass",
                                  dict(want, flash_attention=143), want)
