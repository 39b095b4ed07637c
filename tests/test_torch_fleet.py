"""The port's fleet replanning service against the JAX package's, on the CPU.

The same seeded fleets, traces and chaos overlays go through
``repro.fleet`` (the reference, numpy engine) and ``repro_torch.fleet``
(``device="cpu"``): instances, events, signature digest strings, canonical
remaps, every published plan and ``fleet_digest()`` are ``==`` (tolerance:
none), through the lockstep, fused and sharded engines.  The standard and
chaos digests are also the constants that ``chip_smoke.py`` phase 16 holds
the card to, re-derived here from a live reference run.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_fleet.py
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest

import repro.core as R
import repro.fleet as RF
import repro.fleet.service as r_service
import repro_torch.core as P
import repro_torch.fleet as PF
import repro_torch.fleet.service as p_service
from repro.core.batched import stack_instances as r_stack
from repro.sim.generators import gen_instance as r_gen_instance
from repro_torch.core import sharded
from repro_torch.core.batched import ProblemBatch, batched_min_period, stack_instances
from repro_torch.fleet import metrics as p_metrics
from repro_torch.fleet.telemetry import Trace
from repro_torch.sim.generators import gen_instance

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

CPU = "cpu"
# benchmarks/fleet_bench.py's configurations (QUICK, STANDARD, CHAOS)
QUICK = dict(n_groups=6, replicas=8, n=8, p=4, fleet_seed=2007, num_ticks=12,
             trace_seed=42, burst_prob=0.6)
STANDARD = dict(n_groups=16, replicas=16, n=12, p=6, fleet_seed=2007, num_ticks=30,
                trace_seed=42, burst_prob=0.6)
CHAOS = dict(chaos_seed=77, fail_seed=5, reliability_floor=0.98)


def _with_failures(core, pairs, seed):
    """fleet_bench's bimodal failure probabilities, one draw per template."""
    shared, out = {}, []
    for wl, pf in pairs:
        if id(pf) not in shared:
            shared[id(pf)] = pf.with_failures(core.sample_failures(
                pf.p, kind="bimodal", seed=seed + len(shared)))
        out.append((wl, shared[id(pf)]))
    return out


def _fleet(fleet, core, cfg, chaos=False):
    """(pairs, groups, trace) of one package for ``cfg``; with ``chaos`` the
    fleet carries failure probabilities and the trace the chaos overlay."""
    pairs, groups = fleet.make_fleet(cfg["n_groups"], cfg["replicas"], cfg["n"], cfg["p"],
                                     seed=cfg["fleet_seed"])
    trace = fleet.gen_burst_trace(groups, cfg["num_ticks"], seed=cfg["trace_seed"],
                                  n_stages=cfg["n"], initial_pods=cfg["p"],
                                  burst_prob=cfg["burst_prob"])
    if chaos:
        pairs = _with_failures(core, pairs, CHAOS["fail_seed"])
        trace = fleet.inject_chaos(trace, groups, fleet.ChaosSpec(),
                                   seed=CHAOS["chaos_seed"], initial_pods=cfg["p"])
    return pairs, groups, trace


def _small(fleet, core):
    """tests/test_fleet.py's small fleet with its chaos overlay."""
    pairs, groups = fleet.make_fleet(n_groups=3, replicas=4, n=8, p=4, seed=42)
    pairs = _with_failures(core, pairs, 0)
    trace = fleet.gen_burst_trace(groups, num_ticks=12, seed=7, n_stages=8,
                                  initial_pods=4, burst_prob=0.8)
    return pairs, groups, fleet.inject_chaos(trace, groups, fleet.ChaosSpec(), seed=13,
                                             initial_pods=4)


def _events(trace):
    return [[(type(e).__name__, dataclasses.astuple(e)) for e in tick]
            for tick in trace.ticks]


def _platform(pf):
    return (pf.s.tobytes(), pf.b, pf.name, None if pf.fail is None else pf.fail.tobytes())


def _plan(sp):
    return (sp.mapping.intervals, sp.mapping.alloc, sp.period, sp.latency, sp.planner,
            sp.stage_sizes, sp.max_stage_size, sp.padding_overhead, sp.groups)


def _result(r):
    return (r.mapping.intervals, r.mapping.alloc, r.period, r.latency, r.feasible,
            r.splits, r.name)


_COUNTS = ("ticks", "events", "requests", "solves", "warm_hits", "churns", "deferred",
           "fallback_solves", "dropped_events", "below_floor_ticks", "recovery_ticks",
           "invalid_published", "quarantined_requests", "quarantine_strikes",
           "quarantined_problems", "solve_retries", "worker_restarts",
           "worker_timeouts", "cache_evictions")


def _assert_same_run(port_svc, ref_svc):
    """Every published plan, effective platform, counter and the digest."""
    assert port_svc.fleet_digest() == ref_svc.fleet_digest()
    assert [_plan(st.plan) for st in port_svc.states] == \
        [_plan(st.plan) for st in ref_svc.states]
    assert [_platform(st.platform) for st in port_svc.states] == \
        [_platform(st.platform) for st in ref_svc.states]
    for f in _COUNTS:
        assert getattr(port_svc.metrics, f) == getattr(ref_svc.metrics, f), f


# ---------------------------------------------------------------------------
# Telemetry, chaos and signatures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [QUICK, STANDARD], ids=["quick", "standard"])
def test_fleet_and_burst_trace_equal_the_reference(cfg):
    pp, pg, pt = _fleet(PF, P, cfg)
    rp, rg, rt = _fleet(RF, R, cfg)
    assert pg == rg and pt.seed == rt.seed
    assert _events(pt) == _events(rt)
    for (pwl, ppf), (rwl, rpf) in zip(pp, rp):
        assert pwl.w.tobytes() == rwl.w.tobytes() and pwl.name == rwl.name
        assert pwl.delta.tobytes() == rwl.delta.tobytes()
        assert _platform(ppf) == _platform(rpf)


def test_chaos_overlay_equals_the_reference_and_is_deterministic():
    pp, pg, pt = _fleet(PF, P, STANDARD, chaos=True)
    rp, _, rt = _fleet(RF, R, STANDARD, chaos=True)
    assert _events(pt) == _events(rt)
    assert [_platform(pf) for _, pf in pp] == [_platform(pf) for _, pf in rp]
    assert pt == _fleet(PF, P, STANDARD, chaos=True)[2]
    calm = PF.ChaosSpec(storm_prob=0, flap_prob=0, drop_prob=0, dup_prob=0, reorder_prob=0)
    base = _fleet(PF, P, STANDARD)[2]
    assert PF.inject_chaos(base, pg, calm, seed=13).ticks == base.ticks


def test_event_wire_codec_equals_the_reference():
    events = [PF.StageTimings(3, (0.5, 1.25, 2.0)), PF.StageDrift(1, 4, 3.0),
              PF.PodCountChange(2, 6), PF.PodFailure(0, 1)]
    refs = [RF.StageTimings(3, (0.5, 1.25, 2.0)), RF.StageDrift(1, 4, 3.0),
            RF.PodCountChange(2, 6), RF.PodFailure(0, 1)]
    for ev, rv in zip(events, refs):
        assert PF.event_to_wire(ev) == RF.event_to_wire(rv)
        assert PF.event_from_wire(RF.event_to_wire(rv)) == ev
    with pytest.raises(ValueError):
        PF.event_from_wire(["NoSuchEvent", {}])


@pytest.mark.parametrize("exp", ["E1", "E2", "E3", "E4"])
@pytest.mark.parametrize("with_fail", [False, True])
def test_signature_digest_strings_equal_the_reference(exp, with_fail):
    """The digest hashes the same bytes in the same order: the port's
    signature strings are the reference's, so is the canonical platform and
    its permutation (E1 has many speed ties)."""
    for seed in range(8100, 8104):
        wl, pf = gen_instance(exp, 10, 6, seed)
        rwl, rpf = r_gen_instance(exp, 10, 6, seed)
        if with_fail:
            pf = pf.with_failures(P.sample_failures(pf.p, kind="bimodal", seed=seed))
            rpf = rpf.with_failures(R.sample_failures(rpf.p, kind="bimodal", seed=seed))
        sig, rsig = PF.signature(wl, pf), RF.signature(rwl, rpf)
        assert (sig.digest, sig.n, sig.p, sig.b, sig.bucket) == \
            (rsig.digest, rsig.n, rsig.p, rsig.b, rsig.bucket)
        (canon, perm), (rcanon, rperm) = PF.canonicalize(pf), RF.canonicalize(rpf)
        assert np.array_equal(perm, rperm) and _platform(canon) == _platform(rcanon)
        assert PF.remap_alloc((0, 2, 1), perm) == RF.remap_alloc((0, 2, 1), rperm)


def test_signature_invariant_under_relabeling_and_sensitive_to_every_field():
    wl, pf = gen_instance("E2", 8, 5, 0)
    perm = np.random.default_rng(1).permutation(pf.p)
    base = PF.signature(wl, pf).digest
    assert PF.signature(wl, P.Platform(pf.s[perm], pf.b)).digest == base
    assert PF.signature(wl, P.Platform(pf.s, pf.b, name="something-else")).digest == base
    assert PF.signature(wl, P.Platform(pf.s * 1.0000001, pf.b)).digest != base
    assert PF.signature(wl, P.Platform(pf.s, pf.b * 2)).digest != base
    assert PF.signature(dataclasses.replace(wl, w=wl.w + 1e-9), pf).digest != base
    assert [PF.span_bucket(n) for n in (1, 2, 3, 4, 5, 8, 9)] == [1, 2, 4, 4, 8, 8, 16]
    with pytest.raises(ValueError):
        PF.span_bucket(0)


def test_canonical_solve_remaps_bit_identically():
    """Solving the speed-sorted canonical platform and remapping through the
    permutation reproduces the original solve, on the port and equal to the
    reference's scalar portfolio."""
    for seed in range(8100, 8106):
        wl, pf = gen_instance("E1", 10, 6, seed)
        canon, perm = PF.canonicalize(pf)
        ref = P.min_period_exhaustive(wl, pf, device=CPU)
        via = P.min_period_exhaustive(wl, canon, device=CPU)
        assert (via.period, via.latency, via.mapping.intervals) == \
            (ref.period, ref.latency, ref.mapping.intervals)
        assert PF.remap_alloc(via.mapping.alloc, perm) == ref.mapping.alloc
        assert _result(ref) == _result(R.min_period_exhaustive(*r_gen_instance("E1", 10, 6,
                                                                                seed)))


# ---------------------------------------------------------------------------
# The solve primitive: stack_instances and batched_min_period
# ---------------------------------------------------------------------------

def test_stack_instances_equals_the_reference():
    pairs = [gen_instance("E3", 9, 5, s) for s in range(8100, 8106)]
    rpairs = [r_gen_instance("E3", 9, 5, s) for s in range(8100, 8106)]
    pb, rpb = stack_instances(pairs, device=CPU), r_stack(rpairs)
    for f in ("w", "delta", "s", "prefix", "order"):
        assert np.array_equal(getattr(pb, f), getattr(rpb, f)), f
    assert pb.b == rpb.b and pb.device.type == "cpu"
    via = ProblemBatch.from_arrays(pb.w, pb.delta, pb.s, pb.b, device=CPU)
    assert np.array_equal(via.prefix, pb.prefix) and np.array_equal(via.order, pb.order)
    with pytest.raises(ValueError, match="empty"):
        stack_instances([], device=CPU)
    with pytest.raises(ValueError, match="share n, p, and b"):
        stack_instances(pairs + [gen_instance("E3", 8, 5, 1)], device=CPU)


@pytest.mark.parametrize("exp", ["E1", "E2", "E3", "E4"])
def test_batched_min_period_equals_scalar_and_the_reference(exp):
    pairs = [gen_instance(exp, 12, 6, s) for s in range(8100, 8106)]
    rpairs = [r_gen_instance(exp, 12, 6, s) for s in range(8100, 8106)]
    got = [_result(r) for r in batched_min_period(stack_instances(pairs, device=CPU))]
    assert got == [_result(P.min_period_exhaustive(wl, pf, device=CPU)) for wl, pf in pairs]
    assert got == [_result(r) for r in R.batched_min_period(r_stack(rpairs))]


# ---------------------------------------------------------------------------
# The service: digests against a live reference run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["lockstep", "fused", "sharded"])
def test_quick_trace_equals_the_reference(backend):
    """fleet_bench's QUICK trace, every published plan and counter, through
    each engine (sharded over 3 CPU devices) against the numpy reference."""
    rp, _, rt = _fleet(RF, R, QUICK)
    ref = RF.ReplanService(rp)
    ref.run_trace(rt)
    pp, _, pt = _fleet(PF, P, QUICK)
    with sharded.use_devices([CPU] * 3):
        svc = PF.ReplanService(pp, backend=backend, device=CPU)
        svc.run_trace(pt)
    _assert_same_run(svc, ref)
    assert svc.metrics.requests > svc.metrics.solves > 0


@pytest.mark.parametrize("chaos", [False, True], ids=["standard", "chaos"])
def test_standard_and_chaos_digests_equal_the_reference_and_chip_smoke(chaos):
    """The standard trace, and its chaos overlay with the 0.98 floor: the
    port equals a live reference run, and both equal the constants phase 16
    of chip_smoke.py holds the card to."""
    kw = {"reliability_floor": CHAOS["reliability_floor"]} if chaos else {}
    rp, _, rt = _fleet(RF, R, STANDARD, chaos)
    ref = RF.ReplanService(rp, **kw)
    ref.run_trace(rt)
    pp, _, pt = _fleet(PF, P, STANDARD, chaos)
    svc = PF.ReplanService(pp, device=CPU, **kw)
    svc.run_trace(pt)
    _assert_same_run(svc, ref)
    want = chip_smoke.FLEET_DIGESTS["chaos" if chaos else "standard"]
    assert ref.fleet_digest() == want
    if chaos:
        r = svc.metrics.robustness_summary()
        assert (r["invalid_published"], r["below_floor_ticks"], r["recoveries"]) == (0, 428, 19)


def test_service_default_and_config_surface():
    """The port's defaults: lockstep engine; the reference's backend names
    are not engines here; every knob fails fast."""
    wl, pf = gen_instance("E2", 8, 4, 0)
    svc = PF.ReplanService([(wl, pf)], device=CPU)
    assert svc.backend == "lockstep" and svc.device.type == "cpu"
    assert p_service.KNOWN_BACKENDS == ("lockstep", "fused", "sharded")
    for bad in ("numpy", "cuda"):
        with pytest.raises(ValueError, match="unknown backend"):
            PF.ReplanService([(wl, pf)], backend=bad, device=CPU)
    for kw, name in ((dict(solve_deadline=-1.0), "solve_deadline"),
                     (dict(reliability_floor=1.5), "reliability_floor"),
                     (dict(plan_cache_cap=0), "plan_cache_cap"),
                     (dict(quarantine_after=0), "quarantine_after")):
        with pytest.raises(ValueError, match=name):
            PF.ReplanService([(wl, pf)], device=CPU, **kw)


@pytest.mark.parametrize("stationary", [True, False], ids=["stationary", "burst"])
def test_warm_start_equals_cold(stationary):
    pairs, groups, trace = _small(PF, P)
    if stationary:
        events = tuple(PF.StageDrift(i, 2, 2.0) for g in groups for i in g)
        trace = Trace(ticks=(events,) * 6)
    warm = PF.ReplanService(pairs, warm_start=True, device=CPU)
    cold = PF.ReplanService(pairs, warm_start=False, device=CPU)
    warm.run_trace(trace)
    cold.run_trace(trace)
    assert warm.fleet_digest() == cold.fleet_digest()
    assert warm.metrics.solves <= cold.metrics.solves
    rpairs, rgroups, rtrace = _small(RF, R)
    if stationary:
        rtrace = RF.telemetry.Trace(
            ticks=(tuple(RF.StageDrift(i, 2, 2.0) for g in rgroups for i in g),) * 6)
    ref = RF.ReplanService(rpairs, warm_start=False)
    ref.run_trace(rtrace)
    _assert_same_run(cold, ref)


def test_solve_deadline_defers_then_recovers():
    """A zero solve budget defers the non-urgent replans (never an invalid
    plan); lifting it converges to the scalar portfolio on each instance's
    current platform, as in the reference."""
    pairs, _, trace = _small(PF, P)
    svc = PF.ReplanService(pairs, solve_deadline=0.0, device=CPU)
    svc.run_trace(trace)
    assert svc.metrics.deferred > 0 and svc.metrics.degraded_ticks > 0
    assert svc.metrics.invalid_published == 0
    svc.solve_deadline = None
    svc.tick([])
    assert not svc._pending
    for st in svc.states:
        ref = P.min_period_exhaustive(st.workload, st.platform, device=CPU)
        assert (st.plan.period, st.plan.latency, st.plan.mapping) == \
            (ref.period, ref.latency, ref.mapping)


def test_reliability_floor_triggers_replication_as_in_the_reference():
    wl, pf = gen_instance("E2", 4, 10, seed=5)
    pf = pf.with_failures(np.full(pf.p, 0.1))
    rwl, rpf = r_gen_instance("E2", 4, 10, seed=5)
    rpf = rpf.with_failures(np.full(rpf.p, 0.1))
    svc = PF.ReplanService([(wl, pf)], reliability_floor=0.97, device=CPU)
    ref = RF.ReplanService([(rwl, rpf)], reliability_floor=0.97)
    st = svc.states[0]
    assert st.plan.groups is not None
    assert svc._plan_reliability(st) >= 0.97 - 1e-9
    assert _plan(st.plan) == _plan(ref.states[0].plan)
    assert svc._plan_reliability(st) == ref._plan_reliability(ref.states[0])
    bare = PF.ReplanService([(wl, pf)], device=CPU)
    assert bare._plan_reliability(bare.states[0]) < 0.97


def test_chaos_never_publishes_invalid_plans():
    pairs, _, chaos = _small(PF, P)
    svc = PF.ReplanService(pairs, reliability_floor=0.9, device=CPU)
    assert svc.run_trace(chaos).invalid_published == 0
    for st in svc.states:
        assert max(st.plan.mapping.alloc) < st.platform.p
        if st.plan.groups is not None:
            assert max(u for g in st.plan.groups for u in g) < st.platform.p


@pytest.mark.parametrize("cap", [2, None, p_service.DEFAULT_PLAN_CACHE_CAP])
def test_plan_cache_cap_changes_work_not_plans(cap):
    """A 2-entry LRU evicts and re-solves; the default cap never evicts on
    these traces; each publishes the reference's plans under the same cap."""
    pairs, _, chaos = _small(PF, P)
    svc = PF.ReplanService(pairs, plan_cache_cap=cap, device=CPU)
    svc.run_trace(chaos)
    rpairs, _, rchaos = _small(RF, R)
    ref = RF.ReplanService(rpairs, plan_cache_cap=cap)
    ref.run_trace(rchaos)
    _assert_same_run(svc, ref)
    if cap == 2:
        assert 0 < svc.metrics.cache_evictions <= svc.plan_cache.evictions
        assert len(svc.plan_cache) <= 2
    else:
        assert svc.plan_cache.evictions == 0


def test_plan_cache_lru_order_touches_on_hit():
    c = p_service._PlanCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.lookup("a") == 1
    c.put("c", 3)
    assert c.evictions == 1 and "b" not in c and "a" in c and "c" in c


def test_single_instance_events():
    """Pod failure, resize (surviving speeds kept), the on-prediction fast
    path and a stale StageDrift, each as in the reference."""
    wl, pf = gen_instance("E2", 8, 4, 3)
    svc = PF.ReplanService([(wl, pf)], device=CPU)
    published = svc.tick([PF.PodFailure(0, 1)])
    assert svc.states[0].platform.p == 3 and 0 in published
    assert max(svc.states[0].plan.mapping.alloc) < 3
    svc.tick([PF.StageDrift(0, 0, 3.0)])
    degraded = svc.states[0].platform.s.copy()
    svc.tick([PF.PodCountChange(0, 6)])
    assert np.array_equal(svc.states[0].platform.s[:3], degraded[:3])
    st = svc.states[0]
    predicted = P.interval_cycle_times(st.workload, st.platform, st.plan.mapping)
    before = svc.fleet_digest()
    assert svc.tick([PF.StageTimings(0, tuple(predicted))]) == {}
    assert svc.tick([PF.StageDrift(0, 50, 3.0)]) == {}
    assert svc.fleet_digest() == before and svc.metrics.dropped_events == 1
    rwl, rpf = r_gen_instance("E2", 8, 4, 3)
    ref = RF.ReplanService([(rwl, rpf)])
    for events in ([RF.PodFailure(0, 1)], [RF.StageDrift(0, 0, 3.0)],
                   [RF.PodCountChange(0, 6)], [RF.StageTimings(0, tuple(predicted))],
                   [RF.StageDrift(0, 50, 3.0)]):
        ref.tick(events)
    _assert_same_run(svc, ref)


def test_thread_workers_equal_inline():
    pairs, _, trace = _small(PF, P)
    ref = PF.ReplanService(pairs, device=CPU)
    ref.run_trace(trace)
    svc = PF.ReplanService(pairs, device=CPU)
    svc.supervisor = PF.Supervisor(svc._solve_group, worker_cls=PF.ThreadWorker,
                                   workers=2, timeout=30.0)
    svc.run_trace(trace)
    svc.supervisor.close()
    assert svc.fleet_digest() == ref.fleet_digest()


# ---------------------------------------------------------------------------
# Degradation: solver faults degrade, device faults are raised
# ---------------------------------------------------------------------------

def test_batched_failure_falls_back_to_scalar(monkeypatch):
    """A RuntimeError from the batched solve (monkeypatched into the module
    global the workers call) degrades to per-member scalar solves with the
    reference's plans."""
    pairs, _, chaos = _small(PF, P)
    rpairs, _, rchaos = _small(RF, R)
    ref = RF.ReplanService(rpairs)
    ref.run_trace(rchaos)

    def boom(pb, backend):
        raise RuntimeError("poisoned batch")

    monkeypatch.setattr(p_service, "batched_min_period", boom)
    monkeypatch.setattr(r_service, "batched_min_period", boom)
    svc = PF.ReplanService(pairs, device=CPU)
    svc.supervisor.sleep = lambda s: None
    svc.run_trace(chaos)
    refd = RF.ReplanService(rpairs)
    refd.supervisor.sleep = lambda s: None
    refd.run_trace(rchaos)
    assert svc.metrics.fallback_solves > 0
    assert svc.fleet_digest() == ref.fleet_digest()
    _assert_same_run(svc, refd)


@pytest.mark.parametrize("where", ["batched", "scalar"])
def test_scoring_device_error_is_raised_not_degraded(where, monkeypatch):
    """A split-score fault on the card passes the supervisor (no retry), the
    service's catch-alls (no scalar fallback) and the strike counter (no
    quarantine): the tick raises it and the published plans are untouched."""
    pairs, _, _ = _small(PF, P)
    svc = PF.ReplanService(pairs, device=CPU)
    svc.supervisor.sleep = lambda s: None
    before = svc.fleet_digest()
    calls = []

    def device_fault(*args, **kwargs):
        calls.append(args)
        raise P.ScoringDeviceError("split scoring on cuda failed: RuntimeError: launch refused")

    def solver_fault(*args, **kwargs):
        raise RuntimeError("poisoned batch")

    monkeypatch.setattr(p_service, "batched_min_period",
                        device_fault if where == "batched" else solver_fault)
    if where == "scalar":
        monkeypatch.setattr(p_service, "min_period_exhaustive", device_fault)
    with pytest.raises(P.ScoringDeviceError, match="split scoring on cuda failed"):
        svc.tick([PF.StageDrift(0, 0, 2.0)])
    assert len(calls) == 1
    assert svc.supervisor.stats.retries == (0 if where == "batched" else 1)
    assert not svc.quarantine_strikes and not svc.quarantined
    assert svc.fleet_digest() == before


def test_supervisor_does_not_retry_a_device_fault():
    calls = []

    def fault(batch):
        calls.append(batch)
        raise P.ScoringDeviceError("split scoring on cuda failed: x")

    sup = PF.Supervisor(fault, max_attempts=4, sleep=lambda s: None)
    with pytest.raises(P.ScoringDeviceError):
        sup.solve("pb")
    assert len(calls) == 1 and sup.stats.failures == 1 and sup.stats.retries == 0


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def test_metrics_rows_equal_the_reference():
    """The same recorded ticks give the same summaries and benchmark rows."""
    from repro.fleet.metrics import FleetMetrics as RMetrics

    port, ref = p_metrics.FleetMetrics(), RMetrics()
    assert np.isnan(port.latency_percentile(50)) and port.bench_rows() == ref.bench_rows()
    for m in (port, ref):
        m.record_tick(requests=5, solves=2, warm_hits=1, events=7, wall=0.25,
                      churns=[0.5, 0.0], deferred=1, below_floor=2, recoveries=[3])
        m.record_tick(requests=3, solves=1, warm_hits=0, events=2, wall=0.125,
                      churns=[1.0], fallback_solves=1, worker_restarts=1)
    assert port.summary() == ref.summary()
    assert port.robustness_summary() == ref.robustness_summary()
    assert port.bench_rows("x", {"k": 1}) == ref.bench_rows("x", {"k": 1})
    assert port.chaos_rows("y") == ref.chaos_rows("y")
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
