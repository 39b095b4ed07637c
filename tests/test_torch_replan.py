"""The port's online replanning against the JAX package's, on the CPU:
every case of ``tests/test_replan.py`` runs on the port (StragglerMonitor's
EWMA, ``replan_stages``, the elastic resize), and the monitor, the replanned
plans, the degraded and resized platforms and the schedule helpers are
``==`` the reference's on the same inputs (tolerance: none)."""

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.pipeline import replan as rreplan
from repro.pipeline import schedule as rschedule
from repro.sim.generators import gen_instance as r_gen_instance
from repro_torch import pipeline as ppipe
from repro_torch.pipeline import (StragglerMonitor, elastic_platform, elastic_replan,
                                  replan_stages)
from repro_torch.sim.generators import gen_instance

CPU = "cpu"


def _instance():
    wl = P.make_workload([4.0, 2.0, 6.0, 3.0, 5.0, 2.0],
                         [1.0, 2.0, 1.0, 3.0, 1.0, 2.0, 1.0])
    pf = P.make_platform([3.0, 2.0, 2.0, 1.0], 10.0)
    return wl, pf


def _stage(sp):
    return (None if sp is None else
            (sp.mapping.intervals, sp.mapping.alloc, sp.period, sp.latency, sp.planner,
             sp.stage_sizes, sp.max_stage_size, sp.padding_overhead, sp.groups))


def _platform(pf):
    return (pf.s.tobytes(), pf.b, pf.name, None if pf.fail is None else pf.fail.tobytes())


# ---------------------------------------------------------------------------
# StragglerMonitor
# ---------------------------------------------------------------------------

def test_ewma_first_observation_copies():
    mon = StragglerMonitor(num_stages=3)
    out = mon.observe([1.0, 2.0, 3.0])
    np.testing.assert_array_equal(out, [1.0, 2.0, 3.0])


def test_ewma_convergence_to_stationary_times():
    """Repeated identical observations converge the EWMA geometrically."""
    mon = StragglerMonitor(num_stages=2, alpha=0.2)
    mon.observe([1.0, 1.0])
    target = np.array([3.0, 0.5])
    for _ in range(60):
        mon.observe(target)
    np.testing.assert_allclose(mon.ewma, target, rtol=1e-5)


def test_ewma_blend_is_exact():
    mon = StragglerMonitor(num_stages=1, alpha=0.2)
    mon.observe([1.0])
    mon.observe([2.0])
    assert mon.ewma[0] == pytest.approx(0.8 * 1.0 + 0.2 * 2.0)


def test_threshold_flagging():
    """Only stages whose EWMA/predicted ratio exceeds the threshold flag."""
    mon = StragglerMonitor(num_stages=3, threshold=1.3)
    mon.observe([1.0, 1.4, 1.2])
    assert mon.stragglers([1.0, 1.0, 1.0]) == [1]


def test_no_observation_means_no_stragglers():
    mon = StragglerMonitor(num_stages=3)
    assert mon.stragglers([1.0, 1.0, 1.0]) == []


def test_monitor_and_schedule_equal_the_reference():
    rng = np.random.default_rng(3)
    for alpha, threshold in ((0.2, 1.3), (0.5, 1.1), (1.0, 2.0)):
        got = StragglerMonitor(num_stages=5, alpha=alpha, threshold=threshold)
        want = rreplan.StragglerMonitor(num_stages=5, alpha=alpha, threshold=threshold)
        assert got.stragglers(np.ones(5)) == want.stragglers(np.ones(5)) == []
        for _ in range(12):
            t = rng.uniform(0.5, 3.0, 5)
            assert got.observe(t).tobytes() == want.observe(t).tobytes()
            pred = rng.uniform(0.0, 2.0, 5)
            pred[0] = 0.0
            assert got.stragglers(pred) == want.stragglers(pred)
    for s, m in ((1, 1), (4, 8), (8, 4), (12, 32)):
        assert ppipe.gpipe_ticks(s, m) == rschedule.gpipe_ticks(s, m)
        assert ppipe.bubble_fraction(s, m) == rschedule.bubble_fraction(s, m)
        assert ppipe.stage_microbatch(m, s) == rschedule.stage_microbatch(m, s)
    from repro_torch.pipeline import schedule as pschedule

    assert (pschedule.predicted_step_time(1.5, 7.25, 9)
            == rschedule.predicted_step_time(1.5, 7.25, 9))


# ---------------------------------------------------------------------------
# replan_stages
# ---------------------------------------------------------------------------

def test_replan_stages_no_straggler_fast_path():
    """Healthy timings: no replan, the platform object passes through."""
    wl, pf = _instance()
    current = P.plan(wl, pf, P.Objective("period"), device=CPU)
    mon = StragglerMonitor(num_stages=current.num_stages)
    predicted = P.interval_cycle_times(wl, pf, current.mapping)
    mon.observe(predicted)   # exactly as predicted
    new_plan, out_pf = replan_stages(wl, pf, current, mon, device=CPU)
    assert new_plan is None
    assert out_pf is pf


def test_replan_stages_degrades_and_replans():
    wl, pf = _instance()
    current = P.plan(wl, pf, P.Objective("period"), device=CPU)
    mon = StragglerMonitor(num_stages=current.num_stages)
    predicted = P.interval_cycle_times(wl, pf, current.mapping)
    slow = predicted.copy()
    slow[0] *= 2.0           # stage 0's pod runs 2x slow
    mon.observe(slow)
    new_plan, degraded = replan_stages(wl, pf, current, mon, device=CPU)
    assert isinstance(new_plan, P.StagePlan)
    bad_pod = current.mapping.alloc[0]
    assert degraded.s[bad_pod] == pytest.approx(pf.s[bad_pod] / 2.0)
    # the other pods are untouched
    for u in range(pf.p):
        if u != bad_pod:
            assert degraded.s[u] == pf.s[u]


@pytest.mark.parametrize("exp", ["R2", "E3"])
def test_replan_stages_equals_the_reference(exp):
    """Observed times slowed on no stage, one stage and two stages, over
    two observations: the replanned plan and the degraded platform."""
    (rwl, rpf), (wl, pf) = r_gen_instance(exp, 14, 13, seed=7), gen_instance(exp, 14, 13,
                                                                              seed=7)
    rcur = R.plan(rwl, rpf, R.Objective("period"))
    cur = P.plan(wl, pf, P.Objective("period"), device=CPU)
    assert _stage(cur) == _stage(rcur)
    predicted = R.interval_cycle_times(rwl, rpf, rcur.mapping)
    for slow in ({}, {0: 2.0}, {cur.num_stages - 1: 1.6, 0: 1.35}):
        got = StragglerMonitor(num_stages=cur.num_stages)
        want = rreplan.StragglerMonitor(num_stages=cur.num_stages)
        times = predicted.copy()
        for j, f in slow.items():
            times[j] *= f
        for obs in (times, times * 1.1):
            got.observe(obs)
            want.observe(obs)
        new, deg = replan_stages(wl, pf, cur, got, device=CPU)
        rnew, rdeg = rreplan.replan_stages(rwl, rpf, rcur, want)
        assert _stage(new) == _stage(rnew) and _platform(deg) == _platform(rdeg), slow
        assert (new is None) == (not slow)


# ---------------------------------------------------------------------------
# Elastic resize
# ---------------------------------------------------------------------------

def test_elastic_platform_preserves_surviving_speeds():
    """Shrink keeps the survivors' observed speeds verbatim."""
    pf = P.make_platform([3.0, 1.5, 2.0, 0.5], 10.0)
    out = elastic_platform(pf, 3)
    np.testing.assert_array_equal(out.s, [3.0, 1.5, 2.0])
    assert out.b == pf.b


def test_elastic_platform_fills_new_pods_with_median():
    """Growth: survivors keep their speeds, new pods get the median prior."""
    pf = P.make_platform([3.0, 1.0, 2.0], 10.0)
    out = elastic_platform(pf, 5)
    np.testing.assert_array_equal(out.s[:3], pf.s)
    assert out.s[3] == out.s[4] == pytest.approx(np.median(pf.s))


def test_elastic_platform_explicit_survivors():
    pf = P.make_platform([3.0, 1.0, 2.0, 4.0], 10.0)
    out = elastic_platform(pf, 2, surviving=[3, 1])
    np.testing.assert_array_equal(out.s, [4.0, 1.0])


def test_elastic_platform_rejects_zero_pods():
    pf = P.make_platform([1.0, 2.0], 10.0)
    with pytest.raises(ValueError):
        elastic_platform(pf, 0)


def test_elastic_replan_uses_measured_heterogeneity():
    """The resized plan must see the observed speeds: with one pod far
    faster than the rest, a median-rebuilt (homogeneous) platform would
    spread stages evenly, while the true heterogeneous platform loads the
    fast pod — the plan's stage allocation must reflect the latter."""
    wl = P.make_workload([4.0, 2.0, 6.0, 3.0, 5.0, 2.0, 4.0, 3.0],
                         np.ones(9))
    pf = P.make_platform([10.0, 1.0, 1.0, 1.0, 1.0], 10.0)
    new = elastic_replan(wl, pf, 4, device=CPU)   # drop the last pod, keep 10.0 + 1.0s
    # the fast surviving pod (index 0) must carry the largest interval
    sizes = {u: e - d + 1 for (d, e), u in
             zip(new.mapping.intervals, new.mapping.alloc)}
    assert 0 in sizes, "fast pod unused: measured speeds were discarded"
    assert sizes[0] == max(sizes.values())


@pytest.mark.parametrize("exp", ["R1", "E2"])
def test_elastic_platform_and_replan_equal_the_reference(exp):
    """Shrink, growth and explicit survivors, with and without failure
    probabilities; the replan on each resized platform, growth from one pod
    included."""
    (rwl, rpf), (wl, pf) = r_gen_instance(exp, 12, 10, seed=11), gen_instance(exp, 12, 10,
                                                                              seed=11)
    for new, surv in ((7, None), (10, None), (13, None), (1, None), (4, [9, 2, 5, 0, 7]),
                      (6, [3, 1])):
        got = elastic_platform(pf, new, surviving=surv)
        want = rreplan.elastic_platform(rpf, new, surviving=surv)
        assert _platform(got) == _platform(want), (new, surv)
        if surv is None:
            assert (_stage(elastic_replan(wl, pf, new, device=CPU))
                    == _stage(rreplan.elastic_replan(rwl, rpf, new)))
    with pytest.raises(ValueError):
        elastic_replan(wl, pf, 0, device=CPU)
    (rwl, rpf), (wl, pf) = ((R.make_workload([10.0], [0.0, 0.0]), R.make_platform([1.0], 1.0)),
                            (P.make_workload([10.0], [0.0, 0.0]), P.make_platform([1.0], 1.0)))
    assert _stage(elastic_replan(wl, pf, 2, device=CPU)) == _stage(
        rreplan.elastic_replan(rwl, rpf, 2))
