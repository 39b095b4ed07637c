"""The port's deal-skeleton extension (the paper's Section-7 future work)
against the JAX package's, on the CPU.

Every case of ``tests/test_deal.py`` runs on the port, and the same inputs
go through both packages: ``plan_with_deal`` (its base plan, groups and
metrics), the stacked greedy state against the per-candidate loop, and the
``deal`` solver alone and inside portfolio requests are ``==`` the
reference's (tolerance: none; wall times excepted).
"""

import math

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.core import deal as rdeal
from repro.sim.generators import gen_instance as r_gen_instance
from repro_torch.core import deal as pdeal
from repro_torch.sim.generators import gen_instance

CPU = "cpu"


def _stage(sp):
    return (sp.mapping.intervals, sp.mapping.alloc, sp.period, sp.latency, sp.planner,
            sp.stage_sizes, sp.max_stage_size, sp.padding_overhead, sp.groups)


def _deal(dp):
    return (_stage(dp.base), dp.groups, dp.period, dp.latency, dp.num_stages)


def _cand(c):
    return (c.solver, c.objective.minimize, c.objective.bound,
            None if c.mapping is None else (c.mapping.intervals, c.mapping.alloc),
            c.period, c.latency, c.feasible, c.groups, c.error, c.reliability)


def _deal_or_error(mod, *args, **kw):
    try:
        return _deal(mod.plan_with_deal(*args, **kw))
    except Exception as ex:  # noqa: BLE001 — the error is the result compared
        return (type(ex).__name__, str(ex))


def _random_pairs(seed, count):
    """tests/test_deal.py's random instances, in both packages."""
    rng = np.random.default_rng(seed)
    for _ in range(count):
        n = int(rng.integers(2, 12))
        p = int(rng.integers(3, 10))
        w = rng.integers(1, 50, n).astype(float)
        delta = rng.integers(0, 20, n + 1).astype(float)
        s = rng.integers(1, 21, p).astype(float)
        yield ((R.make_workload(w, delta), R.make_platform(s, 10.0)),
               (P.make_workload(w, delta), P.make_platform(s, 10.0)))


def test_deal_improves_single_bottleneck_stage():
    """One huge stage dominates: interval splitting cannot help (single
    stage), but dealing it over extra processors must."""
    wl = P.make_workload([1.0, 100.0, 1.0], [0.1, 0.1, 0.1, 0.1])
    pf = P.make_platform([10.0] * 6, b=100.0)
    base = P.plan(wl, pf, P.Objective("period"), mode="auto", device=CPU)
    dealt = P.plan_with_deal(wl, pf, P.Objective("period"), device=CPU)
    assert dealt.period < base.period - 1e-9
    # the bottleneck interval got the replicas
    sizes = [len(g) for g in dealt.groups]
    bott = max(range(dealt.num_stages),
               key=lambda j: wl.interval_work(*dealt.base.mapping.intervals[j]))
    assert sizes[bott] > 1


def test_deal_never_worse_than_base():
    for _, (wl, pf) in _random_pairs(0, 15):
        base = P.plan(wl, pf, P.Objective("period"), mode="auto", device=CPU)
        dealt = P.plan_with_deal(wl, pf, P.Objective("period"), device=CPU)
        assert dealt.period <= base.period + 1e-9
        # all groups disjoint
        seen = set()
        for g in dealt.groups:
            assert not (seen & set(g))
            seen |= set(g)


def test_deal_stops_when_comm_bound():
    """If the bottleneck cycle is pure communication, dealing cannot help and
    must not consume processors."""
    wl = P.make_workload([0.01, 0.01], [1000.0, 1000.0, 1000.0])
    pf = P.make_platform([10.0] * 4, b=1.0)
    dealt = P.plan_with_deal(wl, pf, P.Objective("period"), device=CPU)
    assert all(len(g) == 1 for g in dealt.groups)


def test_deal_respects_latency_bound():
    wl = P.make_workload([1.0, 100.0, 1.0], [0.1] * 4)
    pf = P.make_platform([10.0, 10.0, 10.0, 1.0, 1.0], b=100.0)
    base = P.plan(wl, pf, P.Objective("period"), mode="auto", device=CPU)
    # a tight latency bound: dealing onto the slow processors would blow the
    # latency (slowest group member bounds it), so it must hold the bound
    dealt = P.plan_with_deal(wl, pf, P.Objective("period", bound=base.latency * 1.01),
                             device=CPU)
    assert dealt.latency <= base.latency * 1.01 + 1e-9


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_with_deal_equals_the_reference(seed):
    """Every mode (portfolio, exact, the heuristics) and objective, the
    errors of infeasible and unbounded requests included."""
    errors = 0
    for (rwl, rpf), (wl, pf) in _random_pairs(seed, 4):
        lopt = R.optimal_latency(rwl, rpf)
        hi = R.period(rwl, rpf, R.single_processor_mapping(rwl, rpf.fastest()))
        for mode, mini, bound in (("auto", "period", None), ("auto", "period", lopt * 1.3),
                                  ("auto", "period", lopt * 0.5), ("auto", "latency", None),
                                  ("auto", "latency", hi * 0.5), ("exact", "period", None),
                                  ("H5", "period", lopt * 1.5), ("H6", "period", None),
                                  ("H1", "latency", hi * 0.6)):
            want = _deal_or_error(R, rwl, rpf, R.Objective(mini, bound), mode=mode)
            got = _deal_or_error(P, wl, pf, P.Objective(mini, bound), mode=mode, device=CPU)
            assert got == want, (mode, mini, bound)
            errors += isinstance(want[0], str)
        assert (_deal(P.plan_with_deal(wl, pf, device=CPU))
                == _deal(R.plan_with_deal(rwl, rpf)))
    assert errors > 0


@pytest.mark.parametrize("exp", ["R1", "R4", "E3"])
def test_deal_state_equals_the_per_candidate_loop_and_the_reference(exp):
    """The stacked greedy state reproduces ``_deal_metrics`` bit for bit on
    every candidate processor joining every interval, as the reference's does."""
    (rwl, rpf), (wl, pf) = (r_gen_instance(exp, 12, 10, seed=5),
                            gen_instance(exp, 12, 10, seed=5))
    base = P.plan(wl, pf, P.Objective("period"), mode="auto", device=CPU).mapping
    rbase = R.plan(rwl, rpf, R.Objective("period"), mode="auto").mapping
    st, rst = pdeal._DealState(wl, pf, base), rdeal._DealState(rwl, rpf, rbase)
    assert st.metrics(st.rate, st.smin) == rst.metrics(rst.rate, rst.smin)
    free = [u for u in range(pf.p) if u not in base.alloc]
    for j in range(base.m):
        got = st.candidate_metrics(j, pf.s[free])
        assert got.tobytes() == rst.candidate_metrics(j, rpf.s[free]).tobytes()
        for f, u in enumerate(free):
            groups = [[a] for a in base.alloc]
            groups[j].append(u)
            assert (got[f, 0], got[f, 1]) == pdeal._deal_metrics(wl, pf, base, groups)
            assert (pdeal._deal_metrics(wl, pf, base, groups)
                    == rdeal._deal_metrics(rwl, rpf, rbase, groups))
    st.accept(0, float(pf.s[free[0]]))
    rst.accept(0, float(rpf.s[free[0]]))
    assert st.metrics(st.rate, st.smin) == rst.metrics(rst.rate, rst.smin)


def test_deal_solver_equals_the_reference():
    """The registry entry alone and in a request that admits grouped
    solvers; a request that does not admit them never runs it."""
    spec, rspec = P.get_solver("deal"), R.get_solver("deal")
    assert ((spec.optimizes, spec.needs_bound, spec.max_p, spec.supports_groups,
             spec.auto, spec.description, spec.fn.__name__)
            == (rspec.optimizes, rspec.needs_bound, rspec.max_p, rspec.supports_groups,
                rspec.auto, rspec.description, rspec.fn.__name__))
    for (rwl, rpf), (wl, pf) in _random_pairs(3, 3):
        lopt = R.optimal_latency(rwl, rpf)
        for mini, bound in (("period", None), ("period", lopt * 1.2),
                            ("period", lopt * 0.5), ("latency", None)):
            want = R.solve("deal", rwl, rpf, R.Objective(mini, bound))
            got = P.solve("deal", wl, pf, P.Objective(mini, bound), device=CPU)
            assert _cand(got) == _cand(want), (mini, bound)
        for allow in (False, True):
            want = R.plan_request(R.PlanRequest(rwl, rpf, R.Objective("period"),
                                                allow_groups=allow))
            got = P.plan_request(P.PlanRequest(wl, pf, P.Objective("period"),
                                               allow_groups=allow), device=CPU)
            assert [_cand(c) for c in got.candidates] == [_cand(c) for c in want.candidates]
            assert _cand(got.chosen) == _cand(want.chosen) and got.pareto == want.pareto
            assert ("deal" in [c.solver for c in got.candidates]) == allow
            assert _stage(got.plan) == _stage(want.plan)
    assert math.isinf(P.solve("deal", wl, pf, P.Objective("latency"), device=CPU).period)
