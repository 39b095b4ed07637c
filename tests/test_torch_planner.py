"""The port's planner API against the JAX package's, on the CPU: heuristics,
exact solvers, Pareto sweeps, the solver registry and the planner.

Both packages get the same instances, built from the same numpy arrays in
the ways ``tests/test_heuristics.py``, ``test_exact.py``, ``test_solvers.py``
and ``test_planner.py`` build them (n <= 16, p <= 10).  The port runs with
``device="cpu"``, where its split scoring takes the kernels' plain PyTorch
versions.  Tolerance: none; every float, mapping, flag and error string is
``==`` the reference's (wall times excepted).
"""

import itertools
import math

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.core import heuristics as rh
from repro_torch.core import heuristics as ph
from repro_torch.core import planner as pplanner
from repro_torch.core import solvers as psolvers

CPU = "cpu"


def _pair(w, delta, s, b):
    """The same instance in both packages."""
    return ((R.make_workload(w, delta), R.make_platform(s, b)),
            (P.make_workload(w, delta), P.make_platform(s, b)))


def _rand_instance(rng, n_max=17, p_max=11):
    """tests/test_heuristics.py's instances, n and p capped at 16 and 10."""
    n = int(rng.integers(2, n_max))
    p = int(rng.integers(2, p_max))
    return _pair(rng.integers(1, 21, n).astype(float),
                 rng.integers(1, 101, n + 1).astype(float),
                 rng.integers(1, 21, p).astype(float), 10.0)


def _rand_small(rng, n_max=7, p_max=4):
    """tests/test_exact.py's instances."""
    n = int(rng.integers(2, n_max))
    p = int(rng.integers(2, p_max))
    return _pair(rng.integers(1, 11, n).astype(float),
                 rng.integers(0, 21, n + 1).astype(float),
                 rng.integers(1, 11, p).astype(float), 5.0)


def _solver_instance(seed, homogeneous=False):
    """tests/test_solvers.py's ``_instance``."""
    rng = np.random.default_rng(seed)
    n, p = int(rng.integers(4, 10)), int(rng.integers(3, 6))
    w = rng.integers(1, 21, n).astype(float)
    delta = rng.integers(1, 51, n + 1).astype(float)
    s = np.full(p, 4.0) if homogeneous else rng.integers(1, 21, p).astype(float)
    return _pair(w, delta, s, 10.0)


def _mp(m):
    return None if m is None else (m.intervals, m.alloc)


def _res(r):
    return (_mp(r.mapping), r.period, r.latency, r.feasible, r.splits, r.name)


def _obj(o):
    return (o.minimize, o.bound)


def _cand(c):
    """Everything a Candidate carries but its wall time."""
    return (c.solver, _obj(c.objective), _mp(c.mapping), c.period, c.latency,
            c.feasible, c.groups, c.error, c.reliability)


def _stage(sp):
    return (None if sp is None else
            (_mp(sp.mapping), sp.period, sp.latency, sp.planner, sp.stage_sizes,
             sp.max_stage_size, sp.padding_overhead, sp.groups))


def _report(rep):
    return ([_cand(c) for c in rep.candidates], rep.pareto,
            None if rep.chosen is None else _cand(rep.chosen), _stage(rep.plan),
            _obj(rep.request.objective), rep.feasible)


def _bound(rng, code, wl, pf):
    if code in ("H1", "H2", "H3", "H4"):
        return float(rng.uniform(0.1, 50))
    return R.optimal_latency(wl, pf) * float(rng.uniform(1.0, 3.0))


# ---------------------------------------------------------------------------
# Heuristics
# ---------------------------------------------------------------------------

HEURISTICS = ["H1", "H2", "H3", "H4", "H5", "H6"]


@pytest.mark.parametrize("code", HEURISTICS)
def test_fast_paths_match_reference_mode_in_the_port(code):
    """The fast paths (scores from ``score_kernels``) choose what the
    generator paths of ``reference_mode`` choose."""
    rng = np.random.default_rng(42)
    for _ in range(15):
        (rwl, rpf), (wl, pf) = _rand_instance(rng)
        bound = _bound(rng, code, rwl, rpf)
        fast = P.run_heuristic(code, wl, pf, bound, device=CPU)
        with ph.reference_mode():
            ref = P.run_heuristic(code, wl, pf, bound, device=CPU)
        assert _res(fast) == _res(ref), (code, bound)
    assert not ph._State.force_reference


@pytest.mark.parametrize("code", HEURISTICS)
def test_heuristic_results_equal_the_reference(code):
    rng = np.random.default_rng(7)
    for _ in range(15):
        (rwl, rpf), (wl, pf) = _rand_instance(rng)
        for frac in (0.5, 0.9, 1.3):
            bound = _bound(rng, code, rwl, rpf) * frac
            want = R.run_heuristic(code, rwl, rpf, bound)
            assert _res(P.run_heuristic(code, wl, pf, bound, device=CPU)) == _res(want)
    # the named functions, the registries and the names are the reference's
    fn = {**P.FIXED_PERIOD_HEURISTICS, **P.FIXED_LATENCY_HEURISTICS}[code]
    assert fn.__name__ == {**R.FIXED_PERIOD_HEURISTICS, **R.FIXED_LATENCY_HEURISTICS}[code].__name__
    assert P.NAMES[code] == R.NAMES[code]


@pytest.mark.parametrize("code", ["H1", "H2", "H3", "H4"])
def test_split_trajectories_equal_the_reference(code):
    rng = np.random.default_rng(11)
    for _ in range(12):
        (rwl, rpf), (wl, pf) = _rand_instance(rng)
        assert (ph.split_trajectory(code, wl, pf, device=CPU)
                == rh.split_trajectory(code, rwl, rpf))


@pytest.mark.parametrize("iters", [0, 3, 40])
def test_sp_bi_p_bisection_equals_the_reference(iters):
    rng = np.random.default_rng(5)
    for _ in range(10):
        (rwl, rpf), (wl, pf) = _rand_instance(rng)
        bound = R.period(rwl, rpf, R.single_processor_mapping(rwl, rpf.fastest())) * 0.6
        assert (_res(P.sp_bi_p(wl, pf, bound, iters=iters, device=CPU))
                == _res(R.sp_bi_p(rwl, rpf, bound, iters=iters)))


def test_min_period_exhaustive_equals_the_reference_and_the_lockstep_engine():
    from repro_torch.core.batched import ProblemBatch, batched_min_period

    rng = np.random.default_rng(13)
    pairs = [_rand_instance(rng) for _ in range(12)]
    for (rwl, rpf), (wl, pf) in pairs:
        got = P.min_period_exhaustive(wl, pf, device=CPU)
        assert _res(got) == _res(R.min_period_exhaustive(rwl, rpf))
        pb = ProblemBatch.from_arrays(wl.w[None], wl.delta[None], pf.s[None], pf.b,
                                      device=CPU)
        assert _res(batched_min_period(pb)[0]) == _res(got)


def test_heuristics_score_on_the_enclosing_device_and_raise_on_unknown_codes():
    (_, _), (wl, pf) = _rand_instance(np.random.default_rng(1))
    with ph.scoring_device(CPU) as dev:
        assert str(dev) == "cpu"
        inner = P.run_heuristic("H5", wl, pf, math.inf)   # no device: the block's
    assert _res(inner) == _res(P.run_heuristic("H5", wl, pf, math.inf, device=CPU))
    with pytest.raises(KeyError):
        P.run_heuristic("H7", wl, pf, 1.0, device=CPU)
    with pytest.raises(KeyError):
        ph.split_trajectory("H5", wl, pf, device=CPU)


# ---------------------------------------------------------------------------
# Exact solvers and DPs (numpy on the host)
# ---------------------------------------------------------------------------

def _exact_cases(name):
    rng = np.random.default_rng({"brute_force": 0, "exact_min_period": 1,
                                 "exact_min_latency": 2, "dp_homogeneous_period": 3,
                                 "dp_speed_ordered": 4, "pareto_exact": 5}[name])
    for _ in range(10):
        yield _rand_small(rng)


@pytest.mark.parametrize("name", ["brute_force", "exact_min_period", "exact_min_latency",
                                  "dp_homogeneous_period", "dp_speed_ordered",
                                  "pareto_exact"])
def test_exact_solvers_equal_the_reference(name):
    for (rwl, rpf), (wl, pf) in _exact_cases(name):
        front = R.pareto_exact(rwl, rpf)
        lat_cap = (min(l for _, l in front) + max(l for _, l in front)) / 2
        per_cap = (min(p for p, _ in front) + max(p for p, _ in front)) / 2
        if name == "brute_force":
            for kw in ({}, dict(latency_cap=lat_cap), dict(period_cap=per_cap),
                       dict(period_cap=per_cap, objective="latency")):
                assert _mp(P.brute_force(wl, pf, **kw)) == _mp(R.brute_force(rwl, rpf, **kw))
        elif name == "exact_min_period":
            for cap in (math.inf, lat_cap, 0.0):
                assert (_mp(P.exact_min_period(wl, pf, latency_cap=cap))
                        == _mp(R.exact_min_period(rwl, rpf, latency_cap=cap)))
        elif name == "exact_min_latency":
            for cap in (math.inf, per_cap, 0.0):
                assert (_mp(P.exact_min_latency(wl, pf, period_cap=cap))
                        == _mp(R.exact_min_latency(rwl, rpf, period_cap=cap)))
        elif name == "dp_homogeneous_period":
            s = float(rpf.s[0])
            assert (P.dp_homogeneous_period(wl, pf.p, s, pf.b)
                    == R.dp_homogeneous_period(rwl, rpf.p, s, rpf.b))
        elif name == "dp_speed_ordered":
            for cap in (math.inf, lat_cap):
                assert (_mp(P.dp_speed_ordered(wl, pf, latency_cap=cap))
                        == _mp(R.dp_speed_ordered(rwl, rpf, latency_cap=cap)))
        else:
            assert P.pareto_exact(wl, pf) == front


def test_evaluate_batch_and_partitions_equal_the_reference():
    rng = np.random.default_rng(12)
    for _ in range(5):
        (rwl, rpf), (wl, pf) = _rand_small(rng, n_max=8, p_max=5)
        n, p = wl.n, pf.p
        parts = [iv for m in range(1, min(n, p) + 1) for iv in P.all_interval_partitions(n, m)]
        assert parts == [iv for m in range(1, min(n, p) + 1)
                         for iv in R.all_interval_partitions(n, m)]
        want = [R.Mapping(iv, procs) for iv in parts
                for procs in itertools.permutations(range(p), len(iv))]
        got = [P.Mapping(iv, procs) for iv in parts
               for procs in itertools.permutations(range(p), len(iv))]
        for mp in got:
            mp.validate(n, p)
        assert np.array_equal(P.evaluate_batch(wl, pf, got), R.evaluate_batch(rwl, rpf, want))
        assert P.evaluate_batch(wl, pf, []).shape == (0, 2)
    assert P.intervals_from_cuts(9, [2, 5]) == R.intervals_from_cuts(9, [2, 5])
    with pytest.raises(ValueError):
        P.Mapping(((1, 2), (4, 5)), (0, 1)).validate(5, 2)


def test_platform_events_equal_the_reference():
    s, fail = [4.0, 2.0, 8.0], [0.01, 0.02, 0.03]
    for kw in ({}, {"fail": fail}):
        rpf, pf = R.make_platform(s, 10.0, **kw), P.make_platform(s, 10.0, **kw)
        for a, b in ((rpf.degrade(2, 3.0), pf.degrade(2, 3.0)),
                     (rpf.degrade(0, 2.0).degrade(1, 2.0), pf.degrade(0, 2.0).degrade(1, 2.0)),
                     (rpf.without(1), pf.without(1)), (rpf.without(0).without(0),
                                                       pf.without(0).without(0))):
            assert np.array_equal(a.s, b.s) and a.b == b.b and a.name == b.name
            assert (a.fail is None) == (b.fail is None)
            assert a.fail is None or np.array_equal(a.fail, b.fail)
    hr, hp = R.homogeneous_platform(5, 2.0), P.homogeneous_platform(5, 2.0)
    assert np.array_equal(hr.s, hp.s) and (hr.b, hr.name) == (hp.b, hp.name)
    with pytest.raises(ValueError):
        P.make_platform([1.0], 1.0).without(0)
    with pytest.raises(ValueError):
        pf.degrade(0, 0.0)


# ---------------------------------------------------------------------------
# Pareto sweeps
# ---------------------------------------------------------------------------

def test_pareto_fronts_and_grids_equal_the_reference():
    rng = np.random.default_rng(9)
    pts = [(float(a), float(b)) for a, b in rng.integers(1, 30, (60, 2))]
    pts += [(pts[0][0] * (1 + 1e-12), pts[0][1])]
    assert P.pareto_front(pts) == R.pareto_front(pts)
    tri = [(float(a), float(b), float(c)) for a, b, c in
           zip(rng.integers(1, 9, 80), rng.integers(1, 9, 80), rng.uniform(0.5, 1.0, 80))]
    assert P.pareto_front_tri(tri) == R.pareto_front_tri(tri)
    from repro.core import pareto as rpar
    from repro_torch.core import pareto as ppar

    (rwl, rpf), (wl, pf) = _solver_instance(3)
    for k in (1, 7, 20):
        assert np.array_equal(ppar.default_period_grid(wl, pf, k),
                              rpar.default_period_grid(rwl, rpf, k))
        assert np.array_equal(ppar.default_latency_grid(wl, pf, k),
                              rpar.default_latency_grid(rwl, rpf, k))


@pytest.mark.parametrize("code", HEURISTICS)
def test_sweeps_equal_the_reference(code):
    from repro.core import pareto as rpar

    (rwl, rpf), (wl, pf) = _solver_instance(4)
    grid = (rpar.default_period_grid(rwl, rpf, 6) if code in ("H1", "H2", "H3", "H4")
            else rpar.default_latency_grid(rwl, rpf, 6))
    assert ([_res(r) for r in P.sweep_heuristic(code, wl, pf, grid, device=CPU)]
            == [_res(r) for r in R.sweep_heuristic(code, rwl, rpf, grid)])
    assert ([_cand(c) for c in P.sweep_solver(code, wl, pf, grid, device=CPU)]
            == [_cand(c) for c in R.sweep_solver(code, rwl, rpf, grid)])


def test_tradeoff_curves_equal_the_reference_on_the_ungrouped_solvers():
    (rwl, rpf), (wl, pf) = _solver_instance(5)
    got = P.tradeoff_curves(wl, pf, k=6, device=CPU)
    want = R.tradeoff_curves(rwl, rpf, k=6)
    assert list(got) == ["H1", "H2", "H3", "H4", "H5", "H6"]
    assert got == {name: want[name] for name in got}


# ---------------------------------------------------------------------------
# Solver registry
# ---------------------------------------------------------------------------

UNGROUPED = [s.name for s in R.registered_solvers() if not s.supports_groups]


def test_registry_is_the_reference_ungrouped_portfolio_in_order():
    assert UNGROUPED == ["single", "H1", "H2", "H3", "H4", "H5", "H6", "dp-speed-ordered",
                         "dp-homogeneous", "exact", "exact-latency", "brute-force"]
    assert P.solver_names() == UNGROUPED
    grouped = [s.name for s in R.registered_solvers() if s.supports_groups]
    assert len(grouped) == 7 and not set(grouped) & set(P.solver_names())
    (_, _), (wl, pf) = _solver_instance(0)
    (_, _), (hwl, hpf) = _solver_instance(1, homogeneous=True)
    for got in P.registered_solvers():
        want = R.get_solver(got.name)
        assert ((got.optimizes, got.needs_bound, got.max_p, got.supports_groups, got.auto,
                 got.description, got.predicate is None)
                == (want.optimizes, want.needs_bound, want.max_p, want.supports_groups,
                    want.auto, want.description, want.predicate is None)), got.name
        if got.predicate is not None:
            for w_, p_ in ((wl, pf), (hwl, hpf)):
                assert got.predicate(w_, p_) == want.predicate(w_, p_)
    with pytest.raises(KeyError):
        P.get_solver("deal")
    with pytest.raises(ValueError):
        P.register_solver("x", optimizes="energy")


@pytest.mark.parametrize("name", UNGROUPED)
def test_every_solver_candidate_equals_the_reference(name):
    spec = R.get_solver(name)
    (rwl, rpf), (wl, pf) = _solver_instance(1 if name == "dp-homogeneous" else 0,
                                            homogeneous=name == "dp-homogeneous")
    minimize = "latency" if spec.optimizes == "latency" else "period"
    other = "period" if minimize == "latency" else "latency"
    hi = R.period(rwl, rpf, R.single_processor_mapping(rwl, rpf.fastest()))
    lopt = R.optimal_latency(rwl, rpf)
    bounds = [None, (hi * 0.6 if other == "period" else lopt * 1.4),
              (hi * 0.05 if other == "period" else lopt * 0.9)]
    directions = [minimize] + (["latency"] if spec.optimizes == "both" else [])
    for mini in directions:
        for bound in bounds:
            for kw in ({}, {"exact_max_p": 0}):
                want = R.solve(name, rwl, rpf, R.Objective(mini, bound), **kw)
                got = P.solve(name, wl, pf, P.Objective(mini, bound), device=CPU, **kw)
                assert _cand(got) == _cand(want), (name, mini, bound, kw)
                assert got.point == want.point and got.point_tri == want.point_tri
    if spec.optimizes != "both":   # the wrong direction is not applicable
        wrong = "period" if minimize == "latency" else "latency"
        assert (_cand(P.solve(name, wl, pf, P.Objective(wrong), device=CPU))
                == _cand(R.solve(name, rwl, rpf, R.Objective(wrong))))


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

def _seed_cases():
    """tests/test_solvers.py's ``_seed_cases`` for both packages."""
    for seed in range(8):
        rng = np.random.default_rng(seed)
        n, p = int(rng.integers(4, 16)), int(rng.integers(3, 9))
        (rwl, rpf), (wl, pf) = _pair(rng.integers(1, 21, n).astype(float),
                                     rng.integers(1, 51, n + 1).astype(float),
                                     rng.integers(1, 21, p).astype(float), 10.0)
        hi = R.period(rwl, rpf, R.single_processor_mapping(rwl, rpf.fastest()))
        lopt = R.optimal_latency(rwl, rpf)
        for mini, bound in (("period", None), ("period", lopt * 1.5),
                            ("latency", None), ("latency", hi * 0.5)):
            yield (rwl, rpf, R.Objective(mini, bound)), (wl, pf, P.Objective(mini, bound))


def _plan_or_error(mod, *args, **kw):
    try:
        return _stage(mod.plan(*args, **kw))
    except Exception as ex:  # noqa: BLE001 — the error is the result compared
        return (type(ex).__name__, str(ex))


@pytest.mark.parametrize("mode", ["auto", "exact", "H1", "H2", "H3", "H4", "H5", "H6"])
def test_plan_facade_equals_the_reference(mode):
    """Every mode on the seed cases, InfeasiblePlan and the facade's other
    errors included."""
    errors = 0
    for (rwl, rpf, robj), (wl, pf, obj) in _seed_cases():
        want = _plan_or_error(R, rwl, rpf, robj, mode=mode)
        got = _plan_or_error(P, wl, pf, obj, mode=mode, device=CPU)
        assert got == want, (mode, robj)
        errors += isinstance(want[0], str)
    assert errors > 0  # InfeasiblePlan (or the bound/size errors) was exercised
    assert _plan_or_error(P, wl, pf, obj, mode="H9", device=CPU)[0] == "KeyError"


@pytest.mark.parametrize("seed", range(4))
def test_plan_request_reports_equal_the_reference(seed):
    (rwl, rpf), (wl, pf) = _solver_instance(seed)
    base = R.plan_request(R.PlanRequest(rwl, rpf, R.Objective("period"))).plan
    for kw in ({}, {"exclude": ("exact",)}, {"include": ("single", "H5")},
               {"exact_max_p": 0}, {"selection": "knee"}, {"selection": "min-latency"},
               {"include": ("brute-force", "dp-homogeneous", "exact-latency")}):
        for objs in ((("period", None),), (("latency", None),),
                     (("period", None), ("latency", base.latency)),
                     (("latency", base.period * 0.8), ("period", None)),
                     (("period", base.latency * 0.99),)):
            want = R.plan_request(R.PlanRequest(
                rwl, rpf, tuple(R.Objective(*o) for o in objs), **kw))
            got = P.plan_request(P.PlanRequest(
                wl, pf, tuple(P.Objective(*o) for o in objs), **kw), device=CPU)
            assert _report(got) == _report(want), (kw, objs)
            assert got.best() is None or _cand(got.best()) == _cand(want.best())


def test_auto_requests_equal_the_reference():
    assert pplanner.AUTO_PORTFOLIO == R.AUTO_PORTFOLIO
    for (rwl, rpf, robj), (wl, pf, obj) in _seed_cases():
        want = R.plan_request(R.auto_request(rwl, rpf, robj))
        got = P.plan_request(P.auto_request(wl, pf, obj), device=CPU)
        assert _report(got) == _report(want), robj


@pytest.mark.parametrize("selection", ["knee", "lexicographic", "min-period", "min-latency"])
def test_plan_pareto_reports_equal_the_reference(selection):
    for seed in (5, 6):
        (rwl, rpf), (wl, pf) = _solver_instance(seed)
        for kw in ({"k": 8}, {"k": 3, "exclude": ("H4",)}, {"k": 4, "exact_max_p": 0},
                   {"k": 2, "include": ("single", "H1", "H5", "exact")}):
            want = R.plan_pareto(rwl, rpf, selection=selection, **kw)
            got = P.plan_pareto(wl, pf, selection=selection, device=CPU, **kw)
            assert _report(got) == _report(want), (seed, kw)


def test_time_budget_skips_equal_the_reference():
    (rwl, rpf), (wl, pf) = _solver_instance(8)
    want = R.plan_request(R.PlanRequest(rwl, rpf, R.Objective("period"), time_budget=0.0))
    got = P.plan_request(P.PlanRequest(wl, pf, P.Objective("period"), time_budget=0.0),
                         device=CPU)
    assert _report(got) == _report(want)
    assert got.plan is None and all(c.error == "skipped: time budget exhausted"
                                    and c.wall_time == 0.0 for c in got.candidates)
    want = R.plan_pareto(rwl, rpf, k=3, time_budget=0.0)
    got = P.plan_pareto(wl, pf, k=3, time_budget=0.0, device=CPU)
    assert _report(got) == _report(want) and not got.feasible
    assert got.summary().splitlines()[0] == want.summary().splitlines()[0]


def test_infeasible_plan_raises_like_the_reference():
    (rwl, rpf), (wl, pf) = _pair([10.0], [0, 0], [1.0], 1.0)
    with pytest.raises(R.InfeasiblePlan):
        R.plan(rwl, rpf, R.Objective("latency", bound=0.001), mode="auto")
    with pytest.raises(P.InfeasiblePlan, match="no planner produced a feasible mapping"):
        P.plan(wl, pf, P.Objective("latency", bound=0.001), mode="auto", device=CPU)
    rep = P.plan_request(P.auto_request(wl, pf, P.Objective("latency", bound=0.001)),
                         device=CPU)
    want = R.plan_request(R.auto_request(rwl, rpf, R.Objective("latency", bound=0.001)))
    assert _report(rep) == _report(want)
    assert rep.plan is None and rep.chosen is None and not rep.feasible
    with pytest.raises(ValueError):
        P.Objective("energy")
    with pytest.raises(ValueError):
        P.PlanRequest(wl, pf, ())
    with pytest.raises(KeyError):
        P.PlanRequest(wl, pf, P.Objective("period"), selection="nope")
    with pytest.raises(KeyError):
        P.PlanRequest(wl, pf, P.Objective("period"), include=("deal",))


def test_plugin_solver_with_three_arguments_and_plugin_selection():
    """A solver registered with the reference's signature ``fn(workload,
    platform, objective)`` runs on the request's device, and a plugin
    selection policy picks from the candidates — in both packages alike."""
    (rwl, rpf), (wl, pf) = _solver_instance(3)
    seen = []

    def mine(mod, record):
        def fn(workload, platform, objective):
            if record:
                seen.append(str(ph._SCORING_DEVICE.get()))
            # a heuristic called without a device: it scores on the request's
            res = mod.run_heuristic("H6", workload, platform, math.inf)
            return mod.single_processor_mapping(workload, platform.p - 1) if res.splits > 9 \
                else res.mapping
        return fn

    def first_feasible(candidates, request):
        return next((c for c in candidates if c.mapping is not None and c.feasible), None)

    R.register_solver("test-plugin", optimizes="both", description="test plugin")(mine(R, False))
    P.register_solver("test-plugin", optimizes="both", description="test plugin")(mine(P, True))
    R.register_selection("test-first-feasible")(first_feasible)
    P.register_selection("test-first-feasible")(first_feasible)
    try:
        for sel in ("lexicographic", "test-first-feasible"):
            want = R.plan_request(R.PlanRequest(rwl, rpf, R.Objective("period"),
                                                include=("H5", "test-plugin"), selection=sel))
            got = P.plan_request(P.PlanRequest(wl, pf, P.Objective("period"),
                                               include=("H5", "test-plugin"), selection=sel),
                                 device=CPU)
            assert _report(got) == _report(want), sel
            assert _cand(P.solve("test-plugin", wl, pf, P.Objective("latency"), device=CPU)) \
                == _cand(R.solve("test-plugin", rwl, rpf, R.Objective("latency")))
        assert seen and set(seen) == {"cpu"}
        with pytest.raises(ValueError, match="already registered"):
            P.register_solver("test-plugin")(mine(P, False))
    finally:
        from repro.core import solvers as rsolvers
        from repro.core.planner import SELECTION_POLICIES as RSEL

        rsolvers._REGISTRY.pop("test-plugin")
        psolvers._REGISTRY.pop("test-plugin")
        RSEL.pop("test-first-feasible")
        pplanner.SELECTION_POLICIES.pop("test-first-feasible")


def test_solver_errors_are_reported_like_the_reference():
    (rwl, rpf), (wl, pf) = _solver_instance(4)

    def crash(workload, platform, objective):
        raise RuntimeError("boom")

    R.register_solver("test-crash", optimizes="both")(crash)
    P.register_solver("test-crash", optimizes="both")(crash)
    try:
        want = R.plan_request(R.PlanRequest(rwl, rpf, R.Objective("period"),
                                            include=("single", "test-crash")))
        got = P.plan_request(P.PlanRequest(wl, pf, P.Objective("period"),
                                           include=("single", "test-crash")), device=CPU)
        assert _report(got) == _report(want)
        assert [c.error for c in got.candidates] == [None, "RuntimeError: boom"]
        assert (_cand(P.solve("test-crash", wl, pf, P.Objective("period"), device=CPU))
                == _cand(R.solve("test-crash", rwl, rpf, R.Objective("period"))))
    finally:
        from repro.core import solvers as rsolvers

        rsolvers._REGISTRY.pop("test-crash")
        psolvers._REGISTRY.pop("test-crash")


@pytest.mark.parametrize("slow", [None, (1, 2.0), (0, 1.2), (2, 3.5)])
def test_replan_for_straggler_equals_the_reference(slow):
    """tests/test_planner.py's straggler case on a small heterogeneous
    pipeline: observed times slowed on one stage (or none)."""
    rng = np.random.default_rng(21)
    (rwl, rpf), (wl, pf) = _pair(rng.integers(1, 21, 12).astype(float),
                                 rng.integers(1, 51, 13).astype(float),
                                 rng.integers(5, 21, 6).astype(float), 10.0)
    p0r = R.plan(rwl, rpf, R.Objective("period"), mode="auto")
    p0 = P.plan(wl, pf, P.Objective("period"), mode="auto", device=CPU)
    assert _stage(p0) == _stage(p0r)
    observed = R.interval_cycle_times(rwl, rpf, p0r.mapping)
    assert np.array_equal(P.interval_cycle_times(wl, pf, p0.mapping), observed)
    observed = observed.copy()
    if slow is not None and slow[0] < len(observed):
        observed[slow[0]] *= slow[1]
    new_r, deg_r = R.replan_for_straggler(rwl, rpf, p0r, observed)
    new, deg = P.replan_for_straggler(wl, pf, p0, observed, device=CPU)
    assert _stage(new) == _stage(new_r)
    assert np.array_equal(deg.s, deg_r.s) and deg.name == deg_r.name
    with pytest.raises(ValueError):
        P.replan_for_straggler(wl, pf, p0, observed[:-1], device=CPU)
