"""The port's reliability layer against the JAX package's, on the CPU:
failure samplers, replicated mappings and the reliability metric, greedy
replication, the ``-rel`` solvers and tri-criteria planning.

Every case of ``tests/test_reliability.py`` runs on the port, and the same
seeded inputs go through both packages, whose outputs must be ``==``
(tolerance: none; wall times excepted).  The port runs with
``device="cpu"``, where its split scoring takes the kernels' plain PyTorch
versions.
"""

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.sim.generators import gen_instance as r_gen_instance
from repro_torch.sim import RELIABILITY_FAMILIES
from repro_torch.sim.generators import gen_instance

CPU = "cpu"
SEED = 1234
REL = ["H1-rel", "H2-rel", "H3-rel", "H4-rel", "H5-rel", "H6-rel"]


def _instance(exp="R1", n=8, p=6, seed=SEED):
    return gen_instance(exp, n, p, seed=seed)


def _pair(exp, n, p, seed=SEED):
    return r_gen_instance(exp, n, p, seed=seed), gen_instance(exp, n, p, seed=seed)


def _mp(m):
    return None if m is None else (m.intervals, getattr(m, "groups", None) or m.alloc)


def _cand(c):
    """Everything a Candidate carries but its wall time."""
    return (c.solver, c.objective.minimize, c.objective.bound,
            None if c.mapping is None else (c.mapping.intervals, c.mapping.alloc),
            c.period, c.latency, c.feasible, c.groups, c.error, c.reliability)


def _stage(sp):
    return (None if sp is None else
            (sp.mapping.intervals, sp.mapping.alloc, sp.period, sp.latency, sp.planner,
             sp.stage_sizes, sp.max_stage_size, sp.padding_overhead, sp.groups))


def _report(rep):
    return ([_cand(c) for c in rep.candidates], rep.pareto,
            None if rep.chosen is None else _cand(rep.chosen), _stage(rep.plan),
            [(o.minimize, o.bound) for o in rep.request.objectives],
            rep.request.allow_groups, rep.request.exclude,
            rep.feasible)


def _base_plan(wl, pf):
    return P.solve("H5", wl, pf, P.Objective("period"), device=CPU)


# ---------------------------------------------------------------------------
# Failure samplers and the platform's failure vector
# ---------------------------------------------------------------------------

def test_sample_failures_deterministic_and_bounded():
    for kind in ("uniform", "bimodal", "loguniform"):
        a = P.sample_failures(16, kind=kind, seed=3)
        b = P.sample_failures(16, kind=kind, seed=3)
        np.testing.assert_array_equal(a, b)
        assert a.shape == (16,)
        assert np.all(a >= 0.0) and np.all(a < 1.0)
    with pytest.raises(ValueError):
        P.sample_failures(4, kind="nope", seed=0)


@pytest.mark.parametrize("kind", ["uniform", "bimodal", "loguniform"])
def test_sample_failures_equal_the_reference(kind):
    """Seeded and stream-consuming draws give the reference's bytes, and
    leave a shared generator where the reference leaves it."""
    for p, kw in ((1, {}), (16, {}), (100, {"lo": 1e-4, "hi": 0.3}), (7, {"hi": 0.5})):
        for seed in (0, 3, SEED):
            a = P.sample_failures(p, kind=kind, seed=seed, **kw)
            b = R.sample_failures(p, kind=kind, seed=seed, **kw)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        ra, rb = np.random.default_rng(9), np.random.default_rng(9)
        a = P.sample_failures(p, kind=kind, rng=ra, **kw)
        b = R.sample_failures(p, kind=kind, rng=rb, **kw)
        assert a.tobytes() == b.tobytes() and ra.random() == rb.random()


def test_platform_failure_vector_equals_the_reference():
    s, fail = [4.0, 2.0, 8.0], [0.01, 0.02, 0.03]
    for kw in ({}, {"fail": fail}):
        rpf, pf = R.make_platform(s, 10.0, **kw), P.make_platform(s, 10.0, **kw)
        assert pf.failures.tobytes() == rpf.failures.tobytes()
        for new in (None, [0.1, 0.2, 0.3], np.array([0.0, 0.5, 0.25])):
            a, b = pf.with_failures(new), rpf.with_failures(new)
            assert (a.fail is None) == (b.fail is None) and a.name == b.name
            assert a.s.tobytes() == b.s.tobytes() and a.b == b.b
            assert a.failures.tobytes() == b.failures.tobytes()
    with pytest.raises(ValueError):
        P.make_platform(s, 10.0).with_failures([0.1, 1.0, 0.2])
    with pytest.raises(ValueError):
        P.make_platform(s, 10.0).with_failures([0.1, 0.2])


def test_r_families_share_workload_streams():
    """R1 draws failure probabilities LAST: its workload and speeds are
    byte-identical to E2's at the same (n, p, seed) — reliability columns can
    be compared against bi-criteria results on literally the same instances."""
    wl_r, pf_r = _instance("R1")
    wl_e, pf_e = _instance("E2")
    np.testing.assert_array_equal(wl_r.w, wl_e.w)
    np.testing.assert_array_equal(wl_r.delta, wl_e.delta)
    np.testing.assert_array_equal(pf_r.s, pf_e.s)
    assert pf_e.fail is None
    assert pf_r.fail is not None and np.all(pf_r.fail > 0)
    for exp in RELIABILITY_FAMILIES:
        _, pf = _instance(exp)
        assert pf.fail is not None
        (_, rpf) = r_gen_instance(exp, 8, 6, seed=SEED)
        assert pf.fail.tobytes() == rpf.fail.tobytes()


# ---------------------------------------------------------------------------
# Replicated mappings and the reliability metric
# ---------------------------------------------------------------------------

def test_replicated_mapping_equals_the_reference():
    iv, groups = ((1, 3), (4, 8)), ((2, 5), (0,))
    rm, rr = P.ReplicatedMapping(iv, groups), R.ReplicatedMapping(iv, groups)
    assert (rm.intervals, rm.groups, rm.alloc, rm.m) == (rr.intervals, rr.groups,
                                                        rr.alloc, rr.m)
    lead = rm.leader_mapping()
    assert isinstance(lead, P.Mapping) and (lead.intervals, lead.alloc) == (iv, (2, 0))
    rm.validate(8, 6)
    for bad, args in ((P.ReplicatedMapping(iv, ((2, 0), (0,))), (8, 6)),
                      (P.ReplicatedMapping(iv, ((2, 9), (0,))), (8, 6)),
                      (P.ReplicatedMapping(((1, 3), (5, 8)), groups), (8, 6))):
        with pytest.raises(ValueError):
            bad.validate(*args)
    with pytest.raises(ValueError):
        P.ReplicatedMapping(iv, ((2,),))
    with pytest.raises(ValueError):
        P.ReplicatedMapping(iv, ((2,), ()))


def _mixed_mappings(mod, wl, pf, rng, count=24):
    """Plain and replicated mappings of 1-4 intervals over disjoint sets."""
    out = []
    for _ in range(count):
        m = int(rng.integers(1, 5))
        cuts = sorted(rng.choice(np.arange(1, wl.n), m - 1, replace=False).tolist())
        iv = mod.intervals_from_cuts(wl.n, cuts)
        procs = rng.permutation(pf.p).tolist()
        if rng.random() < 0.5:
            out.append(mod.Mapping(iv, procs[:m]))
        else:
            sizes = rng.integers(1, 3, m)
            groups, at = [], 0
            for k in sizes:
                groups.append(tuple(procs[at:at + k]))
                at += k
            out.append(mod.ReplicatedMapping(iv, groups))
    return out


@pytest.mark.parametrize("exp", ["R1", "R3", "E2"])
def test_reliability_and_evaluations_equal_the_reference(exp):
    """The scalar metrics, ``evaluate_tri`` and ``evaluate_batch`` with and
    without the reliability column, over plain, replicated and mixed
    batches: every float ``==`` the reference's."""
    (rwl, rpf), (wl, pf) = _pair(exp, 12, 14)
    got = _mixed_mappings(P, wl, pf, np.random.default_rng(4))
    want = _mixed_mappings(R, rwl, rpf, np.random.default_rng(4))
    for g, w in zip(got, want):
        g.validate(wl.n, pf.p)
        assert P.evaluate_tri(wl, pf, g) == R.evaluate_tri(rwl, rpf, w)
        assert P.reliability(wl, pf, g) == R.reliability(rwl, rpf, w)
        assert np.array_equal(P.interval_cycle_times(wl, pf, g),
                              R.interval_cycle_times(rwl, rpf, w))
        assert P.evaluate(wl, pf, g) == R.evaluate(rwl, rpf, w)
    plain = [i for i, g in enumerate(got) if isinstance(g, P.Mapping)]
    for idx in (range(len(got)), plain, [i for i in range(len(got)) if i not in plain]):
        g, w = [got[i] for i in idx], [want[i] for i in idx]
        for rel in (False, True):
            a = P.evaluate_batch(wl, pf, g, with_reliability=rel)
            b = R.evaluate_batch(rwl, rpf, w, with_reliability=rel)
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), (exp, rel)
    assert P.evaluate_batch(wl, pf, [], with_reliability=True).shape == (0, 3)


def test_evaluate_batch_reliability_matches_scalar():
    wl, pf = _instance("R3", n=8, p=8)
    base = _base_plan(wl, pf).mapping
    rm = P.replicate_greedy(wl, pf, base)
    mappings = [base, rm, base]
    out = P.evaluate_batch(wl, pf, mappings, with_reliability=True)
    assert out.shape == (3, 3)
    for row, mp in zip(out, mappings):
        per, lat, rel = P.evaluate_tri(wl, pf, mp)
        assert row[0] == per and row[1] == lat and row[2] == rel


def test_evaluate_batch_reliability_ones_without_failures():
    wl, pf = _instance("E2")
    base = _base_plan(wl, pf).mapping
    out = P.evaluate_batch(wl, pf, [base, base], with_reliability=True)
    np.testing.assert_array_equal(out[:, 2], [1.0, 1.0])


# ---------------------------------------------------------------------------
# Greedy replication
# ---------------------------------------------------------------------------

def test_replicate_greedy_valid_and_improves():
    wl, pf = _instance()
    base = _base_plan(wl, pf).mapping
    rm = P.replicate_greedy(wl, pf, base)
    rm.validate(wl.n, pf.p)
    assert P.reliability(wl, pf, rm) >= P.reliability(wl, pf, base)
    assert rm.intervals == tuple(base.intervals)
    assert rm.alloc == tuple(base.alloc)   # leaders are the base processors


def test_replicate_greedy_respects_period_bound():
    wl, pf = _instance()
    base = _base_plan(wl, pf).mapping
    bound = P.period(wl, pf, base) * 1.05
    rm = P.replicate_greedy(wl, pf, base, period_bound=bound)
    assert P.period(wl, pf, rm) <= bound * (1 + 1e-12)
    assert P.reliability(wl, pf, rm) >= P.reliability(wl, pf, base)


def test_replicate_greedy_stops_at_target():
    wl, pf = _instance()
    base = _base_plan(wl, pf).mapping
    full = P.replicate_greedy(wl, pf, base)
    target = 0.5 * (P.reliability(wl, pf, base) + P.reliability(wl, pf, full))
    rm = P.replicate_greedy(wl, pf, base, target=target)
    assert P.reliability(wl, pf, rm) >= target - 1e-12
    assert (sum(len(g) for g in rm.groups)
            <= sum(len(g) for g in full.groups))


def test_replicate_greedy_no_failures_is_identity():
    wl, pf = _instance("E2")
    assert pf.fail is None
    base = _base_plan(wl, pf).mapping
    rm = P.replicate_greedy(wl, pf, base)
    assert all(len(g) == 1 for g in rm.groups)
    assert P.period(wl, pf, rm) == P.period(wl, pf, base)
    assert P.latency(wl, pf, rm) == P.latency(wl, pf, base)


@pytest.mark.parametrize("exp", ["R1", "R2", "R3", "R4", "E2"])
def test_replicate_greedy_and_stage_plan_equal_the_reference(exp):
    """Every bound and target combination, from a plain base and from a
    replicated one; ``replicate_stage_plan`` on the portfolio's plan, its
    ``+rel`` suffix applied once."""
    (rwl, rpf), (wl, pf) = _pair(exp, 12, 10)
    rbase = R.solve("H5", rwl, rpf, R.Objective("period")).mapping
    base = _base_plan(wl, pf).mapping
    assert (base.intervals, base.alloc) == (rbase.intervals, rbase.alloc)
    per, lat = R.evaluate(rwl, rpf, rbase)
    full_rel = R.reliability(rwl, rpf, R.replicate_greedy(rwl, rpf, rbase))
    for kw in ({}, {"period_bound": per * 1.05}, {"latency_bound": lat * 1.02},
               {"period_bound": per * 0.5}, {"target": 0.5 * (full_rel + 1.0)},
               {"target": full_rel}, {"target": 0.0},
               {"period_bound": per * 1.2, "latency_bound": lat * 1.2,
                "target": full_rel}):
        got = P.replicate_greedy(wl, pf, base, **kw)
        want = R.replicate_greedy(rwl, rpf, rbase, **kw)
        assert isinstance(got, P.ReplicatedMapping) and _mp(got) == _mp(want), kw
        again = P.replicate_greedy(wl, pf, got, **kw)
        assert _mp(again) == _mp(R.replicate_greedy(rwl, rpf, want, **kw)), kw
    rplan = R.plan(rwl, rpf, R.Objective("period"), mode="auto")
    plan = P.plan(wl, pf, P.Objective("period"), mode="auto", device=CPU)
    assert _stage(plan) == _stage(rplan)
    for kw in ({}, {"target": full_rel}, {"period_bound": rplan.period * 1.1},
               {"latency_bound": rplan.latency}):
        got = P.replicate_stage_plan(wl, pf, plan, **kw)
        want = R.replicate_stage_plan(rwl, rpf, rplan, **kw)
        assert _stage(got) == _stage(want), kw
        assert (got is plan) == (want is rplan)
        assert _stage(P.replicate_stage_plan(wl, pf, got, **kw)) == _stage(
            R.replicate_stage_plan(rwl, rpf, want, **kw))


# ---------------------------------------------------------------------------
# -rel solvers and the tri-criteria portfolio
# ---------------------------------------------------------------------------

def test_rel_solver_degenerates_to_plain_without_failures():
    """On a failure-free platform H1-rel IS H1: same mapping, same metrics,
    bit for bit."""
    wl, pf = _instance("E2")
    bound = 2.0 * P.min_period_exhaustive(wl, pf, device=CPU).period
    plain = P.solve("H1", wl, pf, P.Objective("latency", bound=bound), device=CPU)
    rel = P.solve("H1-rel", wl, pf, P.Objective("latency", bound=bound), device=CPU)
    assert rel.feasible and plain.feasible
    assert rel.mapping == plain.mapping
    assert rel.period == plain.period
    assert rel.latency == plain.latency


def test_rel_solver_meets_bound_and_replicates():
    wl, pf = _instance("R2", n=8, p=8)
    bound = 2.0 * P.min_period_exhaustive(wl, pf, device=CPU).period
    cand = P.solve("H1-rel", wl, pf, P.Objective("latency", bound=bound), device=CPU)
    assert cand.feasible
    assert cand.period <= bound * (1 + 1e-9)
    assert cand.reliability is not None


@pytest.mark.parametrize("name", REL)
def test_every_rel_solver_candidate_equals_the_reference(name):
    """Each ``-rel`` solver over bounds from loose to infeasible, on the R
    families and a failure-free one; its metadata and function name too."""
    spec, rspec = P.get_solver(name), R.get_solver(name)
    assert ((spec.optimizes, spec.needs_bound, spec.max_p, spec.supports_groups,
             spec.auto, spec.description, spec.fn.__name__)
            == (rspec.optimizes, rspec.needs_bound, rspec.max_p, rspec.supports_groups,
                rspec.auto, rspec.description, rspec.fn.__name__))
    for exp in ("R1", "R2", "R3", "R4", "E2"):
        (rwl, rpf), (wl, pf) = _pair(exp, 10, 8)
        hi = R.period(rwl, rpf, R.single_processor_mapping(rwl, rpf.fastest()))
        lopt = R.optimal_latency(rwl, rpf)
        bounds = ([None, hi * 0.6, hi * 0.3, hi * 0.05] if spec.optimizes == "latency"
                  else [None, lopt * 1.4, lopt * 1.05, lopt * 0.9])
        for bound in bounds:
            want = R.solve(name, rwl, rpf, R.Objective(spec.optimizes, bound))
            got = P.solve(name, wl, pf, P.Objective(spec.optimizes, bound), device=CPU)
            assert _cand(got) == _cand(want), (exp, bound)
            assert got.point_tri == want.point_tri


def test_plan_pareto_tri_front_nondominated():
    wl, pf = _instance("R1", n=8, p=6)
    report = P.plan_pareto_tri(wl, pf, k=6, device=CPU)
    assert report.plan is not None
    front = report.pareto
    assert front and all(len(pt) == 3 for pt in front)
    for a in front:
        for b in front:
            if a is b:
                continue
            assert not (b[0] <= a[0] * (1 + 1e-12)
                        and b[1] <= a[1] * (1 + 1e-12)
                        and b[2] >= a[2] * (1 - 1e-12)
                        and (b[0] < a[0] or b[1] < a[1] or b[2] > a[2]))


def test_plan_pareto_tri_floor_prefers_reliable_plans():
    """With a reliability floor, the chosen plan clears it when any candidate
    can; and the knee never picks something less reliable than what the
    bi-criteria portfolio would have shipped."""
    wl, pf = _instance("R2", n=8, p=8)
    tri = P.plan_pareto_tri(wl, pf, reliability_floor=0.95, device=CPU)
    rm = (P.ReplicatedMapping(tri.plan.mapping.intervals, tri.plan.groups)
          if tri.plan.groups is not None else tri.plan.mapping)
    tri_rel = P.reliability(wl, pf, rm)
    best = max(pt[2] for pt in tri.pareto)
    if best >= 0.95:
        assert tri_rel >= 0.95 - 1e-9
    bi = P.plan_pareto(wl, pf, device=CPU)
    assert tri_rel >= P.reliability(wl, pf, bi.plan.mapping) - 1e-12


def test_pareto_front_tri_hand_case():
    pts = [
        (1.0, 9.0, 0.90),   # fast, short, fragile       -> kept
        (1.0, 9.0, 0.99),   # same but more reliable     -> dominates above
        (2.0, 8.0, 0.95),   # slower period, better lat  -> kept
        (3.0, 9.5, 0.90),   # dominated by all           -> dropped
        (0.5, 20.0, 0.50),  # fastest period             -> kept
    ]
    front = P.pareto_front_tri(pts)
    assert (1.0, 9.0, 0.99) in front
    assert (1.0, 9.0, 0.90) not in front
    assert (3.0, 9.5, 0.90) not in front
    assert (2.0, 8.0, 0.95) in front
    assert (0.5, 20.0, 0.50) in front


@pytest.mark.parametrize("exp", ["R1", "R2", "R3", "R4"])
def test_plan_pareto_tri_reports_equal_the_reference(exp):
    """n = 12, p = 8: every field of every candidate, the 3-D front and the
    chosen plan, without a floor, with the median candidate reliability as
    floor, with an unreachable floor, and with the deal solver admitted."""
    (rwl, rpf), (wl, pf) = _pair(exp, 12, 8)
    want = R.plan_pareto_tri(rwl, rpf, k=6)
    got = P.plan_pareto_tri(wl, pf, k=6, device=CPU)
    assert _report(got) == _report(want)
    assert any(c.groups is not None and any(len(g) > 1 for g in c.groups)
               for c in got.candidates)
    floor = float(np.median([c.reliability for c in got.candidates if c.feasible]))
    for kw in ({"reliability_floor": floor}, {"reliability_floor": 1.0},
               {"k": 3, "exclude": ()}, {"k": 3, "include": ("single", "H1-rel", "H6-rel"),
                                         "exclude": ()},
               {"k": 2, "exact_max_p": 0}, {"k": 2, "time_budget": 0.0}):
        kw = {"k": 4} | kw
        want = R.plan_pareto_tri(rwl, rpf, **kw)
        got = P.plan_pareto_tri(wl, pf, device=CPU, **kw)
        assert _report(got) == _report(want), kw


def test_plan_pareto_tri_without_failures_equals_the_reference():
    (rwl, rpf), (wl, pf) = _pair("E2", 10, 6)
    want = R.plan_pareto_tri(rwl, rpf, k=4, reliability_floor=0.5)
    got = P.plan_pareto_tri(wl, pf, k=4, reliability_floor=0.5, device=CPU)
    assert _report(got) == _report(want)
    assert all(c.reliability == 1.0 for c in got.candidates if c.mapping is not None)
