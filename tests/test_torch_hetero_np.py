"""The port's copy of the Theorem-1 NMWTS reduction against the JAX
package's, on the CPU: every case of ``tests/test_hetero_np.py`` runs on the
port, and the reduced instances, the witnesses, the recovered solutions and
the brute-force answers are ``==`` the reference's (tolerance: none)."""

import numpy as np

from repro.core import hetero_partition as rh
from repro_torch.core import exact as pexact
from repro_torch.core import metrics as pmetrics
from repro_torch.core.hetero_partition import (Hetero1DInstance, NMWTSInstance,
                                               extract_nmwts_solution, reduce_nmwts,
                                               witness_from_nmwts_solution)


def _yes_instance(rng, m=3, M=6):
    """Build a YES NMWTS instance by construction."""
    x = rng.integers(1, M, m)
    y = rng.integers(1, M, m)
    z = np.array(sorted(x + rng.permutation(y)))
    rng.shuffle(z)
    return NMWTSInstance(x, y, z)


def test_reduction_yes_direction():
    """NMWTS solution -> K=1 witness for the reduced instance (proof, 'if')."""
    rng = np.random.default_rng(0)
    for _ in range(10):
        inst = _yes_instance(rng)
        sol = inst.solve_small()
        assert sol is not None
        s1, s2 = sol
        hinst = reduce_nmwts(inst)
        intervals, procs = witness_from_nmwts_solution(inst, s1, s2)
        assert hinst.check(intervals, procs), "witness must satisfy K=1"


def test_reduction_witness_structure_recovers_solution():
    """K=1 witness -> NMWTS solution (proof, 'only if')."""
    rng = np.random.default_rng(1)
    for _ in range(10):
        inst = _yes_instance(rng)
        s1, s2 = inst.solve_small()
        hinst = reduce_nmwts(inst)
        intervals, procs = witness_from_nmwts_solution(inst, s1, s2)
        rec = extract_nmwts_solution(inst, hinst, intervals, procs)
        assert rec is not None
        r1, r2 = rec
        # recovered permutations must solve the NMWTS instance
        for i in range(inst.m):
            assert inst.x[i] + inst.y[r1[i]] == inst.z[r2[i]]


def test_reduction_no_instance_has_no_witness():
    """For a NO instance, no partition meets K=1 (checked by exact solver on
    the derived mapping problem, small sizes)."""
    # equal sums (the reduction's precondition) but unmatchable targets:
    # x_i + y_j is always 2, z needs {1, 3} -> NO instance
    inst = NMWTSInstance(np.array([1, 1]), np.array([1, 1]), np.array([1, 3]))
    assert inst.solve_small() is None
    hinst = reduce_nmwts(inst)
    wl, pf = hinst.as_mapping_problem()
    mp = pexact.exact_min_period(wl, pf)
    assert mp is not None
    assert pmetrics.period(wl, pf, mp) > 1.0 + 1e-9


def test_reduction_shapes():
    inst = NMWTSInstance(np.array([1, 2]), np.array([2, 1]), np.array([3, 3]))
    h = reduce_nmwts(inst)
    M = 3
    assert len(h.a) == (M + 3) * 2
    assert len(h.s) == 6
    assert h.K == 1.0


def _both(x, y, z):
    return NMWTSInstance(*map(np.asarray, (x, y, z))), rh.NMWTSInstance(*map(np.asarray,
                                                                          (x, y, z)))


def test_reduction_and_witnesses_equal_the_reference():
    """YES instances (by construction), NO instances and unequal sums: the
    brute-force answer, the reduced instance and its mapping problem, both
    directions' witnesses, the checker on true and corrupted witnesses."""
    rng = np.random.default_rng(2)
    cases = []
    for m, M in ((2, 4), (3, 6), (4, 5)):
        for _ in range(3):
            inst = _yes_instance(rng, m, M)
            cases.append((inst.x, inst.y, inst.z))
    cases += [([1, 1], [1, 1], [1, 3]), ([1, 2], [2, 1], [3, 3]), ([1, 2], [1, 1], [2, 2]),
              ([2, 3, 1], [1, 1, 4], [3, 4, 5])]
    for x, y, z in cases:
        got, want = _both(x, y, z)
        sol = got.solve_small()
        assert sol == want.solve_small()
        h, rhinst = reduce_nmwts(got), rh.reduce_nmwts(want)
        assert isinstance(h, Hetero1DInstance)
        assert (h.a.tobytes(), h.s.tobytes(), h.K) == (rhinst.a.tobytes(), rhinst.s.tobytes(),
                                                        rhinst.K)
        (wl, pf), (rwl, rpf) = h.as_mapping_problem(), rhinst.as_mapping_problem()
        assert (wl.w.tobytes(), wl.delta.tobytes(), wl.name) == (rwl.w.tobytes(),
                                                                 rwl.delta.tobytes(), rwl.name)
        assert (pf.s.tobytes(), pf.b, pf.name) == (rpf.s.tobytes(), rpf.b, rpf.name)
        if sol is None:
            continue
        wit = witness_from_nmwts_solution(got, *sol)
        assert wit == rh.witness_from_nmwts_solution(want, *sol)
        assert h.check(*wit) == rhinst.check(*wit) is True
        assert (extract_nmwts_solution(got, h, *wit)
                == rh.extract_nmwts_solution(want, rhinst, *wit))
        intervals, procs = wit
        moved = (procs[1],) + (procs[0],) + tuple(procs[2:])
        assert h.check(intervals, moved) == rhinst.check(intervals, moved)
        assert (extract_nmwts_solution(got, h, intervals, moved)
                == rh.extract_nmwts_solution(want, rhinst, intervals, moved))
        short = (intervals[0][0], intervals[1][1])
        fewer = ((short,) + tuple(intervals[2:]), (procs[0],) + tuple(procs[2:]))
        assert h.check(*fewer) == rhinst.check(*fewer) is False
