"""Differential harness: the port's lockstep engine against the JAX
reference's, every scenario family, exactly.

The port runs on ``device="cpu"`` (its plain PyTorch scoring) and is held to
``repro.core.batched`` with ``backend="numpy"`` — and, at p = 10, to the
``backend="pallas"`` column (the reference's Pallas kernels in interpret
mode) — on the same stacked instances, handed to the port through
``ProblemBatch.from_arrays``.  Tolerance: exact (``==``) on every float, split
count and mapping, the reference's own cross-engine contract
(tests/test_engine_equivalence.py).
"""

import numpy as np
import pytest

from repro.core import batched as ref
from repro.core import optimal_latency, period
from repro.core.metrics import single_processor_mapping
from repro.sim import EXPERIMENTS, gen_instance_batch
from repro_torch.core import batched as port

FAMILIES = tuple(EXPERIMENTS)
SEEDS = range(7100, 7106)
N_STAGES = 12


def _backends(p):
    return ("numpy", "pallas") if p == 10 else ("numpy",)


def _port_batch(batch):
    return port.ProblemBatch.from_arrays(batch.w, batch.delta, batch.s, batch.b,
                                         prefix=batch.prefix, order=batch.order,
                                         device="cpu")


def _key(r, with_mapping=True):
    mp = None if r.mapping is None else (r.mapping.intervals, r.mapping.alloc)
    return ((mp if with_mapping else None), r.period, r.latency, r.feasible,
            r.splits, r.name)


@pytest.mark.parametrize("p", [10, 100])
@pytest.mark.parametrize("exp", FAMILIES)
def test_trajectories_match_reference(exp, p):
    """H1-H4 exhaustion trajectories."""
    batch = gen_instance_batch(exp, N_STAGES, p, SEEDS)
    codes = ["H1", "H2", "H3", "H4"]
    got = port.batched_trajectory_sets(codes, _port_batch(batch))
    for backend in _backends(p):
        want = ref.batched_trajectory_sets(codes, batch, backend=backend)
        for code in codes:
            assert got[code] == want[code], (code, backend)


@pytest.mark.parametrize("p", [10, 100])
@pytest.mark.parametrize("exp", FAMILIES)
def test_h4_bisection_matches_reference(exp, p):
    """H4 with mappings and split counts (rowwise) and metrics-only with
    probe dedup (grouped), on bounds from infeasible to trivially feasible."""
    batch = gen_instance_batch(exp, 10, p, SEEDS)
    fracs = [0.05, 0.2, 0.4, 0.6, 0.8, 1.0]
    bounds = [period(wl, pf, single_processor_mapping(wl, pf.fastest())) * f
              for (wl, pf), f in zip(batch, fracs)]
    pb = _port_batch(batch)
    got = port.batched_sp_bi_p(pb, bounds, iters=8)
    got_m = port.batched_sp_bi_p(pb, bounds, iters=8, with_mappings=False,
                                 groups=[0, 0, 1, 1, 2, 2])
    for backend in _backends(p):
        want = ref.batched_sp_bi_p(batch, bounds, iters=8, backend=backend)
        want_m = ref.batched_sp_bi_p(batch, bounds, iters=8, backend=backend,
                                     with_mappings=False, groups=[0, 0, 1, 1, 2, 2])
        assert [_key(r) for r in got] == [_key(r) for r in want], backend
        assert all(r.mapping is None for r in got_m)
        assert [_key(r) for r in got_m] == [_key(r) for r in want_m], backend


@pytest.mark.parametrize("p", [10, 100])
@pytest.mark.parametrize("exp", FAMILIES)
def test_fixed_latency_matches_reference(exp, p):
    """H5/H6 over a bound grid spanning infeasible (below L_opt) through
    exhaustion."""
    batch = gen_instance_batch(exp, N_STAGES, p, SEEDS)
    mults = [0.9, 1.0, 1.2, 1.6, 2.2, 3.0]
    bounds = [optimal_latency(wl, pf) * m for (wl, pf), m in zip(batch, mults)]
    pb = _port_batch(batch)
    for code in ("H5", "H6"):
        got = port.batched_fixed_latency(code, pb, bounds)
        for backend in _backends(p):
            want = ref.batched_fixed_latency(code, batch, bounds, backend=backend)
            assert [_key(r) for r in got] == [_key(r) for r in want], (code, backend)


@pytest.mark.parametrize("p", [10, 100])
@pytest.mark.parametrize("exp", FAMILIES)
def test_min_period_matches_reference(exp, p):
    """The unbounded min-period portfolio (the fleet service's solve call)."""
    batch = gen_instance_batch(exp, N_STAGES, p, SEEDS)
    got = port.batched_min_period(_port_batch(batch))
    for backend in _backends(p):
        want = ref.batched_min_period(batch, backend=backend)
        assert [_key(r) for r in got] == [_key(r) for r in want], backend


def test_h4_search_bounds_and_default_prefix_order_match_reference():
    """``from_arrays`` derives prefix and order like the reference, and the
    H4 search interval is the reference's."""
    batch = gen_instance_batch("E3", 20, 50, range(11))
    want = ref.ProblemBatch.from_arrays(batch.w, batch.delta, batch.s, batch.b)
    pb = port.ProblemBatch.from_arrays(batch.w, batch.delta, batch.s, batch.b,
                                       device="cpu")
    assert np.array_equal(pb.prefix, want.prefix)
    assert np.array_equal(pb.order, want.order)
    groups = [0, 0, 1, 2, 2, 3, 4, 5, 6, 7, 8]
    for g, w in zip(port.h4_search_bounds(pb, groups), ref.h4_search_bounds(want, groups)):
        assert np.array_equal(g, w)


def test_row_chunking_cannot_change_results(monkeypatch):
    """3-way scoring chunked down to one row per call gives the same
    trajectories as one call for all rows."""
    batch = gen_instance_batch("E2", 16, 40, range(20, 40))
    whole = port.batched_trajectory_sets(["H2", "H3"], _port_batch(batch))
    monkeypatch.setattr(port, "_CHUNK_BYTES", 1)
    chunked = port.batched_trajectory_sets(["H2", "H3"], _port_batch(batch))
    assert chunked == whole
    assert whole == ref.batched_trajectory_sets(["H2", "H3"], batch)
