"""The port's fused and sharded engines against the JAX package, on the CPU.

The fused engine's step runs eagerly here (its plain split scoring), the
same code a card captures into CUDA graphs.  Its pure helpers (span
buckets, trace budget, chunk rows, the lex argmin, the permutation and
fallback tables) equal the reference's; its H1-H4 trajectories, the H4
bisection, H5/H6 over bound grids and ``batched_min_period`` equal the
reference's ``backend="numpy"`` engine for every family of ``EXPERIMENTS``
on the same seeded instances; the sharded engine over several CPU devices
equals the fused one.  Tolerance: none (``==`` on every float, split count
and mapping).

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_fused.py
"""

import numpy as np
import pytest
import torch

from repro.core import batched as ref
from repro.core import fused as ref_fused
from repro.core import make_platform, make_workload, optimal_latency, period
from repro.core.metrics import single_processor_mapping
from repro.sim import EXPERIMENTS, gen_instance_batch
from repro.sim.generators import SPEED_HIGH, SPEED_LOW
from repro_torch.core import batched as port
from repro_torch.core import fused, sharded

FAMILIES = tuple(EXPERIMENTS)
SEEDS = range(7100, 7106)
NS = (2, 3, 4, 5, 9, 12, 16, 40, 160, 161)


def _pb(batch):
    return port.ProblemBatch.from_arrays(batch.w, batch.delta, batch.s, batch.b,
                                         prefix=batch.prefix, order=batch.order,
                                         device="cpu")


def _pb_of_pairs(pairs):
    assert len({pf.b for _, pf in pairs}) == 1, "a batch shares one bandwidth"
    return port.ProblemBatch.from_arrays(
        np.stack([wl.w for wl, _ in pairs]), np.stack([wl.delta for wl, _ in pairs]),
        np.stack([pf.s for _, pf in pairs]), pairs[0][1].b, device="cpu")


def _key(r):
    mp = None if r.mapping is None else (r.mapping.intervals, r.mapping.alloc)
    return (mp, r.period, r.latency, r.feasible, r.splits, r.name)


@pytest.mark.parametrize("n", NS)
def test_pure_helpers_equal_the_reference(n):
    """bucket_sizes, bucket_index (every need), trace_budget, chunk_rows."""
    assert fused.trace_budget(n) == ref_fused.trace_budget(n)
    for k in (1, 2):
        sizes = fused.bucket_sizes(n, k)
        assert sizes == ref_fused.bucket_sizes(n, k)
        assert fused.chunk_rows(n, k) == ref_fused.chunk_rows(n, k)
        for need in range(0, n + 2):
            if sizes:
                assert fused.bucket_index(need, sizes) == ref_fused.bucket_index(need, sizes)


def test_tables_and_lex_argmin_equal_the_reference():
    """_PERMS3/_FB_A/_FB_B, and the lex argmin on keys full of ties and rows
    with no candidate, against ``_lex_argmin_traced(np, ...)``."""
    for name in ("_PERMS3", "_FB_A", "_FB_B"):
        assert np.array_equal(getattr(fused, name), getattr(ref_fused, name)), name
    rng = np.random.default_rng(5)
    keys = [rng.integers(0, 3, (40, 17)).astype(float) for _ in range(3)]
    mask = rng.random((40, 17)) < 0.4
    mask[:3] = False
    q, has = fused._lex_argmin_traced([torch.from_numpy(k) for k in keys],
                                      torch.from_numpy(mask))
    wq, whas = ref_fused._lex_argmin_traced(np, keys, mask)
    assert np.array_equal(q.numpy(), wq) and np.array_equal(has.numpy(), whas)


@pytest.mark.parametrize("p", [10, 100])
@pytest.mark.parametrize("exp", FAMILIES)
def test_fused_engine_equals_the_reference(exp, p):
    """H1-H4 trajectories, H5/H6 over a bound grid (infeasible through
    exhaustion) and batched_min_period at n = 12; the fused H4 bisection,
    with and without mappings, at n = 10 (tests/test_engine_equivalence.py's
    grids)."""
    batch = gen_instance_batch(exp, 12, p, SEEDS)
    pb = _pb(batch)
    codes = ["H1", "H2", "H3", "H4"]
    assert (port.batched_trajectory_sets(codes, pb, backend="fused")
            == ref.batched_trajectory_sets(codes, batch))
    mults = [0.9, 1.0, 1.2, 1.6, 2.2, 3.0]
    lbounds = [optimal_latency(wl, pf) * m for (wl, pf), m in zip(batch, mults)]
    for code in ("H5", "H6"):
        got = port.batched_fixed_latency(code, pb, lbounds, backend="fused")
        assert [_key(r) for r in got] == [_key(r) for r in
                                          ref.batched_fixed_latency(code, batch, lbounds)]
    assert ([_key(r) for r in port.batched_min_period(pb, backend="fused")]
            == [_key(r) for r in ref.batched_min_period(batch)])
    b10 = gen_instance_batch(exp, 10, p, SEEDS)
    fracs = [0.05, 0.2, 0.4, 0.6, 0.8, 1.0]
    bounds = [period(wl, pf, single_processor_mapping(wl, pf.fastest())) * f
              for (wl, pf), f in zip(b10, fracs)]
    for with_mappings in (True, False):
        got = port.batched_sp_bi_p(_pb(b10), bounds, iters=8, backend="fused",
                                   with_mappings=with_mappings)
        want = ref.batched_sp_bi_p(b10, bounds, iters=8, with_mappings=with_mappings)
        assert [_key(r) for r in got] == [_key(r) for r in want], with_mappings


def _skewed_pairs():
    """tests/test_engine_properties.py's adversarial span skew: a row whose
    worst interval stays wide beside rows that collapse to tiny spans."""
    n, p = 24, 12
    wide = (make_workload([10.0] * n, [1.0] * (n + 1)),
            make_platform([20.0, 19.0, 18.0, 17.0, 16.0, 15.0] + [14.0] * (p - 6), b=10.0))
    skew_w = [1.0] * n
    skew_w[n // 2] = 1000.0
    skewed = (make_workload(skew_w, [1.0] * (n + 1)),
              make_platform([20.0, 10.0, 5.0, 2.5] + [1.0] * (p - 4), b=10.0))
    return [skewed, wide, skewed, skewed]


def _ref_pairs(pairs):
    import repro.core as rc

    return [(rc.make_workload(wl.w, wl.delta), rc.make_platform(pf.s, pf.b))
            for wl, pf in pairs]


def test_skewed_span_batch_equals_the_reference():
    pairs = _skewed_pairs()
    pb = _pb_of_pairs(pairs)
    for code in ("H1", "H2", "H3", "H4"):
        want = ref.batched_trajectories(code, _ref_pairs(pairs), backend="numpy")
        assert port.batched_trajectories(code, pb, backend="fused") == want, code


@pytest.mark.parametrize("poll_every", [1, 3, 8])
def test_polled_bound_covers_every_live_row_in_every_later_iteration(poll_every,
                                                                     monkeypatch):
    """Every step's bucket (picked on the host at the last poll) covers the
    cut count (2-way) or span (3-way) of the worst interval of every row
    live in that step, on the skewed batch and on two families; the results
    do not depend on how often the host polls."""
    monkeypatch.setattr(fused, "POLL_EVERY", poll_every)
    seen = []
    real = fused._Program._choose

    def checked(self, L, r):
        span = r["e"] - r["d"] + (self.k - 1)
        if self.k == 2:
            need = torch.where(r["live"] & (span >= 3), span, 0)
        else:
            need = torch.where(r["live"], span, 0)
        seen.append((int(need.max()), L))
        assert L is None or int(need.max()) <= L, (self.k, L, int(need.max()))
        if self.sizes:
            # and the bucket is the smallest covering the poll's bound
            assert L == self.sizes[fused.bucket_index(self._bound, self.sizes)]
        return real(self, L, r)

    real_read = fused._Program.read_poll

    def read_poll(self, counts):
        real_read(self, counts)
        self._bound = int(self.poll_host[1])

    monkeypatch.setattr(fused._Program, "_choose", checked)
    monkeypatch.setattr(fused._Program, "read_poll", read_poll)
    fused.release_programs()
    try:
        pairs = _skewed_pairs()
        pb = _pb_of_pairs(pairs)
        for code in ("H1", "H2"):
            want = ref.batched_trajectories(code, _ref_pairs(pairs), backend="numpy")
            assert port.batched_trajectories(code, pb, backend="fused") == want
        for exp in ("E3", "I2"):
            batch = gen_instance_batch(exp, 16, 10, SEEDS)
            assert ([_key(r) for r in port.batched_min_period(_pb(batch), backend="fused")]
                    == [_key(r) for r in ref.batched_min_period(batch)])
    finally:
        fused.release_programs()
    assert any(L is not None and L < max(s for _, s in seen if s is not None)
               for _, L in seen), "no step ran below the top bucket"


def test_counters_count_buckets_steps_and_polls():
    """One trajectory run per arity: steps come in blocks of POLL_EVERY
    between polls, at most T per chunk; buckets stepped at most
    trace_budget(n) per chunk size, counted by both capture counters."""
    fused.release_programs()
    for reset in (fused.reset_trace_count, fused.reset_dispatch_count,
                  fused.reset_sync_count, fused.reset_bucket_trace_count):
        reset()
    batch = gen_instance_batch("E2", 40, 100, range(3))
    port.batched_trajectory_sets(["H1", "H2"], _pb(batch), backend="fused")
    T = 39
    assert fused.trace_count() == fused.bucket_trace_count()
    assert 0 < fused.dispatch_count() <= 2 * T
    assert fused.sync_count() <= 2 * (1 + -(-T // fused.POLL_EVERY))
    assert fused.sync_count() >= fused.dispatch_count() / fused.POLL_EVERY
    assert 2 <= fused.bucket_trace_count() <= fused.trace_budget(40)
    caps = fused.captures(40)
    assert caps and all(v == 0 for v in caps.values())   # no graph on the cpu
    fused.release_programs()


def _fixed_shape_pairs(count):
    pairs = []
    for seed in range(count):
        rng = np.random.default_rng(seed)
        w = rng.uniform(0.5, 100.0, 12)
        delta = rng.uniform(0.0, 100.0, 13)
        s = rng.integers(SPEED_LOW, SPEED_HIGH + 1, 10).astype(float)
        pairs.append((make_workload(w, delta), make_platform(s, 10.0)))
    return pairs


@pytest.mark.parametrize("max_chunk", [128, 2])
@pytest.mark.parametrize("B", [1, 2, 3, 5])
def test_sharded_over_three_cpu_devices_equals_fused(B, max_chunk, monkeypatch):
    """Rows split over 3 CPU devices, the batch padded to a device multiple
    with inert rows: == fused, no phantom rows.  With chunks of 2 rows, B = 5
    spreads over all three shards (the last padded)."""
    monkeypatch.setattr(fused, "_MAX_CHUNK", max_chunk)
    pairs = _fixed_shape_pairs(B)
    pb = _pb_of_pairs(pairs)
    with sharded.use_devices(["cpu"] * 3):
        assert sharded.device_count("cpu") == 3
        for code in ("H1", "H2", "H3", "H4"):
            want = port.batched_trajectories(code, pb, backend="fused")
            got = port.batched_trajectories(code, pb, backend="sharded")
            assert got == want and len(got) == B, code
        got = port.batched_sp_bi_p(pb, [40.0] * B, iters=5, backend="sharded")
        want = port.batched_sp_bi_p(pb, [40.0] * B, iters=5, backend="fused")
        assert [_key(r) for r in got] == [_key(r) for r in want]
        assert ([_key(r) for r in port.batched_min_period(pb, backend="sharded")]
                == [_key(r) for r in port.batched_min_period(pb, backend="fused")])
    assert sharded.default_devices("cpu") == [torch.device("cpu")]


def test_converged_padding_rows_stay_inert():
    """An instance batched between rows that converge at once (a flat
    workload on uselessly slow extra processors) keeps its trajectories, and
    the stuck rows keep their one state, in the fused and sharded engines."""
    rng = np.random.default_rng(4)
    w, delta = rng.uniform(0.1, 100.0, 9), rng.uniform(0.0, 100.0, 10)
    wl, pf = make_workload(w, delta), make_platform(rng.uniform(0.5, 20.0, 6), 10.0)
    stuck = (make_workload([10.0] * 9, [0.0] * 10), make_platform([20.0] + [0.001] * 5, 10.0))
    solo = _pb_of_pairs([(wl, pf)])
    padded = _pb_of_pairs([stuck, (wl, pf), stuck])
    for backend in ("fused", "sharded"):
        with sharded.use_devices(["cpu", "cpu"]):
            for code in ("H1", "H2", "H3", "H4"):
                want = port.batched_trajectories(code, solo, backend=backend)[0]
                got = port.batched_trajectories(code, padded, backend=backend)
                assert got[1] == want, (backend, code)
                assert len(got[0]) == 1 and len(got[2]) == 1, (backend, code)


def test_unknown_backend_and_unsplittable_shapes():
    batch = gen_instance_batch("E1", 5, 10, range(2))
    with pytest.raises(ValueError, match="unknown backend"):
        port.batched_trajectories("H1", _pb(batch), backend="numpy")
    one = gen_instance_batch("E1", 1, 3, range(2))      # n = 1: nothing to split
    for backend in ("fused", "sharded"):
        got = port.batched_sp_bi_p(_pb(one), [1e9, 1e9], iters=3, backend=backend)
        assert ([_key(r) for r in got]
                == [_key(r) for r in ref.batched_sp_bi_p(one, [1e9, 1e9], iters=3)])
        assert (port.batched_trajectories("H2", _pb(one), backend=backend)
                == ref.batched_trajectories("H2", one))
    assert fused.fused_available("cpu") and sharded.sharded_available("cpu")
