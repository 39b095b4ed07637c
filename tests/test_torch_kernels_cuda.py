"""The hand-written CUDA split-scoring kernels against their plain PyTorch
versions, on the card.

These tests need a CUDA device (marker ``cuda``) and skip without one.  The
file imports only torch, numpy and the port, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Inputs are random with a fixed seed, live-lane bounds random per row.
Tolerance: exact (``torch.equal``) on live lanes, and lanes at or past the
bound must be zero; a scalar heuristic run on the card equals the same run
on the CPU (mapping, period, latency, splits).  The fused engine's step
replayed as a CUDA graph equals its eager step, buffer for buffer, and the
fused and sharded engines on the card equal the lockstep engine on the CPU.
The fleet service on the card publishes the CPU's plans, and a kernel
launch refused on the card is raised as ``ScoringDeviceError`` out of
``batched_min_period`` and the service.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import make_platform, make_workload, optimal_latency, run_heuristic
from repro_torch.core.heuristics import _PERMS3, score_2way, score_3way
from repro_torch.kernels import split_score

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _t(x, device):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _split_inputs(rng, A, K):
    pre = np.sort(rng.uniform(0.0, 100.0, (A, K + 2)), axis=1)
    delta = rng.uniform(0.0, 50.0, (A, K + 2))
    return (pre[:, :1], pre[:, 1:-1], pre[:, -1:], delta[:, :1], delta[:, 1:-1],
            delta[:, -1:], rng.uniform(0.05, 2.0, (A, 1)), rng.uniform(0.05, 2.0, (A, 1)))


def _three_inputs(rng, A, span):
    o1, o2 = np.triu_indices(span - 1, k=1)
    K = o1.size
    inv = rng.uniform(0.05, 2.0, (A, 3))
    ins = (rng.uniform(0.0, 10.0, (A, 1, 3, K)), rng.uniform(0.1, 100.0, (A, 1, 3, K)),
           rng.uniform(0.0, 10.0, (A, 1, 3, K)),
           inv[:, np.asarray(_PERMS3)][:, :, :, None], rng.uniform(1.0, 50.0, (A, 1, 1)))
    return ins, rng.integers(3, span + 1, A), o2


@pytest.mark.parametrize("A,K", [(1, 1), (64, 300), (2400, 159)])
def test_score_2way_kernel_equals_plain_on_card(cuda_device, A, K):
    rng = np.random.default_rng(21)
    ins = [_t(x, cuda_device) for x in _split_inputs(rng, A, K)]
    need = _t(rng.integers(0, K + 1, A), cuda_device)
    before = split_score.score_2way_cuda.launches
    got = split_score.score_2way_cuda(*ins[:6], 10.0, *ins[6:], need=need)
    torch.cuda.synchronize()
    assert split_score.score_2way_cuda.launches == before + 1
    want = score_2way(*ins[:6], 10.0, *ins[6:])
    live = torch.arange(K, device=cuda_device).repeat(2)[None, :] < need[:, None]
    for g, w in zip(got, want):
        assert torch.equal(g[live], w[live])
        assert not g[~live].any()


@pytest.mark.parametrize("A,span", [(1, 3), (32, 40), (70000, 5)])
def test_score_3way_kernel_equals_plain_on_card(cuda_device, A, span):
    """(70000 rows pass the grid's 65535-row limit: the kernel loops rows.)"""
    rng = np.random.default_rng(23)
    ins, spans, o2 = _three_inputs(rng, A, span)
    ins = [_t(x, cuda_device) for x in ins]
    need = split_score.pair_need(_t(spans, cuda_device), span)
    got = split_score.score_3way_cuda(*ins, need=need)
    torch.cuda.synchronize()
    want = score_3way(*ins)
    live = torch.arange(o2.size, device=cuda_device)[None, :] < need[:, None]
    for g, w in zip(got, want):
        lv = live.view((A,) + (1,) * (w.dim() - 2) + (o2.size,)).expand(w.shape)
        assert torch.equal(g[lv], w[lv])
        assert not g[~lv].any()


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    rng = np.random.default_rng(3)
    ins = [_t(x, cuda_device) for x in _split_inputs(rng, 4, 8)]
    with pytest.raises(TypeError):
        split_score.score_2way_cuda(*ins[:6], 10.0, ins[6].float(), ins[7])
    with pytest.raises(ValueError):
        split_score.score_2way_cuda(*ins[:6], 10.0, ins[6].cpu(), ins[7])
    with pytest.raises(ValueError):
        split_score.score_2way_cuda(ins[0], ins[1].T.contiguous().T, *ins[2:6], 10.0, *ins[6:])


@pytest.mark.parametrize("code", ["H2", "H3", "H5"])
def test_scalar_heuristic_on_card_equals_cpu(cuda_device, code):
    """H2/H3 (3-way splits) run to exhaustion and H5 (2-way) under twice the
    optimal latency, on a 14-stage, 9-processor instance."""
    rng = np.random.default_rng(31)
    wl = make_workload(rng.integers(1, 21, 14).astype(float),
                       rng.integers(1, 101, 15).astype(float))
    pf = make_platform(rng.integers(1, 21, 9).astype(float), 10.0)
    bound = -math.inf if code in ("H2", "H3") else 2.0 * optimal_latency(wl, pf)
    counter = split_score.score_2way_cuda if code == "H5" else split_score.score_3way_cuda
    before = counter.launches
    got = run_heuristic(code, wl, pf, bound, device=cuda_device)
    torch.cuda.synchronize()
    assert counter.launches > before
    want = run_heuristic(code, wl, pf, bound, device="cpu")
    assert got.splits > 0
    assert ((got.mapping.intervals, got.mapping.alloc, got.period, got.latency,
             got.feasible, got.splits, got.name)
            == (want.mapping.intervals, want.mapping.alloc, want.period, want.latency,
                want.feasible, want.splits, want.name))


def test_b_by_pointer_equals_score_2way_f64(cuda_device):
    """``score_2way_cuda`` with ``b`` a 0-dim float64 tensor on the card (the
    entry point the fused engine's graphs capture) equals the by-value call,
    lane for lane."""
    rng = np.random.default_rng(29)
    A, K = 300, 159
    ins = [_t(x, cuda_device) for x in _split_inputs(rng, A, K)]
    need = _t(rng.integers(0, K + 1, A), cuda_device)
    b_t = torch.tensor(10.0, dtype=torch.float64, device=cuda_device)
    got = split_score.score_2way_cuda(*ins[:6], b_t, *ins[6:], need=need)
    want = split_score.score_2way_cuda(*ins[:6], 10.0, *ins[6:], need=need)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        split_score.score_2way_cuda(*ins[:6], b_t.cpu(), *ins[6:], need=need)


@pytest.mark.parametrize("k", [1, 2])
def test_replayed_fused_step_equals_the_eager_step_on_card(cuda_device, k):
    """Three lockstep iterations of the fused engine over a padded chunk:
    each replayed graph leaves every buffer (state, records, counter) equal
    to the eager step from the same state, and adds its kernels to the
    split-score launch counters."""
    from repro_torch.core import batched, fused
    from repro_torch.sim import gen_instance_batch

    batch = gen_instance_batch("E2", 24, 30, range(40, 52))
    pb = batched.ProblemBatch.from_arrays(batch.w, batch.delta, batch.s, batch.b,
                                          prefix=batch.prefix, order=batch.order,
                                          device=cuda_device)
    S = 16
    prog = fused._Program(24, 30, k, S, cuda_device, torch.cuda.graph_pool_handle())
    sel = np.concatenate([np.arange(12), np.zeros(S - 12, dtype=np.int64)])
    prog.load(pb, sel, batched._BatchState(pb), np.arange(S) < 12, np.arange(S) % 2 == 0,
              np.full(S, -np.inf), np.full(S, np.inf))
    bufs = (prog.arr, prog.m, prog.nx, prog.lat, prog.sp, prog.active, prog.t,
            prog.per_rec, prog.lat_rec, prog.acc_rec)
    counter = split_score.score_2way_cuda if k == 1 else split_score.score_3way_cuda
    for L in (prog.sizes[-1], prog.sizes[-1], prog.sizes[-2]):
        snap = [b.clone() for b in bufs]
        prog._step(L)
        eager = [b.clone() for b in bufs]
        for b, s in zip(bufs, snap):
            b.copy_(s)
        before = counter.launches
        prog.step(L, fused._Counts())
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        for name, b, e in zip(("arr", "m", "nx", "lat", "sp", "active", "t", "per_rec",
                               "lat_rec", "acc_rec"), bufs, eager):
            assert torch.equal(b, e), (k, L, name)
    assert int(prog.sp.sum()) > 0 and set(prog.graphs) == {prog.sizes[-1], prog.sizes[-2]}


@pytest.mark.parametrize("engine", ["fused", "sharded"])
def test_fused_engines_on_card_equal_the_cpu(cuda_device, engine):
    """A small campaign and the batched entry points through the fused and
    sharded engines on the card equal the lockstep engine on the CPU."""
    from repro_torch.core import batched, sharded
    from repro_torch.sim import gen_instance_batch, run_campaign, summarize_experiment

    kw = dict(n_pairs=3, n_bounds=4, h4_iters=4)
    want = run_campaign(["E1", "I2"], 9, 10, device="cpu", **kw)
    with sharded.use_devices([cuda_device, cuda_device]):
        got = run_campaign(["E1", "I2"], 9, 10, engine=engine, device=cuda_device, **kw)
        batch = gen_instance_batch("R2", 14, 12, range(5))
        pbs = [batched.ProblemBatch.from_arrays(batch.w, batch.delta, batch.s, batch.b,
                                                device=dev) for dev in (cuda_device, "cpu")]
        rows = [(batched.batched_trajectory_sets(["H1", "H2", "H3", "H4"], pb, backend=be),
                 [(r.period, r.latency, r.splits, r.mapping.intervals)
                  for r in batched.batched_min_period(pb, backend=be)])
                for pb, be in zip(pbs, (engine, "lockstep"))]
    assert rows[0] == rows[1]
    for exp in want:
        assert summarize_experiment(got[exp]) == summarize_experiment(want[exp])


@pytest.mark.parametrize("backend", ["lockstep", "fused"])
def test_fleet_service_on_card_equals_the_cpu(cuda_device, backend):
    """A small fleet's burst trace with its chaos overlay and a reliability
    floor: the service on the card publishes the CPU's plans (same digest,
    same counters), and the card's split-score kernels were launched."""
    from repro_torch.core import sample_failures
    from repro_torch.fleet import (ChaosSpec, ReplanService, gen_burst_trace, inject_chaos,
                                   make_fleet)

    pairs, groups = make_fleet(6, 8, n=8, p=4, seed=2007)
    pairs = [(wl, pf.with_failures(sample_failures(pf.p, kind="bimodal", seed=5)))
             for wl, pf in pairs]
    trace = inject_chaos(gen_burst_trace(groups, 12, seed=42, n_stages=8, initial_pods=4,
                                         burst_prob=0.6),
                         groups, ChaosSpec(), seed=77, initial_pods=4)
    before = split_score.score_2way_cuda.launches
    runs = []
    for dev, be in ((cuda_device, backend), ("cpu", "lockstep")):
        svc = ReplanService(pairs, backend=be, device=dev, reliability_floor=0.98)
        m = svc.run_trace(trace)
        runs.append((svc.fleet_digest(), m.requests, m.solves, m.churns,
                     m.below_floor_ticks, m.invalid_published))
    assert runs[0] == runs[1]
    assert split_score.score_2way_cuda.launches > before


@pytest.mark.parametrize("backend", ["lockstep", "fused"])
def test_kernel_launch_fault_on_card_raises_out_of_engine_and_service(cuda_device, backend,
                                                                     monkeypatch):
    """A split-score launch that fails on the card is a ScoringDeviceError
    out of batched_min_period and out of the fleet service: no fallback."""
    from repro_torch.core import ScoringDeviceError, fused
    from repro_torch.core.batched import batched_min_period, stack_instances
    from repro_torch.fleet import ReplanService
    from repro_torch.kernels import build

    wl = make_workload([3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0], [1.0] * 8)
    pf = make_platform([2.0, 5.0, 3.0, 7.0, 1.5], 10.0)
    fused.release_programs()      # a cached graph would replay without a launch

    def refuse(*args):
        raise RuntimeError("launch refused")

    build.load("split_score")
    monkeypatch.setattr(build, "launch", refuse)
    with pytest.raises(ScoringDeviceError, match="split scoring on cuda"):
        batched_min_period(stack_instances([(wl, pf)], device=cuda_device), backend)
    with pytest.raises(ScoringDeviceError, match="split scoring on cuda"):
        ReplanService([(wl, pf)], backend=backend, device=cuda_device)
    fused.release_programs()
