"""The port's fleet durability and supervision against the JAX package's, on
the CPU.

The journal's records and the wire frames are byte-identical to the
reference's encoders on the same inputs; a journal the reference wrote is
restored by the port and continues to the reference's digest; a controller
killed at any tick recovers bit-identically; supervision retries, times out
and restarts as in the reference; a ``--device cpu`` subprocess worker is
``==`` inline, and so is its answer after an injected kill or corrupt reply
(each worker warmed up first, so the only faults are the injected ones).

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_fleet_recovery.py
"""

import functools
import time

import numpy as np
import pytest

import repro.fleet as RF
import repro_torch.fleet as PF
import repro_torch.fleet.service as p_service
from repro.core.batched import ProblemBatch as RBatch
from repro.core.batched import batched_min_period as r_batched_min_period
from repro.fleet import journal as r_journal
from repro.fleet import transport as r_transport
from repro_torch.core.batched import ProblemBatch, batched_min_period
from repro_torch.fleet import journal as p_journal
from repro_torch.fleet import transport as p_transport

CPU = "cpu"


def _small(fleet, seed=11):
    """tests/test_fleet_recovery.py's small chaos fleet."""
    pairs, groups = fleet.make_fleet(3, 3, n=8, p=4, seed=seed)
    trace = fleet.gen_burst_trace(groups, 10, seed=seed + 1, n_stages=8, initial_pods=4,
                                  burst_prob=0.7)
    return pairs, fleet.inject_chaos(trace, groups, fleet.ChaosSpec(), seed=seed + 2)


def _journal(fleet, path, **kw):
    kw.setdefault("fsync", False)
    return fleet.Journal(path, **kw)


def _reference_run():
    pairs, trace = _small(RF)
    ref = RF.ReplanService(pairs)
    ref.run_trace(trace)
    return ref


def _arrays(seed=0, rows=3, n=8, p=4):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 2.0, size=(rows, n))
    delta = rng.uniform(0.1, 1.0, size=(rows, n + 1))
    s = np.sort(rng.uniform(0.5, 2.0, size=(rows, p)))[:, ::-1].copy()
    return w, delta, s, 10.0


def _batch(seed=0):
    return ProblemBatch.from_arrays(*_arrays(seed), device=CPU)


def _key(r):
    return (r.mapping.intervals, r.mapping.alloc, r.period, r.latency, r.feasible,
            r.splits, r.name)


# ---------------------------------------------------------------------------
# Byte compatibility: journal records and wire frames
# ---------------------------------------------------------------------------

def test_record_codec_and_corruption_detection():
    payload = {"tick": 3, "events": [["StageDrift", {"instance": 1, "stage": 2,
                                                     "factor": 1.5}]]}
    data = p_journal.encode_record(payload)
    assert data == r_journal.encode_record(payload)
    assert p_journal.decode_record(data) == payload
    for mangle in (lambda b: b[: len(b) // 2], lambda b: b"deadbeef" + b[8:],
                   lambda b: b[:9] + b"not json\n", lambda b: b"xx\n"):
        with pytest.raises(PF.JournalError):
            p_journal.decode_record(mangle(data))


def test_frames_equal_the_references():
    """A solve group's frame and its results' frame are byte-identical to the
    reference's, and decode to the same batch on the worker's device."""
    w, delta, s, b = _arrays(seed=21)
    pb, rpb = ProblemBatch.from_arrays(w, delta, s, b, device=CPU), RBatch.from_arrays(w, delta,
                                                                                        s, b)
    frame = p_transport.encode_frame(p_transport.encode_solve(7, pb))
    assert frame == r_transport.encode_frame(r_transport.encode_solve(7, rpb))
    res, rres = batched_min_period(pb), r_batched_min_period(rpb, "numpy")
    assert [_key(r) for r in res] == [_key(r) for r in rres]
    out = p_transport.encode_frame(p_transport.encode_results(7, res))
    assert out == r_transport.encode_frame(r_transport.encode_results(7, rres))
    reader = PF.FrameReader()
    reader.feed(frame[:5])
    assert reader.next_frame() is None
    reader.feed(frame[5:])
    kind, body = reader.next_frame()
    back = p_transport.decode_solve(body, CPU)
    for f in ("w", "delta", "s", "prefix", "order"):
        assert np.array_equal(getattr(back, f), getattr(pb, f)), f
    assert back.b == pb.b and back.device.type == "cpu"
    assert [_key(r) for r in p_transport.decode_results(
        r_transport.encode_results(7, rres)[1])] == [_key(r) for r in res]


@pytest.mark.parametrize("mangle", [
    lambda b: b"XX" + b[2:],                          # bad magic
    lambda b: b[:-1] + bytes([b[-1] ^ 0xFF]),         # payload fails its CRC
    lambda b: b[:2] + (1 << 30).to_bytes(4, "little") + b[6:],   # absurd length
])
def test_corrupt_frames_are_detected(mangle):
    frame = PF.encode_frame(["heartbeat", {"pid": 1, "solves": 0}])
    reader = PF.FrameReader()
    reader.feed(mangle(frame))
    with pytest.raises(PF.FrameError):
        reader.next_frame()


# ---------------------------------------------------------------------------
# Journal: WAL recovery, snapshots, restore
# ---------------------------------------------------------------------------

def test_wal_recovers_longest_good_prefix(tmp_path):
    j = _journal(PF, tmp_path / "j")
    for t in range(4):
        j.append(t, [PF.StageDrift(0, 1, 2.0)])
    j.close()
    rj = _journal(RF, tmp_path / "r")
    for t in range(4):
        rj.append(t, [RF.StageDrift(0, 1, 2.0)])
    rj.close()
    assert j.wal_path.read_bytes() == rj.wal_path.read_bytes()
    data = j.wal_path.read_bytes()
    j.wal_path.write_bytes(data[: len(data) - 10])
    records, error = j.read_wal()
    assert [r["tick"] for r in records] == [0, 1, 2]
    assert error is not None and "record 3" in error
    with pytest.raises(PF.JournalError):
        j.read_wal(strict=True)


def test_snapshot_compacts_wal_and_prunes_old_snapshots(tmp_path):
    pairs, trace = _small(PF)
    j = _journal(PF, tmp_path / "j", snapshot_every=4, keep_snapshots=2)
    PF.ReplanService(pairs, journal=j, device=CPU).run_trace(trace)
    records, error = j.read_wal()
    snaps = j._snapshot_paths()
    assert error is None and len(snaps) <= 2
    assert all(r["tick"] >= snaps[0][0] for r in records)
    assert len(records) <= j.snapshot_every * j.keep_snapshots


def test_restore_reproduces_state_and_continues_identically(tmp_path):
    ref = _reference_run()
    pairs, trace = _small(PF)
    j = _journal(PF, tmp_path / "j", snapshot_every=3)
    svc = PF.ReplanService(pairs, journal=j, device=CPU)
    for events in trace.ticks[:6]:
        svc.tick(events)
    svc.journal.close()
    restored = PF.ReplanService.restore(j, device=CPU)
    assert restored.tick_count == 6 and restored.device.type == "cpu"
    assert restored.fleet_digest() == svc.fleet_digest()
    restored.resume_trace(trace)
    assert restored.fleet_digest() == ref.fleet_digest()
    for field in ("ticks", "requests", "solves", "warm_hits", "events", "deferred",
                  "fallback_solves", "dropped_events", "invalid_published"):
        assert getattr(restored.metrics, field) == getattr(ref.metrics, field), field


@pytest.mark.parametrize("torn", [False, True])
def test_journal_written_by_the_reference_restores_to_its_digest(tmp_path, torn):
    """The fleet's state carried across packages: the reference runs seven
    ticks journaled (snapshots every 3, a WAL tail; optionally the last
    record torn as by a kill -9), the port restores that directory and
    finishes the trace with the reference's digest and counters."""
    ref = _reference_run()
    rpairs, rtrace = _small(RF)
    rj = _journal(RF, tmp_path / "j", snapshot_every=3)
    rsvc = RF.ReplanService(rpairs, journal=rj)
    for events in rtrace.ticks[:7]:
        rsvc.tick(events)
    rsvc.journal.close()
    if torn:
        data = rj.wal_path.read_bytes()
        rj.wal_path.write_bytes(data[: len(data) - 7])
    restored = PF.ReplanService.restore(tmp_path / "j", device=CPU)
    assert restored.backend == "lockstep"
    assert restored.tick_count == (6 if torn else 7)
    if not torn:
        assert restored.fleet_digest() == rsvc.fleet_digest()
    _, trace = _small(PF)
    restored.resume_trace(trace)
    assert restored.fleet_digest() == ref.fleet_digest()
    for field in ("ticks", "requests", "solves", "warm_hits", "events", "churns",
                  "dropped_events", "invalid_published"):
        assert getattr(restored.metrics, field) == getattr(ref.metrics, field), field


def test_snapshot_state_equals_the_references(tmp_path):
    """The port's snapshot of a run holds the reference's state record for
    record (the engine's name aside; wall-clock timings are not state)."""
    pairs, trace = _small(PF)
    rpairs, rtrace = _small(RF)
    states = []
    for fleet, ps, tr, kw in ((PF, pairs, trace, {"device": CPU}), (RF, rpairs, rtrace, {})):
        j = _journal(fleet, tmp_path / fleet.__name__, snapshot_every=5)
        svc = fleet.ReplanService(ps, journal=j, reliability_floor=0.9, **kw)
        svc.run_trace(tr)
        svc.journal.close()
        tick, state = j.latest_snapshot()
        state["config"].pop("backend")
        for timing in ("solve_wall", "latencies"):
            state["metrics"].pop(timing)
        states.append((tick, p_journal.encode_record(state)))
    assert states[0] == states[1]


def test_restore_skips_corrupt_snapshot_in_favor_of_older(tmp_path):
    pairs, trace = _small(PF)
    j = _journal(PF, tmp_path / "j", snapshot_every=3, keep_snapshots=3)
    svc = PF.ReplanService(pairs, journal=j, device=CPU)
    for events in trace.ticks[:7]:
        svc.tick(events)
    svc.journal.close()
    snaps = sorted((tmp_path / "j").glob("snapshot_*.json"))
    assert len(snaps) >= 2
    snaps[-1].write_bytes(b"00000000 torn\n")
    restored = PF.ReplanService.restore(j, device=CPU)
    assert restored.tick_count == svc.tick_count
    assert restored.fleet_digest() == svc.fleet_digest()
    with pytest.raises(PF.JournalError):
        PF.ReplanService.restore(_journal(PF, tmp_path / "empty"), device=CPU)


def test_crash_at_every_tick_recovers_bit_identically(tmp_path):
    ref = _reference_run()
    pairs, trace = _small(PF)
    for crash_tick in range(trace.num_ticks):
        svc, restarts = PF.crash_restart_run(
            pairs, trace, PF.Journal(tmp_path / f"c{crash_tick}", snapshot_every=4,
                                     fsync=False),
            crash_ticks=[crash_tick], device=CPU)
        assert len(restarts) == 1 and svc.device.type == "cpu"
        assert svc.fleet_digest() == ref.fleet_digest(), crash_tick
        assert svc.metrics.ticks == ref.metrics.ticks
        assert svc.metrics.invalid_published == 0


def test_double_crash_and_crash_before_state_mutation(tmp_path):
    ref = _reference_run()
    pairs, trace = _small(PF)
    svc, restarts = PF.crash_restart_run(
        pairs, trace, PF.Journal(tmp_path / "j", snapshot_every=4, fsync=False),
        crash_ticks=[3, 4], device=CPU)
    assert len(restarts) == 2 and svc.fleet_digest() == ref.fleet_digest()
    j = _journal(PF, tmp_path / "k")
    svc = PF.ReplanService(pairs, journal=j, device=CPU)
    before = svc.fleet_digest()

    def hook(tick):
        raise PF.SimulatedCrash("boom")

    svc.crash_hook = hook
    with pytest.raises(PF.SimulatedCrash):
        svc.tick(trace.ticks[0])
    assert svc.fleet_digest() == before and svc.tick_count == 0
    assert [r["tick"] for r in j.read_wal()[0]] == [0]


# ---------------------------------------------------------------------------
# Poison quarantine
# ---------------------------------------------------------------------------

def test_poison_problem_is_quarantined_and_survives_restore(tmp_path, monkeypatch):
    pairs, _ = _small(PF)
    j = _journal(PF, tmp_path / "j", snapshot_every=1)
    svc = PF.ReplanService(pairs, journal=j, quarantine_after=2, device=CPU)
    svc.supervisor.sleep = lambda s: None
    healthy = svc.fleet_digest()

    def boom(*a, **k):
        raise RuntimeError("poisoned solve")

    monkeypatch.setattr(p_service, "batched_min_period", boom)
    monkeypatch.setattr(p_service, "min_period_exhaustive", boom)
    svc.tick([PF.StageDrift(0, 0, 2.0)])
    assert svc.quarantine_strikes and not svc.quarantined and svc._pending
    svc.tick([])
    assert svc.quarantined and not svc._pending
    assert svc.metrics.quarantined_problems == 1 and svc.metrics.quarantined_requests >= 1
    svc.tick([])
    assert svc.fleet_digest() == healthy and svc.metrics.invalid_published == 0
    monkeypatch.undo()
    svc.journal.close()
    restored = PF.ReplanService.restore(j, device=CPU)
    assert restored.replayed_ticks == 0
    assert restored.quarantined == svc.quarantined
    assert restored.quarantine_strikes == svc.quarantine_strikes
    restored.tick([PF.PodCountChange(0, 3)])
    assert restored.metrics.invalid_published == 0 and not restored._pending


# ---------------------------------------------------------------------------
# Supervisor and thread workers
# ---------------------------------------------------------------------------

def test_supervisor_retries_with_exponential_backoff_then_raises():
    calls, delays = [], []

    def flaky(batch):
        calls.append(batch)
        raise RuntimeError("transient")

    sup = PF.Supervisor(flaky, max_attempts=4, backoff_base=0.01, backoff_max=0.03,
                        sleep=delays.append)
    with pytest.raises(PF.WorkerFailed):
        sup.solve("pb")
    assert len(calls) == 4 and delays == [0.01, 0.02, 0.03]
    assert sup.stats.retries == 3 and sup.stats.failures == 4


def test_thread_worker_timeouts_are_counted_and_restarted():
    def hang(batch):
        time.sleep(0.5)
        return ["late"]

    sup = PF.Supervisor(hang, worker_cls=PF.ThreadWorker, max_attempts=2, timeout=0.05,
                        backoff_base=0, sleep=lambda s: None)
    first = sup.pool[0]
    with pytest.raises(PF.WorkerFailed) as ei:
        sup.solve("pb")
    assert isinstance(ei.value.__cause__, PF.WorkerTimeout)
    assert sup.pool[0] is not first and sup.stats.restarts >= 1
    assert sup.stats.timeouts == 2 and sup.stats.failures == 0
    sup.close()
    assert sup.stats.leaked_threads == 2
    with pytest.raises(ValueError, match="preempt"):
        PF.Supervisor(lambda b: b, timeout=1.0,
                      worker_cls=functools.partial(PF.InlineWorker))


# ---------------------------------------------------------------------------
# Subprocess workers (--device cpu), each warmed up before any fault
# ---------------------------------------------------------------------------

def _warm_supervisor(chaos=None, workers=1, **kw):
    """A subprocess supervisor on the CPU whose workers have each answered
    one clean solve (their spawn, imports included, is over) before any
    fault can fire: ``chaos`` starts disarmed (``max_faults=0``)."""
    if chaos is not None:
        armed, chaos.max_faults = chaos.max_faults, 0
    sup = PF.subprocess_supervisor(device=CPU, workers=workers, timeout=120.0, chaos=chaos,
                                   max_attempts=3, backoff_base=0.0, term_grace=0.2,
                                   heartbeat_interval=30.0, **kw)
    warm = _batch(seed=99)
    for _ in range(workers):
        sup.solve(warm)
    assert sup.stats.restarts == 0
    if chaos is not None:
        chaos.max_faults = armed
    return sup


def test_subprocess_worker_on_cpu_equals_inline():
    pb = _batch(seed=21)
    sup = _warm_supervisor()
    try:
        worker = sup.pool[0]
        assert "--device" in worker._proc.args and "cpu" in worker._proc.args
        assert [_key(r) for r in sup.solve(pb)] == [_key(r) for r in batched_min_period(pb)]
    finally:
        sup.close()


@pytest.mark.parametrize("fault", [{"kill_prob": 1.0}, {"corrupt_prob": 1.0}],
                         ids=["kill", "corrupt"])
def test_subprocess_fault_costs_one_restart_and_the_answer_is_inline(fault):
    pb = _batch(seed=22)
    chaos = PF.TransportChaos(max_faults=1, seed=13, **fault)
    sup = _warm_supervisor(chaos)
    try:
        assert [_key(r) for r in sup.solve(pb)] == [_key(r) for r in batched_min_period(pb)]
        assert chaos.total_faults() == 1
        assert sup.stats.restarts == 1 and sup.stats.failures == 1
        assert sup.stats.timeouts == 0
    finally:
        sup.close()


def test_service_digest_under_subprocess_workers_with_kills():
    """Seeded SIGKILLs mid-solve leave the published fleet state
    bit-identical to the reference's inline run, each restart attributable
    to an injected kill."""
    ref = _reference_run()
    pairs, trace = _small(PF)
    chaos = PF.TransportChaos(kill_prob=0.5, max_faults=2, seed=1)
    sup = _warm_supervisor(chaos, workers=2)
    try:
        svc = PF.ReplanService(pairs, device=CPU, supervisor=sup)
        svc.run_trace(trace)
    finally:
        sup.close()
    assert svc.fleet_digest() == ref.fleet_digest()
    assert svc.metrics.invalid_published == 0 and svc.metrics.fallback_solves == 0
    assert chaos.counts.get("kill", 0) >= 1
    assert sup.stats.restarts == chaos.total_faults()


def test_subprocess_supervisor_default_device_is_cuda(monkeypatch):
    """The workers' device defaults to CUDA and is resolved before any
    spawn (here, with a card faked, only the command line is looked at)."""
    import torch

    seen = []

    class Spy:
        def __init__(self, cmd, **kw):
            seen.append(cmd)
            raise OSError("not spawned")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(PF.supervision.subprocess, "Popen", Spy)
    with pytest.raises(OSError, match="not spawned"):
        PF.subprocess_supervisor()
    assert seen and seen[0][seen[0].index("--device") + 1] == "cuda"
    assert seen[0][seen[0].index("--backend") + 1] == "lockstep"
