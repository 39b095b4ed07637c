#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Drives the port's paths on the card and checks them: the Section-5
campaign planner, serving qwen3-4b at full width, the hybrid zamba2-7b at
full width, the planner API and its reliability extensions, and the fleet
replanning service (``repro_torch``), in sixteen phases; any failure exits
non-zero:

  1. card   — prints ``nvidia-smi --query-gpu=name,power.limit`` (one line);
  2. build  — compiles every kernel source of ``src/repro_torch/kernels/csrc``
              with nvcc (one process per source, all started together); the
              SASS (``cuobjdump --dump-sass``) must hold tensor-core
              instructions (HMMA) in every instantiation of flash attention's
              bf16 kernel and of the SSD's heads kernel;
  3. kernels — each hand-written kernel against its plain PyTorch version on
              the card, at the main path's largest shapes with random live-lane
              bounds: equal on live lanes, zero past them (and the 2-way
              kernel's entry point with ``b`` read on the card, which the
              fused engine's graphs capture, equal to it); the kernel's device
              time per call (``device_time``, inputs cold) with its host time
              apart, the plain version's CUDA-event time (median of 20
              single-call windows, host work inside: it copies host scalars
              to the card), and the least time the card could take for the
              same work (its bound);
  4. golden — ``repro_torch.sim.paper_sim.run`` on cuda writes the golden CSVs
              of ``tests/golden/paper_sim`` byte for byte;
  5. main path — the full-width campaign: E1-E4 x 50 instance pairs, n = 160
              stages, p = 1000 processors, 12 bounds, H4 with 10 bisection
              steps, on cuda; every kernel's launch counter is zeroed just
              before and must be > 0 just after;
  6. cpu vs card — 8 of those instances through ``batched_trajectory_sets``
              (H1-H4) and ``batched_min_period`` on cpu and on cuda: equal;
  7. model kernels — RMSNorm, RMSNorm + residual, flash attention (causal,
              and with a window of 1024) and decode attention (three inputs:
              mixed empty slots under a window, the serve runs' 96 live
              slots, a full cache) against their plain versions at qwen3-4b's
              full-width shapes, in float32 (atol 2e-5) and in bfloat16 (per
              element 2e-5 + 2^-6 |want|, two bf16 spacings); the same limit
              must reject the attention answers with the causal mask, the
              window or the empty slots ignored; device time per call of
              kernel, plain version and the one PyTorch call that computes
              the same function (bfloat16), each with its host time per call
              apart (``device_time``: calls enqueued behind a sleep on the
              card; RMSNorm's and decode attention's inputs cold), and the
              bound; flash attention's
              float32 route (CUDA cores) timed beside its bf16 route (tensor
              cores), with the bf16 route's executed rate (6 hd FLOP per
              (query head, key) pair in the band: QK^T and the split PV) and
              the calls each route took.  Flash and decode
              attention again at zamba2-7b's head shapes (32 query and 32 KV
              heads of 112), and the Mamba2 SSD intra-chunk kernel at its
              full-width shapes in float32 (per element 2e-5 + 1e-4 |want|),
              which must reject the answers with an exclusive cumsum and
              with the chunk state's decay left out; its bound counts the
              products at three TF32 tensor-core products each;
  8. forward — ``ModelAPI.forward`` of qwen3-4b at full width (36 layers,
              random weights from a seed), B = 1, S = 4096, with kernels; the
              RMSNorm and flash-attention counters are zeroed just before and
              must be > 0 just after, every flash call on the bf16 route;
              logits finite; wall time, peak memory;
  9. serve  — ``serve_pool`` of qwen3-4b at full width, 8 requests, batch 4,
              64-token prompts, 32 new tokens, capacity 1024; every request
              done, the decode-attention counter > 0 (and the RMSNorm kernel
              unused: decode keeps the plain formula, as the reference does);
 10. hybrid forward — ``ModelAPI.forward`` of zamba2-7b at full width (81
              Mamba2 layers padded to 14 groups of 6, the shared attention
              block), B = 1, S = 4096: exactly 84 SSD and 14 flash-attention
              launches (all on the bf16 route), no RMSNorm kernel (the
              hybrid keeps the plain formula); logits finite; wall time, peak
              memory;
 11. hybrid serve — ``serve_pool`` of zamba2-7b at full width, 8 requests,
              batch 4, 32-token prompts, 16 new tokens, capacity 1024: every
              request done, decode attention launched 14 times per decode
              call (280 calls), neither the RMSNorm nor the SSD kernel;
 12. model cpu vs card — the same seeded parameters and tokens through
              qwen3-4b's smoke config in float32 and a 2-layer full-width
              model in bfloat16, and zamba2-7b's smoke config and a
              one-group (6-layer) full-width model, both in float32, forward
              at S = 1536 and 8 decode steps, cpu (plain versions) against
              cuda (kernels): logits within atol 1e-4 (float32; the hybrid's
              forward 3e-4 at the smoke config and 2e-3 at full width, since
              its gated RMSNorm carries float32 rounding from group to
              group), or max error < 0.35 and mean relative error < 0.05
              (bfloat16); a forward outside the limit is
              diagnosed before the phase fails (a second card forward, the
              parameters' card copies, each block's residual stream, each
              kernel call against its plain version);
 13. planner — the paper's planner API on cuda, the split-score counters
              zeroed just before and read just after: ``plan_pareto`` (20
              bounds per direction), ``plan`` for the period and for the
              latency under half the fastest single-processor period, on one
              instance pair of each of E1-E4 at n = 40, p = 100;
              ``plan_request`` of ``auto_request`` in both directions and of
              the whole default portfolio (exact solvers included) on two
              pairs at n = 10, p = 10; ``min_period_exhaustive`` against
              ``batched_min_period``; the scalar engine's E1 curves against
              the golden CSV.  The same planner calls on cpu: every
              candidate (solver, objective, period, latency, feasibility,
              mapping, error), the chosen plan and the front equal; both
              split-score kernels launched; wall time and launches per
              ``plan_pareto``;
 14. reliability — the reliability sequel, the deal extension and online
              replanning on cuda, the split-score counters zeroed just
              before and read just after, on one instance of each of R1-R4
              at n = 40, p = 100: ``plan_pareto_tri`` (20 bounds per
              direction, the six ``-rel`` solvers beside the plain ones)
              without a floor and with the median candidate reliability as
              floor; ``plan_with_deal`` for the period, unbounded and under a
              latency bound; ``plan_pareto`` and ``replicate_stage_plan`` of
              its plan with a target; ``replan_stages`` with one straggling
              stage; ``elastic_replan`` from 100 to 75 pods.  The same calls
              on cpu with each split-scoring call counted: every candidate
              (groups and reliability included), front, chosen plan, deal
              plan and replanned plan equal, and each call's launches on the
              card equal to its scoring calls on the cpu; both kernels
              launched; wall time and launches per call;
 15. fused — the fused and sharded campaign engines on cuda: ``paper_sim``
              with ``engine="fused"`` writes the golden CSVs byte for byte;
              phase 5's full-width campaign through the fused engine, cold
              (captures included) and then warm, each with the counters
              zeroed just before and read just after: every curve and
              threshold equal to phase 5's, captures per chunk size within
              ``fused.trace_budget(160)``, both split-score kernels launched
              (graph replays x kernels per graph), replays, host polls and
              wall times printed beside phase 5's; phase 6's 8 instances
              (H1-H4 trajectories, ``batched_min_period``, the H4 bisection)
              through the fused engine on cuda equal to the lockstep engine
              on cpu; ``backend="sharded"`` over every visible card and over
              ``[cuda:0, cuda:0]`` (the split, the padding and the merge on
              one card) equal to the fused engine;
 16. fleet — ``repro_torch.fleet.ReplanService`` on cuda, the engine
              counters zeroed just before each run and read just after: the
              reference fleet benchmark's standard trace (16 groups x 16
              replicas, n = 12, p = 6, 30 ticks) and its chaos overlay
              (reliability floor 0.98) through the lockstep and the fused
              engine with the inline supervisor, each ``fleet_digest()`` the
              reference's (``FLEET_DIGESTS``), no invalid published plan; the
              chaos trace through ``crash_restart_run`` (crashes at 1/3 and
              2/3, a snapshot every 8 ticks) and through
              ``subprocess_supervisor(workers=2, device="cuda")`` under
              seeded SIGKILLs mid-solve, the same digest, one restart per
              injected kill and no scalar fallback; the full-size fleet (256
              groups x 16 replicas = 4096 instances, n = 40, p = 100, 30
              ticks) through lockstep and fused (each cold, then warm) on cuda
              and through lockstep on the cpu, every digest equal; both
              split-score kernels launched in every card run (graph replays x
              kernels per graph for the fused engine); wall time, replans/s,
              p50/p99 replan latency, dedup hit rate, solves, captures and
              launches per run, each line with the card's name and power
              limit.

Before its last line it prints one JSON line ``{"kernels": [...]}`` (per
kernel: launches summed over the main paths' runs (phases 5, 8-11, 13-16;
the subprocess workers' launches are their own processes' and not counted),
max abs error, kernel / plain / bound / library device times in ms; decode
attention's at the serve runs' live count); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
With ``--json PATH`` it also writes every number it measured to PATH.
It needs the repository's ``src/`` beside it and a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
SRC = REPO / "src"
GOLDEN = REPO / "tests" / "golden" / "paper_sim"

# H100 SXM (NVIDIA data sheet): HBM3 bandwidth; fp64 and fp32 (non-tensor)
# and dense bf16 and TF32 tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 34e12
FP32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12
TF32_TENSOR_FLOPS_PER_S = 495e12
# the fastest float32-accurate product on the card: three TF32 tensor-core
# products (hi.hi + hi.lo + lo.hi) for each float32 one
F32_ACCURATE_FLOPS_PER_S = TF32_TENSOR_FLOPS_PER_S / 3
L2_BYTES = 50e6  # H100 SXM L2 cache

# main-path shapes at full width (n = 160, p = 1000, 200 instances):
# 2-way: 2400 H5/H6 (instance x bound) rows x 159 cuts; 3-way: 400 H2+H3 rows
# x 159*158/2 cut pairs of a 160-stage interval
N_STAGES, N_PROCS, N_PAIRS, N_BOUNDS, H4_ITERS = 160, 1000, 50, 12, 10
FAMILIES = ("E1", "E2", "E3", "E4")
A2, K2 = 2400, N_STAGES - 1
A3, SPAN3 = 400, N_STAGES
REPS = 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median time of one call of ``fn`` in a CUDA-event window around it on
    an idle card: the wrapper's host work is inside the window.  Used only
    for the split-score kernels' plain versions, which copy host scalars to
    the card on every call (a copy that waits for the card, so
    :func:`device_time`'s sleep cannot hide it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


_CYCLES_PER_MS = []


def sleep_cycles_per_ms(torch) -> float:
    """The rate at which ``torch.cuda._sleep`` counts cycles on this card,
    by CUDA events around one long sleep (measured once per process)."""
    if not _CYCLES_PER_MS:
        cycles = 20_000_000
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(cycles / start.elapsed_time(end))
    return _CYCLES_PER_MS[0]


def device_time(torch, calls, n: int = REPS, attempts: int = 4) -> dict:
    """Device time per call, with the host's work kept out of the window.

    ``calls`` is one callable or a ring of them (one per cold buffer), taken
    in turn.  After a warm-up over the whole ring and one unslept pass of
    ``n`` calls (which sizes the host's enqueueing), a sleep is enqueued on
    the card that outlasts the host's enqueueing of the ``n`` calls; the
    start event is recorded behind it, then the ``n`` calls, then the end
    event, so the window holds the calls' device work back to back and none
    of the wrappers' host work (checks, allocation, the ctypes call).  If the
    start event has already passed when the host is done enqueueing, the
    sleep did not cover the host work: that window is dropped and the next
    attempt sleeps twice as long; after ``attempts`` such windows no number
    is reported.  Returns ``{"ms": device ms per call, "host_us": host µs to
    enqueue one call}`` (the host time of the window that was kept)."""
    ring = list(calls) if isinstance(calls, (list, tuple)) else [calls]
    i = 0

    def enqueue(count):
        nonlocal i
        t0 = time.perf_counter()
        for _ in range(count):
            ring[i % len(ring)]()
            i += 1
        return time.perf_counter() - t0

    enqueue(max(3, len(ring)))
    torch.cuda.synchronize()
    sleep_ms = 3e3 * enqueue(n) + 5.0
    for _ in range(attempts):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_ms * sleep_cycles_per_ms(torch)))
        start.record()
        host_s = enqueue(n)
        covered = not start.query()
        end.record()
        end.synchronize()
        if covered:
            return {"ms": start.elapsed_time(end) / n, "host_us": host_s / n * 1e6}
        sleep_ms *= 2
    fail(f"device timing: enqueueing {n} calls outlasted a sleep of {sleep_ms / 2:.3f} ms "
         f"{attempts} times")


def cold_ring(touched_bytes: float) -> int:
    """Buffers to rotate over so that each call finds its inputs cold: between
    two uses of one buffer the others touch at least twice the L2 cache."""
    return math.ceil(2 * L2_BYTES / touched_bytes) + 1


def bound(nbytes: float, flops: float, peak: float = FP64_FLOPS_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel_2way(torch, split_score, score_2way, gen):
    dev = torch.device("cuda")
    f64 = torch.float64
    A, K = A2, K2

    def r(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, dtype=f64, device=dev, generator=gen) * (hi - lo) + lo

    pre = torch.sort(r(A, K + 2, hi=2000.0), dim=1).values
    pre_d1, pre_C, pre_e = (pre[:, :1].contiguous(), pre[:, 1:-1].contiguous(),
                            pre[:, -1:].contiguous())
    dl = r(A, K + 2, hi=100.0)
    del_d1, del_C, del_e = (dl[:, :1].contiguous(), dl[:, 1:-1].contiguous(),
                            dl[:, -1:].contiguous())
    inv_j, inv_p = r(A, 1, lo=0.05, hi=1.0), r(A, 1, lo=0.05, hi=1.0)
    need = torch.randint(1, K + 1, (A,), device=dev, generator=gen)
    ins = (pre_d1, pre_C, pre_e, del_d1, del_C, del_e, 10.0, inv_j, inv_p)
    got = split_score.score_2way_cuda(*ins, need=need)
    torch.cuda.synchronize()
    want = score_2way(*ins)
    torch.cuda.synchronize()
    live = torch.arange(K, device=dev).repeat(2)[None, :] < need[:, None]
    # the fused engine's entry point: b read on the card from a 0-dim tensor
    b_t = torch.tensor(ins[6], dtype=f64, device=dev)
    got_ptr = split_score.score_2way_cuda(*ins[:6], b_t, *ins[7:], need=need)
    torch.cuda.synchronize()
    err = 0.0
    for g, gp, w in zip(got, got_ptr, want):
        if not torch.equal(g[live], w[live]):
            fail("score_2way_f64 differs from its plain version on live lanes")
        if g[~live].any():
            fail("score_2way_f64 left non-zero lanes past need")
        if not torch.equal(gp, g):
            fail("score_2way_f64_bptr (b on the card) differs from score_2way_f64")
        err = max(err, float((g[live] - w[live]).abs().max()))
    n_live = int(need.sum())
    nbytes = 16 * n_live + 56 * A + 48 * A * K
    # device time on cold inputs: the calls rotate over copies of the inputs
    ring = [ins] + [tuple(t.clone() if torch.is_tensor(t) else t for t in ins)
                    for _ in range(cold_ring(nbytes) - 1)]
    kern = device_time(torch, [lambda x=x: split_score.score_2way_cuda(*x, need=need)
                               for x in ring], max(REPS, len(ring)))
    del ring
    plain_ms = cuda_ms(torch, lambda: score_2way(*ins))
    flops = 25 * n_live + 3 * A
    b_ms, b_by = bound(nbytes, flops)
    return {"name": "score_2way_f64", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/split_score.cu",
            "replaces": "src/repro/kernels/split_score.py:79",
            "shape": {"A": A, "K": K, "live_lanes": n_live, "cold_buffers": cold_ring(nbytes)},
            "max_abs_err": err, "ms": kern["ms"], "host_us": kern["host_us"],
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "flops": flops, "library_ms": None}


def check_kernel_3way(torch, split_score, score_3way, gen):
    dev = torch.device("cuda")
    f64 = torch.float64
    A, span = A3, SPAN3
    K = (span - 1) * (span - 2) // 2

    def r(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, dtype=f64, device=dev, generator=gen) * (hi - lo) + lo

    dI, W, dO = r(A, 1, 3, K, hi=10.0), r(A, 1, 3, K, lo=0.1, hi=2000.0), r(A, 1, 3, K, hi=10.0)
    perms = torch.tensor([(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)],
                         device=dev)
    invp = r(A, 3, lo=0.05, hi=1.0)[:, perms][:, :, :, None].contiguous()
    base = r(A, 1, 1, lo=1.0, hi=500.0)
    spans = torch.randint(3, span + 1, (A,), device=dev, generator=gen)
    need = split_score.pair_need(spans, span)
    ins = (dI, W, dO, invp, base)
    got = split_score.score_3way_cuda(*ins, need=need)
    torch.cuda.synchronize()
    want = score_3way(*ins)
    torch.cuda.synchronize()
    live = torch.arange(K, device=dev)[None, :] < need[:, None]
    err = 0.0
    for g, w in zip(got, want):
        lv = live.view((A,) + (1,) * (w.dim() - 2) + (K,)).expand(w.shape)
        if not torch.equal(g[lv], w[lv]):
            fail("score_3way_f64 differs from its plain version on live lanes")
        if g[~lv].any():
            fail("score_3way_f64 left non-zero lanes past need")
        err = max(err, float((g[lv] - w[lv]).abs().max()))
    del got, want
    n_live = int(need.sum())
    nbytes = 72 * n_live + 160 * A + 240 * A * K
    ring = [ins] + [tuple(t.clone() for t in ins) for _ in range(cold_ring(nbytes) - 1)]
    kern = device_time(torch, [lambda x=x: split_score.score_3way_cuda(*x, need=need)
                               for x in ring], max(REPS, len(ring)))
    del ring
    torch.cuda.empty_cache()
    plain_ms = cuda_ms(torch, lambda: score_3way(*ins))
    flops = 102 * n_live
    b_ms, b_by = bound(nbytes, flops)
    return {"name": "score_3way_f64", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/split_score.cu",
            "replaces": "src/repro/kernels/split_score.py:172",
            "shape": {"A": A, "K": K, "live_lanes": n_live, "cold_buffers": cold_ring(nbytes)},
            "max_abs_err": err, "ms": kern["ms"], "host_us": kern["host_us"],
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "flops": flops, "library_ms": None}


def hmma_counts(build, lib: str, kernel: str) -> dict:
    """Tensor-core (HMMA) instructions in each function of library ``lib``'s
    SASS, by ``cuobjdump --dump-sass``; every instantiation of the functions
    whose name holds ``kernel`` must hold some.  Returns ``{"hmma_per_kernel":
    {function: count}, "hmma_elsewhere": count}``."""
    tool = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "--dump-sass", str(build.library_path(lib))],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        fail(f"cuobjdump failed on the {lib} library: {res.stderr.strip()[-500:]}")
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    tc = {f: n for f, n in counts.items() if kernel in f}
    if not tc or min(tc.values()) <= 0:
        fail(f"{lib}: {kernel} holds no tensor-core instruction: {tc}")
    return {"hmma_per_kernel": tc,
            "hmma_elsewhere": sum(n for f, n in counts.items() if f not in tc)}


def check_campaign(res: dict, n_bounds: int) -> None:
    """The campaign's outputs are well formed: every curve has one finite
    point per bound where any instance is feasible, fractions are in [0, 1],
    thresholds are finite, and H5/H6 thresholds coincide (both are the
    optimal latency)."""
    import numpy as np

    for exp, r in res.items():
        for code, (mp, ml, fr) in r.curves.items():
            if not (len(mp) == len(ml) == len(fr) == n_bounds):
                fail(f"{exp} {code}: curve length is not {n_bounds}")
            if ((fr < 0) | (fr > 1)).any():
                fail(f"{exp} {code}: feasible fraction outside [0, 1]")
            if not (np.isfinite(mp) == (fr > 0)).all() or not (np.isfinite(ml) == (fr > 0)).all():
                fail(f"{exp} {code}: curve points not finite exactly where feasible")
        for code, (m, mx) in r.thresholds.items():
            if not (math.isfinite(m) and math.isfinite(mx)):
                fail(f"{exp} {code}: threshold not finite")
        if r.thresholds["H5"] != r.thresholds["H6"]:
            fail(f"{exp}: H5/H6 thresholds differ")


# serving path at full width: qwen3-4b (36 layers, d 2560, 32 / 8 heads of
# 80, d_ff 9728, vocab 151,936); forward at the train_4k sequence length,
# decode at the serve run's batch and cache capacity
ARCH = "qwen3-4b"
FWD_S = 4096
SERVE = dict(n_requests=8, batch=4, prompt_len=64, max_new=32, capacity=1024, seed=0)
WINDOW = 1024
# kernel against plain version: float32 within atol 2e-5 (the repo's kernel
# tolerance); bfloat16 per element within 2e-5 + 2^-6 |want| (two bf16
# spacings of the value: both sides compute in float32 and round once, so
# they may round a near-tie apart, and no more)
F32_TOL, BF16_RTOL, LOGIT_F32_TOL = 2e-5, 2.0 ** -6, 1e-4
# the hybrid's float32 forward: each Mamba2 layer's SSD decay exp(cum_i -
# cum_j) differs between two summation orders of the running sum cum, and
# the gated RMSNorm about doubles the carried difference at every group.
# The smoke config (chunks of 32) parts from the reference by ~1.2e-4 at
# S = 1536 (tests/test_torch_hybrid.py).  In a full-width group (chunks of
# 256, cum reaching ~-180) the SSD's summation order alone moves the logits
# by a few 1e-4 (python -m repro_torch.launch.rounding_probe --device cpu
# --layers 6 --dtype float32), and the card's float32 GEMMs and scans add
# their own orders; PERF.md has the card's readings.  A planted SSD fault
# moves the logits by more than 1 (tests/test_torch_chip_smoke.py).
HYBRID_FWD_F32_TOL, HYBRID_FULL_FWD_F32_TOL = 3e-4, 2e-3

# the hybrid path at full width: zamba2-7b (81 Mamba2 layers of d 3584 in 14
# groups of 6, SSD heads of 64 with state 64 in chunks of 256; a shared
# attention block of 32 heads of 112); forward at train_4k, serving at the
# qwen3-4b run's batch and capacity with shorter prompts and generations
HYBRID = "zamba2-7b"
HYBRID_SERVE = dict(n_requests=8, batch=4, prompt_len=32, max_new=16, capacity=1024, seed=0)
# the SSD kernel against its plain version: float32, per element 2e-5 + 1e-4
# |want|: the sums run in another order, and exp(cum_i - cum_j) carries the
# rounding of the running sum cum (spacing ~1e-7 of |cum|, ~1e-5 of exp's
# argument once |cum| reaches ~100 at the model's dt)
SSD_ATOL, SSD_RTOL = 2e-5, 1e-4


def _within(torch, got, want):
    """(every element within the tolerance of its dtype, max abs error)."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"shape/dtype {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    diff = (got.float() - want.float()).abs()
    lim = F32_TOL
    if want.dtype == torch.bfloat16:
        lim = F32_TOL + BF16_RTOL * want.float().abs()
    return bool((diff <= lim).all()), float(diff.max())


def _err(torch, name, got, want) -> float:
    ok, err = _within(torch, got, want)
    if not ok:
        fail(f"{name} ({want.dtype}) differs from its plain version: max abs err {err}")
    return err


def _rejects(torch, name, wrong, want) -> float:
    """The tolerance tells a plainly wrong answer (a mask or window ignored)
    from the right one; returns the wrong answer's max abs error."""
    ok, err = _within(torch, wrong, want)
    if ok:
        fail(f"{name}: the tolerance does not reject a wrong answer (max abs err {err})")
    return err


def _kernel_row(name, replaces, err, kern, plain, nbytes, flops, peak, lib, shape):
    """One row of the kernel table; ``kern``, ``plain`` and ``lib`` (or None)
    are :func:`device_time` results."""
    b_ms, b_by = bound(nbytes, flops, peak)
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{replaces[0]}.cu",
            "replaces": f"src/repro/kernels/{replaces[0]}.py:{replaces[1]}",
            "shape": shape, "max_abs_err": err, "ms": kern["ms"], "host_us": kern["host_us"],
            "plain_ms": plain["ms"], "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "flops": flops, "library_ms": None if lib is None else lib["ms"],
            "library_host_us": None if lib is None else lib["host_us"],
            "tolerance": f"float32 atol {F32_TOL}; bfloat16 {F32_TOL} + {BF16_RTOL} |want|"}


def check_model_kernels(torch, cfg, gen) -> list:
    """The four model kernels at the full-width shapes of the serving path,
    in float32 and in bfloat16 (timed); the attention kernels also show that
    the tolerance rejects the answer with the window or mask ignored."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    eps = cfg.norm_eps

    def r(*shape, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * 0.5).to(dtype)

    rows = []
    # RMSNorm: every row of a B = 1, S = 4096 forward.  Timed cold: the calls
    # rotate over enough copies of x (and of the residual) that each finds
    # its input out of L2, as the bound assumes; scale (10 KB) stays warm
    n_el = FWD_S * d
    ring = cold_ring(2 * 2 * n_el)
    xs, ress = r(ring, FWD_S, d), r(ring, FWD_S, d)
    x, res, sc = xs[0], ress[0], 1.0 + 0.1 * r(d, dtype=f32)
    x32, res32 = x.float(), res.float()
    f32_err = _err(torch, "rmsnorm", ops.rmsnorm(x32, sc, eps=eps),
                   ref.rmsnorm_ref(x32, sc, eps=eps))
    err = _err(torch, "rmsnorm", ops.rmsnorm(x, sc, eps=eps), ref.rmsnorm_ref(x, sc, eps=eps))
    sc16 = sc.to(bf16)
    rows.append(_kernel_row(
        "rmsnorm", ("rmsnorm", 17), err,
        device_time(torch, [lambda x=x: ops.rmsnorm(x, sc, eps=eps) for x in xs]),
        device_time(torch, [lambda x=x: ref.rmsnorm_ref(x, sc, eps=eps) for x in xs]),
        4 * n_el + 4 * d, 4 * n_el, FP32_FLOPS_PER_S,
        device_time(torch, [lambda x=x: F.rms_norm(x, (d,), sc16, eps) for x in xs]),
        {"n": FWD_S, "d": d, "dtype": "bfloat16", "cold_buffers": ring})
        | {"f32_max_abs_err": f32_err})
    f32_err = 0.0
    for g, w in zip(ops.rmsnorm_residual(x32, res32, sc, eps=eps),
                    ref.rmsnorm_residual_ref(x32, res32, sc, eps=eps)):
        f32_err = max(f32_err, _err(torch, "rmsnorm_residual", g, w))
    del x32, res32
    err = 0.0
    for g, w in zip(ops.rmsnorm_residual(x, res, sc, eps=eps),
                    ref.rmsnorm_residual_ref(x, res, sc, eps=eps)):
        err = max(err, _err(torch, "rmsnorm_residual", g, w))
    pairs = list(zip(xs, ress))
    rows.append(_kernel_row(
        "rmsnorm_residual", ("rmsnorm", 24), err,
        device_time(torch, [lambda x=x, y=y: ops.rmsnorm_residual(x, y, sc, eps=eps)
                            for x, y in pairs]),
        device_time(torch, [lambda x=x, y=y: ref.rmsnorm_residual_ref(x, y, sc, eps=eps)
                            for x, y in pairs]),
        8 * n_el + 4 * d, 5 * n_el, FP32_FLOPS_PER_S, None,
        {"n": FWD_S, "d": d, "dtype": "bfloat16", "cold_buffers": ring})
        | {"f32_max_abs_err": f32_err})
    del x, res, xs, ress, pairs
    torch.cuda.empty_cache()

    # flash attention: one layer of the forward, causal; and with a window
    fa = {w: check_flash(torch, gen, H, K, hd, w) for w in (None, WINDOW)}
    rows.append(fa[None] | {"window_1024": _sub_row(fa[WINDOW])})
    # decode attention: one layer of a serve step, at its three inputs
    rows.append(check_decode(torch, gen, ARCH, H, K, hd, SERVE["capacity"] // 2))
    return rows


def _sub_row(row) -> dict:
    return {key: row[key] for key in ("max_abs_err", "f32_max_abs_err", "wrong_max_abs_err",
                                      "ms", "host_us", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "library_host_us", "f32_ms",
                                      "tc_executed_tflops", "shape", "inputs")
            if key in row}


def check_flash(torch, gen, H, K, hd, window) -> dict:
    """Flash attention at B = 1, S = T = FWD_S, causal, with ``window``, in
    float32 and bfloat16 against its plain version; the same limit must
    reject the answer with the window ignored (without a window: with
    causality ignored).  The bf16 route (tensor cores) timed beside its plain
    version and SDPA (bf16), and beside the float32 route (CUDA cores).
    Bound by operations, so timed warm (one set of inputs)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    q, k, v = ((torch.randn(shape, generator=gen, device=dev) * 0.5).to(bf16)
               for shape in ((1, FWD_S, H, hd), (1, FWD_S, K, hd), (1, FWD_S, K, hd)))
    name = f"flash_attention (H {H}, K {K}, hd {hd}, window {window})"
    q32, k32, v32 = q.float(), k.float(), v.float()
    f32_err = _err(torch, name, ops.flash_attention(q32, k32, v32, causal=True, window=window),
                   ref.flash_attention_ref(q32, k32, v32, causal=True, window=window))
    f32_ms = device_time(torch, lambda: ops.flash_attention(q32, k32, v32, causal=True,
                                                            window=window))["ms"]
    del q32, k32, v32
    torch.cuda.empty_cache()
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    err = _err(torch, name, ops.flash_attention(q, k, v, causal=True, window=window), want)
    wrong_err = _rejects(torch, name, ref.flash_attention_ref(
        q, k, v, causal=window is not None, window=None), want)
    del want
    torch.cuda.empty_cache()
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = sum(min(i + 1, window or FWD_S) for i in range(FWD_S))
    if window is None:
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                     enable_gqa=True)
    else:
        pq = torch.arange(FWD_S, device=dev)
        band = (pq[:, None] >= pq[None, :]) & (pq[:, None] - pq[None, :] < window)
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                                     enable_gqa=True)
    kern = device_time(torch, lambda: ops.flash_attention(q, k, v, causal=True, window=window))
    row = _kernel_row(
        "flash_attention", ("flash_attention", 27), err, kern,
        device_time(torch, lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                                           window=window)),
        2 * (2 * FWD_S * H * hd + 2 * FWD_S * K * hd), 4 * hd * H * pairs,
        BF16_TENSOR_FLOPS_PER_S, device_time(torch, lib),
        {"B": 1, "S": FWD_S, "T": FWD_S, "H": H, "K": K, "hd": hd, "causal": True,
         "window": window, "pairs": pairs}) | {
        "f32_max_abs_err": f32_err, "wrong_max_abs_err": wrong_err, "f32_ms": f32_ms,
        # the tensor cores' work: QK^T (2 hd) and P V twice, hi and lo (4 hd)
        "tc_executed_tflops": 6 * hd * H * pairs / (kern["ms"] * 1e-3) / 1e12}
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


# decode attention's three inputs, at the serve runs' B = 4 and C = 1024 (a
# slot written at or before pos holds that position; -1 marks an empty slot):
#   mixed       pos drawn from [C/2, C), every 7th slot emptied, the model's
#               window (about 440 live slots per row under qwen3-4b's 512)
#   serve_live  pos 95, the last position of the serve runs' 64-token prompts
#               and 32 new tokens: 96 live slots, the rest never written
#   full        every slot written and live, no window
DECODE_INPUTS = ("mixed", "serve_live", "full")


def decode_bytes(B, H, K, hd, live, C, itemsize=2) -> int:
    """Bytes decode attention must move: q read and out written, K and V of
    the live slots only (a masked slot's K/V never reach the output), the
    mask.  ``live`` counts live slots over all batch rows."""
    return itemsize * (2 * B * H * hd + 2 * live * K * hd) + B * C


def decode_plan(torch, kind, H, K, hd, window, gen, device) -> dict:
    """Input ``kind`` of :data:`DECODE_INPUTS` (``window``: the model's, or
    None): cache positions, current positions, the window it takes, the
    slot mask, its live count, the bytes of the bound, and the cold ring."""
    from repro_torch.kernels import ops

    B, C = SERVE["batch"], SERVE["capacity"]
    slots = torch.arange(C, device=device, dtype=torch.int32)[None, :]
    if kind == "mixed":
        pos = torch.randint(C // 2, C, (B,), generator=gen, device=device)
    elif kind == "serve_live":
        pos = torch.full((B,), SERVE["prompt_len"] + SERVE["max_new"] - 1, device=device)
    else:
        pos, window = torch.full((B,), C - 1, device=device), None
    pos = pos.to(torch.int32)
    written = torch.where(slots <= pos[:, None], slots, -1).to(torch.int32)
    positions = written.clone()
    if kind == "mixed":
        positions[:, 3::7] = -1
    mask = ops.decode_mask(positions, pos, window)
    live = int(mask.sum())
    nbytes = decode_bytes(B, H, K, hd, live, C)
    return {"kind": kind, "B": B, "C": C, "positions": positions, "written": written,
            "pos": pos, "window": window, "mask": mask, "live": live, "bytes": nbytes,
            "ring": cold_ring(nbytes)}


def check_decode(torch, gen, arch, H, K, hd, window) -> dict:
    """Decode attention at the serve runs' B = 4 against C = 1024 at each of
    :data:`DECODE_INPUTS`, in float32 and bfloat16 against its plain version;
    at ``mixed`` the same limit must reject the answers with the empty slots
    taken as written and (with a window) the window ignored.

    Timed by :func:`device_time`: the kernel's wrapper on a prebuilt mask,
    the ``ops`` wrapper (which also builds the mask from the positions),
    the plain version, and SDPA on the same prebuilt mask.  The cache is
    cold, as a real step finds it: every call rotates over ``ring`` distinct
    K/V buffers (SDPA over the same buffers in its head-major layout), so
    between two uses of one buffer the others touch at least twice the L2
    cache.  q, the mask and the positions (a few KB, written just before in
    a real step) stay warm.  The row's numbers are those of ``serve_live``;
    ``inputs`` holds all three."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import ops, ref

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    B, C = SERVE["batch"], SERVE["capacity"]
    q = (torch.randn((B, H, hd), generator=gen, device=dev) * 0.5).to(bf16)
    # the wrapper's split of the cache (None where it does not size one from the card)
    split = (kdec.split_slots(B, K, H // K, C, *kdec.card_shape(dev, hd, 1))
             if hasattr(kdec, "split_slots") else None)
    inputs = {}
    for kind in DECODE_INPUTS:
        plan = decode_plan(torch, kind, H, K, hd, window, gen, dev)
        mask, positions, pos, win = plan["mask"], plan["positions"], plan["pos"], plan["window"]
        n = plan["ring"]
        kv = (torch.randn((n, 2, B, C, K, hd), generator=gen, device=dev) * 0.5).to(bf16)
        k, v = kv[0, 0], kv[0, 1]
        name = f"decode_attention (H {H}, K {K}, hd {hd}, {kind}, window {win})"
        f32_err = _err(torch, name, kdec.decode_attention(q.float(), k.float(), v.float(), mask),
                       ref.decode_attention_ref(q.float(), k.float(), v.float(), mask))
        want = ref.decode_attention_ref(q, k, v, mask)
        err = max(_err(torch, name, kdec.decode_attention(q, k, v, mask), want),
                  _err(torch, name, ops.decode_attention(q, k, v, positions, pos, window=win),
                       want))
        res = {"max_abs_err": err, "f32_max_abs_err": f32_err}
        if kind == "mixed":
            wrong = [ops.decode_mask(plan["written"], pos, win)]
            if win is not None:
                wrong.append(ops.decode_mask(positions, pos, None))
            res["wrong_max_abs_err"] = min(_rejects(
                torch, f"{name}, a wrong mask", ref.decode_attention_ref(q, k, v, m), want)
                for m in wrong)
        torch.cuda.empty_cache()
        kvt = kv.transpose(3, 4).contiguous()  # (ring, 2, B, K, C, hd) for SDPA
        q4, m4 = q[:, :, None], mask[:, None, None, :]
        calls = max(REPS, n)
        kern = device_time(torch, [lambda i=i: kdec.decode_attention(q, kv[i, 0], kv[i, 1], mask)
                                   for i in range(n)], calls)
        opsd = device_time(torch, [lambda i=i: ops.decode_attention(
            q, kv[i, 0], kv[i, 1], positions, pos, window=win) for i in range(n)])
        plain = device_time(torch, [lambda i=i: ref.decode_attention_ref(q, kv[i, 0], kv[i, 1],
                                                                         mask)
                                    for i in range(n)])
        lib = device_time(torch, [lambda i=i: F.scaled_dot_product_attention(
            q4, kvt[i, 0], kvt[i, 1], attn_mask=m4, enable_gqa=True) for i in range(n)], calls)
        del kv, kvt
        torch.cuda.empty_cache()
        inputs[kind] = _kernel_row(
            "decode_attention", ("decode_attention", 24), err, kern, plain, plan["bytes"],
            4 * hd * H * plan["live"], BF16_TENSOR_FLOPS_PER_S, lib,
            {"B": B, "C": C, "H": H, "K": K, "hd": hd, "window": win,
             "live_slots": plan["live"], "cold_buffers": n, "timed_calls": calls,
             "split_slots": split}) | res | {
            "ops_ms": opsd["ms"], "ops_host_us": opsd["host_us"]}
    return inputs["serve_live"] | {
        "arch": arch, "max_abs_err": max(row["max_abs_err"] for row in inputs.values()),
        "inputs": {
        kind: {key: row[key] for key in ("max_abs_err", "f32_max_abs_err", "wrong_max_abs_err",
                                         "ms", "host_us", "ops_ms", "ops_host_us", "plain_ms",
                                         "library_ms", "library_host_us", "bound_ms", "bytes",
                                         "shape") if key in row}
        for kind, row in inputs.items()}}


def _ssd_within(torch, got, want) -> tuple:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"shape/dtype {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    diff = (got - want).abs()
    return bool((diff <= SSD_ATOL + SSD_RTOL * want.abs()).all()), float(diff.max())


def ssd_wrong(torch, x, dt, A, Bm, Cm, *, exclusive: bool, state_decay: bool) -> tuple:
    """The SSD intra-chunk function with one deliberate fault: the exclusive
    instead of the inclusive cumsum, or the chunk state without its
    exp(cum_Q - cum_j) decay (otherwise ``ref.ssd_intra_chunk_ref``)."""
    Q = x.shape[2]
    dth = dt.transpose(2, 3)
    dA = dth * A[:, None]
    cum = torch.cumsum(dA, dim=-1) - (dA if exclusive else 0.0)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
    w = torch.einsum("bcin,bcjn->bcij", Cm, Bm)[:, :, None] * L * dth[..., None, :]
    y = torch.einsum("bchij,bcjhp->bcihp", w, x)
    dec_state = (torch.exp(cum[..., -1:] - cum) if state_decay else 1.0) * dth
    st = torch.einsum("bchjn,bcjhp->bchnp", Bm[:, :, None] * dec_state[..., None], x)
    return y, st, torch.exp(cum[..., -1])


def check_ssd_kernel(torch, cfg, gen) -> dict:
    """The SSD intra-chunk kernel at the hybrid's full-width forward shapes
    (B = 1, S = 4096 in chunks of Q), float32, against its plain version;
    the limit must reject the two wrong answers of :func:`ssd_wrong`."""
    from repro_torch.kernels import mamba2_ssd, ref
    from repro_torch.models.ssm import ssm_dims

    dev = torch.device("cuda")
    _, H, P, N = ssm_dims(cfg)
    B, Q = 1, cfg.ssm_chunk
    nc = FWD_S // Q

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.5

    # the reference's SSD test inputs (tests/test_kernels.py:97-101)
    ins = (r(B, nc, Q, H, P), r(B, nc, Q, H).abs() * 0.1, -r(H).abs() * 0.5,
           r(B, nc, Q, N), r(B, nc, Q, N))
    want = ref.ssd_intra_chunk_ref(*ins)
    err = 0.0
    for name, g, w in zip(("y", "state", "decay"), mamba2_ssd.ssd_intra_chunk(*ins), want):
        ok, e = _ssd_within(torch, g, w)
        if not ok:
            fail(f"ssd_intra_chunk {name} differs from its plain version: max abs err {e}")
        err = max(err, e)
    wrong = {}
    for label, kw in (("exclusive cumsum", dict(exclusive=True, state_decay=True)),
                      ("state without decay", dict(exclusive=False, state_decay=False))):
        res = [_ssd_within(torch, g, w) for g, w in zip(ssd_wrong(torch, *ins, **kw), want)]
        if all(ok for ok, _ in res):
            fail(f"ssd_intra_chunk ({label}): the limit does not reject a wrong answer")
        wrong[label] = max(e for _, e in res)
    torch.cuda.empty_cache()
    pairs = Q * (Q + 1) // 2
    # The bound is the same work whatever implements it: multiply-adds count
    # 2, the causal pairs' C.B scores once per chunk (they do not depend on
    # the head), then per head the pairs' w x and the state (11,371,012,608
    # flops at full width), against each input read once and each output
    # written once (268,180,928 B).  The fastest rate that keeps the products
    # float32-accurate is three TF32 tensor-core products per product (495 / 3
    # = 165 TFLOP/s): 0.069 ms; the bytes take 0.080 ms at 3.35 TB/s, so the
    # bound is 0.080 ms, by bytes.
    flops = B * nc * (2 * pairs * N + H * (2 * pairs * P + 2 * Q * N * P))
    nbytes = 4 * (2 * B * nc * Q * H * P + B * nc * H * N * P + 2 * B * nc * Q * N
                  + B * nc * Q * H + B * nc * H + H)
    row = _kernel_row(
        "ssd_intra_chunk", ("mamba2_ssd", 23), err,
        device_time(torch, lambda: mamba2_ssd.ssd_intra_chunk(*ins)),
        device_time(torch, lambda: ref.ssd_intra_chunk_ref(*ins)),
        nbytes, flops, F32_ACCURATE_FLOPS_PER_S, None,
        {"B": B, "nc": nc, "Q": Q, "H": H, "P": P, "N": N, "dtype": "float32"})
    torch.cuda.empty_cache()
    return row | {"wrong_max_abs_err": wrong,
                  "tolerance": f"float32 {SSD_ATOL} + {SSD_RTOL} |want|"}


def zero_counters(counters) -> None:
    """Each kernel's launch count, and its per-route counts where it has
    routes, to 0."""
    for c in counters:
        c.launches = 0
        for route in getattr(c, "routes", {}):
            c.routes[route] = 0


def route_counts(counters) -> dict:
    return {c.__name__: dict(c.routes) for c in counters if hasattr(c, "routes")}


def check_flash_routes(path: str, launches: dict, routes: dict) -> None:
    """Every flash call of a bf16 forward took the tensor-core route."""
    want = {"tc_bf16": launches["flash_attention"], "cuda_f32": 0}
    if routes["flash_attention"] != want:
        fail(f"{path}: flash routes {routes['flash_attention']}, expected {want}")


def run_forward(torch, cfg, counters) -> dict:
    """The full-width forward with kernels, counters zeroed just before."""
    from repro_torch.models import get_model

    api = get_model(cfg)
    params = api.init(SERVE["seed"], "cuda")
    toks = torch.randint(1, cfg.vocab_size, (1, FWD_S), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    t0 = time.time()
    logits, _ = api.forward(params, {"tokens": toks}, cfg)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {c.__name__: c.launches for c in counters}
    routes = route_counts(counters)
    if not bool(torch.isfinite(logits).all()):
        fail("forward: logits not finite")
    out = {"B": 1, "S": FWD_S, "layers": cfg.n_layers, "wall_s_first": wall,
           "launches": launches, "routes": routes,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "logits_shape": list(logits.shape)}
    del logits
    t0 = time.time()
    api.forward(params, {"tokens": toks}, cfg)
    torch.cuda.synchronize()
    out["wall_s_second"] = time.time() - t0
    return out


def decode_calls(n_requests: int, batch: int, prompt_len: int, max_new: int, **_) -> int:
    """Decode calls of a ``serve_pool`` run whose requests all fit in whole
    waves of ``batch``: each wave feeds its prompts token by token (all but
    the last token) and then generates ``max_new`` tokens."""
    return n_requests // batch * (batch * (prompt_len - 1) + max_new)


def run_serve(torch, arch, serve_cfg, counters) -> dict:
    """``serve_pool`` of ``arch`` at full width, counters zeroed just before."""
    from repro_torch.launch.serve import serve_pool

    torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    served = serve_pool(arch=arch, smoke=False, device="cuda", **serve_cfg)
    launches = {c.__name__: c.launches for c in counters}
    if not served["all_done"]:
        fail(f"serve {arch}: not every request finished: {served}")
    return served | {"config": serve_cfg, "launches": launches,
                     "decode_calls": decode_calls(**serve_cfg),
                     "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _logits_close(got, want, dtype, f32_tol=LOGIT_F32_TOL) -> dict:
    got, want = got.float().cpu(), want.float()
    err = (got - want).abs()
    out = {"max_err": float(err.max()), "mean_rel_err": float(err.mean() / want.abs().mean())}
    ok = bool(got.isfinite().all()) and (
        out["max_err"] <= f32_tol if dtype == "float32"
        else out["max_err"] < 0.35 and out["mean_rel_err"] < 0.05)
    return out | {"ok": ok}


def diagnose_forward(torch, api, cfg, params, card, toks, got, want,
                     f32_tol=LOGIT_F32_TOL) -> dict:
    """Where a forward's card and cpu logits part: whether a second card
    forward repeats the first bit for bit, the logit rows over the float32
    limit, whether a second cpu forward repeats the first, the parameters
    whose card copy differs from the cpu one, each block's residual stream
    (card against cpu; a layer of the dense model, a group of the hybrid),
    every kernel call against its plain version on the same card inputs, and
    the head: its input card against cpu, and each side's logits against the
    float64 product of its own input.  ``params`` and ``card`` may sit on any
    two devices."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import hybrid, ssm, transformer

    rows = (got.float().cpu() - want.float().cpu()).abs().amax(-1).flatten()
    bad = (rows > f32_tol).nonzero().flatten().tolist()
    out = {"rows_over": len(bad), "rows_over_first": bad[:8],
           "device": str(next(iter(card["embed"].values())).device)}
    if torch.cuda.is_available():
        out["uuid"] = str(torch.cuda.get_device_properties(0).uuid)
    streams, calls = [], []
    module, block_name = ((transformer, "block_forward") if cfg.family == "dense"
                          else (hybrid, "_group_forward"))
    block, flash, rms, ssd = (getattr(module, block_name), ops.flash_attention, ops.rmsnorm,
                              ops.ssd_chunked)
    head, heads = module.unembed, []

    def head_rec(p, x, c):
        y = head(p, x, c)
        heads.append((x.float().cpu(), y.float().cpu()))
        return y

    def block_rec(*a):
        y = block(*a)
        streams.append((y[0] if isinstance(y, tuple) else y).float().cpu())
        return y

    def flash_rec(q, k, v, **kw):
        o = flash(q, k, v, **kw)
        calls.append(("flash_attention", float((o - ref.flash_attention_ref(q, k, v, **kw))
                                               .abs().max())))
        return o

    def rms_rec(x, scale, *, eps):
        o = rms(x, scale, eps=eps)
        calls.append(("rmsnorm", float((o - ref.rmsnorm_ref(x, scale, eps=eps)).abs().max())))
        return o

    def ssd_rec(*a):
        o = ssd(*a)
        calls.append(("ssd_chunked", float((o[0] - ssm.ssd_chunked(*a)[0]).abs().max())))
        return o

    setattr(module, block_name, block_rec)
    module.unembed = head_rec
    ops.flash_attention, ops.rmsnorm, ops.ssd_chunked = flash_rec, rms_rec, ssd_rec
    try:
        again, _ = api.forward(card, {"tokens": toks.to(out["device"])}, cfg)
        n_card = len(streams)
        again_cpu, _ = api.forward(params, {"tokens": toks.cpu()}, cfg)
    finally:
        setattr(module, block_name, block)
        module.unembed = head
        ops.flash_attention, ops.rmsnorm, ops.ssd_chunked = flash, rms, ssd
    out["card_repeats_bitwise"] = bool(torch.equal(again, got))
    out["cpu_repeats_bitwise"] = bool(torch.equal(again_cpu.cpu(), want.cpu()))
    # the head: its input (the final norm's output) card against cpu, and
    # each side's logits against the same product in float64 of its own input
    emb = {name: t.double().cpu() for name, t in params["embed"].items()}
    (x_card, y_card), (x_cpu, y_cpu) = heads
    out["head_input_max_err"] = float((x_card - x_cpu).abs().max())
    out["head_card_vs_f64"] = float((y_card.double() - head(emb, x_card.double(), cfg))
                                    .abs().max())
    out["head_cpu_vs_f64"] = float((y_cpu.double() - head(emb, x_cpu.double(), cfg))
                                   .abs().max())

    def differing(a, b, name=""):
        if isinstance(a, dict):
            return [n for k in a for n in differing(a[k], b[k], f"{name}/{k}")]
        return [] if torch.equal(a.cpu(), b.cpu()) else [name]
    out["params_differing"] = differing(card, params)
    out["layer_max_err"] = [float((a - b).abs().max())
                            for a, b in zip(streams[:n_card], streams[n_card:])]
    out["kernel_vs_plain_max_err"] = calls[:len(calls) // 2]
    return out


def model_cpu_vs_card(torch, cfg, fwd_tol=LOGIT_F32_TOL) -> dict:
    """Same seeded parameters and tokens on cpu (plain versions) and cuda
    (kernels): forward at S = 1536 (float32 logits within ``fwd_tol``) and
    8 decode steps.  A forward outside the limit is diagnosed
    (:func:`diagnose_forward`) before the phase fails."""
    from repro_torch.models import get_model

    api = get_model(cfg)
    params = api.init(7, "cpu")
    card = _to(params, "cuda")
    gen = torch.Generator().manual_seed(8)
    toks = torch.randint(1, cfg.vocab_size, (2, 1536), generator=gen)
    worst = {}
    got, _ = api.forward(card, {"tokens": toks[:1].cuda()}, cfg)
    want, _ = api.forward(params, {"tokens": toks[:1]}, cfg)
    worst["forward"] = _logits_close(got, want, cfg.dtype, fwd_tol)
    if not worst["forward"]["ok"]:
        worst["forward"]["diagnosis"] = diagnose_forward(torch, api, cfg, params, card,
                                                         toks[:1], got, want, fwd_tol)
    del got, want
    st_card, st_cpu = api.init_decode_state(2, 16, "cuda"), api.init_decode_state(2, 16, "cpu")
    steps = []
    for t in range(8):
        got, st_card = api.decode(card, st_card, toks[:, t:t + 1].cuda())
        want, st_cpu = api.decode(params, st_cpu, toks[:, t:t + 1])
        steps.append(_logits_close(got, want, cfg.dtype))
    worst["decode"] = {"max_err": max(s["max_err"] for s in steps),
                       "mean_rel_err": max(s["mean_rel_err"] for s in steps),
                       "ok": all(s["ok"] for s in steps)}
    for part, res in worst.items():
        if not res["ok"]:
            fail(f"model cpu vs card ({cfg.arch_id}, {cfg.n_layers} layers, {cfg.dtype}): "
                 f"{part} {res}")
    return worst


def model_kernel_phase(torch, gen, report) -> tuple:
    """Phase 7: every model kernel against its plain version at full-width
    shapes, timed, and the lines that report it.  Returns (rows, the model
    kernels' launch counters, qwen3-4b's and zamba2-7b's configs)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import mamba2_ssd as kssd
    from repro_torch.kernels import rmsnorm as krn

    cfg = get_config(ARCH).replace(use_pallas=True)
    hcfg = get_config(HYBRID).replace(use_pallas=True)
    counters = [krn.rmsnorm, krn.rmsnorm_residual, kfa.flash_attention,
                kdec.decode_attention, kssd.ssd_intra_chunk]
    t0 = time.time()
    zero_counters(counters)
    model_kernels = check_model_kernels(torch, cfg, gen)
    # flash and decode attention at the hybrid's heads (G = 1, hd 112): the
    # shared block runs no window
    heads = (hcfg.n_heads, hcfg.n_kv_heads, hcfg.head_dim)
    hybrid_attn = {"flash_attention": check_flash(torch, gen, *heads, None),
                   "decode_attention": check_decode(torch, gen, HYBRID, *heads, None)}
    for k in model_kernels:
        if k["name"] in hybrid_attn:
            k[HYBRID] = _sub_row(hybrid_attn[k["name"]])
    model_kernels.append(check_ssd_kernel(torch, hcfg, gen))
    report["model_kernels_s"] = time.time() - t0
    report["model_kernels_routes"] = route_counts(counters)
    def routes_note(row):  # flash attention's two routes
        return "" if "f32_ms" not in row else (
            f"; bf16 route at {row['tc_executed_tflops']:.1f} TFLOP/s executed, "
            f"float32 route {row['f32_ms']:.4f} ms")

    def decode_note(name, arch, row):  # decode attention's three inputs
        for kind, w in row.get("inputs", {}).items():
            say(f"phase model kernels: {name} {arch} {kind} ({w['shape']['live_slots']} live "
                f"slots, {w['shape']['cold_buffers']} cold buffers): device {w['ms'] * 1e3:.2f} "
                f"us per call (host {w['host_us']:.1f} us), ops wrapper {w['ops_ms'] * 1e3:.2f} "
                f"us (host {w['ops_host_us']:.1f} us), plain {w['plain_ms'] * 1e3:.2f} us, SDPA "
                f"{w['library_ms'] * 1e3:.2f} us (host {w['library_host_us']:.1f} us), bound "
                f"{w['bound_ms'] * 1e3:.3f} us ({w['bound_ms'] / w['ms']:.1%}); max abs err "
                f"{w['max_abs_err']:.3g} (float32 {w['f32_max_abs_err']:.3g})"
                + (f"; wrong masks rejected at {w['wrong_max_abs_err']:.3g}"
                   if "wrong_max_abs_err" in w else ""))

    for k in model_kernels:
        lib = "n/a" if k["library_ms"] is None else (
            f"{k['library_ms']:.4f} ms, host {k['library_host_us']:.1f} us")
        say(f"phase model kernels: {k['name']} max abs err {k['max_abs_err']:.3g}; "
            f"{k['ms']:.4f} ms device (host {k['host_us']:.1f} us) (plain {k['plain_ms']:.4f} ms, "
            f"bound {k['bound_ms']:.4f} ms by {k['bound_by']}, library {lib}){routes_note(k)}")
        decode_note(k["name"], ARCH, k)
        if HYBRID in k:
            decode_note(k["name"], HYBRID, k[HYBRID])
        for sub, label in (("window_1024", f"window {WINDOW}"), (HYBRID, HYBRID)):
            if sub in k:
                w = k[sub]
                say(f"phase model kernels: {k['name']} {label} max abs err "
                    f"{w['max_abs_err']:.3g}; {w['ms']:.4f} ms (plain {w['plain_ms']:.4f} ms, "
                    f"bound {w['bound_ms']:.4f} ms, library {w['library_ms']:.4f} ms)"
                    f"{routes_note(w)}")
        if "wrong_max_abs_err" in k:
            say(f"phase model kernels: {k['name']} wrong answers rejected, max abs err "
                f"{k['wrong_max_abs_err']}")
    say(f"phase model kernels: routes {report['model_kernels_routes']}")

    return model_kernels, counters, cfg, hcfg


# the planner API: one instance pair of each family at the largest point of
# the paper's default grid (n = 40, p = 100; repro/sim/experiments.py:62-63),
# swept over 20 bounds per direction; and two pairs at (n = 10, p = 10), where
# the exact solvers join the portfolio (p <= 12)
PLAN_N, PLAN_P, PLAN_K = 40, 100, 20
EXACT_N, EXACT_P = 10, 10
PLAN_SEED = 1234


def planner_instances(gen_instance_batch, families, n: int, p: int) -> list:
    return [gen_instance_batch(e, n, p, [PLAN_SEED]).instance(0) for e in families]


def _mapping_row(m):
    return None if m is None else [[list(iv) for iv in m.intervals], list(m.alloc)]


def _candidate_row(c) -> list:
    """Everything a planner Candidate carries but its wall time."""
    return [c.solver, c.objective.minimize, c.objective.bound, _mapping_row(c.mapping),
            c.period, c.latency, c.feasible, c.groups, c.error, c.reliability]


def _stage_row(sp):
    """A StagePlan: mapping, period, latency, planner and processor groups."""
    return None if sp is None else [_mapping_row(sp.mapping), sp.period, sp.latency,
                                    sp.planner, sp.groups]


def _report_row(rep) -> dict:
    return {"candidates": [_candidate_row(c) for c in rep.candidates],
            "chosen": None if rep.chosen is None else _candidate_row(rep.chosen),
            "pareto": [list(pt) for pt in rep.pareto],
            "plan": _stage_row(rep.plan)}


def _plan_row(core, wl, pf, objective, device):
    try:
        sp = core.plan(wl, pf, objective, mode="auto", device=device)
    except core.InfeasiblePlan as ex:
        return ["InfeasiblePlan", str(ex)]
    return [_mapping_row(sp.mapping), sp.period, sp.latency, sp.planner]


def run_planner(core, big, small, device, k: int = PLAN_K, launches=lambda: (0, 0)) -> dict:
    """The planner phase's calls on ``device``.  Per instance of ``big``:
    ``plan_pareto`` (its wall time and the 2-way and 3-way split-score
    launches it made, as ``launches()`` counts them), ``plan`` for the
    period and for the latency under half the fastest single-processor
    period.  Per instance of ``small``: ``plan_request`` of
    ``auto_request`` in both directions and of the whole default portfolio
    (the exact solvers included) with both objectives.  Returns the rows (JSON-ready, everything but wall times)
    and the per-``plan_pareto`` times and launches."""
    rows = {"plan_pareto": [], "plan_period": [], "plan_latency": [], "plan_request": []}
    pareto_s, pareto_launches = [], []
    for wl, pf in big:
        before = launches()
        t0 = time.perf_counter()
        rep = core.plan_pareto(wl, pf, k=k, device=device)
        pareto_s.append(time.perf_counter() - t0)
        pareto_launches.append([a - b for a, b in zip(launches(), before)])
        rows["plan_pareto"].append(_report_row(rep))
        hi = core.period(wl, pf, core.single_processor_mapping(wl, pf.fastest()))
        rows["plan_period"].append(_plan_row(core, wl, pf, core.Objective("period"), device))
        rows["plan_latency"].append(_plan_row(
            core, wl, pf, core.Objective("latency", bound=0.5 * hi), device))
    for wl, pf in small:
        hi = core.period(wl, pf, core.single_processor_mapping(wl, pf.fastest()))
        for req in (core.auto_request(wl, pf, core.Objective("period")),
                    core.auto_request(wl, pf, core.Objective("latency")),
                    core.PlanRequest(wl, pf, (core.Objective("period"),
                                              core.Objective("latency", bound=0.5 * hi)))):
            rows["plan_request"].append(_report_row(core.plan_request(req, device=device)))
    return {"rows": rows, "pareto_s": pareto_s, "pareto_launches": pareto_launches}


def compare_planner(got: dict, want: dict, what: str) -> int:
    """Fail on the first row of ``got`` that is not ``==`` its row in ``want``
    (solver, objective, (period, latency), feasibility, mapping and error of
    every candidate; the chosen plan and the front).  Returns the number of
    candidates compared."""
    n = 0
    for kind, rows in want.items():
        if len(got[kind]) != len(rows):
            fail(f"{what}: {kind}: {len(got[kind])} rows against {len(rows)}")
        for i, (g, w) in enumerate(zip(got[kind], rows)):
            if isinstance(w, dict):
                if len(g["candidates"]) != len(w["candidates"]):
                    fail(f"{what}: {kind}[{i}]: {len(g['candidates'])} candidates against "
                         f"{len(w['candidates'])}")
                for j, (gc, wc) in enumerate(zip(g["candidates"], w["candidates"])):
                    if gc != wc:
                        fail(f"{what}: {kind}[{i}] candidate {j} differs: {gc} against {wc}")
                for key in w:
                    if g[key] != w[key]:
                        fail(f"{what}: {kind}[{i}] {key} differs: {g[key]} against {w[key]}")
                n += len(w["candidates"])
            elif g != w:
                fail(f"{what}: {kind}[{i}] differs: {g} against {w}")
    return n


# the reliability phase: the R families (failure probabilities drawn last,
# so their workloads and speeds are E2's, E2's, E2's and E3's) at the planner
# phase's size; the elastic resize keeps three quarters of the pods
REL_FAMILIES = ("R1", "R2", "R3", "R4")


def run_reliability(core, replan, instances, device, k: int = PLAN_K,
                    launches=lambda: (0, 0)) -> dict:
    """The reliability phase's calls on ``device``, per instance:
    ``plan_pareto_tri`` without a floor and with the median reliability of
    its feasible candidates as floor; ``plan_with_deal`` for the period,
    unbounded and under a latency bound halfway between its base plan's
    latency and its own; ``plan_pareto``, then ``replicate_stage_plan`` of its
    plan with a target of a tenth of the plan's unreliability; ``replan_stages``
    with a monitor that saw the plan's slowest stage run twice as slow as
    predicted; ``elastic_replan`` to three quarters of the pods.  Returns the
    rows (JSON-ready, everything but wall times), and per instance the wall
    times and the 2-way and 3-way split-score launches (as ``launches()``
    counts them) of each ``plan_pareto_tri``, ``plan_with_deal`` and
    ``plan_pareto``."""
    kinds = ("pareto_tri", "pareto_tri_floor", "deal", "deal_bound", "pareto", "replicated",
             "replan", "elastic")
    rows = {kind: [] for kind in kinds}
    timed = {kind: {"s": [], "launches": []} for kind in kinds[:5]}

    def run(kind, fn):
        before = launches()
        t0 = time.perf_counter()
        out = fn()
        timed[kind]["s"].append(time.perf_counter() - t0)
        timed[kind]["launches"].append([a - b for a, b in zip(launches(), before)])
        return out

    for wl, pf in instances:
        tri = run("pareto_tri", lambda: core.plan_pareto_tri(wl, pf, k=k, device=device))
        rows["pareto_tri"].append(_report_row(tri))
        rels = sorted(c.reliability for c in tri.candidates if c.feasible)
        floor = rels[len(rels) // 2]
        rows["pareto_tri_floor"].append(_report_row(run("pareto_tri_floor", lambda: (
            core.plan_pareto_tri(wl, pf, k=k, reliability_floor=floor, device=device)))))
        dp = run("deal", lambda: core.plan_with_deal(wl, pf, core.Objective("period"),
                                                     device=device))
        rows["deal"].append([_stage_row(dp.base), dp.groups, dp.period, dp.latency])
        bound = 0.5 * (dp.base.latency + dp.latency)
        dp = run("deal_bound", lambda: core.plan_with_deal(
            wl, pf, core.Objective("period", bound=bound), device=device))
        rows["deal_bound"].append([bound, _stage_row(dp.base), dp.groups, dp.period,
                                   dp.latency])
        bi = run("pareto", lambda: core.plan_pareto(wl, pf, k=k, device=device))
        rows["pareto"].append(_report_row(bi))
        target = 1.0 - 0.1 * (1.0 - core.reliability(wl, pf, bi.plan.mapping))
        rows["replicated"].append([target, _stage_row(core.replicate_stage_plan(
            wl, pf, bi.plan, target=target))])
        predicted = core.interval_cycle_times(wl, pf, bi.plan.mapping)
        observed = predicted.copy()
        observed[int(predicted.argmax())] *= 2.0
        monitor = replan.StragglerMonitor(num_stages=bi.plan.num_stages)
        monitor.observe(observed)
        new, degraded = replan.replan_stages(wl, pf, bi.plan, monitor, device=device)
        rows["replan"].append([_stage_row(new), degraded.s.tolist(), degraded.name,
                               degraded.failures.tolist()])
        rows["elastic"].append(_stage_row(replan.elastic_replan(wl, pf, 3 * pf.p // 4,
                                                                device=device)))
    return {"rows": rows, "timed": timed}


@contextlib.contextmanager
def counted_scoring(heuristics):
    """Within the block, count each split-scoring call of the planner, on
    any device: yields ``counts``, [2-way, 3-way] calls.  On the card each
    call is one kernel launch."""
    real = heuristics.score_kernels
    counts = [0, 0]

    def kernels(impl="cuda"):
        score2, score3 = real(impl)

        def counted2(*args, **kw):
            counts[0] += 1
            return score2(*args, **kw)

        def counted3(*args, **kw):
            counts[1] += 1
            return score3(*args, **kw)
        return counted2, counted3

    heuristics.score_kernels = kernels
    try:
        yield counts
    finally:
        heuristics.score_kernels = real


def check_min_period(core, batched, big, device) -> None:
    """``min_period_exhaustive`` (the scalar form) against the lockstep
    engine's ``batched_min_period`` on each instance, both on ``device``."""
    for i, (wl, pf) in enumerate(big):
        got = core.min_period_exhaustive(wl, pf, device=device)
        pb = batched.ProblemBatch.from_arrays(wl.w[None], wl.delta[None], pf.s[None],
                                              pf.b, device=device)
        want = batched.batched_min_period(pb)[0]
        row = [(r.mapping.intervals, r.mapping.alloc, r.period, r.latency, r.feasible,
                r.splits, r.name) for r in (got, want)]
        if row[0] != row[1]:
            fail(f"min_period_exhaustive differs from batched_min_period on instance {i}: "
                 f"{row[0]} against {row[1]}")


def check_scalar_golden(experiments, device) -> None:
    """The scalar engine writes the golden E1 curves byte for byte."""
    res = experiments.run_experiment("E1", 5, 10, n_pairs=3, n_bounds=4, engine="scalar",
                                     device=device)
    if experiments.summarize_experiment(res) != (GOLDEN / "curves_E1_n5_p10.csv").read_text():
        fail("scalar engine: curves_E1_n5_p10.csv differs from the golden file")


def check_golden(res: dict, out_dir: pathlib.Path, what: str) -> None:
    """``paper_sim.run``'s claims pass and ``out_dir`` holds the golden CSVs
    byte for byte."""
    if not all(c.startswith("[PASS]") for c in res["claims"]):
        fail(f"{what}: golden claims: {res['claims']}")
    names = sorted(f.name for f in GOLDEN.iterdir())
    if sorted(f.name for f in out_dir.iterdir()) != names:
        fail(f"{what}: golden file set differs")
    for name in names:
        if (out_dir / name).read_bytes() != (GOLDEN / name).read_bytes():
            fail(f"{what}: golden {name} differs")


def compare_campaigns(got: dict, want: dict, what: str) -> None:
    """Two ``run_campaign`` results: every curve point (``==``, NaN where
    NaN) and every threshold equal."""
    import numpy as np

    if sorted(got) != sorted(want):
        fail(f"{what}: families {sorted(got)} against {sorted(want)}")
    for exp in want:
        g, w = got[exp], want[exp]
        if sorted(g.curves) != sorted(w.curves) or g.thresholds != w.thresholds:
            fail(f"{what}: {exp} thresholds or heuristics differ")
        for code in w.curves:
            for a, b in zip(g.curves[code], w.curves[code]):
                if not np.array_equal(a, b, equal_nan=True):
                    fail(f"{what}: {exp} {code} curve differs")


def zero_engine_counters(split_score, engines) -> None:
    for f in (split_score.score_2way_cuda, split_score.score_3way_cuda):
        f.launches = 0
    for m in engines:
        m.reset_trace_count()
        m.reset_dispatch_count()
        m.reset_sync_count()
    engines[0].reset_bucket_trace_count()


def engine_counts(split_score, engines) -> dict:
    """What the fused (and sharded) engine did since the counters were
    zeroed: bucket captures, step replays, host polls and split-score
    launches (each replay adds its graph's kernels)."""
    return {"captures": engines[0].bucket_trace_count(),
            "replays": sum(m.dispatch_count() for m in engines),
            "polls": sum(m.sync_count() for m in engines),
            "launches": {"score_2way_f64": split_score.score_2way_cuda.launches,
                         "score_3way_f64": split_score.score_3way_cuda.launches}}


def fused_campaign(torch, run_campaign, split_score, engines, engine: str, device,
                   n: int = N_STAGES, p: int = N_PROCS, n_pairs: int = N_PAIRS,
                   n_bounds: int = N_BOUNDS, h4_iters: int = H4_ITERS) -> dict:
    """Phase 5's campaign through ``engine`` on ``device``, the counters
    zeroed just before and read just after; wall time by the host clock
    around work that ends in a synchronize on a card."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    zero_engine_counters(split_score, engines)
    t0 = time.time()
    res = run_campaign(FAMILIES, n, p, n_pairs=n_pairs, n_bounds=n_bounds,
                       h4_iters=h4_iters, include_h4=True, engine=engine, device=device)
    sync()
    return {"result": res, "wall_s": time.time() - t0} | engine_counts(split_score, engines)


def h4_bounds(arrays, b: float, fracs=(0.3, 0.6)):
    """Period bounds for the H4 bisection of stacked instances: ``fracs`` of
    each one's single-processor period on its fastest processor (host
    numpy; both engines get the same floats)."""
    import numpy as np

    w, delta, s = arrays[:3]
    single = delta[:, 0] / b + w.sum(axis=1) / s.max(axis=1) + delta[:, -1] / b
    return single * np.resize(np.asarray(fracs), single.shape)


def engine_rows(batched, arrays, b, device, backend: str) -> tuple:
    """H1-H4 trajectories, ``batched_min_period`` and the H4 bisection of
    the stacked instances ``arrays`` (w, delta, s, prefix, order) on
    ``device`` through ``backend``, as comparable rows."""
    pb = batched.ProblemBatch.from_arrays(*arrays[:3], b, prefix=arrays[3], order=arrays[4],
                                          device=device)
    trajs = batched.batched_trajectory_sets(["H1", "H2", "H3", "H4"], pb, backend=backend)
    rows = [[(r.mapping.intervals, r.mapping.alloc, r.period, r.latency, r.feasible,
              r.splits, r.name) for r in res]
            for res in (batched.batched_min_period(pb, backend=backend),
                        batched.batched_sp_bi_p(pb, h4_bounds(arrays, b), iters=H4_ITERS,
                                                backend=backend))]
    return trajs, rows[0], rows[1]


def fused_phase(torch, batched, paper_sim, run_campaign, split_score, camp, wall,
                arrays, b, card) -> dict:
    """Phase 15 on the card: ``paper_sim`` through the fused engine against
    the golden CSVs; phase 5's campaign (``camp``, ``wall`` s) through the
    fused engine cold and then warm, each equal to it, captures within the
    budget; phase 6's instances (``arrays``) through the fused engine on the
    card, on the cpu, and through the lockstep engine on the cpu, equal; the
    sharded engine over every card and over cuda:0 twice equal to fused."""
    from repro_torch.core import fused, sharded

    engines = (fused, sharded)
    t15 = time.time()
    gold15 = REPO / "build" / "chip_smoke" / "paper_sim_fused"
    res = paper_sim.run(gold15, families="all", ns=(5,), ps=(10,), n_pairs=3, n_bounds=4,
                        engine="fused", device="cuda")
    check_golden(res, gold15, "fused golden")
    fused.release_programs()
    runs = {}
    for label in ("cold", "warm"):
        run = fused_campaign(torch, run_campaign, split_score, engines, "fused", "cuda")
        compare_campaigns(run.pop("result"), camp, f"fused {label} campaign vs batched")
        for name, count in run["launches"].items():
            if count <= 0:
                fail(f"fused {label} campaign launched {name} no time")
        runs[label] = run
    caps = fused.captures(N_STAGES)
    budget = fused.trace_budget(N_STAGES)
    if not caps or max(caps.values()) > budget:
        fail(f"fused: captures per chunk size {caps} over the budget {budget}")
    t8 = time.time()
    fused8 = engine_rows(batched, arrays, b, "cuda", "fused")
    card8_s = time.time() - t8
    for dev, backend in (("cpu", "fused"), ("cpu", "lockstep")):
        rows = engine_rows(batched, arrays, b, dev, backend)
        if rows != fused8:
            fail(f"fused on the card differs from {backend} on the cpu (trajectories, "
                 f"min period, H4: {[x == y for x, y in zip(fused8, rows)]})")
    shard_lists = {"every card": [f"cuda:{i}" for i in range(torch.cuda.device_count())],
                   "cuda:0 twice": ["cuda:0", "cuda:0"]}
    for label, devs in shard_lists.items():
        with sharded.use_devices(devs):
            rows = engine_rows(batched, arrays, b, "cuda", "sharded")
        if rows != fused8:
            fail(f"sharded over {label} differs from fused "
                 f"({[x == y for x, y in zip(rows, fused8)]})")
    out = {"card": card, "campaign": runs, "batched_cold_wall_s": wall,
           "captures_per_chunk": {str(k): v for k, v in caps.items()}, "trace_budget": budget,
           "chunk_rows": {f"k{k}": fused.device_chunk_rows(N_STAGES, k, 2 * N_PAIRS * len(FAMILIES))
                          for k in (1, 2)},
           "poll_every": fused.POLL_EVERY, "sharded_devices": shard_lists,
           "instances8_card_s": card8_s, "phase_s": time.time() - t15}
    for label, run in runs.items():
        say(f"phase fused: campaign {len(FAMILIES)}x{N_PAIRS} pairs n={N_STAGES} p={N_PROCS} "
            f"{label} in {run['wall_s']:.2f} s (batched, phase 5: {wall:.2f} s), equal to "
            f"batched; {run['captures']} captures, "
            f"{run['replays']} replays, {run['polls']} polls; launches {run['launches']}")
    say(f"phase fused: golden CSVs byte-identical; captures per chunk size {caps} "
        f"<= {budget}; 8 instances at n={N_STAGES} card (fused) == cpu (fused, lockstep); "
        f"sharded over {list(shard_lists)} == fused; {out['phase_s']:.1f} s; {card}")
    return out


# the fleet replanning service (repro_torch.fleet).  The standard trace of
# the reference's fleet benchmark (benchmarks/fleet_bench.py:69-70): 16
# groups of 16 replicas of one (workload, platform) template each, n = 12,
# p = 6, 30 ticks of correlated bursts; its chaos overlay (storms, flaps,
# delivery faults, bimodal failure probabilities, a 0.98 reliability floor);
# the crash/restart run (crashes at 1/3 and 2/3 of the trace, a snapshot
# every 8 ticks) and the subprocess workers under seeded mid-solve kills
# (fleet_bench.py:79-90).  The full-size fleet: 256 groups x 16 replicas =
# 4096 instances at the paper's largest default point (n = 40, p = 100).
FLEET_STANDARD = dict(n_groups=16, replicas=16, n=12, p=6, fleet_seed=2007, num_ticks=30,
                      trace_seed=42, burst_prob=0.6)
FLEET_CHAOS = dict(chaos_seed=77, fail_seed=5, reliability_floor=0.98)
FLEET_RECOVERY = dict(snapshot_every=8, crash_fracs=(1 / 3, 2 / 3))
FLEET_REMOTE = dict(workers=2, kill_prob=0.5, kill_seed=1, max_kills=6, solve_timeout=60.0)
FLEET_FULL = dict(FLEET_STANDARD, n_groups=256, n=40, p=100)
# the reference's fleet_digest() of the standard trace and of its chaos
# overlay (numpy engine, inline supervisor); tests/test_torch_fleet.py
# re-derives both from a live reference run
FLEET_DIGESTS = {"standard": "54debaa00af3dbb279526096c022ec38",
                 "chaos": "207f2bf7dc4d7a2b5cee51efa1f2cc77"}


def fleet_fixture(fleet, core, cfg: dict, chaos: bool = False) -> tuple:
    """(pairs, trace) of ``cfg`` from its seeds; with ``chaos`` each group's
    platform carries bimodal failure probabilities (one draw per template,
    so replicas keep sharing it) and the trace the seeded chaos overlay."""
    pairs, groups = fleet.make_fleet(cfg["n_groups"], cfg["replicas"], cfg["n"], cfg["p"],
                                     seed=cfg["fleet_seed"])
    trace = fleet.gen_burst_trace(groups, cfg["num_ticks"], seed=cfg["trace_seed"],
                                  n_stages=cfg["n"], initial_pods=cfg["p"],
                                  burst_prob=cfg["burst_prob"])
    if not chaos:
        return pairs, trace
    shared, failing = {}, []
    for wl, pf in pairs:
        if id(pf) not in shared:
            shared[id(pf)] = pf.with_failures(core.sample_failures(
                pf.p, kind="bimodal", seed=FLEET_CHAOS["fail_seed"] + len(shared)))
        failing.append((wl, shared[id(pf)]))
    return failing, fleet.inject_chaos(trace, groups, fleet.ChaosSpec(),
                                       seed=FLEET_CHAOS["chaos_seed"], initial_pods=cfg["p"])


def fleet_run(torch, fleet, split_score, engines, pairs, trace, device, backend: str,
              **service_kw) -> dict:
    """One trace through a ``ReplanService`` on ``device`` with the inline
    supervisor, the engine counters zeroed just before and read just after:
    its digest, its metrics, wall time (construction, the fleet's initial
    planning, included) and what the engines did."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    zero_engine_counters(split_score, engines)
    t0 = time.time()
    svc = fleet.ReplanService(pairs, backend=backend, device=device, **service_kw)
    m = svc.run_trace(trace)
    sync()
    return {"digest": svc.fleet_digest(), "wall_s": time.time() - t0,
            "summary": m.summary(), "robustness": m.robustness_summary()} \
        | engine_counts(split_score, engines)


def fleet_recovery(fleet, pairs, trace, device, journal_dir: pathlib.Path,
                   **service_kw) -> dict:
    """The journaled service killed mid-tick at 1/3 and 2/3 of the trace and
    restored from its journal each time."""
    import shutil

    shutil.rmtree(journal_dir, ignore_errors=True)
    crash = sorted({max(1, int(trace.num_ticks * f)) for f in FLEET_RECOVERY["crash_fracs"]})
    journal = fleet.Journal(journal_dir, snapshot_every=FLEET_RECOVERY["snapshot_every"],
                            fsync=False)
    t0 = time.time()
    svc, restarts = fleet.crash_restart_run(pairs, trace, journal, crash_ticks=crash,
                                            device=device, **service_kw)
    return {"digest": svc.fleet_digest(), "wall_s": time.time() - t0, "crash_ticks": crash,
            "restarts": len(restarts),
            "max_replayed_ticks": max(r["replayed_ticks"] for r in restarts),
            "invalid_published": svc.metrics.invalid_published,
            "quarantined_problems": svc.metrics.quarantined_problems}


def fleet_remote(fleet, pairs, trace, device, remote: dict = FLEET_REMOTE,
                 **service_kw) -> dict:
    """The trace served by process-isolated workers on ``device`` under
    seeded SIGKILLs mid-solve: digest, restarts against injected faults."""
    chaos = fleet.TransportChaos(kill_prob=remote["kill_prob"], max_faults=remote["max_kills"],
                                 seed=remote["kill_seed"])
    sup = fleet.subprocess_supervisor(device=device, workers=remote["workers"],
                                      timeout=remote["solve_timeout"], chaos=chaos,
                                      max_attempts=3, backoff_base=0.0)
    t0 = time.time()
    try:
        svc = fleet.ReplanService(pairs, device=device, supervisor=sup, **service_kw)
        m = svc.run_trace(trace)
    finally:
        sup.close()
    return {"digest": svc.fleet_digest(), "wall_s": time.time() - t0,
            "injected": dict(chaos.counts), "faults": chaos.total_faults(),
            "restarts": sup.stats.restarts, "dispatches": sup.stats.dispatches,
            "timeouts": sup.stats.timeouts, "metric_restarts": m.worker_restarts,
            "invalid_published": m.invalid_published, "fallback_solves": m.fallback_solves}


def _fleet_line(label: str, run: dict, card: str) -> str:
    s = run["summary"]
    return (f"phase fleet: {label} in {run['wall_s']:.3f} s, {s['replans_per_sec']:.1f} "
            f"replans/s, p50 {s['p50_latency_us']:.0f} us, p99 {s['p99_latency_us']:.0f} us, "
            f"dedup {s['dedup_hit_rate']:.4f} ({s['requests']} requests, {s['solves']} "
            f"solves), {run['captures']} captures, {run['replays']} replays, launches "
            f"{run['launches']}; digest {run['digest']}; {card}")


def fleet_phase(torch, split_score, card, device: str = "cuda",
                standard: dict = FLEET_STANDARD, full: dict = FLEET_FULL,
                remote: dict = FLEET_REMOTE, digests: dict = FLEET_DIGESTS,
                journal_dir: pathlib.Path = REPO / "build" / "chip_smoke" / "fleet_journal"
                ) -> dict:
    """Phase 16: the fleet replanning service on ``device``.  The standard
    trace and its chaos overlay through the lockstep and the fused engine,
    each digest the reference's; the crash/restart run and the subprocess
    workers under kills on the chaos trace, the same digest, restarts equal
    to the injected faults; the full-size fleet through lockstep and fused
    (cold, then warm) on ``device`` and through lockstep on the cpu, every
    digest equal.  Both split-score kernels must launch in every run on the
    card."""
    from repro_torch import core, fleet
    from repro_torch.core import fused, sharded

    engines = (fused, sharded)
    on_card = torch.device(device).type == "cuda"
    t16 = time.time()
    runs = {}

    def check(label, run, want):
        if run["digest"] != want:
            fail(f"fleet {label}: digest {run['digest']} against {want}")
        for name, count in run["launches"].items():
            if on_card and count <= 0:
                fail(f"fleet {label} launched {name} no time")
        runs[label] = run

    std, std_trace = fleet_fixture(fleet, core, standard)
    chs, chs_trace = fleet_fixture(fleet, core, standard, chaos=True)
    floor = {"reliability_floor": FLEET_CHAOS["reliability_floor"]}
    for backend in ("lockstep", "fused"):
        check(f"standard {backend}",
              fleet_run(torch, fleet, split_score, engines, std, std_trace, device, backend),
              digests["standard"])
        run = fleet_run(torch, fleet, split_score, engines, chs, chs_trace, device, backend,
                        **floor)
        check(f"chaos {backend}", run, digests["chaos"])
        if run["robustness"]["invalid_published"]:
            fail(f"fleet chaos {backend}: {run['robustness']['invalid_published']} invalid "
                 "published plans")
    rec = fleet_recovery(fleet, chs, chs_trace, device, journal_dir, **floor)
    if rec["digest"] != digests["chaos"] or rec["invalid_published"] \
            or rec["restarts"] != len(rec["crash_ticks"]):
        fail(f"fleet crash/restart: {rec}")
    rem = fleet_remote(fleet, chs, chs_trace, device, remote, **floor)
    if rem["digest"] != digests["chaos"] or rem["invalid_published"] or rem["faults"] < 1 \
            or rem["restarts"] != rem["faults"] or rem["fallback_solves"]:
        fail(f"fleet subprocess workers: {rem}")
    big, big_trace = fleet_fixture(fleet, core, full)
    for label, dev, backend in (("lockstep cold", device, "lockstep"),
                                ("lockstep warm", device, "lockstep"),
                                ("fused cold", device, "fused"),
                                ("fused warm", device, "fused"),
                                ("lockstep cpu", "cpu", "lockstep")):
        run = fleet_run(torch, fleet, split_score, engines, big, big_trace, dev, backend)
        if dev == "cpu":
            run["launches"] = {}    # the cpu runs the plain versions
        check(f"full {label}", run, runs.get("full lockstep cold", run)["digest"])
    out = {"card": card, "device": device, "runs": runs, "recovery": rec, "remote": rem,
           "full": {"instances": len(big), "n": full["n"], "p": full["p"],
                    "ticks": full["num_ticks"]},
           "phase_s": time.time() - t16}
    for label, run in runs.items():
        say(_fleet_line(label, run, card))
    say(f"phase fleet: crash/restart at ticks {rec['crash_ticks']} (max "
        f"{rec['max_replayed_ticks']} WAL ticks replayed) in {rec['wall_s']:.2f} s; "
        f"{remote['workers']} subprocess workers on {device}: {rem['restarts']} restarts for "
        f"{rem['faults']} injected kills, {rem['dispatches']} dispatches, in "
        f"{rem['wall_s']:.2f} s; every digest the reference's (standard {digests['standard']}, "
        f"chaos {digests['chaos']}); full size {len(big)} instances n={full['n']} "
        f"p={full['p']}: {device} == cpu; {out['phase_s']:.1f} s; {card}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=pathlib.Path, default=None,
                    help="also write every measured number to this file")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    if not (SRC / "repro_torch" / "__init__.py").exists():
        fail(f"the port's sources are not beside this script ({SRC / 'repro_torch'})")
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import core, pipeline
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import batched, heuristics
    from repro_torch.core.heuristics import score_2way, score_3way
    from repro_torch.kernels import build, split_score
    from repro_torch.sim import experiments, gen_instance_batch, paper_sim, run_campaign

    report = {}
    t_all = time.time()

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    say(card)
    report["card"] = card
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda

    # 2. build
    t0 = time.time()
    logs = build.build_all()
    report["build_s"] = time.time() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"build {name}: {line.strip()}")
    # the tensor cores in the build: flash attention's bf16 kernel and the
    # SSD's heads kernel (every instantiation), and the SSD's scores kernel
    report["flash_sass"] = hmma_counts(build, "flash_attention", "flash_tc_kernel")
    report["ssd_sass"] = hmma_counts(build, "mamba2_ssd", "ssd_heads_kernel")
    ssd_scores = hmma_counts(build, "mamba2_ssd", "ssd_scores_kernel")["hmma_per_kernel"]
    say(f"phase build: ok in {report['build_s']:.1f} s; HMMA per bf16 flash kernel "
        f"{sorted(report['flash_sass']['hmma_per_kernel'].values())}; HMMA per SSD heads "
        f"kernel {sorted(report['ssd_sass']['hmma_per_kernel'].values())}, SSD scores kernel "
        f"{sorted(ssd_scores.values())}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20070611)

    # 3. kernels against their plain versions
    kernels = [check_kernel_2way(torch, split_score, score_2way, gen),
               check_kernel_3way(torch, split_score, score_3way, gen)]
    torch.cuda.empty_cache()
    for k in kernels:
        say(f"phase kernels: {k['name']} equal to plain on live lanes; {k['ms']:.4f} ms device "
            f"(host {k['host_us']:.1f} us) (plain {k['plain_ms']:.4f} ms, bound "
            f"{k['bound_ms']:.4f} ms)")

    # 4. golden CSVs on cuda
    t0 = time.time()
    gold_dir = REPO / "build" / "chip_smoke" / "paper_sim"
    res = paper_sim.run(gold_dir, families="all", ns=(5,), ps=(10,), n_pairs=3,
                        n_bounds=4, device="cuda")
    check_golden(res, gold_dir, "golden")
    names = sorted(f.name for f in GOLDEN.iterdir())
    report["golden_s"] = time.time() - t0
    say(f"phase golden: {len(names)} files byte-identical in {report['golden_s']:.1f} s")

    # 5. the main path at full width
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    split_score.score_2way_cuda.launches = 0
    split_score.score_3way_cuda.launches = 0
    t0 = time.time()
    camp = run_campaign(FAMILIES, N_STAGES, N_PROCS, n_pairs=N_PAIRS,
                        n_bounds=N_BOUNDS, h4_iters=H4_ITERS, include_h4=True,
                        device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"score_2way_f64": split_score.score_2way_cuda.launches,
                "score_3way_f64": split_score.score_3way_cuda.launches}
    campaign_launches = dict(launches)
    check_campaign(camp, N_BOUNDS)
    for name, count in launches.items():
        if count <= 0:
            fail(f"main path launched {name} no time")
    report["campaign"] = {
        "families": list(FAMILIES), "n": N_STAGES, "p": N_PROCS,
        "n_pairs": N_PAIRS, "n_bounds": N_BOUNDS, "h4_iters": H4_ITERS,
        "wall_s": wall, "launches": campaign_launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "thresholds": {e: r.thresholds for e, r in camp.items()}}
    say(f"phase main path: campaign {len(FAMILIES)}x{N_PAIRS} pairs n={N_STAGES} "
        f"p={N_PROCS} in {wall:.2f} s; launches {campaign_launches}")

    # 6. cpu against the card at full width
    t0 = time.time()
    parts = [gen_instance_batch(e, N_STAGES, N_PROCS, [1234, 1235]) for e in FAMILIES]
    arrays = [np.concatenate([getattr(b, f) for b in parts])
              for f in ("w", "delta", "s", "prefix", "order")]
    out = {}
    for dev in ("cpu", "cuda"):
        pb = batched.ProblemBatch.from_arrays(*arrays[:3], parts[0].b, prefix=arrays[3],
                                              order=arrays[4], device=dev)
        trajs = batched.batched_trajectory_sets(["H1", "H2", "H3", "H4"], pb)
        mp = [(r.mapping.intervals, r.mapping.alloc, r.period, r.latency, r.splits, r.name)
              for r in batched.batched_min_period(pb)]
        out[dev] = (trajs, mp)
    if out["cpu"][0] != out["cuda"][0]:
        fail("cpu vs card: H1-H4 trajectories differ")
    if out["cpu"][1] != out["cuda"][1]:
        fail("cpu vs card: batched_min_period differs")
    report["cpu_vs_card_s"] = time.time() - t0
    say(f"phase cpu vs card: 8 instances at n={N_STAGES} p={N_PROCS} equal "
        f"in {report['cpu_vs_card_s']:.1f} s")

    # 7. the model kernels at full-width shapes
    model_kernels, counters, cfg, hcfg = model_kernel_phase(torch, gen, report)
    kernels += model_kernels

    # 8-11. the main paths of the two models, each with the counters zeroed
    # just before and read just after; a kernel's launches sum over the paths
    by_path = {"campaign": campaign_launches}

    # 8. the serving model's forward at full width
    fwd = run_forward(torch, cfg, counters)
    for name in ("rmsnorm", "flash_attention"):
        if fwd["launches"][name] <= 0:
            fail(f"forward launched {name} no time")
    check_flash_routes(f"forward {ARCH}", fwd["launches"], fwd["routes"])
    by_path[f"{ARCH} forward"] = fwd["launches"]
    report["forward"] = fwd
    say(f"phase forward: {ARCH} B=1 S={FWD_S} {cfg.n_layers} layers in "
        f"{fwd['wall_s_first']:.3f} s (again {fwd['wall_s_second']:.3f} s), peak "
        f"{fwd['peak_mem_bytes']} B; launches {fwd['launches']}; routes {fwd['routes']}")
    torch.cuda.empty_cache()

    # 9. serving at full width
    served = run_serve(torch, ARCH, SERVE, counters)
    if served["launches"]["decode_attention"] <= 0:
        fail("serve launched decode_attention no time")
    if served["launches"]["rmsnorm"] != 0:
        fail("serve: decode ran the fused RMSNorm kernel (the reference's decode "
             "keeps the plain formula)")
    by_path[f"{ARCH} serve"] = served["launches"]
    report["serve"] = served
    say(f"phase serve: {served['tokens_generated']} tokens in {served['decode_steps']} "
        f"decode steps, {served['wall_s']:.3f} s, {served['tokens_per_s']:.2f} tokens/s; "
        f"launches {served['launches']}")
    torch.cuda.empty_cache()

    # 10. the hybrid's forward at full width: every layer of every group,
    # padded ones included, runs the SSD kernel; the shared block runs flash
    from repro_torch.models.hybrid import group_shape

    ng, g, _ = group_shape(hcfg)
    hfwd = run_forward(torch, hcfg, counters)
    want = {"ssd_intra_chunk": ng * g, "flash_attention": ng, "rmsnorm": 0,
            "rmsnorm_residual": 0, "decode_attention": 0}
    if hfwd["launches"] != want:
        fail(f"forward {HYBRID}: launches {hfwd['launches']}, expected {want}")
    check_flash_routes(f"forward {HYBRID}", hfwd["launches"], hfwd["routes"])
    by_path[f"{HYBRID} forward"] = hfwd["launches"]
    report["hybrid_forward"] = hfwd
    say(f"phase hybrid forward: {HYBRID} B=1 S={FWD_S} {hcfg.n_layers} layers "
        f"({ng} groups of {g}) in {hfwd['wall_s_first']:.3f} s (again "
        f"{hfwd['wall_s_second']:.3f} s), peak {hfwd['peak_mem_bytes']} B; "
        f"launches {hfwd['launches']}; routes {hfwd['routes']}")
    torch.cuda.empty_cache()

    # 11. the hybrid served at full width
    hserved = run_serve(torch, HYBRID, HYBRID_SERVE, counters)
    want = {"decode_attention": ng * hserved["decode_calls"], "rmsnorm": 0,
            "rmsnorm_residual": 0, "flash_attention": 0, "ssd_intra_chunk": 0}
    if hserved["launches"] != want:
        fail(f"serve {HYBRID}: launches {hserved['launches']}, expected {want}")
    by_path[f"{HYBRID} serve"] = hserved["launches"]
    report["hybrid_serve"] = hserved
    say(f"phase hybrid serve: {hserved['tokens_generated']} tokens in "
        f"{hserved['decode_calls']} decode calls ({hserved['decode_steps']} generating), "
        f"{hserved['wall_s']:.3f} s, {hserved['tokens_per_s']:.2f} tokens/s; "
        f"launches {hserved['launches']}")
    torch.cuda.empty_cache()

    # 12. the models on cpu against the card.  The hybrid's full-width group
    # is compared in float32: in bfloat16, rounding order alone moves its
    # logits at S = 1536 past the reference's bf16 criterion (which the
    # reference applies at S = 12), between card and cpu and on some CPUs
    # between two thread counts (python -m repro_torch.launch.rounding_probe
    # --layers 6; PERF.md has the readings), so a bf16 comparison could not
    # tell a fault from rounding there
    t0 = time.time()
    report["model_cpu_vs_card"] = {}
    for mcfg, tol in (
            (get_smoke_config(ARCH).replace(dtype="float32", use_pallas=True), LOGIT_F32_TOL),
            (cfg.replace(n_layers=2), LOGIT_F32_TOL),
            (get_smoke_config(HYBRID).replace(dtype="float32", use_pallas=True),
             HYBRID_FWD_F32_TOL),
            (hcfg.replace(n_layers=g, dtype="float32"), HYBRID_FULL_FWD_F32_TOL)):
        res = model_cpu_vs_card(torch, mcfg, tol)
        report["model_cpu_vs_card"][f"{mcfg.arch_id}-{mcfg.n_layers}L-{mcfg.dtype}"] = res
        say(f"phase model cpu vs card: {mcfg.arch_id} {mcfg.n_layers} layers {mcfg.dtype}: "
            f"forward {res['forward']}, decode {res['decode']}")
        torch.cuda.empty_cache()
    report["model_cpu_vs_card_s"] = time.time() - t0

    # 13. the planner API on the card, the split-score counters zeroed just
    # before and read just after; then the same calls on the cpu: equal
    big = planner_instances(gen_instance_batch, FAMILIES, PLAN_N, PLAN_P)
    small = planner_instances(gen_instance_batch, FAMILIES[:2], EXACT_N, EXACT_P)
    score_counters = (split_score.score_2way_cuda, split_score.score_3way_cuda)
    torch.cuda.synchronize()
    zero_counters(score_counters)
    t0 = time.time()
    on_card = run_planner(core, big, small, "cuda",
                          launches=lambda: [f.launches for f in score_counters])
    check_min_period(core, batched, big, "cuda")
    check_scalar_golden(experiments, "cuda")
    torch.cuda.synchronize()
    planner_launches = {"score_2way_f64": split_score.score_2way_cuda.launches,
                        "score_3way_f64": split_score.score_3way_cuda.launches}
    card_s = time.time() - t0
    for name, count in planner_launches.items():
        if count <= 0:
            fail(f"planner launched {name} no time")
    on_cpu = run_planner(core, big, small, "cpu")
    n_cands = compare_planner(on_card["rows"], on_cpu["rows"], "planner card vs cpu")
    by_path["planner"] = planner_launches
    report["planner"] = {
        "card": card, "instances": {"pareto": [PLAN_N, PLAN_P, len(big), PLAN_K],
                                    "exact": [EXACT_N, EXACT_P, len(small)]},
        "candidates_compared": n_cands, "card_s": card_s,
        "pareto_s_card": on_card["pareto_s"], "pareto_s_cpu": on_cpu["pareto_s"],
        "pareto_launches": on_card["pareto_launches"], "launches": planner_launches}
    say(f"phase planner: {n_cands} candidates equal card vs cpu (plan_pareto k={PLAN_K} at "
        f"n={PLAN_N} p={PLAN_P} on {', '.join(FAMILIES)}; plan; plan_request at n={EXACT_N} "
        f"p={EXACT_P}); min_period_exhaustive == batched_min_period; scalar engine golden "
        f"E1 csv byte-identical; launches {planner_launches} in {card_s:.1f} s")
    say(f"phase planner: plan_pareto wall s card {[round(t, 3) for t in on_card['pareto_s']]}, "
        f"cpu {[round(t, 3) for t in on_cpu['pareto_s']]}; split-score launches (2-way, "
        f"3-way) per plan_pareto {on_card['pareto_launches']}; {card}")

    # 14. reliability: the tri-criteria planner, the deal extension and the
    # replanning on the card, the split-score counters zeroed just before and
    # read just after; then the same calls on the cpu, each split-scoring call
    # counted: every row equal, and each call's launches on the card equal to
    # its scoring calls on the cpu
    rel = planner_instances(gen_instance_batch, REL_FAMILIES, PLAN_N, PLAN_P)
    torch.cuda.synchronize()
    zero_counters(score_counters)
    t0 = time.time()
    rel_card = run_reliability(core, pipeline, rel, "cuda",
                               launches=lambda: [f.launches for f in score_counters])
    torch.cuda.synchronize()
    rel_launches = {"score_2way_f64": split_score.score_2way_cuda.launches,
                    "score_3way_f64": split_score.score_3way_cuda.launches}
    rel_card_s = time.time() - t0
    for name, count in rel_launches.items():
        if count <= 0:
            fail(f"reliability launched {name} no time")
    with counted_scoring(heuristics) as counts:
        rel_cpu = run_reliability(core, pipeline, rel, "cpu", launches=lambda: list(counts))
    n_rel = compare_planner(rel_card["rows"], rel_cpu["rows"], "reliability card vs cpu")
    for kind, timed in rel_card["timed"].items():
        if timed["launches"] != rel_cpu["timed"][kind]["launches"]:
            fail(f"reliability: {kind} launched {timed['launches']} on the card against "
                 f"{rel_cpu['timed'][kind]['launches']} scoring calls on the cpu")
    by_path["reliability"] = rel_launches
    report["reliability"] = {
        "card": card, "instances": [PLAN_N, PLAN_P, list(REL_FAMILIES), PLAN_K],
        "candidates_compared": n_rel, "card_s": rel_card_s, "launches": rel_launches,
        "timed_card": rel_card["timed"], "timed_cpu": rel_cpu["timed"]}
    say(f"phase reliability: {n_rel} candidates equal card vs cpu (plan_pareto_tri k={PLAN_K} "
        f"with and without a floor, plan_pareto, plan_with_deal, replicate_stage_plan, "
        f"replan_stages, elastic_replan at n={PLAN_N} p={PLAN_P} on {', '.join(REL_FAMILIES)});"
        f" launches {rel_launches} in {rel_card_s:.1f} s, each call's equal to its cpu "
        f"scoring calls")
    for kind in ("pareto_tri", "deal", "pareto"):
        say(f"phase reliability: {kind} wall s card "
            f"{[round(t, 3) for t in rel_card['timed'][kind]['s']]}, cpu "
            f"{[round(t, 3) for t in rel_cpu['timed'][kind]['s']]}; launches (2-way, 3-way) "
            f"{rel_card['timed'][kind]['launches']}; {card}")

    # 15. the fused and sharded engines: golden CSVs, then phase 5's campaign
    # cold and warm (the counters zeroed just before each and read just
    # after), phase 6's instances card against cpu, and sharded runs
    report["fused"] = fused_phase(torch, batched, paper_sim, run_campaign, split_score,
                                  camp, wall, arrays, parts[0].b, card)
    by_path["fused campaign"] = report["fused"]["campaign"]["warm"]["launches"]

    # 16. the fleet replanning service on the card: the standard and chaos
    # traces (lockstep, fused, crash/restart, subprocess workers) to the
    # reference's digests, then the full-size fleet card against cpu; each
    # run's counters zeroed just before and read just after
    report["fleet"] = fleet_phase(torch, split_score, card)
    for label, run in report["fleet"]["runs"].items():
        if run["launches"]:
            by_path[f"fleet {label}"] = run["launches"]

    launches = {}
    for counts in by_path.values():
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    report["launches_by_path"] = by_path
    line = {"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces")}
        | {"launches": launches[k["name"]]}
        | {key: k[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")}
        for k in kernels]}
    report["kernels"] = [k | {"launches": launches[k["name"]]} for k in kernels]
    report["total_s"] = time.time() - t_all
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(report, indent=1, default=str))
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
