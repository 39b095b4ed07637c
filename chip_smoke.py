#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Drives the port's paths on the card and checks them: the Section-5
campaign planner, serving qwen3-4b at full width, the hybrid zamba2-7b at
full width, the planner API and its reliability extensions, the fleet
replanning service, serving's planner hooks with prefill, training, the
MoE, VLM, enc-dec and xLSTM families, and the planner's stage plan run as a
pipeline (``repro_torch``), in twenty phases; any failure exits non-zero:

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
              limit;
 17. serve plan + prefill — ``plan_serving`` of qwen3-4b and zamba2-7b at
              full width over 2, 4 and 8 pods on cuda, the split-score
              counters zeroed just before and read just after, then on cpu:
              every field equal but the candidates' ``wall_ms``, each kernel
              launched as often as the cpu calls the planner's scoring (the
              2-way kernel at least once); ``serve_pool`` of qwen3-4b at full
              width, 4 requests, batch 4, 16-token prompts, 32 new tokens,
              capacity 1024, ``pods=4, replan=True, replan_every=8,
              inject_straggler=3.0``: every request done, a plan and a replan
              digest, at least one replan, the published stages covering the
              36 layers, decode attention launched once per layer per decode
              call; ``transformer.prefill`` of qwen3-4b at full width with
              kernels, B = 1, S = 4096: exactly 73 RMSNorm launches and no
              flash attention (the reference's prefill takes plain or
              blocked attention), its last logits within the bfloat16 limit
              of phase 12 of ``forward``'s (flash route), then 16 decode steps
              from its state (decode attention only, logits finite); wall time
              and peak memory beside phase 8's forward; the smoke config in
              float32 prefilled at S = 4096 on cpu and cuda: logits and caches
              within atol 1e-4;
 18. train  — ``train_loop`` of qwen3-4b at full width cut to 4 of its 36
              layers, B = 1, S = 4096 (blocked attention under autograd, each
              block recomputed), 3 steps on cuda; again with a checkpoint
              after step 1 and ``fail_at_step=1``; then resumed from that
              checkpoint: every loss finite, the resumed step-2 loss equal to
              the uninterrupted run's, no hand-written kernel launched (the
              reference trains through the plain versions); step time and
              peak memory; then the smoke config in float32, 3 steps on cpu
              and cuda from the same weights: losses within atol 1e-4,
              parameters within the sum of the steps' learning rates.
 19. families — the new kernel shapes first: flash attention at head dim
              128 (mixtral-8x7b's window of 4096 at S = 8192, internvl2-26b's
              48/8 heads and arctic-480b's 56/8 at S = 4096), decode attention
              at the serve runs' 32 live slots (mixtral, internvl2, and
              whisper-large-v3's 20 heads of 64 at C = 448), RMSNorm at 4096
              rows of widths 4096, 6144 and 7168, each against its plain
              version and the library call, timed as phase 7.  Then, freed one
              before the next, at full width with random weights: mixtral-8x7b
              cut to 8 of 32 layers (S = 8192), arctic-480b cut to 2 of 35
              (S = 4096), internvl2-26b (256 patch embeddings + 3,840 tokens),
              whisper-large-v3 (1,500 frames, 448 tokens), xlstm-350m (S =
              4096): the forward with kernels (exact launches: RMSNorm 2L + 1
              and flash L on the bf16 route for the transformer families,
              none for whisper and xlstm), each MoE layer's routing ``==`` a
              plain routing and its output within 2^-6 of a plain per-expert
              MoE, the plain route's forward (no launch) within phase 12's
              bf16 limit, a routing that differs across the routes only at a
              near-tie; prefill (mixtral, internvl2; RMSNorm 2L + 1, no flash)
              against the forward's last logits; 16 decode steps (after
              prefill, or from whisper's encoded frames) each against plain
              decode attention from a copy of the state; ``serve_pool`` at
              B = 4 (4 requests, 16-token prompts, 16 new tokens; decode
              attention once per layer per call); init, forward and serve
              walls, tokens/s and peak memory per model; then each smoke
              config in float32, cpu against cuda: forward at S = 1536
              (routing ``==``), 4 decode steps, one train step's loss, within
              atol 1e-4.
 20. pipeline — ``plan`` of qwen3-4b at full width (36 layers, B = 4, S =
              2048) over 4 pods, pod 2 twice as fast (``tpu_pod_platform(4,
              degraded={2: 0.5})``), by the auto portfolio on cuda with the
              split-score counters zeroed just before and read just after:
              (15, 7, 7, 7) on pods (2, 0, 1, 3), the reference's plan; the
              serving-loaded bf16 weights packed into the pods' stacks
              (``make_stage_params``), every pod on the one card through a
              mesh naming it four times; ``sequential_loss_fn``'s loss and
              gradients, then ``pipelined_loss_fn``'s with M = 4 microbatches
              of 1 (cold, warm; no kernel launch): loss within 2e-3, every
              real layer's slot, the embedding and the final norm within 1e-2
              by relative norm, every masked slot's gradient 0; the kernel
              pass under ``inference_mode`` with kernels: exactly 288 RMSNorm
              and 144 flash launches (bf16 route), its loss within 1e-2 of
              the plain pass's; wall times, peak memory and each pod's summed
              stage device time (CUDA events); then the smoke config in
              float32 (B = 4, S = 256, M = 4), cpu in a child process against
              cuda: the plan equal, loss and every gradient within atol 1e-4.

Before its last line it prints one JSON line ``{"kernels": [...]}`` (per
kernel: launches summed over the main paths' runs (phases 5, 8-11, 13-20;
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
    if got.is_cuda:
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


def check_rmsnorm(torch, xs, sc, eps) -> dict:
    """RMSNorm at each of the bf16 inputs ``xs`` (a ring of cold buffers of
    one shape), in float32 and bfloat16 against its plain version, timed
    beside its plain version and ``F.rms_norm``."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    x = xs[0]
    n, d = x.shape
    x32 = x.float()
    f32_err = _err(torch, "rmsnorm", ops.rmsnorm(x32, sc, eps=eps),
                   ref.rmsnorm_ref(x32, sc, eps=eps))
    del x32
    err = _err(torch, "rmsnorm", ops.rmsnorm(x, sc, eps=eps), ref.rmsnorm_ref(x, sc, eps=eps))
    sc16 = sc.to(torch.bfloat16)
    return _kernel_row(
        "rmsnorm", ("rmsnorm", 17), err,
        device_time(torch, [lambda x=x: ops.rmsnorm(x, sc, eps=eps) for x in xs]),
        device_time(torch, [lambda x=x: ref.rmsnorm_ref(x, sc, eps=eps) for x in xs]),
        4 * n * d + 4 * d, 4 * n * d, FP32_FLOPS_PER_S,
        device_time(torch, [lambda x=x: F.rms_norm(x, (d,), sc16, eps) for x in xs]),
        {"n": n, "d": d, "dtype": "bfloat16", "cold_buffers": len(xs)}) | {
        "f32_max_abs_err": f32_err}


def check_model_kernels(torch, cfg, gen) -> list:
    """The four model kernels at the full-width shapes of the serving path,
    in float32 and in bfloat16 (timed); the attention kernels also show that
    the tolerance rejects the answer with the window or mask ignored."""
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
    rows.append(check_rmsnorm(torch, xs, sc, eps))
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


def check_flash(torch, gen, H, K, hd, window, S=FWD_S) -> dict:
    """Flash attention at B = 1, S = T = ``S``, causal, with ``window``, in
    float32 and bfloat16 against its plain version; the same limit must
    reject the answer with the window ignored (without a window: with
    causality ignored).  The bf16 route (tensor cores) timed beside its plain
    version and SDPA (bf16), and beside the float32 route (CUDA cores).
    Bound by operations, so timed warm (one set of inputs)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    q, k, v = ((torch.randn(shape, generator=gen, device=dev) * 0.5).to(bf16)
               for shape in ((1, S, H, hd), (1, S, K, hd), (1, S, K, hd)))
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
    pairs = sum(min(i + 1, window or S) for i in range(S))
    if window is None:
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                     enable_gqa=True)
    else:
        pq = torch.arange(S, device=dev)
        band = (pq[:, None] >= pq[None, :]) & (pq[:, None] - pq[None, :] < window)
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                                     enable_gqa=True)
    kern = device_time(torch, lambda: ops.flash_attention(q, k, v, causal=True, window=window))
    row = _kernel_row(
        "flash_attention", ("flash_attention", 27), err, kern,
        device_time(torch, lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                                           window=window)),
        2 * (2 * S * H * hd + 2 * S * K * hd), 4 * hd * H * pairs,
        BF16_TENSOR_FLOPS_PER_S, device_time(torch, lib),
        {"B": 1, "S": S, "T": S, "H": H, "K": K, "hd": hd, "causal": True,
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


def decode_plan(torch, kind, H, K, hd, window, gen, device, C=SERVE["capacity"],
                last_pos=SERVE["prompt_len"] + SERVE["max_new"] - 1) -> dict:
    """Input ``kind`` of :data:`DECODE_INPUTS` (``window``: the model's, or
    None) at B rows of C slots (``serve_live``: the serve run's last
    position ``last_pos``): cache positions, current positions, the window
    it takes, the slot mask, its live count, the bytes of the bound, and the
    cold ring."""
    from repro_torch.kernels import ops

    B = SERVE["batch"]
    slots = torch.arange(C, device=device, dtype=torch.int32)[None, :]
    if kind == "mixed":
        pos = torch.randint(C // 2, C, (B,), generator=gen, device=device)
    elif kind == "serve_live":
        pos = torch.full((B,), last_pos, device=device)
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


def check_decode(torch, gen, arch, H, K, hd, window, C=SERVE["capacity"],
                 last_pos=SERVE["prompt_len"] + SERVE["max_new"] - 1,
                 kinds=DECODE_INPUTS) -> dict:
    """Decode attention at the serve runs' B = 4 against C slots (qwen3-4b's
    1024) at each of ``kinds`` (``serve_live``: the serve run's live slots
    up to ``last_pos``), in float32 and bfloat16 against its plain version;
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
    B = SERVE["batch"]
    q = (torch.randn((B, H, hd), generator=gen, device=dev) * 0.5).to(bf16)
    # the wrapper's split of the cache (None where it does not size one from the card)
    split = (kdec.split_slots(B, K, H // K, C, *kdec.card_shape(dev, hd, 1))
             if hasattr(kdec, "split_slots") else None)
    inputs = {}
    for kind in kinds:
        plan = decode_plan(torch, kind, H, K, hd, window, gen, dev, C, last_pos)
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


def _to(tree, device, copy: bool = False):
    if isinstance(tree, dict):
        return {k: _to(v, device, copy) for k, v in tree.items()}
    return tree.to(device, copy=copy)


def _logits_close(got, want, dtype, f32_tol=LOGIT_F32_TOL) -> dict:
    """The float32 limit or the reference's bf16 model criterion, computed
    on ``want``'s device."""
    got, want = got.float().to(want.device), want.float()
    err = (got - want).abs()
    out = {"max_err": float(err.max()), "mean_rel_err": float(err.mean() / want.abs().mean())}
    ok = bool(got.isfinite().all()) and (
        out["max_err"] <= f32_tol if dtype == "float32"
        else out["max_err"] < 0.35 and out["mean_rel_err"] < 0.05)
    return out | {"ok": ok}


def diagnose_forward(torch, api, cfg, params, card, toks, got, want,
                     f32_tol=LOGIT_F32_TOL, extras=None) -> dict:
    """Where a forward's card and cpu logits part: whether a second card
    forward repeats the first bit for bit, the logit rows over the float32
    limit, whether a second cpu forward repeats the first, the parameters
    whose card copy differs from the cpu one, each block's residual stream
    (card against cpu; a layer of the dense model, a group of the hybrid),
    every kernel call against its plain version on the same card inputs, and
    the head: its input card against cpu, and each side's logits against the
    float64 product of its own input.  ``params`` and ``card`` may sit on any
    two devices; ``extras`` are the batch's stub inputs (on the cpu)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import hybrid, ssm, transformer

    rows = (got.float().cpu() - want.float().cpu()).abs().amax(-1).flatten()
    bad = (rows > f32_tol).nonzero().flatten().tolist()
    out = {"rows_over": len(bad), "rows_over_first": bad[:8],
           "device": str(next(iter(card["embed"].values())).device)}
    if torch.cuda.is_available():
        out["uuid"] = str(torch.cuda.get_device_properties(0).uuid)
    streams, calls = [], []
    module, block_name = ((transformer, "block_forward") if cfg.family in transformer.FAMILIES
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
    extras = extras or {}
    try:
        again, _ = api.forward(card, {"tokens": toks.to(out["device"])}
                               | {k: v.to(out["device"]) for k, v in extras.items()}, cfg)
        n_card = len(streams)
        again_cpu, _ = api.forward(params, {"tokens": toks.cpu()} | extras, cfg)
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


# serving's planner hooks: plan_serving of both served models at full width
# over 2, 4 and 8 pods (the reference's pod platform), and serve_pool of
# qwen3-4b shadowed by the fleet service, with a straggler on stage 0 after
# the warm-up window (the reference's CPU run of the smoke config replans
# 3 times in 32 decode steps)
PLAN_ARCHS, PLAN_PODS = (ARCH, HYBRID), (2, 4, 8)
REPLAN_SERVE = dict(n_requests=4, batch=4, prompt_len=16, max_new=32, capacity=1024, seed=0,
                    pods=4, replan=True, replan_every=8, inject_straggler=3.0)
# prefill at the forward's length (blocked attention: S > 2048), then decode
PREFILL_DECODE_STEPS = 16
# training: qwen3-4b at full width cut to 4 of its 36 layers (float32
# master weights, gradients and two AdamW moments of 36 layers take ~60 GB
# before activations), one sequence of the train_4k length; a checkpoint
# after step 1, a crash there, and a resume
TRAIN_LAYERS = 4
TRAIN = dict(arch=ARCH, smoke=False, steps=3, batch=1, seq=FWD_S, seed=0, log_every=1)
# the CPU parity tests' tolerances (tests/test_torch_train.py): losses atol
# 1e-4, parameters within the sum of the steps' learning rates
TRAIN_LOSS_TOL = 1e-4
# the worst leaf's update against the cpu's, relative to its size (see
# update_rel_err): 1 for an update that never happened; the port against the
# reference on the cpu, 3 smoke steps in float32: 1.0e-5 dense, 2.1e-4 hybrid
TRAIN_UPDATE_RTOL = 1e-2
TRAIN_SMOKE = dict(steps=3, batch=2, seq=128, base_lr=1e-3, warmup=1, total_steps=10)
SCORE_ROWS = {"score_2way_cuda": "score_2way_f64", "score_3way_cuda": "score_3way_f64"}


def strip_wall(digest: dict) -> dict:
    """A ``plan_serving`` digest without the candidates' wall times."""
    return digest | {"candidates": [{k: v for k, v in c.items() if k != "wall_ms"}
                                    for c in digest["candidates"]]}


def compare_plans(got: dict, want: dict, what: str) -> int:
    """Every digest of ``got`` equal to ``want``'s on every field but the
    candidates' ``wall_ms``; returns the candidates compared."""
    if sorted(got) != sorted(want):
        fail(f"{what}: digests for {sorted(got)} against {sorted(want)}")
    for key in got:
        if strip_wall(got[key]) != strip_wall(want[key]):
            fail(f"{what}: plan_serving{key} differs: {strip_wall(got[key])} against "
                 f"{strip_wall(want[key])}")
    return sum(len(d["candidates"]) for d in got.values())


def plan_rows(serve, device, archs=PLAN_ARCHS, pods=PLAN_PODS, smoke: bool = False) -> dict:
    return {(arch, p): serve.plan_serving(arch, p, smoke=smoke, device=device)
            for arch in archs for p in pods}


def prefill_launches(cfg) -> dict:
    """The model kernels a ``use_pallas`` prefill of the dense model
    launches: RMSNorm before attention and before the MLP in every layer,
    and the final one; never flash attention (the reference's prefill takes
    plain or blocked attention), nothing else."""
    return {"rmsnorm": 2 * cfg.n_layers + 1, "rmsnorm_residual": 0, "flash_attention": 0,
            "decode_attention": 0, "ssd_intra_chunk": 0}


def check_replan_serve(served: dict, cfg, launches: dict) -> None:
    """The replan serve run's gates: every request done, a plan and a
    replan digest, at least one replan, the published stages covering every
    layer, and decode attention launched once per layer per decode call."""
    if not served["all_done"]:
        fail(f"replan serve: not every request finished: {served}")
    for key in ("plan", "replan"):
        if key not in served:
            fail(f"replan serve: no {key!r} digest")
    rep = served["replan"]
    if rep["replans"] < 1:
        fail(f"replan serve: the straggler was never replanned: {rep}")
    if cfg.n_layers != sum(rep["stage_sizes"]) or cfg.n_layers != sum(
            served["plan"]["stage_sizes"]):
        fail(f"replan serve: stages {rep['stage_sizes']} / {served['plan']['stage_sizes']} do "
             f"not cover {cfg.n_layers} layers")
    want = cfg.n_layers * decode_calls(**REPLAN_SERVE)
    if launches.get("decode_attention", want) != want:
        fail(f"replan serve: decode attention launched {launches['decode_attention']} times, "
             f"expected {want}")


def clone_state(state):
    """A decode state's copy: every tensor of its (nested) named tuples
    cloned, since decode updates the state in place."""
    if isinstance(state, tuple):
        return type(state)(*(clone_state(f) for f in state))
    return state.clone()


def decode_after_prefill(torch, api, params, state, logits, cfg, counters, steps: int,
                         sync, moe=None) -> tuple:
    """``steps`` decode steps through ``api`` from a prefill's (or any)
    ``state`` and last ``logits`` (each step fed the argmax of the one
    before), then the same steps with the plain decode attention
    (``use_pallas`` off) from a copy of that state, fed the same tokens
    (with the port's ``moe`` module given, each MoE layer of the kernel run
    held to :func:`check_moe_layer` and the plain run routed as it was): every step's logits
    within :func:`_logits_close`'s limit of the plain ones.  Returns (the
    launches of the first run, the worst step's errors).
    The counters are zeroed just before the first run and read just after;
    the plain run launches no kernel."""
    from repro_torch.models import get_model

    plain_state = clone_state(state)
    zero_counters(counters)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    fed, got = [], []
    with moe_checks(torch, moe) if moe else contextlib.nullcontext([]) as routed:
        for _ in range(steps):
            fed.append(tok)
            dlogits, state = api.decode(params, state, tok)
            got.append(dlogits)
            tok = dlogits[:, -1].argmax(-1).to(torch.int32)[:, None]
        sync()
    launches = {c.__name__: c.launches for c in counters}
    if not all(bool(torch.isfinite(g).all()) for g in got):
        fail("decode after prefill: logits not finite")
    plain, worst = get_model(cfg.replace(use_pallas=False)), {"max_err": 0.0, "mean_rel_err": 0.0}
    with forced_routing(moe, routed) if moe else contextlib.nullcontext():
        for i, (tok, g) in enumerate(zip(fed, got)):
            want, plain_state = plain.decode(params, plain_state, tok)
            close = _logits_close(g, want.float().cpu(), cfg.dtype)
            if not close["ok"]:
                fail(f"decode after prefill: step {i}'s logits against the plain decode "
                     f"attention's: {close}")
            worst = {k: max(v, close[k]) for k, v in worst.items()}
    return launches, worst


def serve_prefill_phase(torch, split_score, heuristics, counters, cfg, card, fwd: dict,
                        device: str = "cuda", smoke_cfg=None, archs=PLAN_ARCHS,
                        plan_smoke: bool = False, serve_smoke: bool = False,
                        prefill_s: int = FWD_S) -> dict:
    """Phase 17 on ``device``: ``plan_serving`` of ``archs`` over 2, 4 and 8
    pods, equal to the same calls on the cpu (each split-score kernel
    launched as often as the cpu calls the planner's scoring); ``serve_pool``
    of ``cfg``'s arch with pods and replanning; ``prefill`` at ``prefill_s``
    with kernels (``cfg``), its last logits against ``forward``'s, then
    decode steps from its state; and ``smoke_cfg`` prefilled on the cpu and
    on ``device``.  The counters are zeroed just before each run and read
    just after.  ``fwd`` is phase 8's forward report."""
    from repro_torch.launch import serve
    from repro_torch.models import get_model

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    score_counters = (split_score.score_2way_cuda, split_score.score_3way_cuda)
    out, by_path = {"card": card}, {}

    def read(cs):   # the split-score counters under their kernel rows' names
        return {SCORE_ROWS.get(c.__name__, c.__name__): c.launches for c in cs}

    # plan_serving on the device, then on the cpu with each scoring call counted
    sync()
    zero_counters(score_counters)
    t0 = time.time()
    rows = plan_rows(serve, device, archs, smoke=plan_smoke)
    sync()
    plan_s = time.time() - t0
    plan_launches = read(score_counters)
    with counted_scoring(heuristics) as counts:
        rows_cpu = plan_rows(serve, "cpu", archs, smoke=plan_smoke)
    n_cands = compare_plans(rows, rows_cpu, f"plan_serving {device} vs cpu")
    if on_card and (list(plan_launches.values()) != counts or counts[0] <= 0):
        fail(f"plan_serving launched {plan_launches} on the card against {counts} scoring "
             "calls on the cpu")
    by_path["plan_serving"] = plan_launches
    out["plans"] = {"archs": list(archs), "pods": list(PLAN_PODS), "candidates": n_cands,
                    "wall_s": plan_s, "launches": plan_launches, "cpu_scoring_calls": counts,
                    "digests": {f"{a} x{p}": {k: v for k, v in d.items() if k != "candidates"}
                                for (a, p), d in rows.items()}}
    say(f"phase serve plan: plan_serving of {', '.join(archs)} over {list(PLAN_PODS)} pods "
        f"on {device} in {plan_s:.2f} s, {n_cands} candidates equal to the cpu's; launches "
        f"{plan_launches} (cpu scoring calls {counts}); {card}")
    for (a, p), d in rows.items():
        say(f"phase serve plan: {a} x{p}: {d['planner']} stages {d['stage_sizes']} on pods "
            f"{d['pods']}, period {d['period']!r}")

    # serve_pool with the planner and the fleet service shadowing the loop
    all_counters = tuple(counters) + score_counters
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    zero_counters(all_counters)
    served = serve.serve_pool(arch=cfg.arch_id.removesuffix("-smoke"), smoke=serve_smoke,
                              device=device, **REPLAN_SERVE)
    launches = read(all_counters) if on_card else {}
    check_replan_serve(served, cfg, launches)
    by_path["replan serve"] = launches
    out["replan_serve"] = served | {"config": REPLAN_SERVE, "launches": launches}
    rep = served["replan"]
    say(f"phase serve plan: serve_pool {cfg.arch_id} {served['decode_steps']} decode steps in "
        f"{served['wall_s']:.3f} s ({served['tokens_per_s']:.2f} tokens/s), {rep['replans']} "
        f"replans, published stages {rep['stage_sizes']} on pods {rep['pods']} (planned "
        f"{served['plan']['stage_sizes']} on {served['plan']['pods']}); fleet "
        f"{ {k: rep['metrics'][k] for k in ('ticks', 'requests', 'solves')} }; launches "
        f"{launches}; {card}")

    # prefill with kernels, against the forward's last logits, then decode
    api = get_model(cfg)
    params = api.init(SERVE["seed"], device)
    toks = torch.randint(1, cfg.vocab_size, (1, prefill_s), device=device,
                         generator=torch.Generator(device=device).manual_seed(1))
    want = api.forward(params, {"tokens": toks}, cfg)[0][:, -1:].float().cpu()
    from repro_torch.models import transformer

    walls = []
    for _ in range(2):
        state = None        # the first prefill's state is freed before the second
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        zero_counters(counters)
        t0 = time.time()
        logits, state = transformer.prefill(params, toks, cfg)
        sync()
        walls.append(time.time() - t0)
        pre_launches = read(counters)
        peak = torch.cuda.max_memory_allocated() if on_card else None
        if on_card and pre_launches != prefill_launches(cfg):
            fail(f"prefill: launches {pre_launches}, expected {prefill_launches(cfg)}")
    close = _logits_close(logits, want, cfg.dtype)
    if not close["ok"]:
        fail(f"prefill: last logits against the forward's: {close}")
    by_path["prefill"] = pre_launches
    dec_launches, vs_plain = decode_after_prefill(
        torch, api, params, state, logits, cfg, counters, PREFILL_DECODE_STEPS, sync)
    want_dec = cfg.n_layers * PREFILL_DECODE_STEPS
    if on_card and dec_launches != {**prefill_launches(cfg), "rmsnorm": 0,
                                    "decode_attention": want_dec}:
        fail(f"decode after prefill: launches {dec_launches}, expected {want_dec} decode "
             "attention and nothing else")
    by_path["decode after prefill"] = dec_launches
    out["prefill"] = {"B": 1, "S": prefill_s, "layers": cfg.n_layers, "wall_s_first": walls[0],
                      "wall_s_second": walls[1], "peak_mem_bytes": peak,
                      "forward_wall_s_second": fwd.get("wall_s_second"),
                      "forward_peak_mem_bytes": fwd.get("peak_mem_bytes"),
                      "launches": pre_launches, "vs_forward": close,
                      "capacity": int(state.caches.k.shape[2]),
                      "decode_steps": PREFILL_DECODE_STEPS, "decode_launches": dec_launches,
                      "decode_vs_plain": vs_plain}
    say(f"phase prefill: {cfg.arch_id} B=1 S={prefill_s} {cfg.n_layers} layers in "
        f"{walls[0]:.3f} s (again {walls[1]:.3f} s; phase 8's forward {fwd.get('wall_s_second')}"
        f" s), peak {peak} B (forward {fwd.get('peak_mem_bytes')} B); launches {pre_launches};"
        f" last logits vs forward {close}; {PREFILL_DECODE_STEPS} decode steps after it, "
        f"launches {dec_launches}, logits vs plain decode attention {vs_plain}; {card}")
    del params, state, logits, want

    # the smoke config in float32: prefill on the cpu and on the device
    if smoke_cfg is not None:
        sapi = get_model(smoke_cfg)
        sp = sapi.init(7, "cpu")
        stoks = torch.randint(1, smoke_cfg.vocab_size, (1, prefill_s),
                              generator=torch.Generator().manual_seed(8))
        want, wstate = transformer.prefill(sp, stoks, smoke_cfg)
        got, gstate = transformer.prefill(_to(sp, device), stoks.to(device), smoke_cfg)
        errs = {"logits": float((got.float().cpu() - want).abs().max())}
        for name, g, w in zip(wstate.caches._fields, gstate.caches, wstate.caches):
            if g.dtype == torch.int32:
                if not torch.equal(g.cpu(), w):
                    fail(f"prefill cpu vs {device}: cache {name} differs")
            else:
                errs[name] = float((g.float().cpu() - w.float()).abs().max())
        if max(errs.values()) > LOGIT_F32_TOL:
            fail(f"prefill cpu vs {device} ({smoke_cfg.arch_id}, float32): {errs} over "
                 f"{LOGIT_F32_TOL}")
        out["prefill_cpu_vs_card"] = errs
        say(f"phase prefill: {smoke_cfg.arch_id} float32 S={prefill_s} cpu vs {device}: max abs "
            f"err {errs} (limit {LOGIT_F32_TOL})")
    out["by_path"] = by_path
    return out


@contextlib.contextmanager
def config_cut(module, cfg):
    """Within the block, ``module``'s config lookups (full and smoke) give
    ``cfg``: the one cut of a configuration the phase makes (its depth, or
    its dtype), without a parameter the user-facing entry point lacks."""
    real = module.get_config, module.get_smoke_config
    module.get_config = module.get_smoke_config = lambda arch: cfg
    try:
        yield
    finally:
        module.get_config, module.get_smoke_config = real


def train_steps(torch, cfg, device, steps: int, batch: int, seq: int, base_lr: float,
                warmup: int, total_steps: int) -> tuple:
    """``steps`` train steps of ``cfg`` on ``device`` from the same seeded
    master weights (drawn on the cpu): (losses, sum of learning rates,
    parameters on the cpu, the weights they started from)."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import get_model, stub_inputs
    from repro_torch.models.train import init_optimizer, make_train_step

    api = get_model(cfg)
    init = api.init(7, "cpu", master=True)
    params = _to(init, device, copy=True)      # AdamW updates in place
    state = init_optimizer(params)
    step = make_train_step(api.train_forward, cfg, base_lr=base_lr, warmup=warmup,
                           total_steps=total_steps)
    ds = SyntheticLMDataset(cfg.vocab_size, seq, batch, seed=0)
    losses, lr_sum = [], 0.0
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(device) for k, v in ds.batch(i).items()}
        b |= stub_inputs(cfg, batch, device)
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        lr_sum += float(m["lr"])
    return losses, lr_sum, _to(params, "cpu"), init


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _max_param_err(torch, got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(_leaves(got), _leaves(want)))


def update_rel_err(got, want, init) -> float:
    """The worst leaf's ``|got - want| / |want - init|`` (Frobenius norms):
    how far one run's update of the weights lies from the other's, relative
    to its size.  An update that never happened gives 1; a leaf ``want``
    left where it was must stay there in ``got`` too."""
    worst = 0.0
    for g, w, i in zip(_leaves(got), _leaves(want), _leaves(init)):
        diff = float((g.double() - w.double()).norm())
        size = float((w.double() - i.double()).norm())
        worst = max(worst, diff / size if size else (0.0 if diff == 0 else math.inf))
    return worst


def train_phase(torch, counters, card, device: str = "cuda", train: dict = TRAIN,
                n_layers: int = TRAIN_LAYERS, smoke_cfg=None,
                ckpt_dir: pathlib.Path = REPO / "build" / "chip_smoke" / "train_ckpt") -> dict:
    """Phase 18 on ``device``: ``train_loop`` of ``train['arch']`` cut to
    ``n_layers`` layers, uninterrupted, then with a checkpoint after step 1
    and a crash there, then resumed from it: every loss finite, the resumed
    step's loss ``==`` the uninterrupted run's, no hand-written kernel
    launched (training runs the plain versions, as the reference does);
    then ``smoke_cfg`` trained on the cpu and on ``device``, losses and
    parameters within the CPU parity tests' tolerances."""
    import shutil

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import train as tr

    on_card = torch.device(device).type == "cuda"
    base = get_smoke_config(train["arch"]) if train["smoke"] else get_config(train["arch"])
    cfg = base.replace(n_layers=n_layers)
    out = {"card": card, "config": train | {"n_layers": n_layers}}
    with config_cut(tr, cfg):
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        zero_counters(counters)
        t0 = time.time()
        ref = tr.train_loop(ckpt_dir=None, device=device, **train)
        out["wall_s"] = time.time() - t0
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() if on_card else None
        launches = {c.__name__: c.launches for c in counters}
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        t0 = time.time()
        try:
            tr.train_loop(ckpt_dir=str(ckpt_dir), ckpt_every=1, fail_at_step=1, device=device,
                          **train)
        except RuntimeError as e:
            if "simulated failure" not in str(e):
                raise
        else:
            fail("train: the run with fail_at_step=1 did not stop")
        out["crash_run_s"] = time.time() - t0
        t0 = time.time()
        resumed = tr.train_loop(ckpt_dir=str(ckpt_dir), ckpt_every=1, device=device, **train)
        out["resume_run_s"] = time.time() - t0
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = ref["losses"] + resumed["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: a loss is not finite: {ref['losses']}, resumed {resumed['losses']}")
    if resumed["start_step"] != 2 or resumed["losses"] != ref["losses"][2:]:
        fail(f"train: resumed at {resumed['start_step']} with losses {resumed['losses']}, "
             f"uninterrupted {ref['losses']}")
    if any(launches.values()):
        fail(f"train: launched {launches}; training runs no hand-written kernel")
    out |= {"losses": ref["losses"], "resumed_losses": resumed["losses"],
            "step_s": ref["step_s"], "launches": launches}
    say(f"phase train: {cfg.arch_id} {n_layers} layers B={train['batch']} S={train['seq']} "
        f"on {device}: losses {ref['losses']}, step s {[round(t, 3) for t in ref['step_s']]}, "
        f"peak {out['peak_mem_bytes']} B; checkpoint at step 1, crash, resume at step 2: loss "
        f"{resumed['losses']} == uninterrupted (crash run {out['crash_run_s']:.1f} s, resume "
        f"{out['resume_run_s']:.1f} s); launches {launches}; {card}")

    if smoke_cfg is not None:
        got = train_steps(torch, smoke_cfg, device, **TRAIN_SMOKE)
        want = train_steps(torch, smoke_cfg, "cpu", **TRAIN_SMOKE)
        loss_err = max(abs(a - b) for a, b in zip(got[0], want[0]))
        param_err = _max_param_err(torch, got[2], want[2])
        update_err = update_rel_err(got[2], want[2], want[3])
        if loss_err > TRAIN_LOSS_TOL or param_err > want[1] or update_err > TRAIN_UPDATE_RTOL:
            fail(f"train cpu vs {device} ({smoke_cfg.arch_id}, float32): losses {got[0]} "
                 f"against {want[0]}, max parameter err {param_err} (limit {want[1]}), "
                 f"update err {update_err} (limit {TRAIN_UPDATE_RTOL})")
        out["cpu_vs_card"] = {"losses": got[0], "cpu_losses": want[0], "loss_err": loss_err,
                              "param_err": param_err, "lr_sum": want[1],
                              "update_rel_err": update_err}
        say(f"phase train: {smoke_cfg.arch_id} float32, {TRAIN_SMOKE['steps']} steps cpu vs "
            f"{device}: loss err {loss_err:.3g} (limit {TRAIN_LOSS_TOL}), parameter err "
            f"{param_err:.3g} (limit {want[1]:.3g}), update err {update_err:.3g} (limit "
            f"{TRAIN_UPDATE_RTOL})")
    return out


# phase 19: the other families at full width, random weights from a seed,
# B = 1 forwards.  The only cuts are depth, where the bf16 weights would not
# fit one card: mixtral-8x7b 8 of 32 layers (2.9 GB per layer), arctic-480b
# 2 of 35 (26.8 GB of experts per layer).  ``seq`` counts every position:
# internvl2-26b's 256 patch embeddings and 3,840 text tokens; whisper's 448
# decoder tokens beside its 1,500 frames.  Decode after prefill (mixtral,
# internvl2) or from an encoded state (whisper), then serve_pool at B = 4
FAMILY_RUNS = (
    {"arch": "mixtral-8x7b", "layers": 8, "seq": 8192, "prefill": True, "capacity": 1024},
    {"arch": "arctic-480b", "layers": 2, "seq": 4096, "prefill": False, "capacity": None},
    {"arch": "internvl2-26b", "layers": None, "seq": 4096, "prefill": True, "capacity": 1024},
    {"arch": "whisper-large-v3", "layers": None, "seq": 448, "prefill": False,
     "capacity": 448},
    {"arch": "xlstm-350m", "layers": None, "seq": 4096, "prefill": False, "capacity": 1024},
)
FAMILY_SERVE = dict(n_requests=4, batch=4, prompt_len=16, max_new=16, seed=0)
FAMILY_DECODE_STEPS = 16
# the smoke configs card against cpu, in float32: a forward long enough for
# flash attention (S = 1536, the VLM's prefix included), 4 decode steps, one
# train step.  xlstm-350m reaches no kernel, so its forward gains nothing
# from the length and runs at S = 256 (8 chunks): at S = 1536 its float32
# logits move by 6.6e-5 between two MKL code paths on one x86 host alone
# (MKL_CBWR=COMPATIBLE or not; torch 2.13 with MKL), two thirds of the limit
FAMILY_SMOKE_SEQ, FAMILY_SMOKE_DECODE = 1536, 4
FAMILY_SMOKE_SEQ_NO_KERNEL = 256
KERNEL_NAMES = ("rmsnorm", "rmsnorm_residual", "flash_attention", "decode_attention",
                "ssd_intra_chunk")


def flash_gate(S: int, T: int) -> bool:
    """The reference's gate for its flash kernel (``attention``)."""
    return S > 1024 and S % 512 == 0 and T % 512 == 0


def family_launches(cfg, path: str, seq: int = 0, calls: int = 0) -> dict:
    """The model kernels ``path`` of ``cfg`` (with ``use_pallas``) launches.
    ``forward`` at ``seq`` positions: for the transformer families RMSNorm
    before attention and before the FFN in every layer and the final one,
    flash attention once per layer where the gate passes; the enc-dec family
    flash attention only where its encoder (at enc_seq frames), decoder or
    cross attention passes the gate (whisper: none) and no RMSNorm
    (LayerNorm); the xLSTM family nothing (every RMSNorm call site of the
    reference passes no ``use_pallas``).  ``prefill``: RMSNorm as the
    forward, never flash.  ``decode`` (``calls`` steps): decode attention
    once per self-attention layer per step, no RMSNorm kernel (decode keeps
    the plain formula)."""
    out = dict.fromkeys(KERNEL_NAMES, 0)
    L = cfg.n_layers
    transformer = cfg.family in ("dense", "moe", "vlm")
    if path == "forward":
        if transformer:
            out["rmsnorm"] = 2 * L + 1
            out["flash_attention"] = L * flash_gate(seq, seq)
        elif cfg.family == "encdec":
            out["flash_attention"] = (cfg.n_enc_layers * flash_gate(cfg.enc_seq, cfg.enc_seq)
                                      + L * flash_gate(seq, seq)
                                      + L * flash_gate(seq, cfg.enc_seq))
    elif path == "prefill":
        out["rmsnorm"] = 2 * L + 1 if transformer else 0
    elif path == "decode":
        out["decode_attention"] = L * calls if cfg.family != "xlstm" else 0
    else:
        raise ValueError(path)
    return out


def check_launches(what: str, got: dict, want: dict) -> None:
    if got != want:
        fail(f"{what}: launches {got}, expected {want}")


def routing_oracle(torch, logits, k: int, C: int) -> tuple:
    """(top ids (n, k), keep (n, k)) of router ``logits`` (n, E), computed
    apart from the port's sorts: each expert's place in its token's
    descending order is counted directly (a tie places the lower expert
    first, as ``jax.lax.top_k``), and each (token, choice) pair's rank in its
    expert is a running count over the pairs in token order (kept while
    under the capacity ``C``)."""
    import torch.nn.functional as F

    n, E = logits.shape
    idx = torch.arange(E, device=logits.device)
    above = (logits[:, None, :] > logits[:, :, None]).sum(-1)
    tied_lower = ((logits[:, None, :] == logits[:, :, None])
                  & (idx[None, None, :] < idx[None, :, None])).sum(-1)
    place = above + tied_lower                                    # (n, E)
    ids = (place[:, None, :] == torch.arange(k, device=logits.device)[None, :, None]
           ).int().argmax(-1)                                     # (n, k)
    counts = F.one_hot(ids.reshape(-1), E).cumsum(0)
    rank = counts.gather(1, ids.reshape(-1, 1))[:, 0] - 1
    return ids, (rank < C).reshape(n, k)


def check_moe_layer(torch, params, flat, cfg, r, y) -> dict:
    """One MoE dispatch of the port (``moe._grouped_dispatch``: input
    ``flat``, routing ``r``, output ``y``) against plain versions on the
    same inputs: the top-k ids and the kept pairs ``==``
    :func:`routing_oracle`'s, and the output within 2e-5 + 2^-6 of the sum
    of its terms' magnitudes (each pair's expert output times its weight,
    summed over the token's choices) of a plain MoE that runs each expert on
    its kept tokens, each pair weighted by the softmax of the router logits
    at the oracle's ids.  Returns the layer's record; its ``top_ids`` and
    ``logits`` serve :func:`forced_routing`."""
    import torch.nn.functional as F

    E, k, d = cfg.n_experts, cfg.top_k, flat.shape[-1]
    logits = r.logits.reshape(-1, E)
    ids, keep = routing_oracle(torch, logits, k, r.capacity)
    keep_pair = torch.empty_like(r.keep).scatter_(-1, r.order, r.keep).reshape(-1, k)
    top_ids = r.top_ids.reshape(-1, k)
    if not torch.equal(top_ids, ids):
        fail(f"moe {cfg.arch_id}: top-k ids differ from the plain routing at "
             f"{int((top_ids != ids).any(-1).sum())} tokens")
    if not torch.equal(keep_pair, keep):
        fail(f"moe {cfg.arch_id}: kept pairs differ from the plain routing at "
             f"{int((keep_pair != keep).sum())} pairs")
    x, dt = flat.reshape(-1, d), flat.dtype
    w = torch.softmax(logits.gather(-1, ids), dim=-1).to(dt)
    want = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    mag = torch.zeros_like(want)
    for e in range(E):
        t, j = ((ids == e) & keep).nonzero(as_tuple=True)
        if t.numel() == 0:
            continue
        xe = x[t]
        h = F.silu(xe @ params["wg"][e].to(dt)) * (xe @ params["wi"][e].to(dt))
        o = ((h @ params["wo"][e].to(dt)) * w[t, j, None]).float()
        want.index_add_(0, t, o)
        mag.index_add_(0, t, o.abs())
    diff = (y.reshape(-1, d).float() - want).abs()
    lim = F32_TOL + BF16_RTOL * mag
    if not bool((diff <= lim).all()):
        fail(f"moe {cfg.arch_id}: output differs from the plain MoE by {float(diff.max())} "
             f"(worst share of its limit {float((diff / lim).max()):.3g})")
    return {"tokens": int(top_ids.shape[0]), "capacity": r.capacity,
            "dropped_pairs": int((~keep).sum()), "out_max_err": float(diff.max()),
            "top_ids": top_ids, "logits": logits}


@contextlib.contextmanager
def moe_checks(torch, moe):
    """Within the block every MoE dispatch of the port's ``moe`` module is
    held to :func:`check_moe_layer` as it runs; yields the list of the
    layers' records."""
    records, routes = [], []
    real_route, real_dispatch = moe.route, moe._grouped_dispatch

    def route(*args, **kw):
        routes.append(real_route(*args, **kw))
        return routes[-1]

    def dispatch(params, flat, cfg):
        y, aux = real_dispatch(params, flat, cfg)
        records.append(check_moe_layer(torch, params, flat, cfg, routes.pop(), y))
        return y, aux

    moe.route, moe._grouped_dispatch = route, dispatch
    try:
        yield records
    finally:
        moe.route, moe._grouped_dispatch = real_route, real_dispatch


def routing_flips(own, ids, logits, recorded, k: int) -> tuple:
    """Tokens whose top-k ids ``own`` (n, k), chosen from ``logits`` (n, E),
    differ from the ``ids`` another run chose from its ``recorded`` logits
    of the same inputs up to rounding: each must be a near-tie, two
    neighbours among its k + 1 largest ``logits`` within twice the largest
    move of that token's logits between the runs.  Returns (the count of
    such tokens, the worst gap over twice the move)."""
    moved = (own != ids).any(-1)
    if not bool(moved.any()):
        return 0, 0.0
    delta = (logits[moved] - recorded[moved]).abs().amax(-1)
    top = logits[moved].sort(-1, descending=True).values[:, :k + 1]
    ratio = (top[:, :-1] - top[:, 1:]).amin(-1) / (2 * delta)
    if not bool((ratio <= 1).all()):
        fail(f"moe routing: a token's choice moved without a near-tie (gap over twice the "
             f"logits' move {float(ratio.max())})")
    return int(moved.sum()), float(ratio.max())


@contextlib.contextmanager
def forced_routing(moe, records: list):
    """Within the block the port's ``moe`` module routes each successive
    dispatch to the top-k ids of the next of ``records`` (another run's
    :func:`moe_checks` records, in its order), its weights the softmax of
    this run's own logits at those ids: a route's forward replays another
    route's choices, so the two differ by rounding alone.  Each dispatch's
    own choice is held to the recorded one by :func:`routing_flips`, layer
    by layer, so a flip cannot carry into later layers; yields the counts
    (tokens, flipped tokens, the worst near-tie)."""
    real, forced = moe.top_k, list(records)
    stats = {"tokens": 0, "flipped_tokens": 0, "worst_gap_over_2delta": 0.0}

    def top_k(x, k):
        rec = forced.pop(0)
        ids = rec["top_ids"].reshape(x.shape[:-1] + (k,)).to(x.device)
        own = real(x, k)[1]
        flips, worst = routing_flips(own.reshape(-1, k), ids.reshape(-1, k),
                                     x.reshape(-1, x.shape[-1]), rec["logits"].to(x.device), k)
        stats["tokens"] += rec["tokens"]
        stats["flipped_tokens"] += flips
        stats["worst_gap_over_2delta"] = max(stats["worst_gap_over_2delta"], worst)
        return x.gather(-1, ids), ids

    moe.top_k = top_k
    try:
        yield stats
    finally:
        moe.top_k = real
    if forced:
        fail(f"forced routing: {len(forced)} recorded dispatches left over")


def _moe_summary(records: list) -> dict:
    return {"layers": len(records), "dropped_pairs": sum(r["dropped_pairs"] for r in records),
            "capacity": sorted({r["capacity"] for r in records}),
            "out_max_err": max((r["out_max_err"] for r in records), default=0.0)}


def family_cfg(run: dict, smoke: bool = False):
    from repro_torch.configs import get_config, get_smoke_config

    cfg = (get_smoke_config if smoke else get_config)(run["arch"]).replace(use_pallas=True)
    return cfg.replace(n_layers=run["layers"]) if run["layers"] and not smoke else cfg


def family_run(torch, counters, run: dict, device: str = "cuda", smoke: bool = False) -> dict:
    """Phase 19 for one model of :data:`FAMILY_RUNS` on ``device``: init
    (peak memory), the forward with kernels (exact launches, every flash
    call on the bf16 route, the MoE layers held to their plain versions),
    the plain forward replaying the kernel route's MoE routing (no launch,
    logits within the bf16 limit, its own choices moved only at near-ties),
    prefill against the forward, decode steps against plain decode
    attention, and ``serve_pool``; the counters zeroed just before each run
    and read just after.  With ``smoke`` the smoke config runs (the CPU
    tests)."""
    from repro_torch.launch import serve
    from repro_torch.models import encdec, get_model, moe, stub_inputs, transformer

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = family_cfg(run, smoke)
    pcfg = cfg.replace(use_pallas=False)
    api, plain = get_model(cfg), get_model(pcfg)
    arch, seq = run["arch"], run["seq"]
    out, launches = {"config": dict(run) | {"n_layers": cfg.n_layers}}, {}

    def peak():
        return torch.cuda.max_memory_allocated() if on_card else None

    def counted(path, fn):
        sync()
        zero_counters(counters)
        t0 = time.time()
        res = fn()
        sync()
        wall = time.time() - t0
        launches[path] = {c.__name__: c.launches for c in counters}
        return res, wall

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = api.init(FAMILY_SERVE["seed"], device)
    sync()
    out |= {"init_s": time.time() - t0, "init_peak_mem_bytes": peak(),
            "param_bytes": sum(t.numel() * t.element_size() for t in _leaves(params))}
    gen = torch.Generator(device=device).manual_seed(1)
    text = seq - (cfg.n_vis_tokens if cfg.family == "vlm" else 0)
    toks = torch.randint(1, cfg.vocab_size, (1, text), device=device, generator=gen)
    batch = {"tokens": toks} | stub_inputs(cfg, 1, device, gen)

    # the forward with kernels (each MoE layer held to its plain versions as
    # it runs), again (timed warm), then the plain route with the MoE routed
    # as the kernel route was (a routing that differs across the routes
    # moves a token's logits by O(1), so the bf16 limit holds the routes to
    # each other under one routing; each layer's own choice may move only at
    # a near-tie)
    with moe_checks(torch, moe) as kern_moe:
        (logits, _), walls = counted("forward", lambda: api.forward(params, batch, cfg))
    if on_card:
        check_launches(f"{arch} forward", launches["forward"],
                       family_launches(cfg, "forward", seq))
        if launches["forward"]["flash_attention"]:
            check_flash_routes(f"forward {arch}", launches["forward"], route_counts(counters))
    if not bool(torch.isfinite(logits).all()):
        fail(f"{arch} forward: logits not finite")
    _, wall2 = counted("forward again", lambda: api.forward(params, batch, cfg))
    del launches["forward again"]
    out |= {"forward_s_first": walls, "forward_s": wall2, "forward_tokens_per_s": seq / wall2,
            "forward_peak_mem_bytes": peak(), "logits_shape": list(logits.shape)}
    with forced_routing(moe, kern_moe) as flips:
        (want, _), plain_s = counted("plain forward",
                                     lambda: plain.forward(params, batch, pcfg))
    if cfg.family == "moe":
        out["moe"] = _moe_summary(kern_moe) | {"across_routes": flips}
    if any(launches["plain forward"].values()):
        fail(f"{arch} plain forward launched {launches['plain forward']}")
    close = _logits_close(logits, want, cfg.dtype)
    if not close["ok"]:
        fail(f"{arch} forward with kernels against the plain route: {close}"
             + (f"; moe {out['moe']}" if "moe" in out else ""))
    out |= {"plain_forward_s": plain_s, "vs_plain": close,
            "plain_equal_bitwise": bool(torch.equal(logits, want))}
    del want, kern_moe

    # decode steps from one state, against plain decode attention
    state = None
    if run["prefill"]:
        (plog, state), pre_s = counted("prefill", lambda: transformer.prefill(
            params, toks, cfg, prefix_embeds=batch.get("patch_embeds")))
        if on_card:
            check_launches(f"{arch} prefill", launches["prefill"],
                           family_launches(cfg, "prefill"))
        pclose = _logits_close(plog, logits[:, -1:], cfg.dtype)
        if not pclose["ok"]:
            fail(f"{arch} prefill: last logits against the forward's: {pclose}")
        out |= {"prefill_s": pre_s, "prefill_vs_forward": pclose,
                "prefill_peak_mem_bytes": peak(), "cache_capacity": int(state.caches.k.shape[2])}
        start = plog
    elif cfg.family == "encdec":
        with torch.inference_mode():
            enc = encdec.encode(params, batch["frames"], cfg)
        k, v = encdec.precompute_cross(params, enc, cfg)
        state = api.init_decode_state(1, run["capacity"], device)._replace(cross_k=k,
                                                                            cross_v=v)
        start = logits[:, -1:]
        del enc
    if state is not None:
        dec, worst = decode_after_prefill(torch, api, params, state, start, cfg, counters,
                                          FAMILY_DECODE_STEPS, sync,
                                          moe if cfg.family == "moe" else None)
        if on_card:
            check_launches(f"{arch} decode", dec,
                           family_launches(cfg, "decode", calls=FAMILY_DECODE_STEPS))
        launches["decode"] = dec
        out["decode_vs_plain"] = worst
        del state, start
    del logits

    # serving at B = 4: every request done, decode attention once per layer
    # per decode call
    if run["capacity"]:
        serve_cfg = FAMILY_SERVE | {"capacity": run["capacity"]}
        with config_cut(serve, cfg):
            served, _ = counted("serve", lambda: serve.serve_pool(
                arch=arch, smoke=smoke, device=device, params=params, **serve_cfg))
        if not served["all_done"]:
            fail(f"{arch} serve: not every request finished: {served}")
        if on_card:
            check_launches(f"{arch} serve", launches["serve"], family_launches(
                cfg, "decode", calls=decode_calls(**serve_cfg)))
        out["serve"] = served | {"config": serve_cfg, "decode_calls": decode_calls(**serve_cfg),
                                 "peak_mem_bytes": peak()}
    out["launches"] = launches
    out["peak_mem_bytes"] = peak()
    del params
    return out


FAMILY_SMOKE_TRAIN = dict(steps=1, batch=2, seq=64, base_lr=1e-3, warmup=1, total_steps=10)


def family_smoke_inputs(torch, arch: str, seq: int = FAMILY_SMOKE_SEQ) -> dict:
    """The smoke config of ``arch`` in float32 with kernels, its seeded
    weights on the cpu, two rows of tokens (the forward reads the first,
    ``seq`` positions with the VLM's prefix; xLSTM at most
    :data:`FAMILY_SMOKE_SEQ_NO_KERNEL`) and the stub inputs."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model, stub_inputs

    cfg = get_smoke_config(arch).replace(dtype="float32", use_pallas=True)
    params = get_model(cfg).init(7, "cpu")
    gen = torch.Generator().manual_seed(8)
    if cfg.family == "xlstm":
        seq = min(seq, FAMILY_SMOKE_SEQ_NO_KERNEL)
    text = seq - (cfg.n_vis_tokens if cfg.family == "vlm" else 0)
    toks = torch.randint(1, cfg.vocab_size, (2, text), generator=gen)
    return {"params": params, "toks": toks,
            "batch": {"tokens": toks[:1]} | stub_inputs(cfg, 1, "cpu", gen)}


def family_smoke_run(torch, arch: str, inputs: dict, device) -> dict:
    """The smoke checks' runs of ``arch`` on ``device`` from ``inputs``
    (:func:`family_smoke_inputs`' form): the forward's logits and each MoE
    layer's top-k ids, the logits of 4 decode steps (a row for each row of
    the tokens, capacity 16), one train step's loss (:func:`train_steps`,
    from weights seeded alike)."""
    from repro_torch.models import get_model, moe

    cfg = family_cfg({"arch": arch, "layers": None}, smoke=True).replace(dtype="float32")
    api = get_model(cfg)
    params, toks = _to(inputs["params"], device), inputs["toks"].to(device)
    with moe_checks(torch, moe) as routed:
        logits, _ = api.forward(params, _to(inputs["batch"], device), cfg)
    state, steps = api.init_decode_state(toks.shape[0], 16, device), []
    for t in range(FAMILY_SMOKE_DECODE):
        step, state = api.decode(params, state, toks[:, t:t + 1])
        steps.append(step.cpu())
    loss = train_steps(torch, cfg.replace(use_pallas=False), device, **FAMILY_SMOKE_TRAIN)[0][0]
    return {"forward": logits.cpu(), "top_ids": [r["top_ids"].cpu() for r in routed],
            "decode": steps, "loss": loss}


def smoke_cpu_refs(torch, path_in, path_out) -> None:
    """The child side of :func:`cpu_refs_in_child`: :func:`family_smoke_run`
    on the cpu for each arch of the inputs saved at ``path_in``, saved at
    ``path_out``."""
    inputs = torch.load(path_in)
    torch.save({arch: family_smoke_run(torch, arch, ins, "cpu") for arch, ins in inputs.items()},
               path_out)


def cpu_refs_in_child(torch, inputs: dict, work: pathlib.Path,
                      option: str = "--smoke-cpu-refs") -> dict:
    """:func:`family_smoke_run` on the cpu for each arch of ``inputs`` (any
    arch, in :func:`family_smoke_inputs`' form), or with ``option``
    ``--pipeline-cpu-ref`` :func:`pipeline_smoke_run` of the inputs of
    :func:`pipeline_smoke_inputs`, in a child process whose
    MKL keeps its conditional numerical reproducibility
    (``MKL_CBWR=COMPATIBLE``, read when MKL starts): otherwise MKL's float32
    products may round by the alignment of their buffers (ROADMAP.md
    Queue 3).  ``work`` holds the exchanged files while the child runs."""
    import os
    import shutil

    work.mkdir(parents=True, exist_ok=True)
    path_in, path_out = work / "inputs.pt", work / "refs.pt"
    torch.save(inputs, path_in)
    env = dict(os.environ, MKL_CBWR="COMPATIBLE", PYTHONPATH=str(SRC))
    child = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                            option, str(path_in), str(path_out)],
                           env=env, capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        fail(f"smoke cpu references: the child process failed: {child.stderr[-2000:]}")
    refs = torch.load(path_out)
    shutil.rmtree(work, ignore_errors=True)
    return refs


def family_smoke_phase(torch, archs, device: str = "cuda", seq: int = FAMILY_SMOKE_SEQ,
                       work: pathlib.Path = REPO / "build" / "chip_smoke" / "smoke_refs") -> dict:
    """Each smoke config of ``archs`` in float32 from the same seeded
    weights on the cpu (plain versions, in a child process with
    ``MKL_CBWR=COMPATIBLE``, :func:`cpu_refs_in_child`) and on ``device``
    (kernels): the forward at ``seq`` positions within atol 1e-4 with every
    MoE layer's routing ``==``, 4 decode steps within atol 1e-4, one train
    step's loss within atol 1e-4 (``tests/test_torch_model.py``,
    ``tests/test_torch_train.py``).
    The same cpu forward in this process is reported beside it (not gated):
    whether it parts from the child's, the lead of ROADMAP.md Queue 3."""
    from repro_torch.models import get_model

    inputs = {arch: family_smoke_inputs(torch, arch, seq) for arch in archs}
    refs, out = cpu_refs_in_child(torch, inputs, work), {}
    for arch in archs:
        got, want = family_smoke_run(torch, arch, inputs[arch], device), refs[arch]
        cfg = family_cfg({"arch": arch, "layers": None}, smoke=True).replace(dtype="float32")
        res = {"forward": _logits_close(got["forward"], want["forward"], "float32")}
        if not res["forward"]["ok"]:
            api = get_model(cfg)
            res["forward"]["diagnosis"] = diagnose_forward(
                torch, api, cfg, inputs[arch]["params"], _to(inputs[arch]["params"], device),
                inputs[arch]["toks"][:1], got["forward"], want["forward"],
                extras={k: v for k, v in inputs[arch]["batch"].items() if k != "tokens"})
        here, _ = get_model(cfg).forward(inputs[arch]["params"], inputs[arch]["batch"], cfg)
        res["forward_in_process"] = {
            "vs_card": _logits_close(got["forward"], here, "float32")["max_err"],
            "vs_child": float((here - want["forward"]).abs().max())}
        if len(got["top_ids"]) != len(want["top_ids"]) or not all(
                torch.equal(a, b) for a, b in zip(got["top_ids"], want["top_ids"])):
            fail(f"{arch} smoke cpu vs {device}: the MoE routing differs")
        res["moe_layers_equal"] = len(want["top_ids"])
        steps = [_logits_close(g, w, "float32") for g, w in zip(got["decode"], want["decode"])]
        res["decode"] = {"max_err": max(x["max_err"] for x in steps),
                         "ok": all(x["ok"] for x in steps)}
        loss_err = abs(got["loss"] - want["loss"])
        res["train"] = {"loss_err": loss_err, "ok": loss_err <= TRAIN_LOSS_TOL}
        for part in ("forward", "decode", "train"):
            if not res[part]["ok"]:
                fail(f"{arch} smoke cpu vs {device} (float32): {part} {res[part]}")
        out[arch] = res
    return out


def family_kernel_rows(torch, gen, kernels: list) -> None:
    """The kernel shapes phase 19's models launch that no earlier phase
    times, each against its plain version and the library call, added to the
    kernel rows as sub-rows under the model's name: flash attention at head
    dim 128 (mixtral-8x7b under its window at S = 8192, internvl2-26b G = 6,
    arctic-480b G = 7), decode attention at the serve runs' live slots
    (mixtral G = 4, internvl2 G = 6, whisper-large-v3 hd 64, G = 1), RMSNorm
    at 4096 rows of mixtral's, internvl2's and arctic's widths."""
    from repro_torch.configs import get_config

    rows = {k["name"]: k for k in kernels}
    last = FAMILY_SERVE["prompt_len"] + FAMILY_SERVE["max_new"] - 1
    capacity = {run["arch"]: run["capacity"] for run in FAMILY_RUNS}
    for arch, S in (("mixtral-8x7b", 8192), ("internvl2-26b", FWD_S), ("arctic-480b", FWD_S)):
        c = get_config(arch)
        row = check_flash(torch, gen, c.n_heads, c.n_kv_heads, c.head_dim, c.sliding_window, S)
        rows["flash_attention"].setdefault("families", {})[arch] = _sub_row(row)
        torch.cuda.empty_cache()
    for arch in ("mixtral-8x7b", "internvl2-26b", "whisper-large-v3"):
        c = get_config(arch)
        row = check_decode(torch, gen, arch, c.n_heads, c.n_kv_heads, c.head_dim,
                           c.sliding_window, C=capacity[arch], last_pos=last,
                           kinds=("serve_live",))
        rows["decode_attention"].setdefault("families", {})[arch] = _sub_row(row)
        torch.cuda.empty_cache()
    for arch in ("mixtral-8x7b", "internvl2-26b", "arctic-480b"):
        c = get_config(arch)
        d = c.d_model
        xs = (torch.randn((cold_ring(2 * 2 * FWD_S * d), FWD_S, d), generator=gen,
                          device="cuda") * 0.5).to(torch.bfloat16)
        sc = 1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda") * 0.5
        rows["rmsnorm"].setdefault("families", {})[arch] = _sub_row(
            check_rmsnorm(torch, xs, sc, c.norm_eps))
        del xs
        torch.cuda.empty_cache()


def families_phase(torch, counters, card, kernels=None, gen=None, device: str = "cuda",
                   runs=FAMILY_RUNS, smoke: bool = False,
                   smoke_seq: int = FAMILY_SMOKE_SEQ) -> dict:
    """Phase 19 on ``device``: the new kernel shapes timed (``kernels``'s
    sub-rows, on the card), each model of ``runs`` (:func:`family_run`),
    freed before the next, then the smoke configs cpu against ``device``."""
    import gc

    on_card = torch.device(device).type == "cuda"
    out, by_path = {"card": card, "models": {}}, {}
    if kernels is not None:
        t0 = time.time()
        family_kernel_rows(torch, gen, kernels)
        out["kernels_s"] = time.time() - t0
        for k in kernels:
            for arch, w in k.get("families", {}).items():
                lib = "n/a" if w["library_ms"] is None else f"{w['library_ms']:.4f} ms"
                say(f"phase families: {k['name']} {arch} {w['shape']}: {w['ms']:.4f} ms device "
                    f"(host {w['host_us']:.1f} us), plain {w['plain_ms']:.4f} ms, bound "
                    f"{w['bound_ms']:.4f} ms by {w['bound_by']}, library {lib}; max abs err "
                    f"{w['max_abs_err']:.3g}; {card}")
    for run in runs:
        t0 = time.time()
        res = family_run(torch, counters, run, device, smoke)
        res["phase_s"] = time.time() - t0
        out["models"][run["arch"]] = res
        for path, counts in res["launches"].items():
            by_path[f"{run['arch']} {path}"] = counts
        served = res.get("serve", {})
        say(f"phase families: {run['arch']} {res['config']['n_layers']} layers S={run['seq']}: "
            f"init {res['init_s']:.1f} s (peak {res['init_peak_mem_bytes']} B, params "
            f"{res['param_bytes']} B); forward {res['forward_s']:.3f} s "
            f"({res['forward_tokens_per_s']:.0f} tokens/s; first {res['forward_s_first']:.3f} "
            f"s), plain {res['plain_forward_s']:.3f} s, vs plain {res['vs_plain']}"
            + (f"; moe {res['moe']}" if "moe" in res else "")
            + (f"; prefill {res['prefill_s']:.3f} s vs forward {res['prefill_vs_forward']}"
               if "prefill_s" in res else "")
            + (f"; {FAMILY_DECODE_STEPS} decode steps vs plain {res['decode_vs_plain']}"
               if "decode_vs_plain" in res else "")
            + (f"; serve {served['tokens_generated']} tokens in {served['decode_steps']} steps, "
               f"{served['wall_s']:.3f} s ({served['tokens_per_s']:.2f} tokens/s)" if served
               else "")
            + f"; peak {res['peak_mem_bytes']} B; launches "
            f"{ {p: {k: n for k, n in c.items() if n} for p, c in res['launches'].items()} }; "
            f"{card}")
        del res
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    t0 = time.time()
    out["smoke_cpu_vs_card"] = family_smoke_phase(torch, [r["arch"] for r in runs], device,
                                                  smoke_seq)
    out["smoke_cpu_vs_card_s"] = time.time() - t0
    for arch, res in out["smoke_cpu_vs_card"].items():
        say(f"phase families: {arch} smoke float32 cpu (a child with MKL_CBWR=COMPATIBLE) "
            f"vs {device}: {res}")
    out["by_path"] = by_path
    return out


# phase 20: the planner's stage plan run as a pipeline.  qwen3-4b at full
# width, all 36 layers, bf16 weights loaded as serving loads them (the phase
# takes gradients but runs no optimizer step), B = 4 sequences of 2,048 in
# M = 4 microbatches of 1.  The plan: the auto portfolio over the pod
# platform of 4 pods with pod 2 twice as fast (``tpu_pod_platform(4,
# degraded={2: 0.5})``), which the reference plans as (15, 7, 7, 7) on pods
# (2, 0, 1, 3); every pod on the one card (a mesh of 4 stage slots naming it)
PIPELINE = {"arch": "qwen3-4b", "smoke": False, "batch": 4, "seq": 2048, "microbatches": 4,
            "pods": 4, "degraded": {2: 0.5}, "seed": 7}
PIPELINE_PLAN = ((15, 7, 7, 7), (2, 0, 1, 3))
# the pipelined loss against the sequential one: the reference's bound
# (tests/test_pipeline_runtime.py:86); gradients of each layer's slot, of the
# embedding and of the final norm by relative norm (a microbatch's bf16
# products round apart from the whole batch's in the last bits); the kernel
# pass's loss against the plain pass's (besides, each microbatch's logits by
# :func:`_logits_close` and every kernel call against its plain version on
# its own inputs by :func:`_within`)
PIPELINE_LOSS_TOL, PIPELINE_GRAD_RTOL, PIPELINE_KERNEL_TOL = 2e-3, 1e-2, 1e-2
# the smoke config in float32, cpu against the card: the loss and every
# gradient within atol 1e-4
PIPELINE_SMOKE = {"batch": 4, "seq": 256, "microbatches": 4}
PIPELINE_SMOKE_TOL = 1e-4


def pipeline_plan(core, cfg, run: dict, device):
    """The auto portfolio's period plan of ``cfg`` at the run's batch and
    length over its pod platform, scored on ``device``."""
    from repro_torch.models import lm_workload
    from repro_torch.models.common import ShapeSpec

    wl = lm_workload(cfg, ShapeSpec("pipeline", "train", run["seq"], run["batch"]))
    pf = core.tpu_pod_platform(run["pods"], degraded=run["degraded"])
    return core.plan(wl, pf, core.Objective("period"), mode="auto", device=device)


def check_pipeline_plan(pl, want) -> None:
    got = (tuple(pl.stage_sizes), tuple(pl.mapping.alloc))
    if got != (tuple(want[0]), tuple(want[1])):
        fail(f"pipeline plan: stages {got[0]} on pods {got[1]}, expected {tuple(want[0])} on "
             f"pods {tuple(want[1])}")


def pipeline_launches(cfg, microbatches: int, seq: int) -> dict:
    """The kernels the pipeline's kernel pass launches: in every live layer
    step RMSNorm before attention and before the FFN, and flash attention
    where its gate passes; the final norm keeps the plain formula, as the
    reference's (``repro/pipeline/runtime.py:140``) does."""
    steps = cfg.n_layers * microbatches
    return dict.fromkeys(KERNEL_NAMES, 0) | {
        "rmsnorm": 2 * steps, "flash_attention": steps if flash_gate(seq, seq) else 0}


def _paths(tree, prefix: str = "") -> dict:
    """The leaves of nested dicts by '/'-joined key path."""
    if isinstance(tree, dict):
        return {k: v for name in sorted(tree)
                for k, v in _paths(tree[name], f"{prefix}{name}/").items()}
    return {prefix.rstrip("/"): tree}


def pipeline_grads(torch, loss_fn, params, batch) -> tuple:
    """(loss, {path: gradient}) of ``loss_fn(params, batch)`` with respect
    to every leaf of ``params`` (zeros where a leaf does not reach it)."""
    flat = _paths(params)
    leaves = list(flat.values())
    try:
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return float(loss.detach()), dict(zip(flat, grads))


def _rel(torch, got: list, want: list) -> float:
    num = sum(float(((g.float() - w.float()) ** 2).sum()) for g, w in zip(got, want))
    den = sum(float((w.float() ** 2).sum()) for w in want)
    return math.sqrt(num / den) if den else (0.0 if num == 0 else math.inf)


def check_pipeline_grads(torch, loss, grads, seq_loss, seq_grads, pl, mask) -> dict:
    """The pipelined loss and gradients against the sequential ones: the
    loss within :data:`PIPELINE_LOSS_TOL`; each real layer's slot (its
    leaves together), the embedding and the final norm within
    :data:`PIPELINE_GRAD_RTOL` by relative norm; every masked slot's
    gradient (the padding, an unenrolled pod's whole stack) exactly 0."""
    names = sorted(k.removeprefix("stages/") for k in grads if k.startswith("stages/"))
    starts = [0]
    for size in pl.stage_sizes[:-1]:
        starts.append(starts[-1] + size)
    slots = {}
    for j, (start, size) in enumerate(zip(starts, pl.stage_sizes)):
        pod = pl.mapping.alloc[j]
        for k in range(size):
            slots[f"layer {start + k} (pod {pod} slot {k})"] = _rel(
                torch, [grads[f"stages/{n}"][pod, k] for n in names],
                [seq_grads[f"layers/{n}"][start + k] for n in names])
    head = {k: _rel(torch, [grads[k]], [seq_grads[k]]) for k in grads
            if not k.startswith("stages/")}
    dead = ~mask
    nonzero = [n for n in names if grads[f"stages/{n}"][dead.to(grads[f"stages/{n}"].device)].any()]
    out = {"loss": loss, "seq_loss": seq_loss, "loss_err": abs(loss - seq_loss),
           "worst_slot": max(slots.items(), key=lambda kv: kv[1]), "head": head,
           "masked_slots": int(dead.sum()), "masked_nonzero": nonzero}
    if out["loss_err"] > PIPELINE_LOSS_TOL:
        fail(f"pipeline: loss {loss} against the sequential {seq_loss} (limit "
             f"{PIPELINE_LOSS_TOL})")
    if out["worst_slot"][1] > PIPELINE_GRAD_RTOL or max(head.values()) > PIPELINE_GRAD_RTOL:
        fail(f"pipeline: gradients against the sequential ones: worst slot "
             f"{out['worst_slot']}, head {head} (limit {PIPELINE_GRAD_RTOL})")
    if nonzero:
        fail(f"pipeline: masked slots carry a gradient in {nonzero}")
    return out


def pipeline_smoke_inputs(torch, arch: str, smoke: dict = PIPELINE_SMOKE) -> dict:
    """The smoke config of ``arch`` in float32: seeded master weights on the
    cpu and a batch of ``smoke``'s shape."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model

    cfg = get_smoke_config(arch).replace(dtype="float32")
    gen = torch.Generator().manual_seed(9)
    B, S = smoke["batch"], smoke["seq"]
    return {"arch": arch, "params": get_model(cfg).init(7, "cpu", master=True),
            "tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen),
            "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=gen)} | smoke


def pipeline_smoke_run(torch, inputs: dict, device) -> dict:
    """The smoke pipeline of ``inputs`` (:func:`pipeline_smoke_inputs`) on
    ``device``: its plan (scored on ``device``), loss and gradients."""
    from repro_torch import core
    from repro_torch.configs import get_smoke_config
    from repro_torch.pipeline import runtime

    cfg = get_smoke_config(inputs["arch"]).replace(dtype="float32")
    run = dict(PIPELINE, batch=inputs["batch"], seq=inputs["seq"])
    pl = pipeline_plan(core, cfg, run, device)
    params = _to(inputs["params"], device, copy=True)
    stages, mask = runtime.make_stage_params(params["layers"], pl, run["pods"])
    lf = runtime.pipelined_loss_fn(cfg, pl, inputs["microbatches"], mask)
    loss, grads = pipeline_grads(
        torch, lf, {"embed": params["embed"], "stages": stages, "ln_f": params["ln_f"]},
        {k: inputs[k].to(device) for k in ("tokens", "labels")})
    return {"plan": [list(pl.stage_sizes), list(pl.mapping.alloc)], "loss": loss,
            "grads": {k: g.cpu() for k, g in grads.items()}}


def pipeline_cpu_ref(torch, path_in, path_out) -> None:
    """The child side of the smoke comparison: :func:`pipeline_smoke_run` on
    the cpu for the inputs saved at ``path_in``, saved at ``path_out``."""
    torch.save(pipeline_smoke_run(torch, torch.load(path_in), "cpu"), path_out)


def pipeline_order(pl, microbatches: int) -> list:
    """The pod of each live stage step in the executor's order (tick, then
    chain position): at tick ``t`` the pod at chain position ``j`` runs
    microbatch ``t - j``."""
    from repro_torch.pipeline.schedule import gpipe_ticks

    m = pl.num_stages
    return [pl.mapping.alloc[j] for t in range(gpipe_ticks(m, microbatches)) for j in range(m)
            if 0 <= t - j < microbatches]


@contextlib.contextmanager
def pipeline_recording(torch, events=None, logits=None, kernel_calls=None):
    """Watches the pipelined loss from outside the runtime while open: a
    (start, end) CUDA event pair around each stage body
    (``runtime._stage_fn``) appended to ``events``; each microbatch's logits
    (``runtime.unembed``) appended to ``logits``; every flash attention and
    RMSNorm call held to its plain version on the same inputs
    (:func:`_within`), (name, max abs err, within) appended to
    ``kernel_calls``."""
    from repro_torch.kernels import ops, ref
    from repro_torch.pipeline import runtime

    stage, head, flash, rms = runtime._stage_fn, runtime.unembed, ops.flash_attention, ops.rmsnorm

    def stage_rec(*a):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = stage(*a)
        end.record()
        events.append((start, end))
        return y

    def head_rec(*a):
        y = head(*a)
        logits.append(y)
        return y

    def check(name, got, want):
        ok, err = _within(torch, got, want)
        kernel_calls.append((name, err, ok))
        return got

    def flash_rec(q, k, v, **kw):
        return check("flash_attention", flash(q, k, v, **kw),
                     ref.flash_attention_ref(q, k, v, **kw))

    def rms_rec(x, scale, *, eps):
        return check("rmsnorm", rms(x, scale, eps=eps), ref.rmsnorm_ref(x, scale, eps=eps))

    if events is not None:
        runtime._stage_fn = stage_rec
    if logits is not None:
        runtime.unembed = head_rec
    if kernel_calls is not None:
        ops.flash_attention, ops.rmsnorm = flash_rec, rms_rec
    try:
        yield
    finally:
        runtime._stage_fn, runtime.unembed = stage, head
        ops.flash_attention, ops.rmsnorm = flash, rms


def pipeline_kernel_pass(torch, counters, cfg, pl, M: int, mask, mesh, params, batch,
                         device) -> dict:
    """The pipelined loss under ``inference_mode`` three times: with
    ``use_pallas`` (counters zeroed just before and read just after: on the
    card :func:`pipeline_launches` exactly, every flash call on the bf16
    route); again with every flash attention and RMSNorm call held to its
    plain version on its own inputs (as many calls of each as
    :func:`pipeline_launches` counts); then with the plain versions: each
    microbatch's logits held to the kernel pass's by :func:`_logits_close`'s
    criterion and the loss within :data:`PIPELINE_KERNEL_TOL`.  On the card
    each pod's stage bodies are timed by CUDA events in the first and the
    last pass."""
    from repro_torch.pipeline import runtime

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    kcfg = cfg.replace(use_pallas=True)
    want = pipeline_launches(cfg, M, batch["tokens"].shape[1])
    order = pipeline_order(pl, M)
    out = {}

    def timed(c, name, logits, counted=False):
        events = [] if on_card else None
        with pipeline_recording(torch, events=events, logits=logits):
            sync()
            if counted:
                zero_counters(counters)
            t0 = time.time()
            loss = float(runtime.pipelined_loss_fn(c, pl, M, mask, mesh=mesh)(params, batch))
            sync()
            wall = time.time() - t0
        ms = None
        if on_card:
            ms = dict.fromkeys(sorted(set(order)), 0.0)
            for pod, (start, end) in zip(order, events):
                ms[pod] += start.elapsed_time(end)
        out[name] = {"loss": loss, "wall_s": wall, "stage_ms": ms}

    with torch.inference_mode():
        klogits, plogits, calls = [], [], []
        timed(kcfg, "kernel", klogits, counted=True)
        klaunches = {c.__name__: c.launches for c in counters}
        routes = route_counts(counters)
        with pipeline_recording(torch, kernel_calls=calls):
            runtime.pipelined_loss_fn(kcfg, pl, M, mask, mesh=mesh)(params, batch)
        timed(cfg, "plain", plogits)
        close = [_logits_close(k, p, cfg.dtype) for k, p in zip(klogits, plogits)]
        del klogits, plogits
    if on_card:
        check_launches("pipeline kernel pass", klaunches, want)
        check_flash_routes("pipeline kernel pass", klaunches, routes)
    checked = {name: [c for c in calls if c[0] == name] for name in ("flash_attention", "rmsnorm")}
    out |= {"launches": klaunches, "routes": routes, "logits": close,
            "checked_calls": {n: len(c) for n, c in checked.items()},
            "kernel_vs_plain_max_err": {n: max((c[1] for c in cs), default=None)
                                        for n, cs in checked.items()}}
    if {n: len(c) for n, c in checked.items()} != {n: want[n] for n in checked}:
        fail(f"pipeline kernel pass: kernel calls {out['checked_calls']}, expected "
             f"{ {n: want[n] for n in checked} }")
    bad = [c for c in calls if not c[2]]
    if bad:
        fail(f"pipeline kernel pass: {len(bad)} kernel calls differ from their plain versions "
             f"on their own inputs, first {bad[:4]}")
    if len(close) != M or not all(c["ok"] for c in close):
        fail(f"pipeline kernel pass: logits against the plain pass's per microbatch {close}")
    err = abs(out["kernel"]["loss"] - out["plain"]["loss"])
    if not err <= PIPELINE_KERNEL_TOL:
        fail(f"pipeline kernel pass: loss {out['kernel']['loss']} against the plain pass's "
             f"{out['plain']['loss']} (limit {PIPELINE_KERNEL_TOL})")
    return out


def pipeline_phase(torch, counters, card, device: str = "cuda", run: dict = PIPELINE,
                   want_plan=PIPELINE_PLAN, score_counters=(), smoke: dict = PIPELINE_SMOKE,
                   work: pathlib.Path = REPO / "build" / "chip_smoke" / "pipeline_ref") -> dict:
    """Phase 20 on ``device``: the plan of ``run``'s model over its pods
    (``score_counters`` zeroed just before and read just after), ``==``
    ``want_plan``; serving-loaded weights packed into the pods' stacks, all
    pods on ``device`` through a mesh naming it once per pod; the
    sequential loss and gradients, then the pipelined ones twice (cold,
    warm; the model counters zeroed just before and read just after: no
    launch), held to the sequential ones (:func:`check_pipeline_grads`);
    the kernel pass (:func:`pipeline_kernel_pass`); then the
    smoke config in float32, the cpu side in a child process with
    ``MKL_CBWR=COMPATIBLE``: the plan ``==``, loss and gradients within
    :data:`PIPELINE_SMOKE_TOL`."""
    from repro_torch import core
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.pipeline import runtime

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = (get_smoke_config if run["smoke"] else get_config)(run["arch"])
    M, B, S, P = run["microbatches"], run["batch"], run["seq"], run["pods"]
    out, by_path = {"card": card, "config": dict(run)}, {}

    # the plan, scored on the device
    sync()
    zero_counters(score_counters)
    t0 = time.time()
    pl = pipeline_plan(core, cfg, run, device)
    sync()
    by_path["pipeline plan"] = {SCORE_ROWS[c.__name__]: c.launches for c in score_counters}
    out["plan"] = {"stage_sizes": list(pl.stage_sizes), "pods": list(pl.mapping.alloc),
                   "planner": pl.planner, "period": pl.period, "latency": pl.latency,
                   "max_stage_size": pl.max_stage_size,
                   "padding_overhead": pl.padding_overhead, "wall_s": time.time() - t0,
                   "launches": by_path["pipeline plan"]}
    say(f"phase pipeline: {cfg.arch_id} {cfg.n_layers} layers B={B} S={S} over {P} pods "
        f"(degraded {run['degraded']}): plan {pl.planner} stages {pl.stage_sizes} on pods "
        f"{pl.mapping.alloc}, period {pl.period!r}, latency {pl.latency!r}, padding "
        f"{pl.padding_overhead:.3f}; launches {by_path['pipeline plan']}; {card}")
    check_pipeline_plan(pl, want_plan)

    # serving's weights, packed; a mesh of P stage slots on the one device
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = get_model(cfg).init(run["seed"], device)
    stages, mask = runtime.make_stage_params(params["layers"], pl, P)
    gen = torch.Generator(device=device).manual_seed(run["seed"] + 1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), device=device, generator=gen)
             for k in ("tokens", "labels")}
    mesh = make_mesh((P,), ("stage",), devices=[device] * P)

    # the sequential reference first; then the unpacked layers go
    sync()
    t0 = time.time()
    seq_loss, seq_grads = pipeline_grads(torch, runtime.sequential_loss_fn(cfg), params, batch)
    sync()
    out["sequential_s"] = time.time() - t0
    pipe_params = {"embed": params["embed"], "stages": stages, "ln_f": params["ln_f"]}
    del params
    lf = runtime.pipelined_loss_fn(cfg, pl, M, mask, mesh=mesh)
    walls, grads = [], None
    zero_counters(counters)
    for _ in range(2):          # cold, then warm
        grads = None
        sync()
        t0 = time.time()
        loss, grads = pipeline_grads(torch, lf, pipe_params, batch)
        sync()
        walls.append(time.time() - t0)
    launches = {c.__name__: c.launches for c in counters}
    by_path["pipeline train"] = launches
    if any(launches.values()):
        fail(f"pipeline: the gradient pass launched {launches}; it runs the plain versions")
    out["grad"] = check_pipeline_grads(torch, loss, grads, seq_loss, seq_grads, pl, mask)
    out["grad"] |= {"wall_s_cold": walls[0], "wall_s_warm": walls[1],
                    "tokens_per_s_warm": B * S / walls[1],
                    "peak_mem_bytes": torch.cuda.max_memory_allocated() if on_card else None,
                    "launches": launches}
    del grads, seq_grads
    g = out["grad"]
    say(f"phase pipeline: gradient pass M={M}: loss {g['loss']!r} vs sequential "
        f"{g['seq_loss']!r} (err {g['loss_err']:.3g}, limit {PIPELINE_LOSS_TOL}); worst slot "
        f"{g['worst_slot'][0]} rel {g['worst_slot'][1]:.3g}, embed/ln_f "
        f"{ {k: round(v, 6) for k, v in g['head'].items()} } (limit {PIPELINE_GRAD_RTOL}); "
        f"{g['masked_slots']} masked slots all 0; wall cold {walls[0]:.3f} s, warm "
        f"{walls[1]:.3f} s ({g['tokens_per_s_warm']:.0f} tokens/s), sequential "
        f"{out['sequential_s']:.3f} s; peak {g['peak_mem_bytes']} B; launches {launches}; "
        f"{card}")

    # the kernel pass, checked call by call and against the plain pass
    kp = out["kernel_pass"] = pipeline_kernel_pass(torch, counters, cfg, pl, M, mask, mesh,
                                                   pipe_params, batch, device)
    by_path["pipeline kernel pass"] = kp["launches"]
    worst = {k: max(c[k] for c in kp["logits"]) for k in ("max_err", "mean_rel_err")}
    say(f"phase pipeline: kernel pass loss {kp['kernel']['loss']!r}, plain pass "
        f"{kp['plain']['loss']!r} (err {abs(kp['kernel']['loss'] - kp['plain']['loss']):.3g}, "
        f"limit {PIPELINE_KERNEL_TOL}); logits per microbatch worst {worst} (bf16 limits 0.35, "
        f"0.05); {kp['checked_calls']} kernel calls each within its plain version on its own "
        f"inputs (worst {kp['kernel_vs_plain_max_err']}); wall {kp['kernel']['wall_s']:.3f} s, "
        f"plain {kp['plain']['wall_s']:.3f} s; forward stage ms per pod {kp['kernel']['stage_ms']}"
        f", plain {kp['plain']['stage_ms']}; launches {kp['launches']}; {card}")
    del pipe_params, stages
    if on_card:
        torch.cuda.empty_cache()

    # the smoke config in float32, cpu (a child process) against the device
    inputs = pipeline_smoke_inputs(torch, run["arch"], smoke)
    want = cpu_refs_in_child(torch, inputs, work, "--pipeline-cpu-ref")
    got = pipeline_smoke_run(torch, inputs, device)
    if got["plan"] != want["plan"]:
        fail(f"pipeline smoke: plan {got['plan']} on {device} against {want['plan']} on cpu")
    errs = {k: float((g - want["grads"][k]).abs().max()) for k, g in got["grads"].items()}
    res = {"plan": got["plan"], "loss": got["loss"], "cpu_loss": want["loss"],
           "loss_err": abs(got["loss"] - want["loss"]), "grad_err": max(errs.values())}
    if res["loss_err"] > PIPELINE_SMOKE_TOL or res["grad_err"] > PIPELINE_SMOKE_TOL:
        fail(f"pipeline smoke cpu vs {device} (float32): {res}, per leaf {errs} (limit "
             f"{PIPELINE_SMOKE_TOL})")
    out["smoke_cpu_vs_card"] = res
    say(f"phase pipeline: smoke float32 B={smoke['batch']} S={smoke['seq']} M="
        f"{smoke['microbatches']}, plan {got['plan']}: cpu (a child with MKL_CBWR=COMPATIBLE) "
        f"vs {device}: loss err {res['loss_err']:.3g}, worst gradient err "
        f"{res['grad_err']:.3g} (limit {PIPELINE_SMOKE_TOL})")
    out["by_path"] = by_path
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=pathlib.Path, default=None,
                    help="also write every measured number to this file")
    ap.add_argument("--smoke-cpu-refs", nargs=2, type=pathlib.Path, default=None,
                    metavar=("IN", "OUT"), help=argparse.SUPPRESS)
    ap.add_argument("--pipeline-cpu-ref", nargs=2, type=pathlib.Path, default=None,
                    metavar=("IN", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.smoke_cpu_refs is not None or args.pipeline_cpu_ref is not None:
        import torch        # phases 19 and 20's cpu sides, each in its own process

        sys.path.insert(0, str(SRC))
        if args.smoke_cpu_refs is not None:
            smoke_cpu_refs(torch, *args.smoke_cpu_refs)
        else:
            pipeline_cpu_ref(torch, *args.pipeline_cpu_ref)
        return
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

    # 17. serving's planner hooks and prefill: plan_serving card against cpu,
    # serve_pool with pods and replanning, prefill with kernels against the
    # forward and decode after it, prefill cpu against the card; each run's
    # counters zeroed just before and read just after
    t0 = time.time()
    report["serve_prefill"] = serve_prefill_phase(
        torch, split_score, heuristics, counters, cfg, card, report["forward"],
        smoke_cfg=get_smoke_config(ARCH).replace(dtype="float32", use_pallas=True))
    report["serve_prefill"]["phase_s"] = time.time() - t0
    for label, counts in report["serve_prefill"].pop("by_path").items():
        by_path[f"{ARCH} {label}"] = counts
    torch.cuda.empty_cache()

    # 18. training at full width cut to 4 layers: uninterrupted, crashed after
    # a checkpoint, resumed; then the smoke config cpu against the card
    t0 = time.time()
    report["train"] = train_phase(torch, counters, card,
                                  smoke_cfg=get_smoke_config(ARCH).replace(dtype="float32"))
    report["train"]["phase_s"] = time.time() - t0
    by_path[f"{ARCH} train"] = report["train"]["launches"]
    torch.cuda.empty_cache()

    # 19. the MoE, VLM, enc-dec and xLSTM families at full width (depth cut
    # where the weights would not fit): the new kernel shapes timed, then
    # each model's forward with kernels against the plain route, prefill,
    # decode against plain decode attention and serving, each run's counters
    # zeroed just before and read just after; then the smoke configs cpu
    # against the card
    t0 = time.time()
    report["families"] = families_phase(torch, counters, card, kernels, gen)
    report["families"]["phase_s"] = time.time() - t0
    by_path.update(report["families"].pop("by_path"))
    say(f"phase families: {report['families']['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # 20. the planner's stage plan run as a pipeline: qwen3-4b's plan over 4
    # pods (the split-score counters zeroed just before and read just after),
    # the packed stacks on one card, the gradient pass against the sequential
    # loss, the kernel pass (the model counters zeroed just before and read
    # just after); then the smoke config cpu against the card
    t0 = time.time()
    report["pipeline"] = pipeline_phase(torch, counters, card, score_counters=score_counters)
    report["pipeline"]["phase_s"] = time.time() - t0
    by_path.update(report["pipeline"].pop("by_path"))
    say(f"phase pipeline: {report['pipeline']['phase_s']:.1f} s")

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
