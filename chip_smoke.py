#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Drives the port's paths on the card and checks them: the Section-5
campaign planner, serving qwen3-4b at full width, the hybrid zamba2-7b at
full width, the planner API and its reliability extensions, the fleet
replanning service, serving's planner hooks with prefill, training, the
MoE, VLM, enc-dec and xLSTM families, the planner's stage plan run as a
pipeline, the mesh's data and model axes in execution, the dry run held
against a real run, tensor parallelism over the model axis, and decode over
the mesh for every family (``repro_torch``), in twenty-six phases; any
failure exits
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
              block recomputed), 3 steps on cuda: step time and peak memory;
              then ``train_loop`` of the smoke config, B = 2, S = 128, 3
              steps, again with a checkpoint after step 1 and
              ``fail_at_step=1``, then resumed from that checkpoint: every
              loss finite, the resumed step-2 loss equal to the uninterrupted
              run's, no hand-written kernel launched in any of these runs
              (the reference trains through the plain versions); then the
              smoke config in float32, 3 steps on cpu
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
 21. mesh   — every slot of each mesh on the one card (``use_mesh``), each
              data slot tensor-parallel over its model slots: (a)
              ``prefill`` of qwen2.5-14b whole (48 layers, 40 / 8 heads),
              B = 2, S = 4096, with kernels on a (2, 16) data x model mesh:
              40 heads on the 16-way axis: model slot 0 takes each layer's
              projections whole and runs sequence-parallel attention, the
              FFN and the vocabulary split over the 16 slots; exactly
              2 x (48 + 16 x 49) RMSNorm launches (model slot 0 before the
              attention, every model slot before its FFN block and at the
              end), no flash; the collective calls per kind exactly those
              derived from ``param_specs`` (``mesh_collective_calls``: 2 x
              12 + 1 scatters of the views and tokens plus 3 a layer per
              data slot for sequence-parallel attention, ...); logits
              within phase 12's bf16 limit of the
              single-device prefill's from the same weights, the caches
              ``==`` in layout; a second pass with every RMSNorm call held
              to its plain version and every sequence-parallel call to
              one-device ``blocked_attention`` on its own inputs; (b) the
              forward of mixtral-8x7b cut to 8 layers, B = 4, S = 2048, on
              (4, 2): one MoE dispatch group per data slot, 4 experts per
              model slot, 4 x 2 x 17 RMSNorm and 4 x 2 x 8 flash launches
              (bf16 route, 16 / 4 heads each), the collective calls
              exactly derived, each MoE call held to the
              single G = 4 dispatch on its inputs with the layer's weights
              whole (kept pairs ``==``, outputs within the bf16 limit, a
              routing that differs only at a near-tie) and every kernel call
              to its plain version; (c) one FSDP train step of qwen3-4b cut
              to 4 layers (``fsdp_params``, 2 microbatches), B = 4, S =
              1024, on (2, 4), state placed by ``zero1_specs``, against one
              unsharded step from the same state and batch: loss and every
              parameter within 5e-3 (the reference's check, in bf16); from
              the same seeded state in float32 those and the grad norm and
              first moments within 1e-2 by relative norm, each leaf the
              model axis replicates within 0.1 (in bf16 the model slots'
              partial sums round apart, and this model's gradient
              amplifies any such reordering); wall and step times, peak
              memory, the bytes one slot holds.
 22. dryrun — the dry run (``repro_torch.launch.dryrun.run_cell``) held
              against the card: (a) qwen3-4b prefill at full width, B = 1,
              S = 4096, ``use_pallas``, on a one-slot mesh (the reference's
              prefill cell: the forward's logits), run on the card and on
              meta under the op analysis: dot flops, bytes, bytes by kind
              and launches ``==`` (73 RMSNorm and 36 flash, as phase 8's
              forward, and the wrappers' counters the same); the predicted
              per-slot peak (arguments + temp) within 1 % of
              ``torch.cuda.max_memory_allocated`` less what the process held
              before the cell; the step time against
              max(compute, memory) at the card's peaks, reported; (b) phase
              21(c)'s FSDP step on its (2, 4) mesh, card and meta: the
              collectives (bytes and calls per kind) ``==``; (c) on meta,
              after the phases whose host times are end-to-end metrics, in
              three child processes at once, joined after phase 26 (phases
              23-26 run beside them): qwen3-4b ``train_4k`` on pod16x16 cut to
              12 of 36 layers and ``run_pipeline_cell`` at straggler 1.0 and
              2.0 over 4 microbatches, each plan
              covering every layer, each record's per-slot memory,
              ``fits``, dot TFLOP, collective GB and plan printed.  The
              mesh cells take the symmetric data-slot shortcut (data slot
              0's model slots, counted once per data slot), card and meta
              alike.
 23. tp     — tensor parallelism over the model axis, every slot on the one
              card: (a) qwen3-4b whole (36 layers, 32 / 8 heads), B = 2,
              S = 4096, with kernels on (2, 16): ``prefill`` and the
              forward, each with the counters zeroed just before and read
              just after: exactly 2 x 16 x 73 RMSNorm launches each and
              2 x 16 x 36 flash in the forward (bf16 route), every flash
              call at one model slot's 2 query heads and the one K/V head
              they read (8 K/V heads on 16 slots: their head_dim split, each
              slot's head all-gathered: 2 x 8 all-gathers a layer per data
              slot), every collective call count exactly derived; a second
              forward with every kernel
              call held to its plain version, no op reading more than one
              model slot's block of a split weight nor making a whole one
              (``param_guard``); logits of both within phase 12's bf16
              limit of the single-device prefill's and forward's, the caches
              ``==`` in layout; (b) phase 21(b)'s checks on mixtral-8x7b cut
              to 8 layers, B = 2, S = 2048, on (1, 16): 8 experts on 16
              slots, each expert's ff split (896 of 14,336 columns a slot),
              16 x 17 RMSNorm and 16 x 8 flash (2 / 1 heads); (c) phase
              21(c)'s step under the op analysis: the same bounds, one
              slot's bytes of state and of weights gathered over ``data``,
              and its peak charged as the dry run charges it.
 24. decode — decode over the mesh, every slot on the one card, the decode
              state placed by ``state_specs`` and read and written in place
              (no slot gathers the cache or a split weight): (a) qwen3-4b
              whole, B = 8, a 4,096-slot cache drawn from the seed and
              filled to 4,000 positions, on (2, 16): 8 K/V heads on 16
              slots split their head_dim (the head-dim layout: q and the
              new k all-gathered, partial scores all-reduced in float32,
              plain PyTorch); (b) the same on (2, 8): one K/V head a slot,
              the decode-attention kernel on every (data, model) slot; (c)
              mixtral-8x7b cut to 4 layers, B = 1, its 4,096-slot window
              filled to 5,000 positions (the ring wrapped), on (4, 8): the
              cache length split over the data slots, the kernel's
              log-sum-exp route, partials merged onto data slot 0, one
              expert a model slot.  Each 8 steps against one device's
              decode on the same tokens and state (counters zeroed just
              before and read just after each): logits within phase 12's
              bf16 limit, pos and positions ``==``, the written K/V
              columns of layer 0 within the bf16 rounding of one device's
              (per element; deeper layers carry the slots' rounding, held
              to the logits' limit), every other column untouched, the
              state's blocks the placed tensors
              after the steps, launches and collective calls exactly
              derived, every kernel call (and its log-sum-exp) held to its
              plain version; an MoE routed as one device routed (near-ties
              aside); then the log-sum-exp route timed at (c)'s per-slot
              shape beside the route without it and the plain version.
 25. tp families — the hybrid, enc-dec and xLSTM families tensor-parallel
              over the model axis, every slot on the one card, each model
              slot computing from its own blocks of the weights: first
              flash and the SSD at (a)'s per-slot shapes timed against
              their plain versions; (a) zamba2-7b whole (81 layers), B = 1,
              S = 4096, the forward with kernels on (1, 16): exactly 84 x 16
              SSD launches at 7 of 112 heads and 14 x 16 flash at 2 of 32
              heads; (b) whisper-large-v3 whole (32 + 32 layers), B = 2, on
              (1, 16): each attention whole on model slot 0 (20 heads), the
              embedding split over d_model; (c) xlstm-350m whole (24
              layers), B = 2, S = 2048, on (1, 16), in float32, each sLSTM
              layer's collective calls exactly derived (none inside its
              time loop).  Each with the counters zeroed just before and
              read just after, every collective call count exactly derived
              from ``param_specs``, a second forward with every kernel call
              held to its plain version under ``param_guard`` (no op
              reading more than a slot's block of a split weight but the
              listed exceptions); the logits of a float32 pair (the mesh's
              forward and one device's from the same weights) within 1e-3
              mean relative error (a random zamba2-7b's own bf16 forward
              lies ~60 % from its float32 one, so (a)'s and (b)'s bf16
              pairs are reported, (b)'s also within phase 12's bf16 limit);
              (d) the zamba2-7b train step at full width cut to one group
              (6 Mamba2 layers and the shared block) on (2, 4), phase
              21(c)'s bounds and float32 pair.
 26. decode families — decode over the mesh for the hybrid, enc-dec and
              xLSTM families, every slot on the one card, 4 steps from a
              random state drawn from each run's seed (K/V, positions, conv
              windows, SSM, mLSTM and sLSTM states, cross K/V), each slot's
              blocks of it read and written in place where ``state_specs``
              puts them: first the decode kernel at (a)'s, (b)'s and (d)'s
              per-slot shapes timed against its plain version and SDPA;
              (a) zamba2-7b whole (81 layers), float32, B = 4, C = 1,024 on
              (1, 16): exactly 16 x 14 decode-kernel launches a step at 2
              heads of 112, one checked step under ``param_guard`` over the
              weights and the state (no op reading more than a slot's
              block); (b) zamba2-7b cut to 12 layers, B = 1 on (4, 4): the
              cache length over the data slots (the kernel's log-sum-exp
              route), the Mamba states replicated over them, bf16 and a
              float32 pair, the bf16 logits and states held against one
              device that sums and rounds as the mesh does (``==`` on the
              card: within 1e-4 / 1e-5), three planted bf16-only faults
              refused by that limit; (c) whisper-large-v3 whole, bf16, B = 4 on (2,
              16): the self and cross K/V split by head_dim; (d) the same on
              (2, 4): 5 heads a slot, the kernel on the self cache; (e)
              xlstm-350m whole, float32, B = 8 on (2, 16), each sLSTM
              layer's collective calls exactly derived.  Each against one
              device's decode from the same weights and state (counters
              zeroed just before and read just after each): launches and
              collective calls exactly derived, every kernel call held to
              its plain version, the logits within phase 12's bf16 limit
              (bf16) or a float32 pair's 1e-3 mean relative error, every
              state leaf likewise (positions and ``pos`` ``==``, static
              cross K/V untouched), the state's blocks the placed tensors
              after the steps.

Before its last line it prints one JSON line ``{"kernels": [...]}`` (per
kernel: launches summed over the main paths' runs (phases 5, 8-11, 13-26;
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
    from repro_torch.kernels.rmsnorm import rmsnorm_cost

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
        *rmsnorm_cost(n, d, x.element_size()), FP32_FLOPS_PER_S,
        device_time(torch, [lambda x=x: F.rms_norm(x, (d,), sc16, eps) for x in xs]),
        {"n": n, "d": d, "dtype": "bfloat16", "cold_buffers": len(xs)}) | {
        "f32_max_abs_err": f32_err}


def check_model_kernels(torch, cfg, gen) -> list:
    """The four model kernels at the full-width shapes of the serving path,
    in float32 and in bfloat16 (timed); the attention kernels also show that
    the tolerance rejects the answer with the window or mask ignored."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rmsnorm import rmsnorm_residual_cost

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
        *rmsnorm_residual_cost(FWD_S, d, x.element_size()), FP32_FLOPS_PER_S, None,
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
    from repro_torch.kernels.flash_attention import band_pairs, flash_cost

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
    pairs = band_pairs(S, S, True, window)
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
        *flash_cost(1, S, S, H, K, hd, q.element_size(), True, window),
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


def decode_plan(torch, kind, H, K, hd, window, gen, device, C=SERVE["capacity"],
                last_pos=SERVE["prompt_len"] + SERVE["max_new"] - 1) -> dict:
    """Input ``kind`` of :data:`DECODE_INPUTS` (``window``: the model's, or
    None) at B rows of C slots (``serve_live``: the serve run's last
    position ``last_pos``): cache positions, current positions, the window
    it takes, the slot mask, its live count, the bytes and operations of
    the bound (the live slots only: ``decode_cost``), and the cold ring."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_cost

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
    nbytes, flops = decode_cost(B, H, K, hd, C, 2, live)
    return {"kind": kind, "B": B, "C": C, "positions": positions, "written": written,
            "pos": pos, "window": window, "mask": mask, "live": live, "bytes": nbytes,
            "flops": flops, "ring": cold_ring(nbytes)}


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
            plan["flops"], BF16_TENSOR_FLOPS_PER_S, lib,
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
    from repro_torch.kernels.mamba2_ssd import ssd_cost
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
    # The bound is the same work whatever implements it: multiply-adds count
    # 2, the causal pairs' C.B scores once per chunk (they do not depend on
    # the head), then per head the pairs' w x and the state (11,371,012,608
    # flops at full width), against each input read once and each output
    # written once (268,180,928 B).  The fastest rate that keeps the products
    # float32-accurate is three TF32 tensor-core products per product (495 / 3
    # = 165 TFLOP/s): 0.069 ms; the bytes take 0.080 ms at 3.35 TB/s, so the
    # bound is 0.080 ms, by bytes (``ssd_cost``).
    nbytes, flops = ssd_cost(B, nc, Q, H, P, N)
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
# before activations), one sequence of the train_4k length, for step time
# and memory; a checkpoint after step 1, a crash there, and a resume on the
# smoke config (at full width its checkpoints took 70-90 s of host I/O)
TRAIN_LAYERS = 4
TRAIN = dict(arch=ARCH, smoke=False, steps=3, batch=1, seq=FWD_S, seed=0, log_every=1)
TRAIN_RESUME = dict(arch=ARCH, smoke=True, steps=3, batch=2, seq=128, seed=0, log_every=1)
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
    ``n_layers`` layers (step time and memory); then ``train_loop`` of
    :data:`TRAIN_RESUME` uninterrupted, with a checkpoint after step 1 and a crash
    there, and resumed from it: every loss finite, the resumed step's loss
    ``==`` the uninterrupted run's, no hand-written kernel launched in any
    run (training runs the plain versions, as the reference does); then
    ``smoke_cfg`` trained on the cpu and on ``device``, losses and
    parameters within the CPU parity tests' tolerances."""
    import shutil

    resume = TRAIN_RESUME

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import train as tr

    on_card = torch.device(device).type == "cuda"
    base = get_smoke_config(train["arch"]) if train["smoke"] else get_config(train["arch"])
    cfg = base.replace(n_layers=n_layers)
    out = {"card": card, "config": train | {"n_layers": n_layers}, "resume_config": resume}
    zero_counters(counters)
    with config_cut(tr, cfg):
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        ref = tr.train_loop(ckpt_dir=None, device=device, **train)
        out["wall_s"] = time.time() - t0
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() if on_card else None
    whole = tr.train_loop(ckpt_dir=None, device=device, **resume)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.time()
    try:
        tr.train_loop(ckpt_dir=str(ckpt_dir), ckpt_every=1, fail_at_step=1, device=device,
                      **resume)
    except RuntimeError as e:
        if "simulated failure" not in str(e):
            raise
    else:
        fail("train: the run with fail_at_step=1 did not stop")
    out["crash_run_s"] = time.time() - t0
    t0 = time.time()
    resumed = tr.train_loop(ckpt_dir=str(ckpt_dir), ckpt_every=1, device=device, **resume)
    out["resume_run_s"] = time.time() - t0
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches = {c.__name__: c.launches for c in counters}
    losses = ref["losses"] + whole["losses"] + resumed["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: a loss is not finite: {ref['losses']}, {whole['losses']}, resumed "
             f"{resumed['losses']}")
    if resumed["start_step"] != 2 or resumed["losses"] != whole["losses"][2:]:
        fail(f"train: resumed at {resumed['start_step']} with losses {resumed['losses']}, "
             f"uninterrupted {whole['losses']}")
    if any(launches.values()):
        fail(f"train: launched {launches}; training runs no hand-written kernel")
    out |= {"losses": ref["losses"], "resume_losses": whole["losses"],
            "resumed_losses": resumed["losses"], "step_s": ref["step_s"], "launches": launches}
    say(f"phase train: {cfg.arch_id} {n_layers} layers B={train['batch']} S={train['seq']} "
        f"on {device}: losses {ref['losses']}, step s {[round(t, 3) for t in ref['step_s']]}, "
        f"peak {out['peak_mem_bytes']} B; {resume['arch']} smoke={resume['smoke']} "
        f"B={resume['batch']} S={resume['seq']}: checkpoint at step 1, crash, resume at step 2: "
        f"loss {resumed['losses']} == uninterrupted {whole['losses'][2:]} (crash run "
        f"{out['crash_run_s']:.1f} s, resume {out['resume_run_s']:.1f} s); launches "
        f"{launches}; {card}")

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


def plain_moe(torch, params, x, ids, keep, w, inner: bool = False) -> tuple:
    """(output, the sum of its terms' magnitudes), both float32, of a plain
    MoE over tokens ``x`` (N, d): each expert runs on its kept tokens
    (``ids``, ``keep``: (N, k)), each pair's output weighted by ``w`` (N, k)
    in x's type.  A term is a pair's output, or with ``inner`` each product
    of the down projection (``|w| |h| @ |wo|``), the scale of the rounding
    of two computations whose bf16 hidden activations round apart."""
    import torch.nn.functional as F

    dt = x.dtype
    want = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    mag = torch.zeros_like(want)
    for e in range(params["wi"].shape[0]):
        t, j = ((ids == e) & keep).nonzero(as_tuple=True)
        if t.numel() == 0:
            continue
        xe = x[t]
        h = F.silu(xe @ params["wg"][e].to(dt)) * (xe @ params["wi"][e].to(dt))
        o = ((h @ params["wo"][e].to(dt)) * w[t, j, None]).float()
        want.index_add_(0, t, o)
        if inner:
            mag.index_add_(0, t, (h.float().abs() @ params["wo"][e].float().abs())
                           * w[t, j, None].float().abs())
        else:
            mag.index_add_(0, t, o.abs())
    return want, mag


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
    want, mag = plain_moe(torch, params, x, ids, keep, w)
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


# phase 21: the mesh's data and model axes in execution, every slot of each
# mesh on the one card (``devices=[device] * n``).  (a) qwen2.5-14b whole
# (48 layers, 40 / 8 heads of 128), B = 2, S = 4096, prefill on the
# production mesh's (2, 16) shape: 40 heads on a 16-way model axis take
# sequence-parallel attention (256 queries a slot); (b) mixtral-8x7b cut to
# 8 of 32 layers, as phase 19, B = 4, S = 2048, the forward on (4, 2): one
# MoE dispatch group per data slot; (c) qwen3-4b cut to 4 of 36 layers, as
# phase 18, ``fsdp_params`` and 2 microbatches as the reference's test,
# B = 4, S = 1024, one train step on (2, 4)
MESH_RUNS = {
    "prefill": {"arch": "qwen2.5-14b", "layers": None, "batch": 2, "seq": 4096,
                "mesh": (2, 16), "seed": 21, "dtype": None},
    "moe": {"arch": "mixtral-8x7b", "layers": 8, "batch": 4, "seq": 2048, "mesh": (4, 2),
            "seed": 22, "dtype": None},
    "train": {"arch": "qwen3-4b", "layers": 4, "batch": 4, "seq": 1024, "mesh": (2, 4),
              "seed": 23, "dtype": None, "accum": 2, "base_lr": 1e-3},
}
# the train step under the mesh against the unsharded one: the reference's
# bound for the loss and every parameter (tests/test_distributed_numerics.py);
# besides, the grad norm and the first moments (one step from zero moments:
# (1 - b1) times the reduced gradient) by relative norm over the whole tree,
# which a reduction that drops a slot moves by O(1) while AdamW's normalized
# update may not.  Each leaf's first moment is reported, not gated: a small
# leaf (a norm scale) sums bf16-rounded terms over every token, and the
# slots' rows round apart (1.3e-2 on qwen3-4b's worst leaf, PERF.md)
MESH_TRAIN_TOL, MESH_GRAD_RTOL = 5e-3, 1e-2
# each leaf that the model axis replicates (norm scales, the router, biases):
# its first moment by relative norm.  Every model slot's view of it meets a
# part of the rows' gradient, and the step sums them; a sum that takes one
# slot's part M times moves such a leaf by O(1), which the whole tree's
# norm hides
MESH_REPLICATED_RTOL = 0.1


def mesh_cfg(run: dict, smoke: bool = False, **kw):
    from repro_torch.configs import get_config, get_smoke_config

    cfg = (get_smoke_config if smoke else get_config)(run["arch"])
    if run["layers"]:
        cfg = cfg.replace(n_layers=run["layers"])
    if run["dtype"]:
        cfg = cfg.replace(dtype=run["dtype"])
    return cfg.replace(**kw)


def _mesh_of(run: dict, device):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(run["mesh"], ("data", "model"), devices=[device] * math.prod(run["mesh"]))


def mesh_launches(cfg, path: str, dsize: int, seq: int, msize: int = 1) -> dict:
    """The kernels a mesh run over ``dsize`` data slots of ``msize`` model
    slots launches, tensor-parallel.  Where the heads divide the model axis
    every model slot normalizes its own copy of the rows: RMSNorm before
    attention and before the FFN in every layer and the final one, msize x
    (2L + 1) per data slot, and the forward adds flash attention once per
    layer per model slot (at H / msize query heads) where the gate passes.
    Where they do not, model slot 0 alone normalizes before the attention,
    which it runs whole: L + msize x (L + 1) per data slot, flash L.
    Prefill never takes flash (as the reference)."""
    from repro_torch.models.attention import heads_parallel

    out = dict.fromkeys(KERNEL_NAMES, 0)
    L, per_layer = cfg.n_layers, (msize if heads_parallel(cfg, msize) else 1)
    out["rmsnorm"] = dsize * (per_layer * L + msize * (L + 1))
    if path == "forward":
        out["flash_attention"] = dsize * per_layer * L * flash_gate(seq, seq)
    return out


def mesh_collective_calls(cfg, path: str, dsize: int, msize: int, seq: int,
                          batch: int) -> dict:
    """The collective calls of ``path`` (``forward`` or ``prefill``) of the
    transformer families from a whole tree under a (dsize, msize) mesh,
    tensor-parallel, from ``param_specs``'s split of each leaf:

    - the views: per data slot that takes rows (D), one ``scatter`` per
      leaf split over ``model``, one ``broadcast`` per replicated leaf; the
      tokens (and a VLM's prefix) ``scatter`` over the data slots once;
    - with M > 1 model slots, per data slot: the tokens (and prefix)
      ``broadcast`` to its model slots, the embedding ``psum`` (vocabulary
      split) or ``all_gather`` (``d_model`` split);
    - per layer per data slot, where the heads divide the axis: an
      ``all_gather`` per K/V head for each K/V weight split over
      ``head_dim`` (one where split otherwise), the output's ``psum``;
      where they do not: a ``gather`` per split attention leaf onto model
      slot 0, sequence-parallel attention's 3 ``scatter`` + 2 ``all_gather``
      + 1 ``gather`` where its condition holds, a ``broadcast`` of the
      output; the FFN's ``psum`` where its inner dim (the experts or their
      ff) is split, else a ``gather`` per split leaf and a ``broadcast``;
      an MoE whose dispatch gathers the data slots' rows adds a ``gather``
      and a ``scatter`` per dispatching model slot;
    - the head: the forward's unembedding ``reduce_scatter`` (``d_model``
      split; a ``psum`` where M does not divide the positions), one
      ``gather`` of each data slot's logits and the aux loss's ``psum``;
      prefill's ``psum`` of the last position's partial logits where
      ``d_model`` is split, the logits' ``gather`` and two cache
      ``gather`` per layer per data slot."""
    import collections

    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.models import attention, get_model, moe, sharding

    M = msize
    params = get_model(cfg).init(0, "meta")
    named = {}
    sharding._map_with_path(lambda pth, x: named.__setitem__(
        "/".join(pth), sharding.model_split_dim(list(pth), tuple(x.shape), M)), params)
    layer = {k[len("layers/"):]: (None if d is None else "owner" if d == 0 else d - 1)
             for k, d in named.items() if k.startswith("layers/")}
    D = dsize if batch % dsize == 0 else 1
    L, vlm = cfg.n_layers, cfg.family == "vlm"
    calls, per, once = collections.Counter(), collections.Counter(), collections.Counter()
    split = sum(d is not None for d in named.values())
    calls["scatter"] += D * split + 1 + vlm
    calls["broadcast"] += D * (len(named) - split)
    if M > 1:
        calls["broadcast"] += D * (1 + vlm)
        if named["embed/tok"] is not None:
            calls["psum" if named["embed/tok"] == 0 else "all_gather"] += D
        S = seq + (cfg.n_vis_tokens if vlm else 0)
        if attention.heads_parallel(cfg, M):
            for n in ("wk", "wv", "bk", "bv"):
                d, axis = layer.get(f"attn/{n}"), 1 if n[0] == "w" else 0
                if d is None or d == axis:
                    continue
                per["all_gather" if d != "owner" else "broadcast"] += \
                    cfg.n_kv_heads if d == axis + 1 else 1
            per["psum"] += 1
        else:
            per["gather"] += sum(d is not None for k, d in layer.items() if k.startswith("attn/"))
            blocked = S > 2048 and S % 512 == 0 and not (path == "forward" and cfg.use_pallas)
            if blocked and S % M == 0 and (S // M) % 128 == 0:
                per.update({"scatter": 3, "all_gather": 2, "gather": 1})
            per["broadcast"] += 1
    ffn = [("mlp", layer.get("mlp/wi"))]
    if cfg.family == "moe":
        with use_mesh(make_mesh((dsize, msize), ("data", "model"), devices=["meta"] * (dsize * M))):
            own = moe._per_data_slot(cfg, batch, seq, D)[1]
        inner = M > 1 and layer["moe/wi"] in (0, 2)
        experts = sum(layer[f"moe/{k}"] is not None for k in ("router", "wi", "wg", "wo"))
        (per if own else once)["gather"] += 0 if inner else experts
        if not own:
            once.update({"gather": M if inner else 1, "scatter": M if inner else 1})
        if inner:
            per["psum"] += 1
        elif M > 1:
            per["broadcast"] += 1
        ffn = [("moe/dense", layer.get("moe/dense/wi"))] if cfg.dense_residual else []
    for pre, d in ffn:
        if M == 1:
            continue
        if d == 1:
            per["psum"] += 1
        else:
            per["gather"] += sum(v is not None for k, v in layer.items() if k.startswith(pre + "/"))
            per["broadcast"] += 1
    for k, v in per.items():
        calls[k] += v * L * D
    for k, v in once.items():
        calls[k] += v * L
    head = named["embed/tok"] if cfg.tie_embeddings else named["embed/unembed"]
    d_split = M > 1 and head == (1 if cfg.tie_embeddings else 0)
    if path == "forward":
        if d_split:
            calls["reduce_scatter" if seq % M == 0 else "psum"] += D
        calls["gather"] += D
        calls["psum"] += 1
    else:
        calls["psum"] += D * d_split
        calls["gather"] += D + 2 * L * D
    return {k: v for k, v in sorted(calls.items()) if v}


def check_collective_calls(what: str, traffic: dict, want: dict) -> None:
    got = {op: v[0] for op, v in sorted(traffic.items()) if v[0]}
    if got != want:
        fail(f"{what}: collective calls {got}, expected {want}")


def flash_heads(cfg, msize: int) -> tuple:
    """(query heads, K/V heads) of each flash call on a model slot."""
    from repro_torch.models.attention import heads_parallel, kv_heads

    if msize == 1 or not heads_parallel(cfg, msize):
        return cfg.n_heads, cfg.n_kv_heads
    return cfg.n_heads // msize, len(kv_heads(0, cfg.n_heads, cfg.n_kv_heads, msize))


@contextlib.contextmanager
def mesh_recording(torch, calls: list, moe_records=None, flash_heads_seen=None,
                   ssd_heads_seen=None):
    """Within the block every RMSNorm, flash-attention and SSD call is held
    to its plain version on its own inputs (with ``flash_heads_seen``, each
    flash call's (query heads, K/V heads) appended to it; with
    ``ssd_heads_seen``, each SSD call's heads; each SSD output within
    :data:`SSD_ATOL` + :data:`SSD_RTOL` of its largest plain value: a
    model's live chunks sum terms of O(10) that cancel, where an
    elementwise limit reads the float32 rounding of the sum as a fault), every
    sequence-parallel attention call to ``blocked_attention`` on one device
    on its own inputs, and (with ``moe_records``) every MoE call over the
    grid to :func:`check_mesh_moe`, on each data slot's rows and output at
    its model slot 0 with the layer's MoE weights gathered whole for the
    check; each call's (name, max abs err, within) is appended to
    ``calls``."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import attention, layers, moe, ssm

    flash, rms, ssd = ops.flash_attention, ops.rmsnorm, ops.ssd_chunked
    seqpar, moe_grid = attention.seq_parallel_attention, moe.moe_ffn_grid

    def check(name, got, want):
        ok, err = _within(torch, got, want)
        calls.append((name, err, ok))
        return got

    def seqpar_rec(q, k, v, *, causal, window, block_q, block_k):
        got = seqpar(q, k, v, causal=causal, window=window, block_q=block_q, block_k=block_k)
        with use_mesh(None):
            want = attention.blocked_attention(q, k, v, causal=causal, window=window,
                                               block_k=block_k)
        return check("seq_parallel_attention", got, want)

    def flash_rec(q, k, v, **kw):
        if flash_heads_seen is not None:
            flash_heads_seen.append((q.shape[2], k.shape[2]))
        return check("flash_attention", flash(q, k, v, **kw), ref.flash_attention_ref(q, k, v, **kw))

    def moe_rec(ps, dims, hs, cfg, n_data, data_slots):
        ys, auxes = moe_grid(ps, dims, hs, cfg, n_data, data_slots)
        dev = hs[0][0].device
        whole = {k: layers.whole_on([p[k] for p in ps[0]], dims[k], dev)
                 for k in ("router", "wi", "wg", "wo")}
        moe_records.append(check_mesh_moe(torch, whole, [h[0] for h in hs], [y[0] for y in ys],
                                          cfg))
        calls.append(("moe", moe_records[-1]["out_max_err"], True))
        return ys, auxes

    def ssd_rec(x, dt, A, Bm, Cm, chunk=256):
        if ssd_heads_seen is not None:
            ssd_heads_seen.append(x.shape[2])
        got = ssd(x, dt, A, Bm, Cm, chunk)
        ok, err = True, 0.0
        for g, w in zip(got, ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk)):
            diff = float((g - w).abs().max())
            ok = ok and diff <= SSD_ATOL + SSD_RTOL * float(w.abs().max())
            err = max(err, diff)
        calls.append(("ssd_intra_chunk", err, ok))
        return got

    ops.flash_attention, ops.ssd_chunked = flash_rec, ssd_rec
    ops.rmsnorm = lambda x, scale, *, eps: check(
        "rmsnorm", rms(x, scale, eps=eps), ref.rmsnorm_ref(x, scale, eps=eps))
    attention.seq_parallel_attention = seqpar_rec
    if moe_records is not None:
        moe.moe_ffn_grid = moe_rec
    try:
        yield calls
    finally:
        ops.flash_attention, ops.rmsnorm, ops.ssd_chunked = flash, rms, ssd
        attention.seq_parallel_attention, moe.moe_ffn_grid = seqpar, moe_grid


def check_mesh_moe(torch, params, xs, ys, cfg) -> dict:
    """One MoE call over the data slots (inputs ``xs``, outputs ``ys``, one
    dispatch group per slot) against the single-call dispatch of all the
    groups on one device (``moe._grouped_dispatch`` of the gathered rows in
    G = len(xs) groups, with the layer's weights whole): each group's top-k
    ids ``==`` the single call's but at a near-tie (:func:`routing_flips`),
    its kept pairs ``==`` where no token flipped, its outputs at every token
    whose routing agrees within the bf16 limit of the single call's: 2e-5 +
    2^-6 of the sum of the magnitudes of the down projection's products
    (:func:`plain_moe` with ``inner`` on the slot's routing): the two calls'
    expert products have other shapes (and the model slots' partial sums
    round apart), so their bf16 hidden activations round apart, and a
    token's output may cancel below them."""
    from repro_torch.models import moe

    G = len(xs)
    S, d = xs[0].shape[1:]
    flat = torch.cat([x.reshape(1, -1, d).to(xs[0].device) for x in xs])
    r_all = moe.route(flat, params["router"], cfg)
    want, _ = moe._grouped_dispatch(params, flat, cfg)
    out = {"groups": G, "tokens": flat.shape[0] * flat.shape[1], "dropped_pairs": 0,
           "flipped_tokens": 0, "out_max_err": 0.0, "worst_share_of_limit": 0.0}
    k = cfg.top_k
    for g, (x, y) in enumerate(zip(xs, ys)):
        r = moe.route(x.reshape(1, -1, d), params["router"], cfg)
        own = r.top_ids.reshape(-1, k)
        ids = r_all.top_ids[g].reshape(-1, k).to(own.device)
        flips, _ = routing_flips(own, ids, r.logits.reshape(-1, r.logits.shape[-1]),
                                 r_all.logits[g].to(own.device), k)
        out["flipped_tokens"] += flips
        keep, keep_all = r.keep[0], r_all.keep[g].to(r.keep.device)
        out["dropped_pairs"] += int((~keep).sum())
        if flips == 0 and not torch.equal(keep, keep_all):
            fail(f"mesh moe: data slot {g} keeps {int(keep.sum())} pairs, the single G={G} "
                 f"dispatch {int(keep_all.sum())} (differing at {int((keep != keep_all).sum())})")
        same = ~(own != ids).any(-1)
        keep_pair = torch.empty_like(r.keep).scatter_(-1, r.order, r.keep).reshape(-1, k)
        w = r.weights.reshape(-1, k)
        _, mag = plain_moe(torch, params, x.reshape(-1, d), own, keep_pair, w, inner=True)
        diff = (y.reshape(-1, d).float() - want[g].to(y.device).float()).abs()[same]
        lim = F32_TOL + BF16_RTOL * mag[same]
        if not bool((diff <= lim).all()):
            fail(f"mesh moe: data slot {g}'s output differs from the single G={G} dispatch by "
                 f"{float(diff.max())} (worst share of its limit {float((diff / lim).max()):.3g})")
        out["out_max_err"] = max(out["out_max_err"], float(diff.max()))
        out["worst_share_of_limit"] = max(out["worst_share_of_limit"],
                                          float((diff / lim).max()))
    return out


def _check_calls(what: str, calls: list, want: dict) -> dict:
    counts = {n: sum(1 for c in calls if c[0] == n) for n in want}
    if counts != want:
        fail(f"{what}: checked calls {counts}, expected {want}")
    bad = [c for c in calls if not c[2]]
    if bad:
        fail(f"{what}: {len(bad)} calls differ from their plain versions on their own inputs, "
             f"first {bad[:4]}")
    return {n: max((c[1] for c in calls if c[0] == n), default=None) for n in want}


def mesh_prefill_run(torch, counters, run: dict, device, smoke: bool = False) -> dict:
    """(a) prefill under the mesh, the counters zeroed just before and read
    just after (:func:`mesh_launches`), its collective calls exactly
    :func:`mesh_collective_calls`'s; a second mesh prefill with every
    kernel and sequence-parallel call checked; then the single-device
    prefill from the same weights: the mesh's logits within
    :func:`_logits_close`'s limit of its, the caches ``==`` in layout."""
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import get_model
    from repro_torch.models.transformer import prefill

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = mesh_cfg(run, smoke, use_pallas=True)
    mesh = _mesh_of(run, device)
    dsize, msize = run["mesh"]
    B, S = run["batch"], run["seq"]
    t0 = time.time()
    params = get_model(cfg).init(run["seed"], device)
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=device,
                         generator=torch.Generator(device=device).manual_seed(run["seed"]))
    sync()
    out = {"config": cfg.arch_id, "layers": cfg.n_layers, "init_s": time.time() - t0}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    collectives.TRAFFIC.clear()
    t0 = time.time()
    with use_mesh(mesh):
        logits, state = prefill(params, toks, cfg)
    sync()
    out["mesh_wall_s"] = time.time() - t0
    out["collectives"] = {op: list(v) for op, v in collectives.TRAFFIC.items()}
    out["launches"] = {c.__name__: c.launches for c in counters}
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() if on_card else None
    want = mesh_launches(cfg, "prefill", dsize, S, msize)
    if on_card:
        check_launches("mesh prefill", out["launches"], want)
    check_collective_calls("mesh prefill", out["collectives"],
                           mesh_collective_calls(cfg, "prefill", dsize, msize, S, B))
    seqpar = cfg.n_heads % msize != 0 and S % msize == 0 and (S // msize) % 128 == 0 \
        and S > 2048 and S % 512 == 0
    calls = []
    with mesh_recording(torch, calls), use_mesh(mesh):
        prefill(params, toks, cfg)
    out["kernel_vs_plain_max_err"] = _check_calls(
        "mesh prefill", calls, {"rmsnorm": want["rmsnorm"],
                                "seq_parallel_attention": dsize * cfg.n_layers * seqpar})
    if seqpar == 0:
        fail(f"mesh prefill: {cfg.n_heads} heads on a {msize}-way model axis at S={S} do not "
             f"take sequence-parallel attention")
    sync()
    t0 = time.time()
    ref_logits, ref_state = prefill(params, toks, cfg)
    sync()
    out["single_wall_s"] = time.time() - t0
    out["logits"] = _logits_close(logits, ref_logits, cfg.dtype)
    if not out["logits"]["ok"]:
        fail(f"mesh prefill: logits against the single-device prefill's {out['logits']}")
    got, ref = state.caches, ref_state.caches
    for f in ("k", "v", "pos", "positions"):
        a, b = getattr(got, f), getattr(ref, f)
        if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
            fail(f"mesh prefill: cache {f} {tuple(a.shape)} {a.dtype} {a.device}, single device "
                 f"{tuple(b.shape)} {b.dtype} {b.device}")
    if not (torch.equal(got.pos, ref.pos) and torch.equal(got.positions, ref.positions)):
        fail("mesh prefill: cache positions differ from the single-device prefill's")
    out["cache_max_err"] = {f: float((getattr(got, f).float() - getattr(ref, f).float()).abs()
                                     .max()) for f in ("k", "v")}
    return out


def mesh_moe_run(torch, counters, run: dict, device, smoke: bool = False) -> dict:
    """(b) the MoE model's forward under the mesh: the counters zeroed just
    before and read just after (:func:`mesh_launches`), its collective
    calls exactly :func:`mesh_collective_calls`'s; a second forward
    with every kernel call checked and every MoE call held to the single
    G-group dispatch (:func:`check_mesh_moe`); logits finite."""
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import get_model

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = mesh_cfg(run, smoke, use_pallas=True)
    api = get_model(cfg)
    mesh = _mesh_of(run, device)
    dsize, msize = run["mesh"]
    B, S = run["batch"], run["seq"]
    t0 = time.time()
    params = api.init(run["seed"], device)
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=device,
                         generator=torch.Generator(device=device).manual_seed(run["seed"]))
    sync()
    out = {"config": cfg.arch_id, "layers": cfg.n_layers, "init_s": time.time() - t0}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    collectives.TRAFFIC.clear()
    t0 = time.time()
    with use_mesh(mesh):
        logits, _ = api.forward(params, {"tokens": toks}, cfg)
    sync()
    out["mesh_wall_s"] = time.time() - t0
    out["collectives"] = {op: list(v) for op, v in collectives.TRAFFIC.items()}
    out["launches"] = {c.__name__: c.launches for c in counters}
    out["routes"] = route_counts(counters)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() if on_card else None
    want = mesh_launches(cfg, "forward", dsize, S, msize)
    if on_card:
        check_launches("mesh moe forward", out["launches"], want)
        check_flash_routes("mesh moe forward", out["launches"], out["routes"])
    check_collective_calls("mesh moe forward", out["collectives"],
                           mesh_collective_calls(cfg, "forward", dsize, msize, S, B))
    if tuple(logits.shape) != (B, S, cfg.vocab_size) or not bool(logits.isfinite().all()):
        fail(f"mesh moe forward: logits {tuple(logits.shape)}, finite "
             f"{bool(logits.isfinite().all())}")
    calls, records, heads = [], [], []
    with mesh_recording(torch, calls, records, heads), use_mesh(mesh):
        api.forward(params, {"tokens": toks}, cfg)
    out["kernel_vs_plain_max_err"] = _check_calls(
        "mesh moe forward", calls, {"rmsnorm": want["rmsnorm"],
                                    "flash_attention": want["flash_attention"],
                                    "moe": cfg.n_layers})
    out["flash_heads"] = sorted(set(heads))
    if out["flash_heads"] != [flash_heads(cfg, msize)]:
        fail(f"mesh moe forward: flash calls at (query, K/V) heads {out['flash_heads']}, "
             f"expected {flash_heads(cfg, msize)} on each of {msize} model slots")
    if any(r["groups"] != dsize for r in records):
        fail(f"mesh moe forward: dispatch groups {[r['groups'] for r in records]}, one per data "
             f"slot expected ({dsize})")
    out["moe"] = {"layers": len(records), "groups": dsize, "model_slots": msize,
                  "split": moe_split(cfg, msize),
                  "dropped_pairs": sum(r["dropped_pairs"] for r in records),
                  "flipped_tokens": sum(r["flipped_tokens"] for r in records),
                  "out_max_err": max(r["out_max_err"] for r in records),
                  "worst_share_of_limit": max(r["worst_share_of_limit"] for r in records)}
    return out


def moe_split(cfg, msize: int) -> str:
    """How ``param_specs`` splits the experts over ``msize`` model slots."""
    from repro_torch.models.sharding import model_split_dim

    dim = model_split_dim(["layers", "moe", "wi"], (cfg.n_layers, cfg.n_experts, cfg.d_model,
                                                   cfg.expert_d_ff), msize)
    return {1: "experts", 3: "expert ff"}.get(dim, "none")


def _rel_norm(torch, a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).double())
                 / max(float(torch.linalg.vector_norm(b.double())), 1e-30))


def _train_pair(torch, counters, cfg, run: dict, device, analysis: bool) -> dict:
    """One train step of ``cfg`` under ``run``'s mesh (state placed by
    ``zero1_specs``) and one unsharded step from the same seeded state and
    batch: their errors (loss, worst parameter, grad norm, first moments
    over the tree, per leaf and per leaf the model axis replicates), step
    times, the mesh step's collectives, launches and peak; with
    ``analysis``, one slot's peak as the dry run charges it."""
    from repro_torch.launch import collectives, dryrun, hlo_analysis
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import get_model, sharding
    from repro_torch.models.train import (init_optimizer, make_loss_fn, make_train_step,
                                          place_train_state, value_and_grad)
    from repro_torch.optim.tree import tree_leaves

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    api = get_model(cfg)
    mesh = _mesh_of(run, device)
    B, S = run["batch"], run["seq"]
    params = api.init(run["seed"], device, master=True)
    opt = init_optimizer(params)
    gen = torch.Generator(device=device).manual_seed(run["seed"])
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), device=device, generator=gen)
             for k in ("tokens", "labels")}
    placed, popt = place_train_state(params, opt, cfg, mesh)
    specs = sharding.zero1_specs(params, cfg, mesh)
    state = (params, opt.m, opt.v)
    out = {"dtype": cfg.dtype,
           "bytes_unsharded": sum(x.numel() * x.element_size()
                                  for t in state for x in tree_leaves(t)),
           "bytes_per_slot": sum(sharding.slot_bytes(t, specs, mesh) for t in state)}
    step = make_train_step(api.train_forward, cfg, base_lr=run["base_lr"], warmup=0)
    zero_counters(counters)
    # a throwaway forward and backward first, so that neither step is timed
    # with the process's first autograd pass
    value_and_grad(make_loss_fn(api.train_forward, cfg), params,
                   {k: v[:B // run["accum"]] for k, v in batch.items()})
    sync()
    t0 = time.time()
    params, opt, m_ref = step(params, opt, batch)
    sync()
    out["single_step_s"] = time.time() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sync()
    collectives.TRAFFIC.clear()
    t0 = time.time()
    with use_mesh(mesh):
        if analysis:
            (placed, popt, m_mesh), an = hlo_analysis.analyze(
                lambda: step(placed, popt, batch), devices=mesh.size, detail=False)
        else:
            placed, popt, m_mesh = step(placed, popt, batch)
    sync()
    out["mesh_step_s"] = time.time() - t0
    if analysis:
        dsize, msize = run["mesh"]
        shared = dryrun._gathered_bytes(params, specs, mesh)
        out["slot_view_bytes"] = shared // msize
        out["slot_peak_bytes"] = int((an["peak_bytes"] - shared) / (dsize * msize)
                                     + shared / msize)
    out["collectives"] = {op: list(v) for op, v in collectives.TRAFFIC.items()}
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() if on_card else None
    out["launches"] = {c.__name__: c.launches for c in counters}
    out["loss"], out["single_loss"] = float(m_mesh["loss"]), float(m_ref["loss"])
    out["loss_err"] = abs(out["loss"] - out["single_loss"])
    out["grad_norm_rel_err"] = abs(float(m_mesh["grad_norm"]) - float(m_ref["grad_norm"])) \
        / float(m_ref["grad_norm"])
    errs, rel, diff2, norm2, repl = [], [], 0.0, 0.0, []
    for st, want, sm, wm in zip(tree_leaves(placed), tree_leaves(params), tree_leaves(popt.m),
                                tree_leaves(opt.m)):
        errs.append(float((sharding.gather(st, want.device) - want).abs().max()))
        got_m = sharding.gather(sm, wm.device)
        rel.append(_rel_norm(torch, got_m, wm))
        if sharding.model_dim(st.spec) is None:
            repl.append(rel[-1])
        diff2 += float(torch.sum(torch.square((got_m - wm).double())))
        norm2 += float(torch.sum(torch.square(wm.double())))
    out["param_max_err"], out["moment_leaf_max_rel_err"] = max(errs), max(rel)
    out["replicated_moment_max_rel_err"] = max(repl, default=0.0)
    out["moment_rel_err"] = math.sqrt(diff2 / max(norm2, 1e-300))
    return out


def mesh_train_run(torch, counters, run: dict, device, smoke: bool = False,
                   analysis: bool = False) -> dict:
    """(c) one train step under the mesh, tensor-parallel (state placed by
    ``zero1_specs``), against one unsharded step from the same state and
    batch (:func:`_train_pair`): in the run's dtype the loss and every
    parameter within :data:`MESH_TRAIN_TOL` (the reference's own check, in
    its bf16); then, from the same seeded state in float32, those and the
    grad norm and the first moments within :data:`MESH_GRAD_RTOL` by
    relative norm, each leaf the model axis replicates within
    :data:`MESH_REPLICATED_RTOL`.  In bf16 the model slots' partial sums
    round apart from one product over the whole contraction, and this
    model's gradient amplifies that: splitting one MLP contraction in two
    on one device moves its bf16 first moments by 1.1 % (PERF.md), so the
    moments are gated where only a wrong sum can move them.  Step times;
    the bytes one slot holds under the placement against the unsharded
    tree's; with ``analysis``, the run's mesh step under the op analysis
    and one slot's peak charged as the dry run charges it."""
    cfg = mesh_cfg(run, smoke, fsdp_params=True, accum_steps=run["accum"])
    out = {"config": cfg.arch_id, "layers": cfg.n_layers}
    out.update(_train_pair(torch, counters, cfg, run, device, analysis))
    if any(out["launches"].values()):
        fail(f"mesh train: the steps launched {out['launches']}; training runs the plain versions")
    if out["loss_err"] > MESH_TRAIN_TOL or out["param_max_err"] > MESH_TRAIN_TOL:
        fail(f"mesh train ({cfg.dtype}): loss err {out['loss_err']}, worst parameter err "
             f"{out['param_max_err']} (limit {MESH_TRAIN_TOL})")
    f32 = out if cfg.dtype == "float32" else _train_pair(
        torch, counters, cfg.replace(dtype="float32"), run, device, False)
    out["float32"] = {k: f32[k] for k in ("loss_err", "param_max_err", "grad_norm_rel_err",
                                          "moment_rel_err", "moment_leaf_max_rel_err",
                                          "replicated_moment_max_rel_err", "mesh_step_s",
                                          "single_step_s")}
    if f32["loss_err"] > MESH_TRAIN_TOL or f32["param_max_err"] > MESH_TRAIN_TOL \
            or f32["grad_norm_rel_err"] > MESH_GRAD_RTOL or f32["moment_rel_err"] > MESH_GRAD_RTOL \
            or f32["replicated_moment_max_rel_err"] > MESH_REPLICATED_RTOL:
        fail(f"mesh train (float32): loss err {f32['loss_err']}, worst parameter err "
             f"{f32['param_max_err']} (limit {MESH_TRAIN_TOL}); grad norm rel err "
             f"{f32['grad_norm_rel_err']}, first moments rel err {f32['moment_rel_err']} (limit "
             f"{MESH_GRAD_RTOL}; worst leaf {f32['moment_leaf_max_rel_err']}), worst leaf "
             f"replicated over the model axis {f32['replicated_moment_max_rel_err']} (limit "
             f"{MESH_REPLICATED_RTOL})")
    return out


def mesh_phase(torch, counters, card, device: str = "cuda", runs: dict = MESH_RUNS,
               smoke: bool = False) -> dict:
    """Phase 21 on ``device``: (a) :func:`mesh_prefill_run`, (b)
    :func:`mesh_moe_run`, (c) :func:`mesh_train_run`, each from its own
    seeded weights, freed before the next."""
    on_card = torch.device(device).type == "cuda"
    out, by_path = {"card": card}, {}
    for name, fn in (("prefill", mesh_prefill_run), ("moe", mesh_moe_run),
                     ("train", mesh_train_run)):
        t0 = time.time()
        res = out[name] = fn(torch, counters, runs[name], device, smoke)
        res["part_s"] = time.time() - t0
        by_path[f"mesh {name}"] = res["launches"]
        say_mesh_part(name, res, runs[name], card)
        if on_card:
            torch.cuda.empty_cache()
    out["by_path"] = by_path
    return out


def say_mesh_part(name: str, r: dict, run: dict, card) -> None:
    """The line phase 21 prints for part ``name`` as it ends."""
    head = (f"phase mesh: {r['config']} {r['layers']} layers B={run['batch']} S={run['seq']} "
            f"on a {run['mesh']} mesh:")
    if name == "prefill":
        say(f"{head} (a) prefill, sequence-parallel attention, in {r['mesh_wall_s']:.3f} s, one "
            f"device {r['single_wall_s']:.3f} s; peak {r['peak_mem_bytes']} B; logits "
            f"{r['logits']}; caches == in layout (k/v max err {r['cache_max_err']}); every call "
            f"within its plain version (worst {r['kernel_vs_plain_max_err']}); collectives "
            f"{r['collectives']}; launches {r['launches']}; part {r['part_s']:.1f} s; {card}")
    elif name == "moe":
        say(f"{head} (b) forward in {r['mesh_wall_s']:.3f} s; peak {r['peak_mem_bytes']} B; MoE "
            f"{r['moe']}; every call within its plain version (worst "
            f"{r['kernel_vs_plain_max_err']}); collectives {r['collectives']}; launches "
            f"{r['launches']}; part {r['part_s']:.1f} s; {card}")
    else:
        f32 = r["float32"]
        say(f"{head} (c) FSDP step in {r['mesh_step_s']:.3f} s, unsharded "
            f"{r['single_step_s']:.3f} s; loss {r['loss']!r} vs {r['single_loss']!r} (err "
            f"{r['loss_err']:.3g}), worst parameter err {r['param_max_err']:.3g} (limit "
            f"{MESH_TRAIN_TOL}), grad norm rel err {r['grad_norm_rel_err']:.3g}, first moments "
            f"rel err {r['moment_rel_err']:.3g} (worst leaf {r['moment_leaf_max_rel_err']:.3g}, "
            f"replicated over model {r['replicated_moment_max_rel_err']:.3g}); float32: loss "
            f"err {f32['loss_err']:.3g}, parameter err {f32['param_max_err']:.3g}, grad norm "
            f"rel err {f32['grad_norm_rel_err']:.3g}, first moments rel err "
            f"{f32['moment_rel_err']:.3g} (limit {MESH_GRAD_RTOL}), replicated leaves "
            f"{f32['replicated_moment_max_rel_err']:.3g} (limit {MESH_REPLICATED_RTOL}); "
            f"collectives {r['collectives']}; per slot "
            f"{r['bytes_per_slot']} B of state against {r['bytes_unsharded']} B unsharded; peak "
            f"{r['peak_mem_bytes']} B; part {r['part_s']:.1f} s; {card}")

# ---------------------------------------------------------------------------
# 23. tensor parallelism over the model axis
# ---------------------------------------------------------------------------

# every slot on the one card.  (a) qwen3-4b whole (36 layers, 32 / 8 heads of
# 80), B = 2, S = 4096, prefill and forward with kernels on (2, 16): each
# model slot takes 2 query heads and the one K/V head they read (8 K/V heads
# on 16 slots: param_specs splits their head_dim, and each slot all-gathers
# its head's columns); (b) mixtral-8x7b cut to 8 layers, B = 2, S = 2048,
# the forward on (1, 16): 8 experts on 16 slots, each expert's ff split (896
# of 14,336 columns a slot); (c) phase 21(c)'s FSDP step on (2, 4) under the
# op analysis, one slot's peak and bytes beside phase 21(c)'s
TP_RUNS = {
    "prefill": {"arch": "qwen3-4b", "layers": None, "batch": 2, "seq": 4096, "mesh": (2, 16),
                "seed": 41, "dtype": None},
    "moe": {"arch": "mixtral-8x7b", "layers": 8, "batch": 2, "seq": 2048, "mesh": (1, 16),
            "seed": 42, "dtype": None},
    "train": dict(MESH_RUNS["train"], seed=43),
}


# the subtrees stacked on leading layer axes, and how many
STACKED_AXES = {"layers": 1, "enc": 1, "dec": 1, "mamba_groups": 2, "mamba_ln": 2, "mlstm": 2,
                "slstm": 1}


@contextlib.contextmanager
def param_guard(torch, params, cfg, mesh, allowed=(), state=None, state_specs=None):
    """Within the block (a run from the whole tree ``params`` under
    ``mesh``), every op that reads a tensor in the memory of a leaf that
    ``param_specs`` splits over ``model`` must read at most one model
    slot's block of it, and no op may make a tensor of such a leaf's whole
    shape or of one layer's whole shape (a view reads nothing), but for
    the leaves whose paths start with one of ``allowed`` (the documented
    exceptions, :func:`family_tp_exceptions`), which may be made whole.
    With a whole decode ``state`` and its ``state_specs``, every op that
    reads a state leaf's memory must read at most one mesh slot's block of
    it (its reads are reported under ``state/<path>``).  Yields a dict: the
    most elements any op read of a parameter, that of each split leaf (and
    state leaf) against its block, and the shapes made."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch import hlo_analysis
    from repro_torch.models import sharding

    msize = mesh.shape["model"]
    specs = sharding.param_specs(params, cfg, mesh)
    spans, whole, exempt = [], set(), set()

    def leaf(path, x):
        split = sharding.model_dim(specs_at[path]) is not None
        name = "/".join(path)
        spans.append((x.data_ptr(), x.data_ptr() + x.numel() * x.element_size(), x.numel(),
                      x.numel() // msize if split else x.numel(), name))
        if split:     # the whole leaf, and one layer of a stack
            (exempt if name.startswith(tuple(allowed)) else whole).update(
                tuple(x.shape[i:]) for i in range(STACKED_AXES.get(path[0], 0) + 1))
        return x

    specs_at = {}
    sharding._map_with_path(lambda pth, sp: specs_at.__setitem__(pth, sp), specs)
    sharding._map_with_path(leaf, params)
    whole -= exempt
    if state is not None:
        sspec = {}
        sharding._map_with_path(lambda pth, sp: sspec.__setitem__(pth, sp), state_specs)

        def state_leaf(path, x):
            n = x.numel() // math.prod(sharding._counts(sspec[path], mesh, x.dim()))
            spans.append((x.data_ptr(), x.data_ptr() + x.numel() * x.element_size(), x.numel(),
                          n, "state/" + "/".join(path)))
        sharding._map_with_path(state_leaf, state)
    report = {"max_read": 0, "over_block": [], "whole_made": [], "reads": {}}

    def tensors(xs):
        for x in xs:
            if isinstance(x, torch.Tensor):
                yield x
            elif isinstance(x, (list, tuple)):
                yield from tensors(x)

    class Guard(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if hlo_analysis._plan(func)[0] == "composite":
                with self:      # count the ops it is made of, as the analysis does
                    out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            out = func(*args, **kwargs)
            made = list(tensors([out]))
            ins = list(tensors(list(args) + list(kwargs.values())))
            held = {t.untyped_storage().data_ptr() for t in ins if t.device.type != "meta"}
            if made and all(t.device.type != "meta" and t.untyped_storage().data_ptr() in held
                            for t in made):
                return out      # a view: it reads nothing
            for t in ins:
                if t.device.type == "meta":
                    continue
                ptr = t.data_ptr()
                # an expanded dim (stride 0) reads its elements once
                n_read = math.prod(n for n, st in zip(t.shape, t.stride()) if st != 0)
                for lo, hi, n, block, name in spans:
                    if lo <= ptr < hi:
                        report["max_read"] = max(report["max_read"], n_read)
                        report["reads"][name] = max(report["reads"].get(name, 0), n_read)
                        if n_read > block:
                            report["over_block"].append((func.overloadpacket.__name__, name,
                                                         n_read, block))
                        break
            for t in made:
                if tuple(t.shape) in whole:
                    report["whole_made"].append((func.overloadpacket.__name__, tuple(t.shape)))
            return out

    with Guard():
        yield report


def check_param_guard(what: str, report: dict) -> None:
    if report["over_block"] or report["whole_made"]:
        fail(f"{what}: a slot read more than its block of a split weight "
             f"{report['over_block'][:4]} or made a whole one {report['whole_made'][:4]}")


def tp_prefill_run(torch, counters, run: dict, device, smoke: bool = False) -> dict:
    """(a) prefill and the forward of a dense model under the mesh,
    tensor-parallel, each with the counters zeroed just before and read
    just after (:func:`mesh_launches`), the collective calls exactly
    :func:`mesh_collective_calls`'s; a second forward with every kernel
    call held to its plain version on its own inputs, every flash call at
    one model slot's heads (:func:`flash_heads`), under
    :func:`param_guard`; then the single-device prefill and forward from
    the same weights: logits within :func:`_logits_close`'s limit, the
    caches ``==`` in layout."""
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import get_model
    from repro_torch.models.transformer import prefill

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = mesh_cfg(run, smoke, use_pallas=True)
    api = get_model(cfg)
    mesh = _mesh_of(run, device)
    dsize, msize = run["mesh"]
    B, S = run["batch"], run["seq"]
    t0 = time.time()
    params = api.init(run["seed"], device)
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=device,
                         generator=torch.Generator(device=device).manual_seed(run["seed"]))
    sync()
    out = {"config": cfg.arch_id, "layers": cfg.n_layers, "init_s": time.time() - t0,
           "launches": {}, "collectives": {}, "wall_s": {}}
    got = {}
    for path in ("prefill", "forward"):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        zero_counters(counters)
        collectives.TRAFFIC.clear()
        t0 = time.time()
        with use_mesh(mesh):
            got[path] = prefill(params, toks, cfg) if path == "prefill" else \
                api.forward(params, {"tokens": toks}, cfg)
        sync()
        out["wall_s"][path] = time.time() - t0
        out["collectives"][path] = {op: list(v) for op, v in collectives.TRAFFIC.items()}
        out["launches"][path] = {c.__name__: c.launches for c in counters}
        out[f"{path}_peak_mem_bytes"] = torch.cuda.max_memory_allocated() if on_card else None
        if on_card:
            check_launches(f"tp {path}", out["launches"][path],
                           mesh_launches(cfg, path, dsize, S, msize))
        check_collective_calls(f"tp {path}", out["collectives"][path],
                               mesh_collective_calls(cfg, path, dsize, msize, S, B))
    if on_card:
        check_flash_routes("tp forward", out["launches"]["forward"], route_counts(counters))
    want = mesh_launches(cfg, "forward", dsize, S, msize)
    calls, heads = [], []
    with mesh_recording(torch, calls, flash_heads_seen=heads), \
            param_guard(torch, params, cfg, mesh) as guard, use_mesh(mesh):
        api.forward(params, {"tokens": toks}, cfg)
    out["kernel_vs_plain_max_err"] = _check_calls(
        "tp forward", calls, {"rmsnorm": want["rmsnorm"],
                              "flash_attention": want["flash_attention"]})
    out["flash_heads"] = sorted(set(heads))
    if want["flash_attention"] and out["flash_heads"] != [flash_heads(cfg, msize)]:
        fail(f"tp forward: flash calls at (query, K/V) heads {out['flash_heads']}, expected "
             f"{flash_heads(cfg, msize)}")
    check_param_guard("tp forward", guard)
    out["largest_param_read"] = guard["max_read"]
    out["one_layer_projection"] = cfg.d_model * cfg.n_heads * cfg.head_dim
    sync()
    t0 = time.time()
    ref = {"prefill": prefill(params, toks, cfg), "forward": api.forward(params, {"tokens": toks},
                                                                          cfg)}
    sync()
    out["single_wall_s"] = time.time() - t0
    for path in ("prefill", "forward"):
        out[f"{path}_logits"] = _logits_close(got[path][0], ref[path][0], cfg.dtype)
        if not out[f"{path}_logits"]["ok"]:
            fail(f"tp {path}: logits against the single-device {path}'s "
                 f"{out[f'{path}_logits']}")
    a, b = got["prefill"][1].caches, ref["prefill"][1].caches
    for f in ("k", "v", "pos", "positions"):
        x, y = getattr(a, f), getattr(b, f)
        if x.shape != y.shape or x.dtype != y.dtype or x.device != y.device:
            fail(f"tp prefill: cache {f} {tuple(x.shape)} {x.dtype} {x.device}, single device "
                 f"{tuple(y.shape)} {y.dtype} {y.device}")
    if not (torch.equal(a.pos, b.pos) and torch.equal(a.positions, b.positions)):
        fail("tp prefill: cache positions differ from the single-device prefill's")
    out["cache_max_err"] = {f: float((getattr(a, f).float() - getattr(b, f).float()).abs().max())
                            for f in ("k", "v")}
    return out


def tp_phase(torch, counters, card, device: str = "cuda", runs: dict = TP_RUNS,
             smoke: bool = False) -> dict:
    """Phase 23 on ``device``: (a) :func:`tp_prefill_run`, (b)
    :func:`mesh_moe_run` on (1, 16) (the experts' ff split), (c)
    :func:`mesh_train_run` under the op analysis, each from its own seeded
    weights, freed before the next."""
    on_card = torch.device(device).type == "cuda"
    out, by_path = {"card": card}, {}
    for name in ("prefill", "moe", "train"):
        t0 = time.time()
        if name == "prefill":
            res = tp_prefill_run(torch, counters, runs[name], device, smoke)
            by_path.update({f"tp {p}": res["launches"][p] for p in ("prefill", "forward")})
        elif name == "moe":
            res = mesh_moe_run(torch, counters, runs[name], device, smoke)
            by_path["tp moe"] = res["launches"]
        else:
            res = mesh_train_run(torch, counters, runs[name], device, smoke, analysis=True)
            by_path["tp train"] = res["launches"]
        res["part_s"] = time.time() - t0
        out[name] = res
        say_tp_part(name, res, runs[name], card)
        if on_card:
            torch.cuda.empty_cache()
    out["by_path"] = by_path
    return out


def say_tp_part(name: str, r: dict, run: dict, card) -> None:
    """The line phase 23 prints for part ``name`` as it ends."""
    head = (f"phase tp: {r['config']} {r['layers']} layers B={run['batch']} S={run['seq']} on a "
            f"{run['mesh']} mesh:")
    if name == "prefill":
        say(f"{head} (a) prefill {r['wall_s']['prefill']:.3f} s and forward "
            f"{r['wall_s']['forward']:.3f} s tensor-parallel, both one device "
            f"{r['single_wall_s']:.3f} s; peaks {r['prefill_peak_mem_bytes']} / "
            f"{r['forward_peak_mem_bytes']} B; logits {r['prefill_logits']} / "
            f"{r['forward_logits']}; caches == in layout (k/v max err {r['cache_max_err']}); "
            f"flash at (query, K/V) heads {r['flash_heads']}; every call within its plain "
            f"version (worst {r['kernel_vs_plain_max_err']}); largest parameter block read "
            f"{r['largest_param_read']} elements (one layer's wq {r['one_layer_projection']}), no "
            f"whole split weight; collectives {r['collectives']}; launches {r['launches']}; part "
            f"{r['part_s']:.1f} s; {card}")
    elif name == "moe":
        say(f"{head} (b) forward in {r['mesh_wall_s']:.3f} s; peak {r['peak_mem_bytes']} B; MoE "
            f"{r['moe']}; flash at {r['flash_heads']}; every call within its plain version "
            f"(worst {r['kernel_vs_plain_max_err']}); collectives {r['collectives']}; launches "
            f"{r['launches']}; part {r['part_s']:.1f} s; {card}")
    else:
        f32 = r["float32"]
        say(f"{head} (c) FSDP step under the op analysis in {r['mesh_step_s']:.3f} s, unsharded "
            f"{r['single_step_s']:.3f} s; loss err {r['loss_err']:.3g}, worst parameter err "
            f"{r['param_max_err']:.3g} (limit {MESH_TRAIN_TOL}), grad norm rel err "
            f"{r['grad_norm_rel_err']:.3g}, first moments rel err {r['moment_rel_err']:.3g}; "
            f"float32: grad norm rel err {f32['grad_norm_rel_err']:.3g}, first moments rel err "
            f"{f32['moment_rel_err']:.3g} (limit {MESH_GRAD_RTOL}), replicated leaves "
            f"{f32['replicated_moment_max_rel_err']:.3g} (limit {MESH_REPLICATED_RTOL}); per "
            f"slot {r['bytes_per_slot']} B of state + "
            f"{r['slot_view_bytes']} B of data-gathered weights held, peak "
            f"{r['slot_peak_bytes']} B charged (card peak over every slot "
            f"{r['peak_mem_bytes']} B); collectives {r['collectives']}; part "
            f"{r['part_s']:.1f} s; {card}")


# ---------------------------------------------------------------------------
# 22. the dry run held against the card
# ---------------------------------------------------------------------------

# (a) one slot: qwen3-4b prefill at full width with kernels; (b) phase 21(c)'s
# FSDP step on its (2, 4) mesh; (c) production dry runs on meta, the cell cut
# to 12 of 36 layers and the pipelines to 4 microbatches (at 36 layers and 8
# microbatches they took 227.8 s and 130-143 s, which put the whole script
# over 1,200 s once phase 25 came; PERF.md)
DRYRUN_RUNS = {
    "validate": {"arch": ARCH, "kind": "prefill", "batch": 1, "seq": FWD_S, "mesh": (1, 1),
                 "overrides": {"use_pallas": True}, "seed": 31},
    "mesh": {"arch": MESH_RUNS["train"]["arch"], "kind": "train",
             "batch": MESH_RUNS["train"]["batch"], "seq": MESH_RUNS["train"]["seq"],
             "mesh": MESH_RUNS["train"]["mesh"], "seed": 32,
             "overrides": {"n_layers": MESH_RUNS["train"]["layers"], "fsdp_params": True,
                           "accum_steps": MESH_RUNS["train"]["accum"]}},
    "production": {"arch": ARCH, "shape": "train_4k", "stragglers": (1.0, 2.0),
                   "pipeline_shape": None, "layers": 12, "microbatches": 4},
}
# the analysis a dry run on meta must match on the card: (a) every count,
# (b) the traffic between slots
DRYRUN_EXACT = ("dot_flops", "bytes_accessed", "bytes_by_kind", "launches")
DRYRUN_COLLECTIVES = ("collectives", "collective_counts")
# the dry run's per-slot peak (arguments + temp) against max_memory_allocated
# less the process's holdings before the cell: it read 0.19 % and 0.014 %
# apart on the card (two runs); 1 % keeps the largest tensor the model could
# leave out under 0.19 GB of (a)'s 18.7 GB (its logits are 1.24 GB)
DRYRUN_PEAK_RTOL = 0.01
# (c)'s children together: 173-196 s for the longest on the card's host
DRYRUN_CHILD_TIMEOUT = 900


def dryrun_diffs(real: dict, meta: dict, keys) -> dict:
    """key -> what differs between two op analyses at ``keys``: the entries
    of a dict that differ, else the two values."""
    out = {}
    for key in keys:
        a, b = real.get(key), meta.get(key)
        if a == b:
            continue
        if isinstance(a, dict) and isinstance(b, dict):
            out[key] = {k: (a.get(k), b.get(k)) for k in sorted(set(a) | set(b))
                        if a.get(k) != b.get(k)}
        else:
            out[key] = (a, b)
    return out


def dryrun_pair(torch, counters, run: dict, device, smoke: bool = False) -> tuple:
    """``run_cell`` of ``run`` on ``device`` (the counters zeroed just before
    and read just after), then on meta: (real record, meta record, the
    counters' launches)."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.common import ShapeSpec

    shape = ShapeSpec(f"{run['kind']}_{run['seq']}_b{run['batch']}", run["kind"], run["seq"],
                      run["batch"])
    kw = dict(shape=shape, mesh=(run["mesh"], ("data", "model")), overrides=run["overrides"],
              seed=run["seed"], smoke=smoke)
    zero_counters(counters)
    real = run_cell(run["arch"], shape.name, device=device, **kw)
    launches = {c.__name__: c.launches for c in counters}
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    meta = run_cell(run["arch"], shape.name, device="meta", **kw)
    return real, meta, launches


def dryrun_validate(torch, counters, run: dict, device, smoke: bool = False) -> dict:
    """(a) the cell on one slot for real and on meta: the op analyses ``==``
    (:data:`DRYRUN_EXACT`), the launches those of a ``use_pallas`` forward
    (and, on the card, the wrappers' counters the same), the predicted
    per-slot peak within :data:`DRYRUN_PEAK_RTOL` of the card's; the
    measured step time against max(compute, memory) of the analysis over
    one H100's peaks (reported, not gated)."""
    from repro_torch.configs import get_config, get_smoke_config

    real, meta, counted = dryrun_pair(torch, counters, run, device, smoke)
    diffs = dryrun_diffs(real["hlo"], meta["hlo"], DRYRUN_EXACT)
    if diffs:
        fail(f"dry run (a): the meta analysis differs from the {device} run's: {diffs}")
    cfg = (get_smoke_config if smoke else get_config)(run["arch"])
    # the dry run's prefill cell is the reference's: the forward's logits,
    # so RMSNorm 2L + 1 and flash once a layer where its gate passes
    want = {k: v for k, v in mesh_launches(cfg, "forward", 1, run["seq"]).items() if v}
    if real["hlo"]["launches"] != want:
        fail(f"dry run (a): the analysis counted launches {real['hlo']['launches']}, a "
             f"use_pallas forward launches {want}")
    on_card = torch.device(device).type == "cuda"
    if on_card and {k: v for k, v in counted.items() if v} != want:
        fail(f"dry run (a): the wrappers counted {counted}, the analysis {want}")
    mem = meta["memory"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    measured = real.get("measured_peak_bytes")
    out = {"config": run["arch"], "hlo_equal": True, "launches": counted,
           "analysis_launches": real["hlo"]["launches"], "dot_flops": meta["hlo"]["dot_flops"],
           "bytes_accessed": meta["hlo"]["bytes_accessed"], "predicted_peak_bytes": predicted,
           "measured_peak_bytes": measured, "wall_s": real["step_s"],
           "meta_step_s": meta["step_s"]}
    if measured is not None:
        out["peak_rel_err"] = abs(predicted - measured) / measured
        if out["peak_rel_err"] > DRYRUN_PEAK_RTOL:
            fail(f"dry run (a): predicted peak {predicted} B, the card's {measured} B "
                 f"({out['peak_rel_err']:.1%} apart, limit {DRYRUN_PEAK_RTOL:.0%})")
    terms = {"compute": meta["hlo"]["dot_flops"] / BF16_TENSOR_FLOPS_PER_S,
             "memory": meta["hlo"]["bytes_accessed"] / HBM_BYTES_PER_S}
    out["terms_s"] = terms
    out["wall_over_roofline"] = real["step_s"] / max(terms.values())
    return out


def dryrun_mesh(torch, counters, run: dict, device, smoke: bool = False) -> dict:
    """(b) the FSDP step on its mesh for real and on meta: the traffic
    between slots ``==`` (:data:`DRYRUN_COLLECTIVES`); the other counts'
    differences reported."""
    real, meta, counted = dryrun_pair(torch, counters, run, device, smoke)
    diffs = dryrun_diffs(real["hlo"], meta["hlo"], DRYRUN_COLLECTIVES)
    if diffs:
        fail(f"dry run (b): the meta run's collectives differ from the {device} run's: {diffs}")
    if any(counted.values()):
        fail(f"dry run (b): the train step launched {counted}; training runs the plain versions")
    return {"config": run["arch"], "launches": counted, "collectives": meta["hlo"]["collectives"],
            "collective_counts": meta["hlo"]["collective_counts"],
            "other_diffs": dryrun_diffs(real["hlo"], meta["hlo"], DRYRUN_EXACT),
            "memory": meta["memory"], "wall_s": real["step_s"], "meta_step_s": meta["step_s"],
            "measured_peak_bytes": real.get("measured_peak_bytes")}


def dryrun_production_record(what: str, run: dict, smoke: bool = False) -> dict:
    """One of (c)'s dry runs on meta, on the host: ``"cell"`` is ``run_cell``
    of the production cell on pod16x16 cut to ``run["layers"]`` layers,
    ``"pipeline <straggler>"`` ``run_pipeline_cell`` at that straggler over
    ``run["microbatches"]`` microbatches (its plan covering every layer);
    the record's per-slot memory, ``fits``, dot TFLOP, collective GB and
    plan."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.dryrun import run_cell, run_pipeline_cell

    t0 = time.time()
    cfg = (get_smoke_config if smoke else get_config)(run["arch"])
    if what == "cell":
        rec = run_cell(run["arch"], run["shape"], device="meta", smoke=smoke, detail=False,
                       overrides={"n_layers": min(cfg.n_layers, run["layers"])})
    else:
        st = float(what.split()[1])
        shape = None
        if run["pipeline_shape"]:
            from repro_torch.models.common import ShapeSpec

            shape = ShapeSpec(*run["pipeline_shape"])
        rec = run_pipeline_cell(run["arch"], run["microbatches"], straggler=st, device="meta",
                                smoke=smoke, shape=shape, detail=False)
        if sum(rec["plan"]["stage_sizes"]) != cfg.n_layers:
            fail(f"dry run (c): the plan at straggler {st} ({rec['plan']['stage_sizes']}) does "
                 f"not cover the {cfg.n_layers} layers")
    mem = rec["memory"]
    out = {"arch": run["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
           "argument_bytes": mem["argument_size_in_bytes"],
           "temp_bytes": mem["temp_size_in_bytes"], "fits": mem["fits"],
           "dot_tflop": rec["hlo"]["dot_flops"] / 1e12,
           "collective_gb": {k: v / 1e9 for k, v in rec["hlo"]["collectives"].items()},
           "step_s": rec["step_s"], "s": time.time() - t0}
    if "plan" in rec:
        out["plan"] = rec["plan"]
        out["cut"] = f"{run['microbatches']} microbatches"
    else:
        out["cut"] = f"{min(cfg.n_layers, run['layers'])} of {cfg.n_layers} layers"
    return out


def dryrun_production_whats(run: dict) -> list:
    return ["cell"] + [f"pipeline {st}" for st in run["stragglers"]]


def _stop_children(children: dict) -> None:
    for child, _ in children.values():
        if child.poll() is None:
            child.kill()
            child.wait()


def start_production_children(run: dict, smoke: bool = False) -> dict:
    """(c)'s dry runs (:func:`dryrun_production_record`), each in a child
    process, all started at once (host work on meta tensors): a handle for
    :func:`join_production_children`.  A child still running when the
    script exits is stopped then."""
    import atexit
    import os
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    children = {}
    work = tempfile.TemporaryDirectory()
    try:
        for what in dryrun_production_whats(run):
            out = pathlib.Path(work.name) / (what.replace(" ", "_") + ".json")
            children[what] = (subprocess.Popen(
                [sys.executable, str(pathlib.Path(__file__).resolve()), "--dryrun-production",
                 what, str(out), json.dumps({"run": run, "smoke": smoke})], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out)
    except BaseException:
        _stop_children(children)
        work.cleanup()
        raise
    atexit.register(_stop_children, children)
    return {"children": children, "work": work, "t_end": time.time() + DRYRUN_CHILD_TIMEOUT}


def join_production_children(handle: dict) -> dict:
    """What -> record of the children :func:`start_production_children`
    started.  A child that fails, or runs past
    :data:`DRYRUN_CHILD_TIMEOUT` from its start, fails the phase; every
    child has ended or been stopped when this returns."""
    children = handle["children"]
    try:
        recs = {}
        for what, (child, path) in children.items():
            try:
                _, err = child.communicate(timeout=max(handle["t_end"] - time.time(), 1.0))
            except subprocess.TimeoutExpired:
                fail(f"dry run (c): {what} did not end within {DRYRUN_CHILD_TIMEOUT} s")
            if child.returncode != 0 or not path.exists():
                fail(f"dry run (c): {what} failed: {err[-2000:]}")
            recs[what] = json.loads(path.read_text())
        return recs
    finally:
        _stop_children(children)
        handle["work"].cleanup()


def say_dryrun_production(c: dict) -> None:
    """The lines phase 22 prints for (c)'s records."""
    for what, rec in c.items():
        plan = ""
        if "plan" in rec:
            plan = (f"plan {rec['plan']['stage_sizes']} on pods {rec['plan']['alloc']} "
                    f"({rec['plan']['planner']}, period {rec['plan']['period_s']:.6g} s); ")
        say(f"phase dryrun: (c) meta {rec['arch']} {what} {rec['shape']} ({rec['cut']}) on "
            f"{rec['mesh']}: "
            f"{plan}per slot {rec['argument_bytes'] / 1e9:.2f} GB arguments + "
            f"{rec['temp_bytes'] / 1e9:.2f} GB temp, fits {rec['fits']}, "
            f"{rec['dot_tflop']:.1f} dot TFLOP, collectives "
            f"{ {k: round(v, 2) for k, v in rec['collective_gb'].items()} } GB; "
            f"{rec['s']:.1f} s in its process")


def dryrun_phase(torch, counters, card, device: str = "cuda", runs: dict = DRYRUN_RUNS,
                 smoke: bool = False, defer: bool = False) -> dict:
    """Phase 22 on ``device``: (a) :func:`dryrun_validate`, (b)
    :func:`dryrun_mesh`, then (c) the production dry runs on meta in child
    processes at once (:func:`start_production_children`), joined here or,
    with ``defer``, left running under ``"production_pending"`` for the
    caller to join (:func:`join_production_children`)."""
    out = {"card": card}
    t0 = time.time()
    a = out["validate"] = dryrun_validate(torch, counters, runs["validate"], device, smoke)
    a["part_s"] = time.time() - t0
    say(f"phase dryrun: (a) {a['config']} prefill (forward) B={runs['validate']['batch']} "
        f"S={runs['validate']['seq']} with kernels on one slot: meta analysis == the card "
        f"run's (dot {a['dot_flops']:.6g} flop, {a['bytes_accessed']:.6g} B, launches "
        f"{a['analysis_launches']}); peak predicted {a['predicted_peak_bytes']} B, measured "
        f"{a['measured_peak_bytes']} B (rel err {a.get('peak_rel_err')}); step "
        f"{a['wall_s']:.3f} s (under the analysis) = {a['wall_over_roofline']:.2f} x "
        f"max(compute {a['terms_s']['compute']:.4f} s, memory {a['terms_s']['memory']:.4f} s) "
        f"at 989 TFLOP/s and 3.35 TB/s; meta step {a['meta_step_s']:.1f} s; part "
        f"{a['part_s']:.1f} s; {card}")
    t0 = time.time()
    b = out["mesh"] = dryrun_mesh(torch, counters, runs["mesh"], device, smoke)
    b["part_s"] = time.time() - t0
    say(f"phase dryrun: (b) {b['config']} FSDP step on {runs['mesh']['mesh']}: collectives "
        f"== ({b['collectives']}, calls {b['collective_counts']}); other counts' differences "
        f"{b['other_diffs'] or 'none'}; per slot {b['memory']['argument_size_in_bytes']} B "
        f"arguments + {b['memory']['temp_size_in_bytes']} B temp; step {b['wall_s']:.3f} s, "
        f"peak {b['measured_peak_bytes']} B; part {b['part_s']:.1f} s; {card}")
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    handle = start_production_children(runs["production"], smoke)
    if defer:
        out["production_pending"] = handle
    else:
        out["production"] = c = join_production_children(handle)
        out["production_s"] = time.time() - t0
        say_dryrun_production(c)
    out["by_path"] = {"dryrun validate": a["launches"], "dryrun mesh": b["launches"]}
    return out



# ---------------------------------------------------------------------------
# 24. decode over the mesh, the decode state left where state_specs puts it
# ---------------------------------------------------------------------------

# every slot on the one card.  (a) qwen3-4b whole (36 layers, 32 / 8 heads of
# 80), B = 8, a cache of 4,096 slots drawn from the seed and filled to 4,000
# positions, on (2, 16): 8 K/V heads on 16 model slots, so ``state_specs``
# splits the cache's head_dim (5 of 80 columns a slot): the head-dim layout;
# (b) the same weights and state on (2, 8): one K/V head a model slot, the
# decode-attention kernel on each (data, model) slot; (c) mixtral-8x7b cut
# to 4 layers, B = 1, its 4,096-slot window filled to 5,000 positions (the
# ring wrapped), on (4, 8): one K/V head and one expert a model slot, the
# cache length split over the 4 data slots (1,024 slots each), partials
# merged by their log-sum-exp
DECODE_RUNS = {
    "cols": {"arch": "qwen3-4b", "layers": None, "batch": 8, "capacity": 4096, "filled": 4000,
             "steps": 8, "mesh": (2, 16), "seed": 51, "dtype": None, "float32_pair": True},
    "heads": {"arch": "qwen3-4b", "layers": None, "batch": 8, "capacity": 4096, "filled": 4000,
              "steps": 8, "mesh": (2, 8), "seed": 51, "dtype": None},
    "length": {"arch": "mixtral-8x7b", "layers": 4, "batch": 1, "capacity": 4096,
               "filled": 5000, "steps": 8, "mesh": (4, 8), "seed": 52, "dtype": None},
}
# a kernel call's log-sum-exp against its plain version's: the kernel's
# exponentials are the SFU's ex2 (~2 ulp), its sums in another order
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5


def decode_layout_of(cfg, msize: int) -> str:
    """The layout ``state_specs`` gives a decode over ``msize`` model slots
    (:func:`repro_torch.models.attention.decode_layout`'s rule)."""
    if msize == 1 or cfg.n_kv_heads % msize == 0:
        return "heads"
    return "cols" if cfg.head_dim % msize == 0 else "whole"


def decode_holders(cfg, dsize: int, batch: int, capacity: int) -> tuple:
    """(data slots that carry rows, data slots holding a part of each
    carried row's cache, whether each holder computes a partial): the batch
    split over the data slots (each its own), else the cache length (every
    data slot a slice), else the cache replicated (one computes)."""
    C = min(capacity, cfg.sliding_window) if cfg.sliding_window else capacity
    if batch % dsize == 0:
        return dsize, 1, True
    return 1, dsize, C % dsize == 0


def decode_launches(cfg, dsize: int, msize: int, batch: int, capacity: int, steps: int,
                    mesh: bool = True) -> dict:
    """The kernels ``steps`` decode steps launch: on one device (``mesh``
    off) the decode-attention kernel once per layer under ``use_pallas``;
    over the mesh, in the heads layout, once per layer on each model slot of
    each data slot that computes a partial; none in the head-dim layout
    (plain PyTorch there) and no RMSNorm (decode's norms are plain, as one
    device's)."""
    out = dict.fromkeys(KERNEL_NAMES, 0)
    if not cfg.use_pallas:
        return out
    L = cfg.n_layers
    if not mesh:
        out["decode_attention"] = steps * L
    elif decode_layout_of(cfg, msize) == "heads":
        D, H, each = decode_holders(cfg, dsize, batch, capacity)
        out["decode_attention"] = steps * L * D * (H if each else 1) * msize
    return out


def decode_collective_calls(cfg, dsize: int, msize: int, batch: int, capacity: int,
                            steps: int) -> dict:
    """The collective calls of ``steps`` mesh decode steps from placed
    weights (not ``zero1_specs``) and a state placed by ``state_specs``,
    from ``param_specs``'s split of each leaf, per step:

    - the token ``scatter`` over the D data slots that carry rows; with
      M > 1 model slots, per carrier, the token ``broadcast`` to its model
      slots and the embedding's ``psum`` (vocabulary split) or
      ``all_gather`` (``d_model`` split);
    - per layer per carrier: where other data slots hold a part of the
      cache, one ``broadcast`` per model slot of its packed q / k / v to
      them, and, where several compute, two ``gather`` per model slot of
      their partial outputs and log-sum-exps; the heads layout: the output's
      ``psum``; the head-dim layout: an ``all_gather`` (heads or head_dim
      split) or ``psum`` (``d_model`` split) of q and of k (and of v where
      ``wv`` does not split head_dim), each computing holder's score
      ``psum``, the output columns' ``all_gather`` unless ``wo`` splits
      head_dim too, then ``wo``'s ``psum`` (heads or head_dim split) or
      ``all_gather`` (``d_model``); the FFN as the forward's (the MLP's or
      the split experts' ``psum``; an MoE whose dispatch gathers the data
      slots' rows a ``gather`` and a ``scatter`` per dispatching model
      slot);
    - per carrier the logits' ``gather`` (with a ``psum`` of the partial
      logits first where ``d_model`` is split)."""
    import collections

    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.models import moe

    M = msize
    named = _split_dims(cfg, M)
    layer = {k[len("layers/"):]: (None if d is None else "owner" if d == 0 else d - 1)
             for k, d in named.items() if k.startswith("layers/")}
    D, H, each = decode_holders(cfg, dsize, batch, capacity)
    computing = H if each else 1
    layout = decode_layout_of(cfg, M)
    calls = _decode_embed_calls(named, cfg, D, M)
    per, once = collections.Counter(), collections.Counter()
    per.update(_decode_attn_calls(_sub_dims(layer, "attn/", 0), M, H, computing, layout))
    ffn = [("mlp", layer.get("mlp/wi"))]
    if cfg.family == "moe":
        dcfg = cfg.replace(capacity_factor=max(cfg.capacity_factor, 8.0))
        with use_mesh(make_mesh((dsize, M), ("data", "model"), devices=["meta"] * (dsize * M))):
            own = moe._per_data_slot(dcfg, batch, 1, D)[1]
        inner = M > 1 and layer["moe/wi"] in (0, 2)
        experts = sum(layer[f"moe/{k}"] is not None for k in ("router", "wi", "wg", "wo"))
        (per if own else once)["gather"] += 0 if inner else experts
        if not own:
            once.update({"gather": M if inner else 1, "scatter": M if inner else 1})
        if inner:
            per["psum"] += 1
        elif M > 1:
            per["broadcast"] += 1
        ffn = [("moe/dense", layer.get("moe/dense/wi"))] if cfg.dense_residual else []
    for pre, d in ffn:
        if M == 1:
            continue
        if d == 1:
            per["psum"] += 1
        else:
            per["gather"] += sum(v is not None for k, v in layer.items() if k.startswith(pre + "/"))
            per["broadcast"] += 1
    L = cfg.n_layers
    for k, v in per.items():
        calls[k] += v * L * D
    for k, v in once.items():
        calls[k] += v * L
    return {k: v * steps for k, v in sorted(calls.items()) if v}


def _decode_embed_calls(named: dict, cfg, D: int, M: int):
    """A decode step's collective calls outside its layers: the token
    ``scatter`` over the data slots; per carrying data slot, with M > 1
    model slots, the token ``broadcast`` to its model slots and the
    embedding's ``psum`` (vocabulary split) or ``all_gather`` (``d_model``
    split); the logits' ``gather`` (with a ``psum`` of the partial logits
    first where ``d_model`` is split)."""
    import collections

    calls = collections.Counter()
    calls["scatter"] += 1
    if M > 1:
        calls["broadcast"] += D
        if named["embed/tok"] is not None:
            calls["psum" if named["embed/tok"] == 0 else "all_gather"] += D
    head = named["embed/tok"] if cfg.tie_embeddings else named["embed/unembed"]
    calls["psum"] += D * (M > 1 and head == (1 if cfg.tie_embeddings else 0))
    calls["gather"] += D
    return calls


def _decode_attn_calls(layer: dict, M: int, H: int, computing: int, layout: str):
    """One decode attention's collective calls per carrying data slot
    (``decode_attention_row``), ``layer`` the dims of one layer's attention
    leaves, as :func:`decode_collective_calls` lists them."""
    import collections

    per = collections.Counter()
    if H > 1:
        per["broadcast"] += M
    if computing > 1:
        per["gather"] += 2 * M
    if layout == "heads":
        per["psum"] += M > 1
        return per
    split = layout == "cols" and M > 1
    for w in ("wq", "wk", "wv"):
        d = layer[w]
        if d is None or M == 1 or (w == "wv" and split and d == 2):
            continue
        per["psum" if d == 0 else "all_gather"] += 1
    per["psum"] += computing * split
    per.update(_out_row_calls(layer["wo"], M, split))
    return per


def _out_row_calls(d, M: int, split: bool):
    """``attention._out_row``'s calls, ``d`` the dim ``wo`` splits: a
    ``psum`` where it splits head_dim as the columns are; else the columns'
    ``all_gather`` and ``wo``'s ``psum`` (heads or head_dim split) or
    ``all_gather`` (``d_model``)."""
    import collections

    per = collections.Counter()
    if M > 1:
        if d == 1 and split:
            per["psum"] += 1
        else:
            per["all_gather"] += split
            if d in (0, 1):
                per["psum"] += 1
            elif d == 2:
                per["all_gather"] += 1
    return per


def decode_state_fill(torch, api, batch: int, capacity: int, filled: int, seed: int, device):
    """A decode state of ``capacity`` slots (the window where smaller) as
    ``filled`` tokens of decode would leave it: each ring slot holds the
    latest position written to it (-1 where none was), ``pos`` is
    ``filled``, K and V are ``normal * 0.5`` drawn from ``seed`` (the
    unwritten slots' too: the mask must hide them)."""
    st = api.init_decode_state(batch, capacity, device)
    c = st.caches
    C = c.k.shape[2]
    g = torch.Generator(device=device).manual_seed(seed)
    for t in (c.k, c.v):
        for i in range(t.shape[0]):       # a layer at a time: one layer's float32 draw
            t[i].copy_(torch.randn(t[i].shape, generator=g, device=device) * 0.5)
    slot = torch.arange(C, device=device)
    p = (filled - 1) - (filled - 1 - slot) % C
    c.positions.copy_(torch.where(p >= 0, p, -1).to(torch.int32).expand_as(c.positions))
    c.pos.fill_(filled)
    return st


@contextlib.contextmanager
def decode_recording(torch, calls: list):
    """Within the block every decode-attention call through the kernels'
    ``ops`` wrapper is held to its plain version on its own inputs: the
    output by phase 7's limit, a log-sum-exp (the cache-length split's
    route) within ``LSE_ATOL + LSE_RTOL |want|``; each call's (name, max abs
    err, within) is appended to ``calls``."""
    from repro_torch.kernels import ops, ref

    real = ops.decode_attention

    def rec(q, k, v, positions, pos, *, window=None, return_lse=False):
        got = real(q, k, v, positions, pos, window=window, return_lse=return_lse)
        mask = ops.decode_mask(positions, pos, window)
        want = ref.decode_attention_ref(q, k, v, mask, return_lse)
        if return_lse:
            ok, err = _within(torch, got[0], want[0])
            lerr = (got[1] - want[1]).abs()
            lok = bool((lerr <= LSE_ATOL + LSE_RTOL * want[1].abs()).all())
            calls.append(("decode_attention_lse", float(lerr.max()), lok))
        else:
            ok, err = _within(torch, got, want)
        calls.append(("decode_attention", err, ok))
        return got

    ops.decode_attention = rec
    try:
        yield calls
    finally:
        ops.decode_attention = real


def _shard_ptrs(state) -> list:
    from repro_torch.models import sharding

    out = []
    sharding._map_leaves(lambda x: out.append(tuple(t.data_ptr() for t in x.shards)), state)
    return out


def decode_mesh_run(torch, counters, name: str, run: dict, cfg, params, device) -> dict:
    """One part of phase 24: ``run["steps"]`` decode steps of ``cfg`` on
    one device from a :func:`decode_state_fill` state (the counters zeroed
    just before and read just after: one decode-attention launch a layer
    under ``use_pallas``; an MoE's every dispatch held to
    :func:`check_moe_layer`, its routing recorded), then the same steps on
    the same tokens over the mesh from the weights and the state placed by
    ``param_specs`` and ``state_specs`` (counters zeroed just before and
    read just after: :func:`decode_launches`, the collective calls exactly
    :func:`decode_collective_calls`'s; an MoE routed as one device routed,
    each layer's own choice a near-tie where it differs,
    :func:`forced_routing`): every step's logits within
    :func:`_logits_close`'s limit of one device's; the state's blocks the
    same tensors after the steps; gathered afterwards, ``pos`` and the
    positions ``==`` one device's, the written K/V columns of layer 0
    within the bf16 rounding of one device's (per element) and those of
    every layer within the logits' limit, every other column untouched; then,
    where the layout launches the kernel, the mesh steps again from a fresh
    placement with every kernel call held to its plain version.  With
    ``run["float32_pair"]`` a bf16 run is also held to
    :func:`decode_float32_pair`."""
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import get_model, moe, sharding

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    api = get_model(cfg)
    mesh = _mesh_of(run, device)
    dsize, msize = run["mesh"]
    B, steps, cap = run["batch"], run["steps"], run["capacity"]
    state0 = decode_state_fill(torch, api, B, cap, run["filled"], run["seed"], device)
    toks = torch.randint(0, cfg.vocab_size, (B, steps), device=device, dtype=torch.int32,
                         generator=torch.Generator(device=device).manual_seed(run["seed"] + 1))
    out = {"config": cfg.arch_id, "layers": cfg.n_layers, "capacity": state0.caches.k.shape[2],
           "layout": decode_layout_of(cfg, msize)}
    ref_state = clone_state(state0)
    is_moe = cfg.family == "moe"
    zero_counters(counters)
    t0 = time.time()
    want = []
    with moe_checks(torch, moe) if is_moe else contextlib.nullcontext([]) as routed:
        for t in range(steps):
            lg, ref_state = api.decode(params, ref_state, toks[:, t:t + 1])
            want.append(lg)
        sync()
    out["single_wall_s"] = time.time() - t0
    out["single_launches"] = {c.__name__: c.launches for c in counters}
    if on_card:
        check_launches(f"decode {name} one device", out["single_launches"],
                       decode_launches(cfg, dsize, msize, B, cap, steps, mesh=False))
    per = msize if is_moe and moe_split(cfg, msize) != "none" else 1
    forced = [r for r in routed for _ in range(per)]
    pparams = sharding.place(params, sharding.param_specs(params, cfg, mesh), mesh)
    specs = sharding.state_specs(state0, cfg, mesh, B)
    pstate = sharding.place(state0, specs, mesh)
    ptrs = _shard_ptrs(pstate)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    collectives.TRAFFIC.clear()
    got = []
    t0 = time.time()
    with forced_routing(moe, forced) if is_moe else contextlib.nullcontext() as flips, \
            use_mesh(mesh):
        for t in range(steps):
            lg, pstate = api.decode(pparams, pstate, toks[:, t:t + 1])
            got.append(lg)
        sync()
    out["mesh_wall_s"] = time.time() - t0
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() if on_card else None
    out["launches"] = {c.__name__: c.launches for c in counters}
    out["collectives"] = {op: list(v) for op, v in collectives.TRAFFIC.items()}
    out["routing"] = flips
    if on_card:
        check_launches(f"decode {name}", out["launches"],
                       decode_launches(cfg, dsize, msize, B, cap, steps))
    check_collective_calls(f"decode {name}", out["collectives"],
                           decode_collective_calls(cfg, dsize, msize, B, cap, steps))
    worst = {"max_err": 0.0, "mean_rel_err": 0.0}
    for t, (g, w) in enumerate(zip(got, want)):
        close = _logits_close(g, w, cfg.dtype)
        if not close["ok"] or tuple(g.shape) != (B, 1, cfg.vocab_size):
            fail(f"decode {name}: step {t}'s logits {tuple(g.shape)} against one device's "
                 f"{close}")
        worst = {k: max(v, close[k]) for k, v in worst.items()}
    out["logits"] = worst
    if _shard_ptrs(pstate) != ptrs or sharding.state_specs(state0, cfg, mesh, B) != specs:
        fail(f"decode {name}: the state's blocks are not the placed blocks after the steps")
    a, b, s0 = sharding.gather(pstate).caches, ref_state.caches, state0.caches
    if not (torch.equal(a.pos, b.pos) and torch.equal(a.positions, b.positions)):
        fail(f"decode {name}: pos or positions differ from one device's")
    C = out["capacity"]
    written = torch.tensor(sorted({(run["filled"] + t) % C for t in range(steps)}),
                           device=a.k.device)
    rest = torch.ones(C, dtype=torch.bool, device=a.k.device)
    rest[written] = False
    out["cache"] = {}
    for f in ("k", "v"):
        x, y, x0 = getattr(a, f), getattr(b, f), getattr(s0, f)
        if not torch.equal(x[:, :, rest], x0[:, :, rest]):
            fail(f"decode {name}: the step wrote {f} outside the token's ring slots")
        x, y = x[:, :, written], y[:, :, written]
        # layer 0's columns carry the projections' rounding alone: each
        # element within it; every layer's carry the rounding of the layers
        # before (the slots' partial sums round apart), held as the logits
        first_ok, first_err = _within(torch, x[0], y[0])
        close = _logits_close(x, y, cfg.dtype, f32_tol=F32_TOL)
        if not (first_ok and close["ok"]):
            fail(f"decode {name}: written {f} columns differ from one device's: layer 0 by "
                 f"{first_err}, all layers {close}")
        out["cache"][f] = {"layer0_max_err": first_err,
                           "layer0_equal_share": float((x[0] == y[0]).float().mean()),
                           "max_err": close["max_err"], "mean_rel_err": close["mean_rel_err"],
                           "equal_share": float((x == y).float().mean())}
    if cfg.dtype != "float32" and run.get("float32_pair"):
        del pparams, pstate
        out["float32"] = decode_float32_pair(torch, cfg, params, state0, toks, mesh, name,
                                             {"one device": want, "mesh": got})
    n_kernel = decode_launches(cfg, dsize, msize, B, cap, steps)["decode_attention"]
    if n_kernel:
        pparams = sharding.place(params, sharding.param_specs(params, cfg, mesh), mesh)
        calls = []
        rstate = sharding.place(state0, specs, mesh)
        forced = [r for r in routed for _ in range(per)]
        with decode_recording(torch, calls), use_mesh(mesh), \
                forced_routing(moe, forced) if is_moe else contextlib.nullcontext():
            for t in range(steps):
                api.decode(pparams, rstate, toks[:, t:t + 1])
        lse = decode_holders(cfg, dsize, B, cap)[1] > 1
        want_calls = {"decode_attention": n_kernel} | (
            {"decode_attention_lse": n_kernel} if lse else {})
        out["kernel_vs_plain_max_err"] = _check_calls(f"decode {name}", calls, want_calls)
        del rstate
    return out


def decode_float32_pair(torch, cfg, params, state0, toks, mesh, name: str,
                        bf16: dict) -> dict:
    """The same steps in float32 from the same (bf16) weights and state, on
    one device and over the mesh.  How far each bf16 run's logits
    (``bf16``: run name -> per-step logits) lie from the float32 one
    device's is reported: at qwen3-4b's full width one device's own are
    ~4.4 % off (mean rel, PERF.md), so the bf16 pair's limit sees a fault
    only once it moves the logits by as much; the float32 pair holds the
    mesh to one device within
    :data:`LOGIT_F32_TOL`, layer 0's cache within :data:`F32_TOL` and every
    layer's within :data:`LOGIT_F32_TOL` (the slots' partial sums round
    apart, and each layer carries the rounding of those before: 2.6e-5 at
    qwen3-4b's full width on the card)."""
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import get_model, sharding

    cfg32 = cfg.replace(dtype="float32")
    api = get_model(cfg32)
    def widen(x):
        return x.float() if x.is_floating_point() else x.clone()

    p32 = sharding._map_leaves(widen, params)
    ref = sharding._map_leaves(widen, state0)
    B, steps = toks.shape
    pp = sharding.place(p32, sharding.param_specs(p32, cfg32, mesh), mesh)
    ps = sharding.place(ref, sharding.state_specs(ref, cfg32, mesh, B), mesh)
    worst = {"max_err": 0.0, "mean_rel_err": 0.0}
    off = {k: 0.0 for k in bf16}
    for t in range(steps):
        want, ref = api.decode(p32, ref, toks[:, t:t + 1])
        with use_mesh(mesh):
            got, ps = api.decode(pp, ps, toks[:, t:t + 1])
        close = _logits_close(got, want, "float32")
        if not close["ok"]:
            fail(f"decode {name} float32: step {t}'s logits against one device's {close}")
        worst = {k: max(v, close[k]) for k, v in worst.items()}
        for k, runs in bf16.items():
            off[k] = max(off[k], _logits_close(runs[t], want, cfg.dtype)["mean_rel_err"])
    a = sharding.gather(ps).caches
    err = [(getattr(a, f) - getattr(ref.caches, f)).abs() for f in ("k", "v")]
    first, cache = max(float(e[0].max()) for e in err), max(float(e.max()) for e in err)
    if first > F32_TOL or cache > LOGIT_F32_TOL or \
            not torch.equal(a.positions, ref.caches.positions):
        fail(f"decode {name} float32: the caches differ from one device's by {first} in layer 0, "
             f"{cache} in all")
    return {"logits": worst, "cache_layer0_max_err": first, "cache_max_err": cache,
            "bf16_mean_rel_err_from_float32": off}


def lse_route_row(torch, cfg, run: dict, gen) -> dict:
    """Decode attention's log-sum-exp route at (c)'s per-slot shape (one
    row, the model slot's K/V head and its G query heads, one data slot's
    slice of the window), a quarter of the slots valid in a mask drawn from
    ``gen``: the output ``==`` the route without the log-sum-exp's, the
    kernel with and without it and the plain version with it timed by
    :func:`device_time` (K/V cold), against the bound."""
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_cost

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    dsize, msize = run["mesh"]
    C = min(run["capacity"], cfg.sliding_window or run["capacity"]) // dsize
    K, H, hd, B = cfg.n_kv_heads // msize, cfg.n_heads // msize, cfg.head_dim, run["batch"]
    q = (torch.randn((B, H, hd), generator=gen, device=dev) * 0.5).to(bf16)
    mask = torch.rand((B, C), generator=gen, device=dev) < 0.25
    nbytes, flops = decode_cost(B, H, K, hd, C, 2, int(mask.sum()), lse=True)
    n = cold_ring(nbytes)
    kv = (torch.randn((n, 2, B, C, K, hd), generator=gen, device=dev) * 0.5).to(bf16)
    got = kdec.decode_attention(q, kv[0, 0], kv[0, 1], mask, return_lse=True)
    if not torch.equal(got[0], kdec.decode_attention(q, kv[0, 0], kv[0, 1], mask)):
        fail("decode_attention lse route: its output differs from the route without it")
    want = ref.decode_attention_ref(q, kv[0, 0], kv[0, 1], mask, True)
    err = _err(torch, "decode_attention lse route", got[0], want[0])
    lerr = (got[1] - want[1]).abs()
    if not bool((lerr <= LSE_ATOL + LSE_RTOL * want[1].abs()).all()):
        fail(f"decode_attention lse route: log-sum-exp differs by {float(lerr.max())}")
    # REPS calls a window over a ring of n cold buffers: at this small shape
    # n runs to hundreds, and as many calls (two launches each) behind the
    # sleep would fill the card's launch queue, which blocks the host
    kern = device_time(torch, [lambda i=i: kdec.decode_attention(q, kv[i, 0], kv[i, 1], mask,
                                                                 return_lse=True)
                               for i in range(n)])
    base = device_time(torch, [lambda i=i: kdec.decode_attention(q, kv[i, 0], kv[i, 1], mask)
                               for i in range(n)])
    plain = device_time(torch, [lambda i=i: ref.decode_attention_ref(q, kv[i, 0], kv[i, 1], mask,
                                                                     True)
                                for i in range(n)])
    b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS_PER_S)
    del kv
    return {"shape": {"B": B, "C": C, "H": H, "K": K, "hd": hd, "live": int(mask.sum()),
                      "cold_buffers": n},
            "max_abs_err": err, "lse_max_abs_err": float(lerr.max()), "ms": kern["ms"],
            "host_us": kern["host_us"], "no_lse_ms": base["ms"], "plain_ms": plain["ms"],
            "bound_ms": b_ms, "bound_by": b_by}


def decode_phase(torch, counters, card, device: str = "cuda", runs: dict = DECODE_RUNS,
                 smoke: bool = False, gen=None) -> dict:
    """Phase 24 on ``device``: :func:`decode_mesh_run` for (a) and (b) from
    one seeded qwen3-4b, then (c) from a seeded mixtral cut to its layers;
    on the card, the decode kernel's log-sum-exp route timed at (c)'s
    per-slot shape (:func:`lse_route_row`)."""
    from repro_torch.models import get_model

    on_card = torch.device(device).type == "cuda"
    out, by_path = {"card": card}, {}
    params, key = None, None
    for name in ("cols", "heads", "length"):
        run = runs[name]
        t0 = time.time()
        cfg = mesh_cfg(run, smoke, use_pallas=True)
        if key != (run["arch"], run["seed"]):
            params = None
            if on_card:
                torch.cuda.empty_cache()
            params, key = get_model(cfg).init(run["seed"], device), (run["arch"], run["seed"])
        res = decode_mesh_run(torch, counters, name, run, cfg, params, device)
        res["part_s"] = time.time() - t0
        by_path[f"decode {name} one device"] = res["single_launches"]
        by_path[f"decode {name}"] = res["launches"]
        out[name] = res
        say_decode_part(name, res, run, card)
        if on_card:
            torch.cuda.empty_cache()
    del params
    if on_card:
        out["lse_route"] = lse_route_row(torch, mesh_cfg(runs["length"], smoke), runs["length"],
                                         gen)
        r = out["lse_route"]
        say(f"phase decode: the decode kernel's log-sum-exp route at {r['shape']}: "
            f"{r['ms']:.5f} ms ({r['no_lse_ms']:.5f} without it), plain {r['plain_ms']:.5f} ms, "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}); max abs err {r['max_abs_err']:.3g}, "
            f"lse {r['lse_max_abs_err']:.3g}; {card}")
    out["by_path"] = by_path
    return out


def say_decode_part(name: str, r: dict, run: dict, card) -> None:
    """The line phase 24 prints for part ``name`` as it ends."""
    say(f"phase decode: ({ {'cols': 'a', 'heads': 'b', 'length': 'c'}[name] }) {r['config']} "
        f"{r['layers']} layers B={run['batch']} C={r['capacity']} filled {run['filled']} on a "
        f"{run['mesh']} mesh, {r['layout']} layout: {run['steps']} steps in "
        f"{r['mesh_wall_s']:.3f} s, one device {r['single_wall_s']:.3f} s; logits {r['logits']}; "
        f"float32 pair {r.get('float32')}; "
        f"written K/V {r['cache']}; peak {r['peak_mem_bytes']} B; kernel calls within their "
        f"plain versions {r.get('kernel_vs_plain_max_err')}; routing {r['routing']}; "
        f"collectives {r['collectives']}; launches {r['launches']} (one device "
        f"{r['single_launches']}); part {r['part_s']:.1f} s; {card}")


# ---------------------------------------------------------------------------
# 25. the hybrid, enc-dec and xLSTM families over the model axis
# ---------------------------------------------------------------------------

# every slot on the one card, random weights from each run's seed.  (a)
# zamba2-7b whole (81 layers in 14 groups of 6, the last 3 padded), B = 1,
# S = 4096, the forward with kernels on (1, 16): 7 of 112 SSM heads and 2
# of 32 attention heads a model slot; (b) whisper-large-v3 whole (32 + 32
# layers), B = 2, 448 decoder positions over 1,500 frames, on (1, 16): 20
# heads do not divide 16, so model slot 0 runs each attention whole, and
# the vocabulary does not either, so the embedding splits over d_model
# (its bf16 pair is gated too, beside the float32 pair); (c) xlstm-350m
# whole (24 layers), B = 2, S = 2048, on (1, 16): a quarter of an mLSTM
# head's columns a slot, the sLSTM's time loop on slot 0, in float32
# (:data:`F32_PAIR_REL`), its dispatch guard on the first 256 positions
# (what a slot reads does not depend on the length); (d)
# the zamba2-7b train step at full width cut to one group (6 Mamba layers
# and the shared block), fsdp_params and 2 microbatches, B = 4, S = 1024,
# on (2, 4), with phase 21(c)'s bounds and float32 pair
FAMILY_TP_RUNS = {
    "hybrid": {"arch": "zamba2-7b", "layers": None, "batch": 1, "seq": 4096, "mesh": (1, 16),
               "seed": 51, "dtype": None},
    "encdec": {"arch": "whisper-large-v3", "layers": None, "batch": 2, "seq": 448,
               "mesh": (1, 16), "seed": 52, "dtype": None, "bf16_gate": True},
    "xlstm": {"arch": "xlstm-350m", "layers": None, "batch": 2, "seq": 2048, "mesh": (1, 16),
              "seed": 53, "dtype": "float32", "guard_seq": 256},
    "train": {"arch": "zamba2-7b", "layers": 6, "batch": 4, "seq": 1024, "mesh": (2, 4),
              "seed": 54, "dtype": None, "accum": 2, "base_lr": 1e-3},
}


# These random-weight models' logits move with the rounding of their
# recurrences: at full width the one-device bf16 forward lies 7.3 % (mean
# rel) from the float32 forward on the same weights after one zamba2-7b
# group and 35 % for xlstm-350m (S = 256; PERF.md), and a mesh's bf16 forward
# as far from one device's (zamba2 whole: 59 %), so a bf16 pair sees no fault
# short of that.  The logits are held on a float32 pair, the mesh's forward
# against one device's from the same weights: within this mean relative
# error (the port's own float32 xlstm-350m forward lies 1.6e-4 from the
# reference's at S = 2048, zamba2's one group on (1, 16) 1.4e-5 from one
# device's; this repo's CPU, PERF.md; the whole zamba2-7b on (1, 16) 3.0e-4
# on the H100).  A wrong head, a wrong slot's columns or a dropped slot
# moves the logits by O(1)
F32_PAIR_REL = 1e-3


def _pair_close(got, want) -> dict:
    """A float32 pair's logits: max and mean relative error, within
    :data:`F32_PAIR_REL` by the mean relative error."""
    out = _logits_close(got, want, "float32")
    return out | {"ok": bool(got.isfinite().all()) and out["mean_rel_err"] <= F32_PAIR_REL}


def _split_dims(cfg, msize: int) -> dict:
    """Leaf path -> the dim ``param_specs`` splits over a ``model`` axis of
    ``msize`` slots (``None``: replicated), from a meta tree."""
    from repro_torch.models import get_model, sharding

    named = {}
    sharding._map_with_path(lambda pth, x: named.__setitem__(
        "/".join(pth), sharding.model_split_dim(list(pth), tuple(x.shape), msize)),
        get_model(cfg).init(0, "meta"))
    return named


def _sub_dims(named: dict, prefix: str, lead: int) -> dict:
    """The leaves under ``prefix`` (their names below it) with the dims of
    one entry of a stack on ``lead`` leading axes."""
    return {k[len(prefix):]: (None if d is None else d - lead) for k, d in named.items()
            if k.startswith(prefix)}


def family_tp_exceptions(cfg, msize: int) -> tuple:
    """The leaf paths whose one-layer weights a model slot may take whole
    under a ``model`` axis of ``msize`` slots (``param_guard``'s
    exceptions): an attention whose heads do not divide the axis (slot 0
    runs it whole, PR 26's exception), a Mamba2 mixer whose SSM heads or
    layout do not split (slot 0 runs it whole), the sLSTM's recurrent ``r``
    (re-laid whole on the time loop's slot once per layer), and any other
    layer that ``param_specs`` does not split the tensor-parallel way."""
    from repro_torch.models import ssm, xlstm
    from repro_torch.models.attention import heads_parallel

    if msize == 1:
        return ()
    named = _split_dims(cfg, msize)
    out = []
    if not heads_parallel(cfg, msize):
        out += {"hybrid": ["shared_attn/attn/"],
                "encdec": ["enc/attn/", "dec/self_attn/", "dec/cross_attn/"]}.get(cfg.family, [])
    for pre, lead in (("shared_attn/mlp/", 0), ("enc/mlp/", 1), ("dec/mlp/", 1),
                      ("slstm/ffn/", 1)):
        d = _sub_dims(named, pre, lead)
        if d and not (d["wi"] == 1 and d["wo"] in (0, None)):
            out.append(pre)
    if cfg.family == "hybrid" and not ssm.heads_parallel(cfg, _sub_dims(named, "mamba_groups/", 2),
                                                          msize):
        out.append("mamba_groups/")
    if cfg.family == "xlstm":
        if not xlstm.mlstm_parallel(cfg, _sub_dims(named, "mlstm/", 2), msize):
            out.append("mlstm/")
        sd = _sub_dims(named, "slstm/", 1)
        out += ["slstm/r"] + (["slstm/wx"] if sd["wx"] not in (None, 1) else []) \
            + (["slstm/out"] if sd["out"] not in (None, 0) else [])
    return tuple(out)


def _attn_calls(d: dict, cfg, M: int, S: int, T: int) -> dict:
    """One attention's collective calls per data slot (``attention_row``)
    of a forward with kernels: per K/V weight split over ``head_dim`` an
    ``all_gather`` per K/V head, and the output's ``psum``, where the heads
    divide the axis; else a ``gather`` per split leaf onto model slot 0,
    sequence-parallel attention's 3 ``scatter`` + 2 ``all_gather`` + 1
    ``gather`` where its condition holds, and the output's ``broadcast``."""
    from repro_torch.models.attention import heads_parallel

    out = {}
    if heads_parallel(cfg, M):
        for n in ("wk", "wv", "bk", "bv"):
            dim, axis = d.get(n), 1 if n[0] == "w" else 0
            if dim is None or dim == axis:
                continue
            out["all_gather"] = out.get("all_gather", 0) + (cfg.n_kv_heads if dim == axis + 1
                                                            else 1)
        out["psum"] = 1
        return out
    out["gather"] = sum(v is not None for v in d.values())
    blocked = not (cfg.use_pallas and flash_gate(S, T)) and S > 2048 and S % 512 == 0 \
        and T % 512 == 0
    if blocked and S == T and S % M == 0 and (S // M) % 128 == 0:
        out.update({"scatter": 3, "all_gather": 2, "gather": out["gather"] + 1})
    out["broadcast"] = 1
    return out


def _mlp_calls(d: dict) -> dict:
    """``mlp_row``'s: the partial sums' ``psum`` where the inner dim is
    split, else a ``gather`` per split leaf and a ``broadcast``."""
    if d["wi"] == 1 and d["wo"] in (0, None):
        return {"psum": 1}
    return {"gather": sum(v is not None for v in d.values()), "broadcast": 1}


def _whole_calls(d: dict) -> dict:
    return {"gather": sum(v is not None for v in d.values()), "broadcast": 1}


def slstm_layer_calls(cfg, msize: int) -> dict:
    """One sLSTM layer's collective calls per data slot (``slstm_row``):
    the input projection's columns gathered onto the loop's slot (one
    ``gather``), ``r`` re-laid whole there (one ``gather``), the output's
    columns scattered to ``out``'s row blocks and the partial sums'
    ``psum``, then the FFN's; none inside the time loop."""
    d = _sub_dims(_split_dims(cfg, msize), "slstm/", 1)
    out = {"gather": (d["wx"] is not None) + (d["r"] is not None)}
    if d["out"] == 0:
        out.update({"scatter": 1, "psum": 1})
    else:
        out.update({"gather": out["gather"] + (d["out"] is not None), "broadcast": 1})
    for k, v in _mlp_calls(_sub_dims(d, "ffn/", 0)).items():
        out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def family_tp_collectives(cfg, dsize: int, msize: int, seq: int, batch: int) -> dict:
    """The collective calls of the forward of the hybrid, enc-dec or xLSTM
    family from a whole tree under a (dsize, msize) mesh, from
    ``param_specs``'s split of each leaf: the views (per data slot that
    takes rows, a ``scatter`` per split leaf and a ``broadcast`` per
    replicated one), the tokens' (and frames') ``scatter``; with M > 1 the
    tokens' (and frames') ``broadcast`` and the embedding's ``psum`` or
    ``all_gather`` per data slot; per layer per data slot :func:`_attn_calls`,
    :func:`_mlp_calls`, the Mamba2 mixer's (where split by heads: a
    ``gather`` of activation columns and one of conv tap rows per model
    slot, the gated norm's and ``out_proj``'s ``psum``), the mLSTM's (where
    split by columns: x_in's ``all_gather``, a ``gather`` of z's columns per
    model slot, an ``all_gather`` of q and of k per head where a head's
    columns span slots, ``down``'s ``psum``) and :func:`slstm_layer_calls`;
    else the layer's split leaves
    gathered onto slot 0 and a ``broadcast``; the head: the unembedding's
    ``reduce_scatter`` (``d_model`` split; a ``psum`` where M does not
    divide the positions), a ``gather`` of each data slot's logits and the
    aux losses' ``psum``."""
    import collections

    from repro_torch.models import ssm, xlstm

    M = msize
    named = _split_dims(cfg, M)
    D = dsize if batch % dsize == 0 else 1
    encdec = cfg.family == "encdec"
    calls, per = collections.Counter(), collections.Counter()
    split = sum(d is not None for d in named.values())
    calls["scatter"] += D * split + 1 + encdec
    calls["broadcast"] += D * (len(named) - split)
    if M > 1:
        calls["broadcast"] += D * (1 + encdec)
        if named["embed/tok"] is not None:
            calls["psum" if named["embed/tok"] == 0 else "all_gather"] += D
        if cfg.family == "hybrid":
            ng, g = math.ceil(cfg.n_layers / cfg.attn_every), cfg.attn_every
            sd = _sub_dims(named, "shared_attn/", 0)
            md = _sub_dims(named, "mamba_groups/", 2)
            per.update({k: v * ng for k, v in _attn_calls(_sub_dims(sd, "attn/", 0), cfg, M,
                                                          seq, seq).items()})
            per.update({k: v * ng for k, v in _mlp_calls(_sub_dims(sd, "mlp/", 0)).items()})
            if ssm.heads_parallel(cfg, md, M):
                mix = {"gather": 2 * M, "psum": 2}
            else:
                mix = _whole_calls(md)
            per.update({k: v * ng * g for k, v in mix.items()})
        elif encdec:
            for pre, L, S, T in (("enc/attn/", cfg.n_enc_layers, cfg.enc_seq, cfg.enc_seq),
                                 ("dec/self_attn/", cfg.n_layers, seq, seq),
                                 ("dec/cross_attn/", cfg.n_layers, seq, cfg.enc_seq)):
                per.update({k: v * L for k, v in _attn_calls(_sub_dims(named, pre, 1), cfg, M,
                                                             S, T).items()})
            for pre, L in (("enc/mlp/", cfg.n_enc_layers), ("dec/mlp/", cfg.n_layers)):
                per.update({k: v * L for k, v in _mlp_calls(_sub_dims(named, pre, 1)).items()})
        else:
            ng, nm = cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1
            md = _sub_dims(named, "mlstm/", 2)
            if xlstm.mlstm_parallel(cfg, md, M):
                d_in, H, P = xlstm.mlstm_dims(cfg)
                mix = {"all_gather": 1 + (2 * H if d_in // M < P else 0), "gather": M, "psum": 1}
            else:
                mix = _whole_calls(md)
            per.update({k: v * ng * nm for k, v in mix.items()})
            per.update({k: v * ng for k, v in slstm_layer_calls(cfg, M).items()})
    for k, v in per.items():
        calls[k] += v * D
    head = named["embed/tok"] if cfg.tie_embeddings else named["embed/unembed"]
    if M > 1 and head == (1 if cfg.tie_embeddings else 0):
        calls["reduce_scatter" if seq % M == 0 else "psum"] += D
    calls["gather"] += D
    calls["psum"] += 1
    return {k: v for k, v in sorted(calls.items()) if v}


def ssd_heads(cfg, msize: int) -> int:
    """The SSM heads of each SSD call on a model slot: the slot's share
    where the mixer splits by heads, else all of them (slot 0)."""
    from repro_torch.models import ssm

    H = ssm.ssm_dims(cfg)[1]
    md = _sub_dims(_split_dims(cfg, msize), "mamba_groups/", 2)
    return H // msize if ssm.heads_parallel(cfg, md, msize) else H


def family_tp_launches(cfg, dsize: int, msize: int, seq: int) -> dict:
    """The kernels the forward of the hybrid, enc-dec or xLSTM family with
    ``use_pallas`` launches over (dsize, msize): the SSD once per Mamba2
    layer (padded ones included) per model slot where the SSM heads split
    (else once, on slot 0), flash attention once per shared-attention
    application per model slot where the heads divide the axis (else once)
    where the gate passes; the enc-dec family flash where phase 19's gate
    passes (whisper: never); the xLSTM family nothing; no RMSNorm kernel
    (every norm of these families is the plain formula)."""
    from repro_torch.models import ssm
    from repro_torch.models.attention import heads_parallel

    out = dict.fromkeys(KERNEL_NAMES, 0)
    per = msize if heads_parallel(cfg, msize) else 1
    if cfg.family == "hybrid":
        ng, g = math.ceil(cfg.n_layers / cfg.attn_every), cfg.attn_every
        out["ssd_intra_chunk"] = dsize * ng * g * ssm.ssm_dims(cfg)[1] // ssd_heads(cfg, msize)
        out["flash_attention"] = dsize * ng * per * flash_gate(seq, seq)
    elif cfg.family == "encdec":
        out["flash_attention"] = dsize * per * family_launches(cfg, "forward", seq)[
            "flash_attention"]
    return out


@contextlib.contextmanager
def slstm_traffic(torch, per_layer: list, fn: str = "slstm_row"):
    """Within the block each sLSTM layer's collective calls over the grid
    (``xlstm.<fn>``: ``slstm_row``, or decode's ``slstm_decode_row``) are
    appended to ``per_layer``, one dict a call."""
    from repro_torch.launch import collectives
    from repro_torch.models import xlstm

    real = getattr(xlstm, fn)

    def counted(*a, **k):
        before = {op: v[0] for op, v in collectives.TRAFFIC.items()}
        out = real(*a, **k)
        per_layer.append({op: v[0] - before.get(op, 0) for op, v in collectives.TRAFFIC.items()
                          if v[0] - before.get(op, 0)})
        return out

    setattr(xlstm, fn, counted)
    try:
        yield per_layer
    finally:
        setattr(xlstm, fn, real)


def family_tp_forward_run(torch, counters, run: dict, device, smoke: bool = False) -> dict:
    """(a)-(c): the forward of ``run``'s model with kernels under its mesh,
    tensor-parallel, the counters zeroed just before and read just after
    (:func:`family_tp_launches`), its collective calls exactly
    :func:`family_tp_collectives`'s, each sLSTM layer's exactly
    :func:`slstm_layer_calls`'s; a second forward with every kernel call
    held to its plain version (flash at one model slot's heads, the SSD at
    its SSM heads) under :func:`param_guard` (the exceptions of
    :func:`family_tp_exceptions`); then the single-device forward from the
    same weights: logits within :func:`_logits_close`'s limit."""
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import get_model, sharding
    from repro_torch.models.registry import stub_inputs

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = mesh_cfg(run, smoke, use_pallas=True)
    api = get_model(cfg)
    mesh = _mesh_of(run, device)
    dsize, msize = run["mesh"]
    B, S = run["batch"], run["seq"]
    t0 = time.time()
    params = api.init(run["seed"], device)
    gen = torch.Generator(device=device).manual_seed(run["seed"])
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), device=device, generator=gen)}
    batch.update(stub_inputs(cfg, B, device, gen))
    sync()
    out = {"config": cfg.arch_id, "layers": cfg.n_layers, "init_s": time.time() - t0}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    collectives.TRAFFIC.clear()
    per_layer = []
    t0 = time.time()
    with use_mesh(mesh), slstm_traffic(torch, per_layer):
        got, _ = api.forward(params, batch, cfg)
    sync()
    out["mesh_wall_s"] = time.time() - t0
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() if on_card else None
    out["launches"] = {c.__name__: c.launches for c in counters}
    out["collectives"] = {op: list(v) for op, v in collectives.TRAFFIC.items()}
    want = family_tp_launches(cfg, dsize, msize, S)
    if on_card:
        check_launches(f"tp {cfg.arch_id}", out["launches"], want)
        if want["flash_attention"]:
            check_flash_routes(f"tp {cfg.arch_id}", out["launches"], route_counts(counters))
    check_collective_calls(f"tp {cfg.arch_id}", collectives.TRAFFIC,
                           family_tp_collectives(cfg, dsize, msize, S, B))
    if cfg.family == "xlstm":
        layer = slstm_layer_calls(cfg, msize)
        if len(per_layer) != dsize * cfg.n_layers // cfg.slstm_every \
                or any(c != layer for c in per_layer):
            fail(f"tp {cfg.arch_id}: sLSTM collective calls per layer {per_layer}, expected "
                 f"{layer} in each of {dsize * cfg.n_layers // cfg.slstm_every}")
        out["slstm_layer_collectives"] = layer
    calls, fheads, sheads = [], [], []
    allowed = family_tp_exceptions(cfg, msize)
    gseq = run.get("guard_seq") or S
    t0 = time.time()
    with mesh_recording(torch, calls, flash_heads_seen=fheads, ssd_heads_seen=sheads), \
            param_guard(torch, params, cfg, mesh, allowed) as guard, use_mesh(mesh):
        api.forward(params, dict(batch, tokens=batch["tokens"][:, :gseq]), cfg)
    sync()
    out["checked_wall_s"] = time.time() - t0
    out["kernel_vs_plain_max_err"] = _check_calls(
        f"tp {cfg.arch_id}", calls, {"flash_attention": want["flash_attention"],
                                     "ssd_intra_chunk": want["ssd_intra_chunk"]})
    out["flash_heads"], out["ssd_heads"] = sorted(set(fheads)), sorted(set(sheads))
    if want["flash_attention"] and out["flash_heads"] != [flash_heads(cfg, msize)]:
        fail(f"tp {cfg.arch_id}: flash calls at (query, K/V) heads {out['flash_heads']}, "
             f"expected {flash_heads(cfg, msize)}")
    if want["ssd_intra_chunk"] and out["ssd_heads"] != [ssd_heads(cfg, msize)]:
        fail(f"tp {cfg.arch_id}: SSD calls at {out['ssd_heads']} heads, expected "
             f"{ssd_heads(cfg, msize)}")
    check_param_guard(f"tp {cfg.arch_id}", guard)
    out["exceptions"] = list(allowed)
    out["largest_param_read"] = guard["max_read"]
    sync()
    t0 = time.time()
    ref, _ = api.forward(params, batch, cfg)
    sync()
    out["single_wall_s"] = time.time() - t0
    if cfg.dtype == "float32":
        out["logits"] = _pair_close(got, ref)
    else:
        out["bf16_logits"] = _logits_close(got, ref, cfg.dtype)
        if run.get("bf16_gate") and not out["bf16_logits"]["ok"]:
            fail(f"tp {cfg.arch_id}: bf16 logits against the single-device forward's "
                 f"{out['bf16_logits']}")
        del got
        cfg = cfg.replace(dtype="float32")
        params = sharding._map_leaves(lambda x: x.float(), params)
        batch = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
        t0 = time.time()
        with use_mesh(mesh):
            got, _ = api.forward(params, batch, cfg)
        want, _ = api.forward(params, batch, cfg)
        sync()
        out["float32_pair_wall_s"] = time.time() - t0
        out["logits"] = _pair_close(got, want)
        out["bf16_one_device_from_float32"] = _logits_close(ref, want, "float32")
    if not out["logits"]["ok"]:
        fail(f"tp {cfg.arch_id}: float32 logits against the single-device forward's "
             f"{out['logits']} (limit {F32_PAIR_REL} mean rel)")
    return out


def family_tp_kernel_rows(torch, gen, kernels: list, runs: dict = FAMILY_TP_RUNS) -> None:
    """The per-slot shapes (a) gives the kernels, timed against their plain
    versions and added as sub-rows ``tp_families`` of the flash and SSD
    rows: flash at zamba2-7b's 2 query and 2 K/V heads of 112 a slot, S =
    4096; the SSD at 7 of its 112 SSM heads (B = 1, S = 4096), beside which
    sixteen such calls stand against phase 7's one call over all 112 heads
    (each slot recomputes the heads-independent C·Bᵀ scores)."""
    cfg = mesh_cfg(runs["hybrid"])
    M = runs["hybrid"]["mesh"][1]
    rows = {k["name"]: k for k in kernels}
    H, K = flash_heads(cfg, M)
    row = check_flash(torch, gen, H, K, cfg.head_dim, None, runs["hybrid"]["seq"])
    rows["flash_attention"].setdefault("tp_families", {})[f"{cfg.arch_id} per slot"] = \
        _sub_row(row)
    torch.cuda.empty_cache()
    per = check_ssd_kernel(torch, cfg.replace(d_model=cfg.d_model // M), gen)
    sub = _sub_row(per)
    full = rows["ssd_intra_chunk"]
    sub["slots_ms"] = M * per["ms"]
    sub["one_call_all_heads_ms"] = full["ms"]
    rows["ssd_intra_chunk"].setdefault("tp_families", {})[f"{cfg.arch_id} per slot"] = sub
    torch.cuda.empty_cache()


def family_tp_phase(torch, counters, card, kernels=None, gen=None, device: str = "cuda",
                    runs: dict = FAMILY_TP_RUNS, smoke: bool = False) -> dict:
    """Phase 25 on ``device``: (a)-(c) :func:`family_tp_forward_run`, (d)
    :func:`mesh_train_run` on the hybrid, each from its own seeded weights,
    freed before the next; on the card first the per-slot kernel shapes
    (:func:`family_tp_kernel_rows`)."""
    on_card = torch.device(device).type == "cuda"
    out, by_path = {"card": card}, {}
    if on_card and kernels is not None:
        t0 = time.time()
        family_tp_kernel_rows(torch, gen, kernels, runs)
        out["kernel_rows_s"] = time.time() - t0
    for name in ("hybrid", "encdec", "xlstm", "train"):
        t0 = time.time()
        if name == "train":
            res = mesh_train_run(torch, counters, runs[name], device, smoke)
        else:
            res = family_tp_forward_run(torch, counters, runs[name], device, smoke)
        by_path[f"tp family {name}"] = res["launches"]
        res["part_s"] = time.time() - t0
        out[name] = res
        say_family_tp_part(name, res, runs[name], card)
        if on_card:
            torch.cuda.empty_cache()
    out["by_path"] = by_path
    return out


def say_family_tp_part(name: str, r: dict, run: dict, card) -> None:
    """The line phase 25 prints for part ``name`` as it ends."""
    head = (f"phase tp families: {r['config']} {r['layers']} layers B={run['batch']} "
            f"S={run['seq']} on a {run['mesh']} mesh:")
    if name == "train":
        f32 = r["float32"]
        say(f"{head} (d) FSDP step in {r['mesh_step_s']:.3f} s, unsharded "
            f"{r['single_step_s']:.3f} s; loss err {r['loss_err']:.3g}, worst parameter err "
            f"{r['param_max_err']:.3g} (limit {MESH_TRAIN_TOL}), grad norm rel err "
            f"{r['grad_norm_rel_err']:.3g}, first moments rel err {r['moment_rel_err']:.3g}; "
            f"float32: grad norm rel err {f32['grad_norm_rel_err']:.3g}, first moments rel err "
            f"{f32['moment_rel_err']:.3g} (limit {MESH_GRAD_RTOL}), replicated leaves "
            f"{f32['replicated_moment_max_rel_err']:.3g} (limit {MESH_REPLICATED_RTOL}); per "
            f"slot {r['bytes_per_slot']} B of state against {r['bytes_unsharded']} B unsharded; "
            f"peak {r['peak_mem_bytes']} B; collectives {r['collectives']}; part "
            f"{r['part_s']:.1f} s; {card}")
        return
    say(f"{head} forward {r['mesh_wall_s']:.3f} s tensor-parallel (init {r['init_s']:.1f} s, "
        f"checked run {r['checked_wall_s']:.1f} s, float32 pair "
        f"{r.get('float32_pair_wall_s', 0.0):.1f} s), one device {r['single_wall_s']:.3f} s; peak "
        f"{r['peak_mem_bytes']} B; float32 logits {r['logits']} (bf16 pair "
        f"{r.get('bf16_logits')}, one device's bf16 from its float32 "
        f"{r.get('bf16_one_device_from_float32')}); flash at {r['flash_heads']}, SSD at "
        f"{r['ssd_heads']} heads; every call within its plain version (worst "
        f"{r['kernel_vs_plain_max_err']}); largest parameter block read "
        f"{r['largest_param_read']} elements, exceptions {r['exceptions']}; sLSTM per layer "
        f"{r.get('slstm_layer_collectives')}; collectives {r['collectives']}; launches "
        f"{r['launches']}; part {r['part_s']:.1f} s; {card}")


# ---------------------------------------------------------------------------
# 26. decode over the mesh for the hybrid, enc-dec and xLSTM families
# ---------------------------------------------------------------------------

# every slot on the one card, random weights and a random decode state from
# each run's seed (a zero state would hide a fault in reading the old one),
# 4 steps (the conv window turns over).  (a) zamba2-7b whole (81 layers in
# 14 groups of 6), B = 4, a 1,024-slot cache filled to 1,000 positions, on
# (1, 16), in float32 (a random zamba2-7b amplifies bf16 rounding to O(1):
# PERF.md): 2 of 32 K/V heads and 7 of 112 SSM heads a model slot, the decode
# kernel on each, one step checked under the dispatch guard; (b) zamba2-7b
# cut to 2 groups (12 of 81 layers), B = 1, on (4, 4): the cache length split
# over the data slots (the kernel's log-sum-exp route, 8 heads a slot), the
# Mamba states replicated over them, in bf16 and in a float32 pair: the bf16
# logits and states gated against one device that sums and rounds as the
# mesh does (:func:`mesh_rounding`, bit for bit on the card), three planted
# bf16-only faults refused by that gate; (c)
# whisper-large-v3 whole, bf16, B = 4, its 448-slot self cache filled to 400
# and random cross K/V, on (2, 16): 20 heads do not divide 16, so the self and
# cross K/V split head_dim (4 of 64 columns a slot), plain PyTorch; (d) the
# same weights and state on (2, 4): 5 heads a slot, the decode kernel on the
# self cache; (e) xlstm-350m whole, float32 (its bf16 forward lies 35 % from
# float32), B = 8, on (2, 16)
FAMILY_DECODE_RUNS = {
    "hybrid": {"arch": "zamba2-7b", "layers": None, "batch": 4, "capacity": 1024,
               "filled": 1000, "steps": 4, "mesh": (1, 16), "seed": 61, "dtype": "float32",
               "guard_steps": 1},
    "hybrid_b1": {"arch": "zamba2-7b", "layers": 12, "batch": 1, "capacity": 1024,
                  "filled": 1000, "steps": 4, "mesh": (4, 4), "seed": 62, "dtype": None,
                  "float32_pair": True, "rounding_limit": {"logits": 1e-4, "state": 1e-5},
                  "rounding_faults": ("psum", "merge", "state")},
    "encdec": {"arch": "whisper-large-v3", "layers": None, "batch": 4, "capacity": 448,
               "filled": 400, "steps": 4, "mesh": (2, 16), "seed": 63, "dtype": None,
               "bf16_gate": True},
    "encdec_heads": {"arch": "whisper-large-v3", "layers": None, "batch": 4, "capacity": 448,
                     "filled": 400, "steps": 4, "mesh": (2, 4), "seed": 63, "dtype": None,
                     "bf16_gate": True},
    "xlstm": {"arch": "xlstm-350m", "layers": None, "batch": 8, "capacity": 0, "filled": 0,
              "steps": 4, "mesh": (2, 16), "seed": 64, "dtype": "float32"},
}
FAMILY_DECODE_PARTS = {"hybrid": "a", "hybrid_b1": "b", "encdec": "c", "encdec_heads": "d",
                       "xlstm": "e"}
# leaves a decode step never writes
STATIC_LEAVES = ("cross_k", "cross_v")


def family_state_fill(torch, api, run: dict, device):
    """A decode state of ``run``'s batch and capacity drawn from its seed:
    K/V, conv windows, SSM states, the mLSTM's ``C`` and ``n``, the sLSTM's
    ``c``, ``m`` and ``h`` and the cross K/V ``normal * 0.5``, the sLSTM's
    ``n`` in [0.5, 1.5) (a normalizer), each ring slot holding the latest
    position of ``run["filled"]`` tokens (-1 where none was) and ``pos``
    that count.  One stacked entry is drawn at a time (a float32 draw of one
    layer, not of the stack)."""
    from repro_torch.models import sharding

    B, cap, filled = run["batch"], run["capacity"], run["filled"]
    st = api.init_decode_state(B, cap, device)
    g = torch.Generator(device=device).manual_seed(run["seed"])

    def fill(path, x):
        name = path[-1]
        if name == "pos":
            x.fill_(filled)
        elif name == "positions":
            C = x.shape[-1]
            slot = torch.arange(C, device=device)
            p = (filled - 1) - (filled - 1 - slot) % C
            x.copy_(torch.where(p >= 0, p, -1).to(torch.int32).expand_as(x))
        else:
            for i in range(x.shape[0]):
                r = torch.rand(x[i].shape, generator=g, device=device) + 0.5 \
                    if path == ("sl", "n") else \
                    torch.randn(x[i].shape, generator=g, device=device) * 0.5
                x[i].copy_(r)
    sharding._map_with_path(fill, st)
    return st


def _state_leaves(state) -> dict:
    from repro_torch.models import sharding

    out = {}
    sharding._map_with_path(lambda p, x: out.__setitem__("/".join(p), x), state)
    return out


def _state_model_dims(cfg, dsize: int, msize: int, batch: int, capacity: int) -> dict:
    """Leaf path -> the dim ``state_specs`` splits over ``model`` (or None),
    from a meta state."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model, sharding

    mesh = make_mesh((dsize, msize), ("data", "model"), devices=["meta"] * (dsize * msize))
    st = get_model(cfg).init_decode_state(batch, capacity, "meta")
    return {k: sharding.model_dim(v) for k, v in
            _state_leaves(sharding.state_specs(st, cfg, mesh, batch)).items()}


def family_attn_layers(cfg) -> int:
    """The decode attentions of one step: the hybrid's shared block once a
    group, the enc-dec model's self attention once a decoder layer."""
    if cfg.family == "hybrid":
        return math.ceil(cfg.n_layers / cfg.attn_every)
    return cfg.n_layers if cfg.family == "encdec" else 0


def family_decode_launches(cfg, dsize: int, msize: int, batch: int, capacity: int, steps: int,
                           mesh: bool = True) -> dict:
    """:func:`decode_launches` for the hybrid's shared attention (once a
    group) and the enc-dec model's self attention (once a layer; its cross
    attention is plain PyTorch, as the reference's); none for the xLSTM."""
    return decode_launches(cfg.replace(n_layers=family_attn_layers(cfg)), dsize, msize, batch,
                           capacity, steps, mesh) if family_attn_layers(cfg) else \
        dict.fromkeys(KERNEL_NAMES, 0)


def _pos_broadcasts(cfg, dsize: int, msize: int, batch: int, capacity: int, holders: int,
                    L: int) -> int:
    """``attention.read_pos``'s broadcasts per layer per carrying data slot:
    where ``state_specs`` splits ``pos``'s layer axis over ``model`` (whisper's
    32 layers on 16 or 4 model slots), every model slot but the layer's
    owner reads it from the owner, for each data slot holding a part of the
    cache."""
    key = "caches/pos" if cfg.family == "hybrid" else "self_caches/pos"
    d = _state_model_dims(cfg, dsize, msize, batch, capacity)[key]
    return holders * (msize - 1) if d == 0 and L % msize == 0 else 0


def _cross_decode_calls(layer: dict, M: int, holders: int, computing: int, layout: str):
    """One cross attention's collective calls per carrying data slot
    (``attention.cross_attention_row``): q's ``psum`` / ``all_gather``
    where the head-dim layout's ``wq`` does not split head_dim; where the
    frames are split over the data slots, one ``broadcast`` per model slot
    of q to them and two ``gather`` per model slot of the partials and
    log-sum-exps; the head-dim layout's score ``psum`` per computing slice;
    the output as :func:`_out_row_calls` (a ``psum`` in the heads layout)."""
    import collections

    per = collections.Counter()
    if M > 1 and layout == "cols" and layer["wq"] not in (2, None):
        per["psum" if layer["wq"] == 0 else "all_gather"] += 1
    if computing > 1:
        per["broadcast"] += M
        per["gather"] += 2 * M
    if layout == "heads":
        per["psum"] += M > 1
        return per
    per["psum"] += computing * (M > 1)
    per.update(_out_row_calls(layer["wo"], M, M > 1))
    return per


def _mlstm_y_moves(cfg, dims: dict, M: int) -> int:
    """The model slots whose rows of ``down`` hold channels of y that
    another slot's ``C`` block computed (one gather each in
    ``xlstm.mlstm_decode_row``)."""
    from repro_torch.models.xlstm import mlstm_dims

    d_in, H, P = mlstm_dims(cfg)
    d = dims["ml/C"]
    nd = 6
    cd, moves = d_in // M, 0
    for m in range(M):
        heads = range(m * H // M, (m + 1) * H // M) if d == nd - 3 else range(H)
        cols = range(m * P // M, (m + 1) * P // M) if d == nd - 1 else range(P)
        moves += any((c // P) not in heads or (c % P) not in cols
                     for c in range(m * cd, (m + 1) * cd))
    return moves


def slstm_decode_layer_calls(cfg, msize: int) -> dict:
    """One sLSTM layer's collective calls per carrying data slot
    (``xlstm.slstm_decode_row``): the old h's ``all_gather``, the partial
    recurrent products' ``psum`` (``r`` split by its rows), one ``gather``
    per model slot of its gate columns of the input projection, the output's
    ``psum`` (row-parallel ``out``), then the FFN's; none per head."""
    if msize == 1:
        return {}
    d = _sub_dims(_split_dims(cfg, msize), "slstm/", 1)
    out = {"all_gather": 1, "gather": msize, "psum": 1 + (d["r"] == 1)}
    for k, v in _mlp_calls(_sub_dims(d, "ffn/", 0)).items():
        out[k] = out.get(k, 0) + v
    return out


def family_decode_collectives(cfg, dsize: int, msize: int, batch: int, capacity: int,
                              steps: int) -> dict:
    """The collective calls of ``steps`` mesh decode steps of the hybrid,
    enc-dec or xLSTM family from placed weights and a state placed by
    ``state_specs``, per step: :func:`_decode_embed_calls`; per carrying data
    slot, for the hybrid per group :func:`_decode_attn_calls` and the shared
    MLP's ``psum``, per Mamba2 layer one ``gather`` per model slot into the
    conv window's channel blocks and one into the SSM state's block (one
    more moving y to ``out_proj``'s rows where the state splits the head
    dim, not the heads) and two ``psum`` (the gated norm's, ``out_proj``'s);
    for the enc-dec model per layer :func:`_decode_attn_calls`,
    :func:`_cross_decode_calls`, the MLP's ``psum`` and
    :func:`_pos_broadcasts`; for the xLSTM per mLSTM layer three
    ``all_gather`` (x_in, q, k), one ``gather`` per model slot of its v
    columns and of its z columns, one per slot that takes y from others
    (:func:`_mlstm_y_moves`) and two ``psum`` (den, ``down``), per sLSTM
    layer :func:`slstm_decode_layer_calls`."""
    import collections

    from repro_torch.models import xlstm

    M = msize
    named = _split_dims(cfg, M)
    sdims = _state_model_dims(cfg, dsize, M, batch, capacity)
    if cfg.family == "xlstm":
        D = dsize if batch % dsize == 0 else 1
    else:
        D, H, each = decode_holders(cfg, dsize, batch, capacity)
        computing = H if each else 1
        layout = decode_layout_of(cfg, M)
    calls = _decode_embed_calls(named, cfg, D, M)
    per = collections.Counter()

    def add(counts, n):
        for k, v in counts.items():
            per[k] += v * n
    if cfg.family == "hybrid":
        ng, g = family_attn_layers(cfg), cfg.attn_every
        add(_decode_attn_calls(_sub_dims(named, "shared_attn/attn/", 0), M, H, computing,
                               layout), ng)
        add({"broadcast": _pos_broadcasts(cfg, dsize, M, batch, capacity, H, ng)}, ng)
        if M > 1:
            add(_mlp_calls(_sub_dims(named, "shared_attn/mlp/", 0)), ng)
            heads = sdims["mamba/ssm"] == 3
            add({"gather": 2 * M + (0 if heads else M), "psum": 2}, ng * g)
    elif cfg.family == "encdec":
        L = cfg.n_layers
        add(_decode_attn_calls(_sub_dims(named, "dec/self_attn/", 1), M, H, computing, layout),
            L)
        add({"broadcast": _pos_broadcasts(cfg, dsize, M, batch, capacity, H, L)}, L)
        if batch % dsize == 0:
            cross_computing = 1
        else:
            cross_computing = dsize if cfg.enc_seq % dsize == 0 else 1
        clayout = "heads" if sdims["cross_k"] in (None, 3) else "cols"
        add(_cross_decode_calls(_sub_dims(named, "dec/cross_attn/", 1), M, dsize,
                                cross_computing, clayout), L)
        if M > 1:
            add(_mlp_calls(_sub_dims(named, "dec/mlp/", 1)), L)
    elif M > 1:
        ng, nm = xlstm.xlstm_group_shape(cfg)
        add({"all_gather": 3, "gather": 2 * M + _mlstm_y_moves(cfg, sdims, M), "psum": 2},
            ng * nm)
        add(slstm_decode_layer_calls(cfg, M), ng)
    for k, v in per.items():
        calls[k] += v * D
    return {k: v * steps for k, v in sorted(calls.items()) if v}


def _compare_states(torch, got, want, init, dtype: str, what: str, gate: bool = True) -> dict:
    """Every leaf of two decode states (trees of the same structure): the
    integer leaves (``pos``, positions) ``==``, the static ones (the cross
    K/V) untouched in both; each float leaf's max abs and mean relative
    error, within a float32 pair's :data:`F32_PAIR_REL` where ``dtype`` is
    float32 and, in a bf16 run with ``gate``, the bf16 leaves (the K/V
    caches) within phase 12's bf16 limit (a bf16 run's float32 recurrent
    states, and an ungated run's leaves, are held by its float32 pair)."""
    out = {}
    a, b, s0 = _state_leaves(got), _state_leaves(want), _state_leaves(init)
    for k, w in b.items():
        g = a[k].to(w.device)
        if not w.is_floating_point():
            if not torch.equal(g, w):
                fail(f"{what}: {k} differs from one device's")
            continue
        if k.split("/")[-1] in STATIC_LEAVES:
            if not (torch.equal(g, s0[k]) and torch.equal(w, s0[k])):
                fail(f"{what}: the static {k} was written")
            continue
        close = _logits_close(g, w, dtype)
        if dtype == "float32" or w.dtype == torch.float32:
            close["ok"] = bool(g.isfinite().all()) and close["mean_rel_err"] <= F32_PAIR_REL
            gated = dtype == "float32"
        else:
            gated = gate
        if gated and not close["ok"]:
            fail(f"{what}: {k} differs from one device's: {close}")
        out[k] = {"max_err": close["max_err"], "mean_rel_err": close["mean_rel_err"],
                  "gated": gated}
    return out


def _close_fn(dtype: str):
    return (lambda g, w: _pair_close(g, w)) if dtype == "float32" else \
        (lambda g, w: _logits_close(g, w, dtype))


def family_float32_pair(torch, cfg, params, state0, toks, mesh, name: str, bf16: dict) -> dict:
    """The same steps in float32 from the same (bf16) weights and state, on
    one device and over the mesh: every step's logits and every state leaf
    within a float32 pair's limits; how far each bf16 run's logits
    (``bf16``: run name -> per-step logits) lie from the float32 one
    device's is reported."""
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import get_model, sharding

    cfg32 = cfg.replace(dtype="float32")
    api = get_model(cfg32)

    def widen(x):
        return x.float() if x.is_floating_point() else x.clone()
    p32 = sharding._map_leaves(widen, params)
    ref = sharding._map_leaves(widen, state0)
    s32 = sharding._map_leaves(widen, state0)
    B, steps = toks.shape
    pp = sharding.place(p32, sharding.param_specs(p32, cfg32, mesh), mesh)
    ps = sharding.place(s32, sharding.state_specs(s32, cfg32, mesh, B), mesh)
    worst = {"max_err": 0.0, "mean_rel_err": 0.0}
    off = {k: 0.0 for k in bf16}
    for t in range(steps):
        want, ref = api.decode(p32, ref, toks[:, t:t + 1])
        with use_mesh(mesh):
            got, ps = api.decode(pp, ps, toks[:, t:t + 1])
        close = _pair_close(got, want)
        if not close["ok"]:
            fail(f"decode family {name} float32: step {t}'s logits against one device's {close}")
        worst = {k: max(v, close[k]) for k, v in worst.items()}
        for k, runs in bf16.items():
            off[k] = max(off[k], _logits_close(runs[t], want, cfg.dtype)["mean_rel_err"])
    states = _compare_states(torch, sharding.gather(ps), ref, s32, "float32",
                             f"decode family {name} float32")
    return {"logits": worst, "state": states, "bf16_mean_rel_err_from_float32": off}


@contextlib.contextmanager
def mesh_rounding(torch, params, cfg, msize: int, holders: int, ssm_dim: int,
                  rows: bool = True, order: bool = True):
    """Within the block one device's bf16 hybrid decode computes as the
    mesh of ``msize`` model slots and ``holders`` cache slices does.

    With ``rows`` each product the mesh computes row-parallel (every Mamba2
    layer's ``out_proj``, the shared attention's ``wo`` and the shared
    MLP's ``wo``, their rows in ``msize`` contiguous blocks) runs as
    ``msize`` partial products, each rounded to its type, summed in float32
    in slot order and rounded once, as ``collectives.psum`` does.  With
    ``holders`` > 1 the decode attention runs over that many contiguous
    slices of the cache length, each slice's output (rounded by the kernel)
    weighed by its log-sum-exp in float32 and the sum rounded once, as the
    mesh's data slots merge theirs (the formula written out here, so a
    fault in the port's merge does not reach this reference).  With
    ``order`` every other sum is taken in the mesh's blocks, in the order
    the mesh takes it: each column-parallel product (``in_proj``, ``wq``,
    ``wk``, ``wv``, the MLP's ``wi`` and ``wg``, the unembedding) by
    ``msize`` column blocks, the decode kernel on each model slot's heads,
    the gated RMSNorm's float32 sum of squares by ``d_in`` blocks summed in
    slot order, and ``y = C . ssm`` by the SSM state's blocks (its dim
    ``ssm_dim`` of the (groups, layers, B, H, P, N) leaf).  Yields the set
    of products reached, to check against those expected."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels import ops as kops
    from repro_torch.models.ssm import ssm_dims

    aten = torch.ops.aten
    d_in = ssm_dims(cfg)[0]
    by_rows, by_cols = set(), set()

    def add(where, w, shape):
        where.add((w.data_ptr(), tuple(shape)))
    for key, where in (("out_proj", by_rows), ("in_proj", by_cols)):
        st = params["mamba_groups"][key]
        for i in range(st.shape[0]):
            for jl in range(st.shape[1]):
                add(where, st[i, jl], st.shape[2:])
    att, mlp = params["shared_attn"]["attn"], params["shared_attn"]["mlp"]
    add(by_rows, att["wo"], (att["wo"].shape[0] * att["wo"].shape[1], att["wo"].shape[2]))
    add(by_rows, mlp["wo"], mlp["wo"].shape)
    for k in ("wq", "wk", "wv"):
        add(by_cols, att[k], (att[k].shape[0], att[k].shape[1] * att[k].shape[2]))
    for k in ("wi", "wg"):
        add(by_cols, mlp[k], mlp[k].shape)
    add(by_cols, params["embed"]["unembed"], params["embed"]["unembed"].shape)
    expected = by_rows if rows else set()
    if order:
        expected = expected | by_cols | {"gated_norm", "ssm_read"}
    seen = set()

    def blocks(n):
        return [slice(m * (n // msize), (m + 1) * (n // msize)) for m in range(msize)]

    class Mirror(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in (aten.mm.default, aten.matmul.default) and not kwargs:
                a, w = args
                key = (w.data_ptr(), tuple(w.shape))
                if rows and key in by_rows:
                    seen.add(key)
                    parts = [func(a[..., b].contiguous(), w[b]) for b in blocks(w.shape[0])]
                    acc = parts[0].float()
                    for part in parts[1:]:
                        acc = acc + part.float()
                    return acc.to(parts[0].dtype)
                if order and key in by_cols:
                    seen.add(key)
                    return torch.cat([func(a, w[:, b].contiguous()) for b in blocks(w.shape[1])],
                                     dim=-1)
            if order and func is aten.mean.dim and args[0].dtype == torch.float32 and \
                    args[0].shape[-1] == d_in and list(args[1]) == [-1]:
                seen.add("gated_norm")
                x = args[0]
                acc = None
                for b in blocks(d_in):
                    part = x[..., b].contiguous().sum(dim=-1, keepdim=True)
                    acc = part if acc is None else acc + part
                return acc / d_in
            if order and func is aten.einsum.default and args[0] == "bn,bhpn->bhp":
                seen.add("ssm_read")
                c, st = args[1]
                dim = ssm_dim - 2
                return torch.cat([func(args[0], [c, st.narrow(dim, b.start, b.stop - b.start)
                                                 .contiguous()])
                                  for b in blocks(st.shape[dim])], dim=dim)
            return func(*args, **kwargs)

    real = kops.decode_attention

    def mirrored(q, k, v, positions, pos, *, window=None, return_lse=False):
        if return_lse:
            raise ValueError("the one-device decode asks for no log-sum-exp")
        H, K, c = q.shape[1], k.shape[2], k.shape[1] // holders
        hb = blocks(H) if order else [slice(0, H)]
        kb = blocks(K) if order else [slice(0, K)]
        outs = []
        for h, g in zip(hb, kb):
            parts = [real(q[:, h].contiguous(), k[:, i * c:(i + 1) * c, g].contiguous(),
                          v[:, i * c:(i + 1) * c, g].contiguous(),
                          positions[:, i * c:(i + 1) * c].contiguous(), pos, window=window,
                          return_lse=holders > 1) for i in range(holders)]
            if holders == 1:
                outs.append(parts[0])
                continue
            lse = torch.stack([lv for _, lv in parts])
            wt = torch.exp(lse - lse.amax(dim=0))
            acc = sum(wi[..., None] * o.float() for wi, (o, _) in zip(wt, parts))
            outs.append((acc / wt.sum(dim=0)[..., None]).to(parts[0][0].dtype))
        return torch.cat(outs, dim=1)

    kops.decode_attention = mirrored
    try:
        with Mirror():
            yield seen
    finally:
        kops.decode_attention = real
    if seen != expected:
        fail(f"the mesh's rounding reached {len(seen & expected)} of the {len(expected)} "
             f"products and sums it mirrors (and {len(seen - expected)} others)")


def _written_rel(got, want, init) -> float:
    """The mean relative error of ``got`` against ``want`` over the entries
    either changed from ``init`` (a decode step writes a cache's new slots
    only; a recurrent state changes whole)."""
    g, w, s0 = got.float().to(want.device), want.float(), init.float().to(want.device)
    m = (w != s0) | (g != s0)
    if not bool(m.any()):
        return 0.0
    return float((g - w).abs()[m].mean() / w.abs()[m].mean())


def _rounding_dist(logits: list, state, ref_logits: list, ref_state, init) -> dict:
    """How far a bf16 run (each step's logits, its final state, gathered)
    lies from a reference run: the largest step's mean relative logit
    error, and each float state leaf's :func:`_written_rel`."""
    a, b, s0 = _state_leaves(state), _state_leaves(ref_state), _state_leaves(init)
    return {"logits": max(_logits_close(g, w, "float32")["mean_rel_err"]
                          for g, w in zip(logits, ref_logits)),
            "state": {k: _written_rel(a[k], w, s0[k]) for k, w in b.items()
                      if w.is_floating_point() and k.split("/")[-1] not in STATIC_LEAVES}}


def _over(dist: dict, limit: dict) -> bool:
    return dist["logits"] > limit["logits"] or max(dist["state"].values()) > limit["state"]


@contextlib.contextmanager
def rounding_fault(torch, kind: str, dtype):
    """A fault that shows only where the model computes in bf16: ``psum``
    (every all-reduce of bf16 partial sums accumulating in their own type,
    rounded after each add: no fault over two slots, whose one add rounds
    once either way), ``merge`` (the cache slices' partial attentions
    merged in their own type, not float32) or ``state`` (the new conv
    windows and SSM states rounded to the model's ``dtype`` before they are
    written)."""
    from repro_torch.launch import collectives
    from repro_torch.models import attention, sharding

    real = (collectives._sum32, attention.merge_partials, sharding.write_piece)

    def sum_rounding(xs, dev):
        out = xs[0].to(dev)
        for x in xs[1:]:
            out = out + x.to(dev)
        return out.float()

    def merge_rounding(parts):
        lse = torch.stack([l for _, l in parts])
        w = torch.exp(lse - lse.amax(dim=0))
        acc = sum(wi[..., None].to(o.dtype) * o for wi, (o, _) in zip(w, parts))
        return acc / w.sum(dim=0)[..., None].to(acc.dtype)

    def write_rounded(piece, new):
        return real[2](piece, new.to(dtype).to(new.dtype))

    if kind == "psum":
        collectives._sum32 = sum_rounding
    elif kind == "merge":
        attention.merge_partials = merge_rounding
    else:
        sharding.write_piece = write_rounded
    try:
        yield
    finally:
        collectives._sum32, attention.merge_partials, sharding.write_piece = real


def family_rounding_gate(torch, cfg, params, state0, toks, mesh, name: str, run: dict,
                         got: list, got_state, want: list, want_state) -> dict:
    """(b)'s bf16 gate.  One device's bf16 decode run again under
    :func:`mesh_rounding` (the same weights, state and tokens) is the
    reference; how far it lies from plain one device's, and how far each of
    its parts alone does (the row-parallel partial sums, the cache slices,
    the mesh's summation order), is what the mesh's layout does to the
    numbers.  The mesh's own bf16 run (``got``, ``got_state``) must lie
    within ``run["rounding_limit"]`` of it, by the logits and by every
    float state leaf (:func:`_rounding_dist`): the two compute alike, so
    the limit sits just above float32 noise (an extra rounding anywhere
    grows to a few percent over the steps).  Each :func:`rounding_fault` of
    ``run["rounding_faults"]`` planted in the mesh run must then lie beyond
    the limit, else the gate is blind."""
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import get_model, sharding

    api = get_model(cfg)
    dsize, msize = run["mesh"]
    B, steps = toks.shape
    holders = decode_holders(cfg, dsize, B, run["capacity"])[1]
    ssm_dim = _state_model_dims(cfg, dsize, msize, B, run["capacity"])["mamba/ssm"]

    def one_device(rows: bool, holders: int, order: bool):
        st, lgs = clone_state(state0), []
        with mesh_rounding(torch, params, cfg, msize, holders, ssm_dim, rows, order):
            for t in range(steps):
                lg, st = api.decode(params, st, toks[:, t:t + 1])
                lgs.append(lg)
        return lgs, st
    limit = run["rounding_limit"]
    out = {"limit": limit}
    for part, knobs in (("rows_only", (True, 1, False)), ("slices_only", (False, holders, False)),
                        ("order_only", (False, 1, True))):
        lgs, st = one_device(*knobs)
        out[f"{part}_from_one_device"] = _rounding_dist(lgs, st, want, want_state, state0)
    emu, st = one_device(True, holders, True)
    out |= {"emulated_from_one_device": _rounding_dist(emu, st, want, want_state, state0),
           "mesh_from_one_device": _rounding_dist(got, got_state, want, want_state, state0),
           "mesh_from_emulated": _rounding_dist(got, got_state, emu, st, state0)}
    pparams = sharding.place(params, sharding.param_specs(params, cfg, mesh), mesh)
    for kind in run["rounding_faults"]:
        ps = sharding.place(clone_state(state0), sharding.state_specs(state0, cfg, mesh, B),
                            mesh)
        bad = []
        with rounding_fault(torch, kind, getattr(torch, cfg.dtype)), use_mesh(mesh):
            for t in range(steps):
                lg, ps = api.decode(pparams, ps, toks[:, t:t + 1])
                bad.append(lg)
        out[f"planted_{kind}_from_emulated"] = _rounding_dist(bad, sharding.gather(ps), emu, st,
                                                              state0)
    if _over(out["mesh_from_emulated"], limit):
        fail(f"decode family {name} bf16: the mesh lies beyond {limit} from one device rounded "
             f"as the mesh rounds: {out}")
    for kind in run["rounding_faults"]:
        if not _over(out[f"planted_{kind}_from_emulated"], limit):
            fail(f"decode family {name} bf16: the gate {limit} passes a planted {kind} rounding "
                 f"fault: {out}")
    return out


def family_decode_guard(torch, cfg, params, state0, toks, mesh, steps: int, want: list,
                        name: str) -> dict:
    """``steps`` mesh decode steps from the whole weights and a whole copy
    of the state (each slot reading its blocks through views) under
    :func:`param_guard` over both: no op reads more than a model slot's
    block of a split weight or more than one slot's block of a state leaf
    (the exceptions of :func:`family_tp_exceptions` aside), and the logits
    are the counted run's."""
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import get_model, sharding

    api = get_model(cfg)
    st = clone_state(state0)
    B = toks.shape[0]
    specs = sharding.state_specs(st, cfg, mesh, B)
    allowed = family_tp_exceptions(cfg, mesh.shape["model"])
    close = _close_fn(cfg.dtype)
    t0 = time.time()
    with param_guard(torch, params, cfg, mesh, allowed, state=st, state_specs=specs) as guard, \
            use_mesh(mesh):
        for t in range(steps):
            lg, st = api.decode(params, st, toks[:, t:t + 1])
            c = close(lg, want[t])
            if not c["ok"]:
                fail(f"decode family {name}: the checked step {t}'s logits {c}")
    check_param_guard(f"decode family {name}", guard)
    state_reads = {k: v for k, v in guard["reads"].items() if k.startswith("state/")}
    if set(state_reads) != {f"state/{k}" for k in _state_leaves(st)}:
        fail(f"decode family {name}: the guard saw reads of {sorted(state_reads)} only")
    return {"steps": steps, "wall_s": time.time() - t0, "exceptions": list(allowed),
            "largest_param_read": max((v for k, v in guard["reads"].items()
                                       if not k.startswith("state/")), default=0),
            "largest_state_read": state_reads}


def family_decode_run(torch, counters, name: str, run: dict, device, smoke: bool = False,
                      params=None) -> dict:
    """One part of phase 26: ``run["steps"]`` decode steps of ``run``'s
    model on one device from :func:`family_state_fill`'s state (the
    counters zeroed just before and read just after), then the same steps
    on the same tokens over the mesh from the weights and the state placed
    by ``param_specs`` and ``state_specs`` (counters zeroed just before and
    read just after: :func:`family_decode_launches`, the collective calls
    exactly :func:`family_decode_collectives`'s, each sLSTM layer's exactly
    :func:`slstm_decode_layer_calls`'s; every decode-kernel call held to its
    plain version, :func:`decode_recording`): every step's logits within
    phase 12's bf16 limit or a float32 pair's; the state's blocks the same
    tensors after the steps; gathered afterwards, every leaf against one
    device's (:func:`_compare_states`); then ``run["rounding_limit"]``'s
    :func:`family_rounding_gate`, ``run["float32_pair"]``'s
    :func:`family_float32_pair` and ``run["guard_steps"]``'s
    :func:`family_decode_guard`."""
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import get_model, sharding

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = mesh_cfg(run, smoke, use_pallas=True)
    api = get_model(cfg)
    mesh = _mesh_of(run, device)
    dsize, msize = run["mesh"]
    B, steps, cap = run["batch"], run["steps"], run["capacity"]
    t0 = time.time()
    if params is None:
        params = api.init(run["seed"], device)
    state0 = family_state_fill(torch, api, run, device)
    toks = torch.randint(0, cfg.vocab_size, (B, steps), device=device, dtype=torch.int32,
                         generator=torch.Generator(device=device).manual_seed(run["seed"] + 1))
    sync()
    out = {"config": cfg.arch_id, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "init_s": time.time() - t0,
           "layout": decode_layout_of(cfg, msize) if family_attn_layers(cfg) else None,
           "state_model_dims": _state_model_dims(cfg, dsize, msize, B, cap)}
    ref_state = clone_state(state0)
    zero_counters(counters)
    t0 = time.time()
    want = []
    for t in range(steps):
        lg, ref_state = api.decode(params, ref_state, toks[:, t:t + 1])
        want.append(lg)
    sync()
    out["single_wall_s"] = time.time() - t0
    out["single_launches"] = {c.__name__: c.launches for c in counters}
    if on_card:
        check_launches(f"decode family {name} one device", out["single_launches"],
                       family_decode_launches(cfg, dsize, msize, B, cap, steps, mesh=False))
    pparams = sharding.place(params, sharding.param_specs(params, cfg, mesh), mesh)
    specs = sharding.state_specs(state0, cfg, mesh, B)
    pstate = sharding.place(state0, specs, mesh)
    ptrs = _shard_ptrs(pstate)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    zero_counters(counters)
    collectives.TRAFFIC.clear()
    calls, per_layer, got = [], [], []
    t0 = time.time()
    with decode_recording(torch, calls), slstm_traffic(torch, per_layer, "slstm_decode_row"), \
            use_mesh(mesh):
        for t in range(steps):
            lg, pstate = api.decode(pparams, pstate, toks[:, t:t + 1])
            got.append(lg)
        sync()
    out["mesh_wall_s"] = time.time() - t0
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() if on_card else None
    out["launches"] = {c.__name__: c.launches for c in counters}
    out["collectives"] = {op: list(v) for op, v in collectives.TRAFFIC.items()}
    launches = family_decode_launches(cfg, dsize, msize, B, cap, steps)
    if on_card:
        check_launches(f"decode family {name}", out["launches"], launches)
    check_collective_calls(f"decode family {name}", collectives.TRAFFIC,
                           family_decode_collectives(cfg, dsize, msize, B, cap, steps))
    if cfg.family == "xlstm":
        layer = slstm_decode_layer_calls(cfg, msize)
        carriers = dsize if B % dsize == 0 else 1
        n = carriers * (cfg.n_layers // cfg.slstm_every) * steps
        if len(per_layer) != n or any(c != layer for c in per_layer):
            fail(f"decode family {name}: sLSTM collective calls per layer {per_layer[:3]}..., "
                 f"expected {layer} in each of {n}")
        out["slstm_layer_collectives"] = layer
    n_kernel = launches["decode_attention"]
    lse = family_attn_layers(cfg) and decode_holders(cfg, dsize, B, cap)[1] > 1
    want_calls = ({"decode_attention": n_kernel} | ({"decode_attention_lse": n_kernel}
                                                   if lse else {})) if n_kernel else {}
    if want_calls:
        out["kernel_vs_plain_max_err"] = _check_calls(f"decode family {name}", calls, want_calls)
    elif calls:
        fail(f"decode family {name}: {len(calls)} decode-kernel calls in a layout that runs none")
    close = _close_fn(cfg.dtype)
    gate = cfg.dtype == "float32" or bool(run.get("bf16_gate"))
    if not (gate or run.get("float32_pair")):
        fail(f"decode family {name}: a bf16 run without its gate needs a float32 pair")
    worst = {"max_err": 0.0, "mean_rel_err": 0.0}
    for t, (g, w) in enumerate(zip(got, want)):
        c = close(g, w)
        if (gate and not c["ok"]) or not bool(g.isfinite().all()) or \
                tuple(g.shape) != (B, 1, cfg.vocab_size):
            fail(f"decode family {name}: step {t}'s logits {tuple(g.shape)} against one "
                 f"device's {c}")
        worst = {k: max(v, c[k]) for k, v in worst.items()}
    out["logits"] = worst | {"gated": gate}
    if _shard_ptrs(pstate) != ptrs or sharding.state_specs(state0, cfg, mesh, B) != specs:
        fail(f"decode family {name}: the state's blocks are not the placed blocks after the "
             f"steps")
    out["state"] = _compare_states(torch, sharding.gather(pstate), ref_state, state0, cfg.dtype,
                                   f"decode family {name}", gate)
    if run.get("rounding_limit"):
        out["rounding"] = family_rounding_gate(torch, cfg, params, state0, toks, mesh, name, run,
                                               got, sharding.gather(pstate), want, ref_state)
    del pparams, pstate
    if run.get("float32_pair"):
        out["float32"] = family_float32_pair(torch, cfg, params, state0, toks, mesh, name,
                                             {"one device": want, "mesh": got})
    if run.get("guard_steps"):
        if on_card:
            torch.cuda.empty_cache()
        out["guard"] = family_decode_guard(torch, cfg, params, state0, toks, mesh,
                                           run["guard_steps"], want, name)
    return out


def family_decode_shape_row(torch, gen, label: str, B: int, H: int, K: int, hd: int, C: int,
                            live: int, dtype, lse: bool) -> dict:
    """Decode attention at one of phase 26's per-slot shapes (B rows, H
    query and K K/V heads of ``hd``, C slots of which the first ``live``
    valid, as a filled ring leaves them; with ``lse`` the log-sum-exp
    route), against its plain version, timed by :func:`device_time` (K/V
    cold) beside the plain version and SDPA on the same mask, against the
    bound of the bytes it must read."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_cost

    dev = torch.device("cuda")
    q = (torch.randn((B, H, hd), generator=gen, device=dev) * 0.5).to(dtype)
    mask = (torch.arange(C, device=dev) < live)[None, :].expand(B, C).contiguous()
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes, flops = decode_cost(B, H, K, hd, C, itemsize, int(mask.sum()), lse=lse)
    n = cold_ring(nbytes)
    kv = (torch.randn((n, 2, B, C, K, hd), generator=gen, device=dev) * 0.5).to(dtype)
    got = kdec.decode_attention(q, kv[0, 0], kv[0, 1], mask, return_lse=lse)
    want = ref.decode_attention_ref(q, kv[0, 0], kv[0, 1], mask, lse)
    err = _err(torch, f"decode_attention {label}", got[0] if lse else got,
               want[0] if lse else want)
    kern = device_time(torch, [lambda i=i: kdec.decode_attention(q, kv[i, 0], kv[i, 1], mask,
                                                                 return_lse=lse)
                               for i in range(n)])
    plain = device_time(torch, [lambda i=i: ref.decode_attention_ref(q, kv[i, 0], kv[i, 1], mask,
                                                                     lse)
                                for i in range(n)])
    kvt = kv.transpose(3, 4).contiguous()
    q4, m4 = q[:, :, None], mask[:, None, None, :]
    lib = device_time(torch, [lambda i=i: F.scaled_dot_product_attention(
        q4, kvt[i, 0], kvt[i, 1], attn_mask=m4, enable_gqa=True) for i in range(n)])
    peak = FP32_FLOPS_PER_S if dtype == torch.float32 else BF16_TENSOR_FLOPS_PER_S
    b_ms, b_by = bound(nbytes, flops, peak)
    del kv, kvt
    torch.cuda.empty_cache()
    return {"shape": {"B": B, "H": H, "K": K, "hd": hd, "C": C, "live": live,
                      "dtype": str(dtype).split(".")[-1], "lse": lse, "cold_buffers": n},
            "max_abs_err": err, "ms": kern["ms"], "host_us": kern["host_us"],
            "plain_ms": plain["ms"], "library_ms": lib["ms"], "bound_ms": b_ms,
            "bound_by": b_by, "bytes": nbytes}


def family_decode_kernel_rows(torch, gen, kernels: list, runs: dict = FAMILY_DECODE_RUNS) -> None:
    """The per-slot shapes phase 26 gives the decode kernel, timed and added
    as sub-rows ``decode_families`` of the decode row: (a) zamba2-7b's 2 K/V
    heads of 112 a model slot, B 4, 1,000 live of 1,024 slots, float32; (b)
    its 8 heads a slot over one data slot's quarter of the cache (256
    slots, all live), B 1, bf16, the log-sum-exp route; (d) whisper's 5
    heads of 64 a slot, 2 rows a data slot, 400 live of 448, bf16."""
    from repro_torch.configs import get_config

    rows = {k["name"]: k for k in kernels}
    sub = rows["decode_attention"].setdefault("decode_families", {})
    for key, dtype, lse in (("hybrid", torch.float32, False), ("hybrid_b1", torch.bfloat16, True),
                            ("encdec_heads", torch.bfloat16, False)):
        run = runs[key]
        c = get_config(run["arch"])
        dsize, msize = run["mesh"]
        D, Hd, _ = decode_holders(c, dsize, run["batch"], run["capacity"])
        B = run["batch"] // D
        C = run["capacity"] // Hd
        live = min(C, run["filled"])
        K, H = c.n_kv_heads // msize, c.n_heads // msize
        label = f"{run['arch']} ({FAMILY_DECODE_PARTS[key]}) per slot"
        sub[label] = family_decode_shape_row(torch, gen, label, B, H, K, c.head_dim, C, live,
                                             dtype, lse)


def family_decode_phase(torch, counters, card, kernels=None, gen=None, device: str = "cuda",
                        runs: dict = FAMILY_DECODE_RUNS, smoke: bool = False) -> dict:
    """Phase 26 on ``device``: on the card first the decode kernel at the
    parts' per-slot shapes (:func:`family_decode_kernel_rows`), then
    :func:`family_decode_run` for (a)-(e), (c) and (d) from one seeded
    whisper, the others each from its own seeded weights, freed before the
    next."""
    from repro_torch.models import get_model

    on_card = torch.device(device).type == "cuda"
    out, by_path = {"card": card}, {}
    if on_card and kernels is not None:
        t0 = time.time()
        family_decode_kernel_rows(torch, gen, kernels, runs)
        out["kernel_rows_s"] = time.time() - t0
    params, key = None, None
    for name, run in runs.items():
        t0 = time.time()
        if key != (run["arch"], run["layers"], run["dtype"], run["seed"]):
            params = None
            if on_card:
                torch.cuda.empty_cache()
            cfg = mesh_cfg(run, smoke, use_pallas=True)
            params = get_model(cfg).init(run["seed"], device)
            key = (run["arch"], run["layers"], run["dtype"], run["seed"])
        res = family_decode_run(torch, counters, name, run, device, smoke, params)
        res["part_s"] = time.time() - t0
        by_path[f"decode family {name} one device"] = res["single_launches"]
        by_path[f"decode family {name}"] = res["launches"]
        out[name] = res
        say_family_decode_part(name, res, run, card)
    del params
    if on_card:
        torch.cuda.empty_cache()
    out["by_path"] = by_path
    return out


def say_family_decode_part(name: str, r: dict, run: dict, card) -> None:
    """The line phase 26 prints for part ``name`` as it ends."""
    say(f"phase decode families: ({FAMILY_DECODE_PARTS[name]}) {r['config']} {r['layers']} "
        f"layers {r['dtype']} B={run['batch']} C={run['capacity']} filled {run['filled']} on a "
        f"{run['mesh']} mesh, {r['layout']} layout, state split over model "
        f"{r['state_model_dims']}: {run['steps']} steps in {r['mesh_wall_s']:.3f} s (every "
        f"kernel call checked), one device {r['single_wall_s']:.3f} s (init {r['init_s']:.1f} s); "
        f"logits {r['logits']}; state {r['state']}; bf16 against one device rounded as the "
        f"mesh {r.get('rounding')}; float32 pair {r.get('float32')}; guard "
        f"{r.get('guard')}; peak {r['peak_mem_bytes']} B; kernel calls within their plain "
        f"versions {r.get('kernel_vs_plain_max_err')}; sLSTM per layer "
        f"{r.get('slstm_layer_collectives')}; collectives {r['collectives']}; launches "
        f"{r['launches']} (one device {r['single_launches']}); part {r['part_s']:.1f} s; {card}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=pathlib.Path, default=None,
                    help="also write every measured number to this file")
    ap.add_argument("--smoke-cpu-refs", nargs=2, type=pathlib.Path, default=None,
                    metavar=("IN", "OUT"), help=argparse.SUPPRESS)
    ap.add_argument("--pipeline-cpu-ref", nargs=2, type=pathlib.Path, default=None,
                    metavar=("IN", "OUT"), help=argparse.SUPPRESS)
    ap.add_argument("--dryrun-production", nargs=3, default=None,
                    metavar=("WHAT", "OUT", "RUN"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dryrun_production is not None:
        import torch        # phase 22(c)'s dry runs, each in its own process

        sys.path.insert(0, str(SRC))
        torch.set_num_threads(1)
        what, path, run = args.dryrun_production
        run = json.loads(run)
        rec = dryrun_production_record(what, run["run"], run["smoke"])
        pathlib.Path(path).write_text(json.dumps(rec, default=str))
        return
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
    torch.cuda.empty_cache()

    # 21. the mesh's data and model axes in execution on the one card:
    # sequence-parallel prefill, per-slot MoE dispatch and the FSDP train
    # step, each run's counters zeroed just before and read just after
    t0 = time.time()
    report["mesh"] = mesh_phase(torch, counters, card)
    report["mesh"]["phase_s"] = time.time() - t0
    by_path.update(report["mesh"].pop("by_path"))
    say(f"phase mesh: {report['mesh']['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # 22. the dry run held against the card: the op analysis on meta against
    # a real run on one slot and on phase 21(c)'s mesh, then production dry
    # runs on meta in three child processes, started here, after the phases
    # whose host times are end-to-end metrics (the campaign, the planner,
    # the fleet, serving), and joined after phase 26: phases 23-26 run
    # beside them (their mesh walls are reported, not gated); the real runs'
    # counters zeroed just before and read just after
    t0 = time.time()
    report["dryrun"] = dryrun_phase(torch, counters, card, defer=True)
    production = report["dryrun"].pop("production_pending")
    report["dryrun"]["phase_s"] = time.time() - t0
    by_path.update(report["dryrun"].pop("by_path"))
    say(f"phase dryrun: {report['dryrun']['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # 23. tensor parallelism over the model axis on the one card: a dense
    # prefill and forward on (2, 16), the MoE's expert-column split on
    # (1, 16), the FSDP step under the op analysis; each run's counters
    # zeroed just before and read just after
    t0 = time.time()
    report["tp"] = tp_phase(torch, counters, card)
    report["tp"]["phase_s"] = time.time() - t0
    by_path.update(report["tp"].pop("by_path"))
    say(f"phase tp: {report['tp']['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # 24. decode over the mesh on the one card, the decode state left where
    # state_specs puts it: qwen3-4b's head-dim layout on (2, 16) and heads
    # layout on (2, 8), mixtral's cache-length split on (4, 8), each against
    # one device's decode; each run's counters zeroed just before and read
    # just after
    t0 = time.time()
    report["decode"] = decode_phase(torch, counters, card, gen=gen)
    report["decode"]["phase_s"] = time.time() - t0
    by_path.update(report["decode"].pop("by_path"))
    for k in kernels:
        if k["name"] == "decode_attention":
            k["lse_route"] = report["decode"]["lse_route"]
    say(f"phase decode: {report['decode']['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # 25. the hybrid, enc-dec and xLSTM families over the model axis on the
    # one card: the per-slot kernel shapes, then zamba2-7b's, whisper's and
    # xlstm's forwards on (1, 16) and the zamba2-7b step on (2, 4), each
    # run's counters zeroed just before and read just after
    t0 = time.time()
    report["tp_families"] = family_tp_phase(torch, counters, card, kernels, gen)
    report["tp_families"]["phase_s"] = time.time() - t0
    by_path.update(report["tp_families"].pop("by_path"))
    say(f"phase tp families: {report['tp_families']['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # 26. decode over the mesh for the hybrid, enc-dec and xLSTM families on
    # the one card, each slot's blocks of a random state read and written in
    # place: the decode kernel at the new per-slot shapes, then zamba2-7b on
    # (1, 16) and (4, 4), whisper on (2, 16) and (2, 4), xlstm on (2, 16),
    # each against one device's decode; each run's counters zeroed just
    # before and read just after
    t0 = time.time()
    report["decode_families"] = family_decode_phase(torch, counters, card, kernels, gen)
    report["decode_families"]["phase_s"] = time.time() - t0
    by_path.update(report["decode_families"].pop("by_path"))
    say(f"phase decode families: {report['decode_families']['phase_s']:.1f} s")

    # 22(c), joined
    t0 = time.time()
    report["dryrun"]["production"] = join_production_children(production)
    report["dryrun"]["production_wait_s"] = time.time() - t0
    say_dryrun_production(report["dryrun"]["production"])
    say(f"phase dryrun: (c) joined after {report['dryrun']['production_wait_s']:.1f} s more")

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
