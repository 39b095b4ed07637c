#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Drives the port's main path, the Section-5 campaign planner
(``repro_torch``), on the card and checks it, in six phases; any failure
exits non-zero:

  1. card   — prints ``nvidia-smi --query-gpu=name,power.limit`` (one line);
  2. build  — compiles every kernel source of ``src/repro_torch/kernels/csrc``
              with nvcc (one process per source, all started together);
  3. kernels — each hand-written kernel against its plain PyTorch version on
              the card, at the main path's largest shapes with random live-lane
              bounds: equal on live lanes, zero past them; CUDA-event timings
              (median of 20) of kernel and plain version, and the least time
              the card could take for the same work (its bound);
  4. golden — ``repro_torch.sim.paper_sim.run`` on cuda writes the golden CSVs
              of ``tests/golden/paper_sim`` byte for byte;
  5. main path — the full-width campaign: E1-E4 x 50 instance pairs, n = 160
              stages, p = 1000 processors, 12 bounds, H4 with 10 bisection
              steps, on cuda; every kernel's launch counter is zeroed just
              before and must be > 0 just after;
  6. cpu vs card — 8 of those instances through ``batched_trajectory_sets``
              (H1-H4) and ``batched_min_period`` on cpu and on cuda: equal.

Before its last line it prints one JSON line ``{"kernels": [...]}`` (per
kernel: launches on the main path, max abs error, kernel / plain / bound
times in ms); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
With ``--json PATH`` it also writes every number it measured to PATH.
It needs the repository's ``src/`` beside it and a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
SRC = REPO / "src"
GOLDEN = REPO / "tests" / "golden" / "paper_sim"

# H100 SXM (NVIDIA data sheet): HBM3 bandwidth and fp64 (non-tensor) peak
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 34e12

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
    """Median device time of one call of ``fn``, by CUDA events."""
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


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP64_FLOPS_PER_S * 1e3
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
    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g[live], w[live]):
            fail("score_2way_f64 differs from its plain version on live lanes")
        if g[~live].any():
            fail("score_2way_f64 left non-zero lanes past need")
        err = max(err, float((g[live] - w[live]).abs().max()))
    ms = cuda_ms(torch, lambda: split_score.score_2way_cuda(*ins, need=need))
    plain_ms = cuda_ms(torch, lambda: score_2way(*ins))
    n_live = int(need.sum())
    nbytes = 16 * n_live + 56 * A + 48 * A * K
    flops = 25 * n_live + 3 * A
    b_ms, b_by = bound(nbytes, flops)
    return {"name": "score_2way_f64", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/split_score.cu",
            "replaces": "src/repro/kernels/split_score.py:79",
            "shape": {"A": A, "K": K, "live_lanes": n_live},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
            "library_ms": None}


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
    ms = cuda_ms(torch, lambda: split_score.score_3way_cuda(*ins, need=need))
    plain_ms = cuda_ms(torch, lambda: score_3way(*ins))
    n_live = int(need.sum())
    nbytes = 72 * n_live + 160 * A + 240 * A * K
    flops = 102 * n_live
    b_ms, b_by = bound(nbytes, flops)
    return {"name": "score_3way_f64", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/split_score.cu",
            "replaces": "src/repro/kernels/split_score.py:172",
            "shape": {"A": A, "K": K, "live_lanes": n_live},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
            "library_ms": None}


def check_campaign(res: dict, n_bounds: int) -> None:
    """The campaign's outputs are well formed: every curve has one finite
    point per bound where any instance is feasible, fractions are in [0, 1],
    thresholds are finite, and H5/H6 thresholds coincide (both are the
    optimal latency)."""
    import math

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

    from repro_torch.core import batched
    from repro_torch.core.heuristics import score_2way, score_3way
    from repro_torch.kernels import build, split_score
    from repro_torch.sim import gen_instance_batch, paper_sim, run_campaign

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
    say(f"phase build: ok in {report['build_s']:.1f} s")

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20070611)
    kernels = [check_kernel_2way(torch, split_score, score_2way, gen),
               check_kernel_3way(torch, split_score, score_3way, gen)]
    torch.cuda.empty_cache()
    for k in kernels:
        say(f"phase kernels: {k['name']} equal to plain on live lanes; "
            f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms)")

    # 4. golden CSVs on cuda
    t0 = time.time()
    gold_dir = REPO / "build" / "chip_smoke" / "paper_sim"
    res = paper_sim.run(gold_dir, families="all", ns=(5,), ps=(10,), n_pairs=3,
                        n_bounds=4, device="cuda")
    if not all(c.startswith("[PASS]") for c in res["claims"]):
        fail(f"golden claims: {res['claims']}")
    names = sorted(f.name for f in GOLDEN.iterdir())
    if sorted(f.name for f in gold_dir.iterdir()) != names:
        fail("golden: file set differs")
    for name in names:
        if (gold_dir / name).read_bytes() != (GOLDEN / name).read_bytes():
            fail(f"golden: {name} differs")
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
    check_campaign(camp, N_BOUNDS)
    for name, count in launches.items():
        if count <= 0:
            fail(f"main path launched {name} no time")
    report["campaign"] = {
        "families": list(FAMILIES), "n": N_STAGES, "p": N_PROCS,
        "n_pairs": N_PAIRS, "n_bounds": N_BOUNDS, "h4_iters": H4_ITERS,
        "wall_s": wall, "launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "thresholds": {e: r.thresholds for e, r in camp.items()}}
    say(f"phase main path: campaign {len(FAMILIES)}x{N_PAIRS} pairs n={N_STAGES} "
        f"p={N_PROCS} in {wall:.2f} s; launches {launches}")

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
